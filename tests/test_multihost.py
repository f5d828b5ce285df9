"""Two-process jax.distributed test.

Spawns 2 worker processes (tests/multihost_worker.py) with a localhost
coordinator and 4 virtual CPU devices each — a real cross-process
cluster with an 8-device global mesh. The workers drive
``multihost.initialize`` (env contract), ``host_local_batch_to_global``,
``replicate_to_global``, ``make_batched_localizer`` and the distributed
pose-graph optimizer, checking results against single-process replays.

This is the multi-host execution path SURVEY.md §2.8 plans
(jax.distributed + DCN init + host-shard feeding); everything else in
the suite runs single-process on a virtual mesh.
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_cluster_localization_and_pose_graph():
    root = Path(__file__).resolve().parent.parent
    worker = root / "tests" / "multihost_worker.py"
    port = _free_port()

    procs = []
    for pid in range(2):
        env = dict(os.environ)
        env.update({
            "JAX_COORDINATOR_ADDRESS": f"localhost:{port}",
            "JAX_NUM_PROCESSES": "2",
            "JAX_PROCESS_ID": str(pid),
            "XLA_FLAGS": "--xla_force_host_platform_device_count=4",
            "JAX_PLATFORMS": "cpu",
            "PYTHONPATH": str(root),
        })
        # Workers must not share a compilation cache mid-write.
        env.pop("JAX_COMPILATION_CACHE_DIR", None)
        procs.append(subprocess.Popen(
            [sys.executable, str(worker)], env=env, cwd=str(root),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))

    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=600)
            outs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.wait()
        pytest.fail("multihost workers timed out")

    if any(p.returncode == 77 for p in procs):
        pytest.skip("jax.distributed unavailable in this sandbox:\n"
                    + outs[0][-500:])
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{out[-4000:]}"
        assert "MULTIHOST_OK" in out
