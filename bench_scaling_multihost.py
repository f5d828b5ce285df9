"""Cross-process scaling artifact.

Measures the real 2-process ``jax.distributed`` cluster from
``tests/test_multihost.py`` against a single process at FIXED TOTAL
WORK: 8 virtual CPU devices and an 8-scan batch either live in one
process, or split 4+4 across two processes with a localhost
coordinator. Total compute on the machine is identical, so the
throughput ratio isolates exactly the cross-process costs — dual
runtimes, distributed dispatch, and the coordination barrier — which
is the loss model for the DP serving step (zero steady-state
collectives: maps replicated, scans sharded, no cross-scan
communication; see BASELINE.md scaling methodology).

This is NOT a statement about physical scaling (2 CPU cores cannot
speed anything up by splitting); on real multi-host GPU hardware the
same per-host batch would ride separate cards and the efficiency target is
>= 80% (BASELINE.json).

Run: python bench_scaling_multihost.py        (parent; spawns workers)
Output: SCALING_MULTIHOST.json
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path


def worker() -> int:
    import jax

    jax.config.update("jax_platforms", "cpu")

    from lidar_feature_extraction_tpu.parallel import multihost

    n_proc = int(os.environ.get("JAX_NUM_PROCESSES", "1"))
    if n_proc > 1:
        multihost.initialize()
    pid = jax.process_index()
    n_dev_local = len(jax.local_devices())

    import numpy as np
    import jax.numpy as jnp

    from __graft_entry__ import _synthetic_scene, _tiny_config
    from lidar_feature_extraction_tpu.core.pose import Pose
    from lidar_feature_extraction_tpu.parallel.distributed import (
        make_batched_localizer)

    mesh = multihost.global_mesh()
    cfg = _tiny_config(max_iterations=8)
    maps, image = _synthetic_scene(cfg)   # deterministic per process

    local_ids = [pid * n_dev_local + k for k in range(n_dev_local)]
    local_images = jax.tree.map(
        lambda *xs: np.stack([np.asarray(x) for x in xs]),
        *[image._replace(
            xyz=image.xyz + jnp.float32(0.01 * b)) for b in local_ids])
    local_priors = Pose(
        q=np.tile(np.asarray([1.0, 0, 0, 0], np.float32),
                  (n_dev_local, 1)),
        t=np.zeros((n_dev_local, 3), np.float32))

    g_images = multihost.host_local_batch_to_global(mesh, local_images)
    g_priors = multihost.host_local_batch_to_global(mesh, local_priors)
    g_maps = multihost.replicate_to_global(mesh, maps)
    n_global = g_images.xyz.shape[0]

    # chain_n localization steps per DISPATCH (each step's prior is the
    # previous step's result — a real data dependence): scaling chain_n
    # separates fixed per-dispatch coordination cost from compute.
    chain_n = int(os.environ.get("MH_BENCH_CHAIN", "1"))
    from functools import partial as _partial

    from jax.sharding import NamedSharding, PartitionSpec as P
    from lidar_feature_extraction_tpu.pipeline.localization import (
        localize_scan)

    batched = jax.vmap(_partial(localize_scan, cfg=cfg),
                       in_axes=(None, 0, 0))
    replicated = NamedSharding(mesh, P())
    sharded = NamedSharding(mesh, P("data"))

    def chain(maps, images, q, t):
        def body(_, carry):
            cq, ct = carry
            res, _f = batched(maps, images, Pose(cq, ct))
            return res.pose.q, res.pose.t
        return jax.lax.fori_loop(0, chain_n, body, (q, t))

    fn = jax.jit(chain,
                 in_shardings=(replicated,
                               jax.tree.map(lambda _: sharded, g_images),
                               sharded, sharded),
                 out_shardings=(sharded, sharded))

    out = fn(g_maps, g_images, g_priors.q, g_priors.t)
    jax.block_until_ready(out)

    n_iter = int(os.environ.get("MH_BENCH_ITERS", "30"))
    t0 = time.perf_counter()
    for _ in range(n_iter):
        out = fn(g_maps, g_images, g_priors.q, g_priors.t)
        jax.block_until_ready(out)
    dt = time.perf_counter() - t0

    sps = n_global * chain_n * n_iter / dt
    if pid == 0:
        print("MHBENCH " + json.dumps({
            "n_processes": n_proc,
            "n_devices_global": n_global,
            "chain_per_dispatch": chain_n,
            "global_scans_per_sec": round(sps, 2),
            "ms_per_dispatch": round(1000 * dt / n_iter, 2),
        }), flush=True)
    return 0


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def run_config(n_proc: int, chain_n: int = 1) -> dict:
    root = Path(__file__).resolve().parent
    port = _free_port()
    per_host_devices = 8 // n_proc
    procs = []
    for pid in range(n_proc):
        env = dict(os.environ)
        env.update({
            "MH_BENCH_WORKER": "1",
            "MH_BENCH_CHAIN": str(chain_n),
            "XLA_FLAGS":
                f"--xla_force_host_platform_device_count={per_host_devices}",
            "JAX_PLATFORMS": "cpu",
            "PYTHONPATH": str(root),
        })
        env.pop("JAX_COMPILATION_CACHE_DIR", None)
        if n_proc > 1:
            env.update({
                "JAX_COORDINATOR_ADDRESS": f"localhost:{port}",
                "JAX_NUM_PROCESSES": str(n_proc),
                "JAX_PROCESS_ID": str(pid),
            })
        else:
            for k in ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES",
                      "JAX_PROCESS_ID"):
                env.pop(k, None)
        # Pin each multi-process worker to a disjoint core set: without
        # pinning, every process spins an XLA CPU thread pool sized to
        # ALL cores and the measurement is dominated by oversubscription
        # rather than runtime overhead.
        cmd = [sys.executable, __file__]
        n_cores = os.cpu_count() or 1
        if n_proc > 1 and n_cores >= n_proc:
            per = n_cores // n_proc
            lo, hi = pid * per, pid * per + per - 1
            cmd = ["taskset", "-c", f"{lo}-{hi}"] + cmd
        procs.append(subprocess.Popen(
            cmd, env=env, cwd=str(root),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = [p.communicate(timeout=900)[0] for p in procs]
    for p, out in zip(procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"worker rc={p.returncode}:\n{out[-3000:]}")
    for out in outs:
        for line in out.splitlines():
            if line.startswith("MHBENCH "):
                return json.loads(line[len("MHBENCH "):])
    raise RuntimeError("no MHBENCH line:\n" + outs[0][-2000:])


def main() -> None:
    rows = {}
    for chain_n in (1, 10):
        one = run_config(1, chain_n)
        print(f"1-process chain={chain_n}:", one, flush=True)
        two = run_config(2, chain_n)
        print(f"2-process chain={chain_n}:", two, flush=True)
        rows[f"chain_{chain_n}"] = {
            "one_process": one,
            "two_process": two,
            "efficiency": round(two["global_scans_per_sec"]
                                / one["global_scans_per_sec"], 3),
        }
    # Fixed per-dispatch cross-process overhead from the two chain
    # depths: dispatch time = a + b * chain_n per config.
    ov = {}
    for k, r in rows.items():
        ov[k] = round(r["two_process"]["ms_per_dispatch"]
                      - r["one_process"]["ms_per_dispatch"], 2)
    out = {
        "metric": "cross_process_efficiency_fixed_total_work",
        "value": rows["chain_10"]["efficiency"],
        "unit": "ratio",
        **rows,
        "extra_ms_per_dispatch_2proc": ov,
        "methodology": (
            "8 virtual CPU devices / 8-scan DP localization batch, in "
            "one process vs split 4+4 across a real 2-process "
            "jax.distributed cluster (localhost coordinator, workers "
            "core-pinned to disjoint cores). Total compute is "
            "identical, so the ratio bounds the cross-process runtime "
            "cost ON A 2-CORE MACHINE. Observed: the extra time "
            "scales with work per dispatch (chain_1 vs chain_10), i.e. "
            "the split runtimes execute the same shard programs "
            "slower here (per-process XLA/coordination threads "
            "competing inside 1 core), NOT a fixed dispatch tax — the "
            "loss model that transfers to real multi-host GPU hardware "
            "(where each host owns whole cards and cores) is dispatch "
            "skew only, per BASELINE.md; this artifact records the "
            "number a 2-core machine can measure, with its confound "
            "stated."),
    }
    print(json.dumps(out))
    with open("SCALING_MULTIHOST.json", "w") as f:
        json.dump(out, f, indent=1)


if __name__ == "__main__":
    if os.environ.get("MH_BENCH_WORKER"):
        sys.exit(worker())
    main()
