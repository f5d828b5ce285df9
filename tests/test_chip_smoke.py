"""What can be checked of the GPU bring-up without a card.

- chip_smoke.py refuses a CPU backend (and runs nowhere but in the repo),
  and its phases run at tiny shapes with the CPU standing in for both
  devices;
- the labeling arithmetic is backend-independent: the correctly
  rounded square root and the exact split products;
- the full-width compaction is a bit-exact gather;
- no Pallas kernel is traced for any backend;
- the nvidia-smi parser and the compile-cache directory rule.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import chip_smoke as cs
from lidar_feature_extraction_tpu.config import kitti_hdl64
from lidar_feature_extraction_tpu.ops import extraction as ex
from lidar_feature_extraction_tpu.utils import compile_cache
from lidar_feature_extraction_tpu.utils.device_info import parse_nvidia_smi

ROOT = Path(__file__).resolve().parents[1]


def _tiny_cfg(n_rings=16, n_points=512):
    pc = kitti_hdl64()
    return dataclasses.replace(pc, extraction=dataclasses.replace(
        pc.extraction, n_rings=n_rings, max_points_per_ring=n_points))


@pytest.fixture
def cpu():
    return jax.devices("cpu")[0]


# ------------------------------------------------------------ the script


def test_device_guard_refuses_cpu_backend(capsys):
    with pytest.raises(SystemExit) as exc:
        cs.main([])
    assert exc.value.code != 0
    out = capsys.readouterr()
    assert '"ok"' not in out.out
    assert "needs a GPU" in out.err


def test_script_alone_exits_nonzero_without_result(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_extraction_phase_tiny(cpu):
    cfg = _tiny_cfg()
    times, diffs = cs.compare_extraction(cs.worldsim_sweep(cfg, n_az=512),
                                         cfg, cpu, cpu, n_steady=1)
    assert diffs["n_label_diff"] == 0 and diffs["curvature_bit_equal"]
    assert diffs["n_edges"] > 0 and diffs["n_surfaces"] > 0
    assert times["cold_s"] > 0 and times["steady_s"] > 0


def test_localization_phase_tiny(cpu, capsys):
    cfg = _tiny_cfg()
    rng = np.random.default_rng(0)
    _, edges, surfs, scans, gt, twists = cs.localization_world(
        cfg, rng, n_scans=3, n_az=512, n_poles=20, n_ground=4000)
    with tempfile.TemporaryDirectory() as tmp:
        out = cs.phase_localization(cfg, cpu, cpu, edges, surfs, scans,
                                    gt, twists, tmp, ate_limit=10.0)
    assert out["max_pose_diff_m"] == 0.0
    assert out["repeat_max_diff_m"] == 0.0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["phase"] == "localization" and line["n_scans"] == 3


def test_mapping_phase_tiny(cpu):
    cfg = _tiny_cfg()
    rng = np.random.default_rng(1)
    world = cs.localization_world(cfg, rng, n_scans=1, n_az=256,
                                  n_poles=20, n_ground=2000)[0]
    out = cs.phase_mapping(cfg, cpu, world, rng, n_scans=4, n_az=512,
                           ate_limit=10.0, min_loops=0)
    assert out["n_keyframes"] >= 1
    assert out["ate_rmse_m"] == out["ate_rmse_m_repeat"]


def test_pose_graph_phase_tiny(cpu, capsys):
    cs.phase_pose_graph(cpu, cpu, sizes=(("dense", 16), ("cg", 32)))
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [x["solver"] for x in lines] == ["dense", "cg"]
    assert all(x["max_pose_diff_m"] == 0.0 for x in lines)


def test_pose_graph_problem_converges_toward_truth(cpu):
    from lidar_feature_extraction_tpu.parallel.pose_graph import PoseGraph

    graph, cons = cs.pose_graph_problem(24, noise=0.05)
    out, _, _ = cs.solve_pose_graph("dense", graph, cons, cpu)
    # Residual of the optimized graph is far below the start's.
    from lidar_feature_extraction_tpu.parallel.pose_graph import (
        constraint_residual)

    def cost(g):
        r = jax.vmap(constraint_residual)(
            g.poses_q[cons[0]], g.poses_t[cons[0]], g.poses_q[cons[1]],
            g.poses_t[cons[1]], cons[2], cons[3])
        return float(jnp.sum(r * r))

    start = PoseGraph(*(jnp.asarray(a) for a in graph))
    assert cost(out) < 0.01 * cost(start)


def test_four_card_phase_on_virtual_devices():
    assert len(jax.devices()) >= 4, "conftest provides 8 CPU devices"
    cs.phase_four_cards(_tiny_cfg(), n_az=256,
                        graph_sizes=(("dense", 16), ("cg", 32)))


def test_quat_angle_is_exact_near_zero():
    from lidar_feature_extraction_tpu.core import quaternion as quat

    q = np.asarray(quat.exp_so3(jnp.asarray([0.1, 0.2, 0.3])))
    dq = np.asarray(quat.exp_so3(jnp.asarray([0.0, 0.0, 1e-4])))
    q2 = np.asarray(quat.quat_multiply(jnp.asarray(q), jnp.asarray(dq)))
    assert cs.quat_angle_deg(q, q) == 0.0
    np.testing.assert_allclose(cs.quat_angle_deg(q, q2), np.degrees(1e-4),
                               rtol=1e-2)


# ------------------------------------------- backend-independent labeling


@pytest.mark.parametrize("lo,hi", [(-35.0, 35.0), (-2.0, 8.0)])
def test_sqrt_rn_is_correctly_rounded(lo, hi):
    rng = np.random.default_rng(0)
    s = (10.0 ** rng.uniform(lo, hi, size=500_000)).astype(np.float32)
    np.testing.assert_array_equal(np.asarray(jax.jit(ex.sqrt_rn)(s)),
                                  np.sqrt(s))
    # Two correction steps recover from a start two ulps off either way
    # (inside the range sqrt_rn corrects).
    s = s[(s >= 2.0 ** -80) & (s <= 2.0 ** 100)]
    ref = np.sqrt(s)
    for k in (-2, 2):
        start = (ref.view(np.int32) + k).view(np.float32)
        fixed = ex._sqrt_step(jnp.asarray(s), ex._sqrt_step(
            jnp.asarray(s), jnp.asarray(start)))
        np.testing.assert_array_equal(np.asarray(fixed), ref)


def test_dot2_is_independent_of_fused_multiply_add():
    """_dot2 must equal the same sum computed from exactly rounded
    halves in numpy, where no multiply-add is ever fused."""
    rng = np.random.default_rng(1)
    a, b, c, d = (rng.uniform(-80, 80, size=100_000).astype(np.float32)
                  for _ in range(4))

    def split(v):
        hi = (v.view(np.int32) & ~0xFFF).view(np.float32)
        return hi, v - hi

    (ah, al), (bh, bl), (ch, cl), (dh, dl) = map(split, (a, b, c, d))
    want = (((ah * bh + ch * dh) + ((ah * bl + al * bh)
                                    + (ch * dl + cl * dh)))
            + (al * bl + cl * dl))
    got = np.asarray(jax.jit(ex._dot2)(a, b, c, d))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got, a.astype(np.float64) * b + c.astype(
        np.float64) * d, rtol=1e-6, atol=1e-3)


def _full_width_scans():
    from bench import build_scan

    cfg = kitti_hdl64()
    return {"bench_scene": (cfg, build_scan(cfg, np.random.default_rng(0))),
            "worldsim_sweep": (cfg, cs.worldsim_sweep(cfg))}


@pytest.mark.parametrize("scan", ["bench_scene", "worldsim_sweep"])
def test_full_width_compaction_is_exact_gather(scan):
    """At 64x2304 the compaction matmul returns, bit for bit, the points
    a gather at the selected lanes returns."""
    cfg, image = _full_width_scans()[scan]
    e = cfg.extraction
    leaf = cfg.registration.surface_downsample_leaf
    ce, cs_ = e.edges_per_ring, e.surface_runs_per_ring
    feats = ex.extract_features_compact(image, e, surface_leaf=leaf,
                                        edges_per_ring=ce,
                                        surface_runs_per_ring=cs_)
    key = ex._voxel_run_key(image.xyz, leaf)
    col = np.asarray(ex.compact_columns(feats.labels, image.mask, key,
                                        ce, cs_)[0])
    xyz = np.asarray(image.xyz)
    R = xyz.shape[0]
    want_e = np.zeros((R, ce, 3), np.float32)
    want_s = np.zeros((R, cs_, 3), np.float32)
    for r in range(R):
        for p in np.flatnonzero(col[r] < ce + cs_):
            if col[r, p] < ce:
                want_e[r, col[r, p]] = xyz[r, p]
            else:
                want_s[r, col[r, p] - ce] = xyz[r, p]
    assert np.asarray(feats.edge_valid).sum() > 0
    np.testing.assert_array_equal(np.asarray(feats.edge_xyz),
                                  want_e.reshape(-1, 3))
    np.testing.assert_array_equal(np.asarray(feats.surface_xyz),
                                  want_s.reshape(-1, 3))


def _backend_is_never_asked():
    raise AssertionError("extraction must not branch on the backend")


@pytest.mark.parametrize("backend", [lambda: "gpu", _backend_is_never_asked],
                         ids=["gpu", "never_asked"])
def test_compact_extraction_traces_no_pallas_kernel(backend, monkeypatch):
    """One program for every backend: no kernel, no backend check."""
    cfg = _tiny_cfg(4, 256)
    image = cs.worldsim_sweep(cfg, n_az=256)
    monkeypatch.setattr(jax, "default_backend", backend)
    e = cfg.extraction
    traced = ex.extract_features_compact.trace(
        image, e, surface_leaf=1.0, edges_per_ring=e.edges_per_ring,
        surface_runs_per_ring=e.surface_runs_per_ring)
    text = str(traced.jaxpr)
    assert "pallas_call" not in text
    assert "dot_general" in text


# -------------------------------------------------- device info, cache dir


@pytest.mark.parametrize("line,name,watts", [
    ("NVIDIA H100 80GB HBM3, 700.00 W", "NVIDIA H100 80GB HBM3", 700.0),
    ("NVIDIA H100 80GB HBM3, 350.00 W", "NVIDIA H100 80GB HBM3", 350.0),
    ("NVIDIA H100 PCIe, [N/A]", "NVIDIA H100 PCIe", None),
])
def test_parse_nvidia_smi(line, name, watts):
    assert parse_nvidia_smi(line) == {"name": name, "power_limit_w": watts}


def test_parse_nvidia_smi_rejects_other_lines():
    with pytest.raises(ValueError):
        parse_nvidia_smi("No devices were found")


def test_compile_cache_dir_from_env(monkeypatch, tmp_path):
    monkeypatch.setenv(compile_cache.ENV, str(tmp_path))
    assert compile_cache.compile_cache_dir() == str(tmp_path)


def test_compile_cache_dir_default_in_checkout(monkeypatch):
    monkeypatch.delenv(compile_cache.ENV, raising=False)
    path = Path(compile_cache.compile_cache_dir())
    assert path == ROOT / ".jax_cache"
    ignored = (ROOT / ".gitignore").read_text().split()
    assert ".jax_cache/" in ignored


def test_compile_cache_dir_is_stable(monkeypatch):
    monkeypatch.delenv(compile_cache.ENV, raising=False)
    assert compile_cache.compile_cache_dir() \
        == compile_cache.compile_cache_dir()
