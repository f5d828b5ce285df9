"""Worker process for tests/test_multihost.py — NOT a pytest module.

Spawned twice by the parent test with the JAX_* env contract
(JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID) plus 4
virtual CPU devices per process, forming a REAL 2-process
jax.distributed cluster with an 8-device global mesh (SURVEY.md §2.8:
jax.distributed + DCN init is the multi-host plan; this exercises it
across actual process boundaries).

Checks, in order:
1. ``multihost.initialize`` picks the cluster up from the environment;
2. ``host_local_batch_to_global`` assembles per-host scan batches into
   one globally-sharded batch (each host feeds its own scans);
3. ``make_batched_localizer`` runs the data-parallel localization step
   over the global mesh and every host's shard of the result matches a
   single-device replay of its own scans;
4. the distributed pose-graph optimizer (constraints sharded across
   both hosts, normal equations psum'd over the global mesh) matches
   the single-process optimizer.

Exit codes: 0 = all checks passed, 77 = cluster bring-up unavailable
in this sandbox (parent skips), anything else = failure.
"""

import sys


def main() -> int:
    import jax

    # The workers are CPU processes (two of them would not share a card);
    # force CPU before any backend init.
    jax.config.update("jax_platforms", "cpu")

    from lidar_feature_extraction_tpu.parallel import multihost

    try:
        multihost.initialize()   # env contract (JAX_* variables)
        n_proc = jax.process_count()
        n_dev = len(jax.devices())
    except Exception as e:  # cluster bring-up unavailable
        print(f"SKIP: jax.distributed unavailable: {e!r}")
        return 77
    assert n_proc == 2, n_proc
    assert n_dev == 8, n_dev

    import numpy as np
    import jax.numpy as jnp

    from __graft_entry__ import _synthetic_scene, _tiny_config
    from lidar_feature_extraction_tpu.core.pose import Pose
    from lidar_feature_extraction_tpu.parallel.distributed import (
        make_batched_localizer)
    from lidar_feature_extraction_tpu.parallel.pose_graph import (
        Constraints, PoseGraph, optimize_pose_graph)
    from lidar_feature_extraction_tpu.pipeline.localization import (
        localize_scan)

    pid = jax.process_index()
    mesh = multihost.global_mesh()
    cfg = _tiny_config(max_iterations=2)
    maps, image = _synthetic_scene(cfg)   # deterministic: same per host

    # --- per-host scan ingestion -> global batch (4 scans per host) ---
    # Global scan b is a deterministic perturbation of the base image,
    # so either host can also compute any scan locally for the check.
    def scan_xyz(b: int) -> np.ndarray:
        return np.asarray(image.xyz) + 0.01 * b

    local_ids = [pid * 4 + k for k in range(4)]
    local_images = jax.tree.map(
        lambda *xs: np.stack([np.asarray(x) for x in xs]),
        *[image._replace(xyz=jnp.asarray(scan_xyz(b), jnp.float32))
          for b in local_ids])
    local_priors = Pose(
        q=np.tile(np.asarray([1.0, 0, 0, 0], np.float32), (4, 1)),
        t=np.zeros((4, 3), np.float32))

    g_images = multihost.host_local_batch_to_global(mesh, local_images)
    g_priors = multihost.host_local_batch_to_global(mesh, local_priors)
    g_maps = multihost.replicate_to_global(mesh, maps)
    assert g_images.xyz.shape[0] == 8, g_images.xyz.shape

    # --- data-parallel localization over the 2-host mesh ---
    localizer = make_batched_localizer(mesh, cfg)
    results, _feats = localizer(g_maps, g_images, g_priors)
    jax.block_until_ready(results.pose.t)

    # Each host's addressable output shards must match a local
    # single-device replay of the corresponding global scans.
    for shard in results.pose.t.addressable_shards:
        (row_slice, _) = shard.index
        for row, b in enumerate(range(row_slice.start, row_slice.stop)):
            local_img = image._replace(
                xyz=jnp.asarray(scan_xyz(b), jnp.float32))
            ref, _ = localize_scan(maps, local_img,
                                   Pose.identity(jnp.float32), cfg)
            np.testing.assert_allclose(
                np.asarray(shard.data)[row], np.asarray(ref.pose.t),
                atol=1e-5)

    # --- distributed pose graph: constraints sharded across hosts ---
    # A consistent odometry CHAIN (every pose constrained) with noisy
    # initialization: well-conditioned, so the distributed solution
    # must match the single-process one tightly. (A random-index graph
    # can leave poses held only by the 1e-6 damping, where the answer
    # is sensitive to reduction order.)
    rng = np.random.default_rng(7)   # same graph on both hosts
    k = 9
    m = 8
    graph = PoseGraph(
        poses_q=jnp.asarray(np.tile([1.0, 0, 0, 0], (k, 1)), jnp.float32),
        poses_t=jnp.asarray(rng.normal(scale=0.05, size=(k, 3)),
                            jnp.float32))
    i = np.arange(m, dtype=np.int32)
    cons = Constraints(
        i=i, j=i + 1,
        z_q=np.tile(np.asarray([1.0, 0, 0, 0], np.float32), (m, 1)),
        z_t=np.asarray(rng.normal(scale=0.05, size=(m, 3)), np.float32),
        weight=np.ones(m, np.float32))

    half = slice(pid * (m // 2), (pid + 1) * (m // 2))
    local_cons = jax.tree.map(lambda x: np.asarray(x)[half], cons)
    g_cons = multihost.host_local_batch_to_global(mesh, local_cons)
    g_graph = multihost.replicate_to_global(mesh, graph)

    from functools import partial
    from jax.sharding import PartitionSpec as P

    @jax.jit
    @partial(jax.shard_map, mesh=mesh,
             in_specs=(P(), Constraints(P("data"), P("data"), P("data"),
                                        P("data"), P("data"))),
             out_specs=P(), check_vma=False)
    def dist_opt(g, c):
        return optimize_pose_graph(g, c, axis_name="data")

    out_dist = dist_opt(g_graph, g_cons)
    out_single = optimize_pose_graph(graph, cons)
    np.testing.assert_allclose(
        np.asarray(out_dist.poses_t.addressable_shards[0].data),
        np.asarray(out_single.poses_t), atol=1e-3)

    print(f"MULTIHOST_OK pid={pid}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
