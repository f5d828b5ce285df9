"""ATE parity of the production fast path vs the faithful path.

The benched configuration (``config.py kitti_hdl64``: GeometryMaps +
``extract_features_compact`` + no per-iteration kNN) rides a stack of
documented deviations from the reference whose acceptance criterion is
*ATE parity* (docs/design.md §8):

- precomputed per-voxel geometry instead of per-query k=15 kNN
  (``localization/include/lidar_feature_localization/edge.hpp:78-126``);
- orthogonal-regression planes instead of the reference's ``X.w = -1``
  fit (``surface.hpp:79-83``);
- run-end surface samples instead of voxel centroids (compact path).

This test measures that criterion: one pre-generated synthetic drive is
replayed through BOTH closed-loop pipelines (localization + EKF
feedback, SURVEY.md §3.1+§3.2) and the production ATE must stay within
1.2x of the faithful ATE (plus a small absolute epsilon so a
near-perfect faithful run can't fail the ratio on noise).
"""

import numpy as np
import jax.numpy as jnp

from lidar_feature_extraction_tpu.config import (ExtractionConfig,
                                                 PipelineConfig,
                                                 RegistrationConfig,
                                                 VoxelMapConfig)
from lidar_feature_extraction_tpu.pipeline.localization import (
    build_feature_maps, build_geometry_maps)
from lidar_feature_extraction_tpu.utils import worldsim
from lidar_feature_extraction_tpu.utils.evaluation import ate_rmse


def _configs():
    """Same extraction + registration parameters; only the deviation
    stack differs (compact extraction + geometry maps vs full
    extraction + point maps with per-iteration refits)."""
    vm = VoxelMapConfig(voxel_size=2.0, table_capacity=1 << 12,
                        points_per_voxel=16, max_probes=8)
    # kitti_hdl64's extraction parameters (padding=2, 3 deg neighbor,
    # edge_threshold=50 — the reference's production YAML overlay) at
    # CI shapes.
    ex = ExtractionConfig(n_rings=16, max_points_per_ring=512,
                          padding=2, neighbor_degree_threshold=3.0,
                          edge_threshold=50.0, max_range=1000.0,
                          nms_rounds=32, max_edges=512, max_surfaces=4096,
                          edges_per_ring=32, surface_runs_per_ring=128)
    faithful = PipelineConfig(
        compact_extraction=False,
        extraction=ex,
        registration=RegistrationConfig(
            n_neighbors=8, max_iterations=20,
            refit_per_iteration=True,
            edge_map=vm, surface_map=vm))
    production = PipelineConfig(
        compact_extraction=True,
        extraction=ex,
        registration=RegistrationConfig(
            n_neighbors=8, max_iterations=20,
            edge_map=vm, surface_map=vm))
    return faithful, production


def test_production_ate_within_1p2x_of_faithful():
    rng = np.random.default_rng(0)
    faithful, production = _configs()

    world = worldsim.make_world(rng)
    world_edges, world_surfs = worldsim.world_maps(world, rng)
    # IDENTICAL pre-generated ray-cast scans for both pipelines.
    scans, gt = worldsim.make_scan_sequence(world, rng, n_scans=10,
                                            n_rings=16, n_az=512)
    twists = worldsim.synth_twists(len(scans), rng=rng)

    args = (jnp.asarray(world_edges, jnp.float32),
            jnp.ones(len(world_edges), bool),
            jnp.asarray(world_surfs, jnp.float32),
            jnp.ones(len(world_surfs), bool))
    feature_maps = build_feature_maps(*args, faithful)
    geometry_maps = build_geometry_maps(*args, production)

    est_faithful = worldsim.run_drive(feature_maps, faithful, scans,
                                      twists=twists)
    est_production = worldsim.run_drive(geometry_maps, production, scans,
                                        twists=twists)

    ate_faithful = ate_rmse(est_faithful, gt, align=False)
    ate_production = ate_rmse(est_production, gt, align=False)

    # Both must actually track (catches a world/extraction mismatch that
    # would make the ratio vacuous).
    assert ate_faithful < 1.5, ate_faithful
    assert ate_production < 1.5, ate_production
    # The acceptance criterion for every production-path deviation
    # production ATE <= 1.2x faithful ATE. Measured
    # at r3: faithful 0.79 m, production 0.74 m (ratio 0.94) over a
    # 10-scan drive — see BASELINE.md.
    assert ate_production <= 1.2 * ate_faithful + 0.05, (
        ate_production, ate_faithful)
