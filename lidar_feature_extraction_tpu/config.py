"""Configuration tree for the LiDAR SLAM engine.

One frozen-dataclass tree replaces the reference's scattered ROS parameter
structs and hardcoded constants:

- extraction params: reference ``extraction/include/lidar_feature_extraction/
  hyper_parameter.hpp:32-67`` (9 params, defaults identical);
- registration params: reference hardcodes ``N_NEIGHBORS=15``
  (``localization/include/lidar_feature_localization/localizer.hpp:46``),
  ``max_iter=40`` (``localization/app/localization.cpp:54``), surface
  downsample leaf 1.0 m (``surface.hpp:111``), Huber k=1.345
  (``robust.hpp``), degeneracy threshold 0.1 (``degenerate.hpp``) — all
  lifted into config here;
- EKF params: reference ``ekf_localizer/include/ekf_localizer/
  ekf_localizer.hpp:141-171`` (11 params);
- mapping params: keyframe thresholds 1.0 m / 0.1 rad
  (``mapping/include/lidar_feature_mapping/map.hpp:89-90``), recent-scans
  window 7 (``localization/app/odometry.cpp:50``).

Fields that have no reference counterpart (capacities, voxel sizes, NMS
iteration caps) exist because every device tensor is fixed-shape: dynamic
C++ vectors become statically-sized masked arrays.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ExtractionConfig:
    """Feature-extraction hyperparameters.

    Mirrors ``hyper_parameter.hpp:32-67``; shape fields are additions.
    """

    padding: int = 5
    neighbor_degree_threshold: float = 2.0
    distance_diff_threshold: float = 0.3
    parallel_beam_min_range_ratio: float = 0.02
    edge_threshold: float = 0.05
    surface_threshold: float = 0.05
    min_range: float = 0.1
    max_range: float = 100.0
    n_blocks: int = 6

    # --- Shape parameters (no reference counterpart) ---
    # Range image: [n_rings, max_points_per_ring]; rings with fewer than
    # padding+1 valid points are dropped (RemoveSparseRings, ring.cpp:46).
    n_rings: int = 64
    max_points_per_ring: int = 2048
    # Round bound of the multi-select parallel NMS that replaces the
    # reference's sequential argsort+suppress labeling (label.hpp:
    # 61-139). Every round selects ALL locally-best candidates at once;
    # typical scans resolve in a handful of rounds, and a cap of at
    # least the largest block size guarantees exact sequential
    # equivalence even for adversarial monotone chains.
    nms_rounds: int = 64
    # Fixed capacities for the compacted feature outputs.
    max_edges: int = 4096
    max_surfaces: int = 8192
    # Per-ring capacities for the single-matmul compaction path
    # (ops/extraction.py extract_features_compact): edges keep their
    # per-ring azimuth rank; surfaces come out as voxel-run centroids,
    # stratified by azimuth when a ring overflows the cap.
    edges_per_ring: int = 32
    surface_runs_per_ring: int = 64
    # Represent each surface voxel run by its centroid (PCL-style mean,
    # paid for with a cumsum + segmented scan) instead of the default
    # run-end measured point (free).
    compact_surface_centroid: bool = False

    @property
    def radian_threshold(self) -> float:
        import math

        return math.radians(self.neighbor_degree_threshold)


@dataclasses.dataclass(frozen=True)
class VoxelMapConfig:
    """Device-resident voxel-hash feature map (replaces nanoflann KD-tree).

    The reference builds a KD-tree over the feature map
    (``localization/include/lidar_feature_localization/kdtree.hpp:56``) and
    does exact k-NN. Here we hash map points into an open-addressed voxel
    table and gather candidates from the 3x3x3 neighborhood of the query
    voxel; ATE parity (not neighbor parity) is the acceptance criterion.
    """

    voxel_size: float = 1.0
    table_capacity: int = 1 << 18  # number of voxel buckets
    points_per_voxel: int = 8      # slots per bucket
    max_probes: int = 16           # linear probing bound


@dataclasses.dataclass(frozen=True)
class RegistrationConfig:
    """Gauss-Newton scan registration parameters."""

    n_neighbors: int = 15            # localizer.hpp:46
    # Minimum neighborhood size for a line/plane fit to count as a
    # correspondence (masked kNN / geometry-grid validity gate; the
    # reference has no explicit gate — a starved KD-tree query simply
    # returns duplicated far points).
    min_fit_points: int = 5
    max_iterations: int = 40         # localization.cpp:54 (Optimizer default 20)
    convergence_tol: float = 1e-3    # optimizer.cpp:35-38
    huber_k: float = 1.345           # robust.hpp
    degeneracy_threshold: float = 0.1  # degenerate.hpp / optimizer.cpp:67
    surface_downsample_leaf: float = 1.0  # surface.hpp:111
    # Deviation from the reference's per-iteration KD-tree search:
    # the 27-voxel candidate sets are gathered once per search round and
    # the Gauss-Newton inner iterations only re-rank them (valid while
    # the pose correction stays below a voxel size). n_search_rounds
    # splits max_iterations into that many gather+optimize rounds.
    n_search_rounds: int = 2
    # Refit the line/plane geometry (neighbor top-k + PCA / plane fit)
    # every inner GN iteration instead of once per search round. The
    # fitted geometry depends only on the selected map neighbors, which
    # can change inside a round only while the pose correction stays
    # within the cached candidate neighborhood — refitting there buys
    # sub-voxel neighbor churn at ~10x the per-iteration cost. Default
    # off; ATE parity is the acceptance criterion (docs/design.md §3).
    refit_per_iteration: bool = False
    # Dense-grid cell counts for the scan-to-scan odometry window (the
    # grid is re-centered on the current pose every step; extent in
    # meters = dims * voxel_size of the respective map config).
    odometry_grid_dims: Tuple[int, int, int] = (128, 128, 32)
    edge_map: VoxelMapConfig = dataclasses.field(
        default_factory=lambda: VoxelMapConfig(voxel_size=1.0))
    surface_map: VoxelMapConfig = dataclasses.field(
        default_factory=lambda: VoxelMapConfig(voxel_size=2.0))
    # Fixed shapes for the masked correspondence tensors.
    max_edge_points: int = 4096
    max_surface_points: int = 4096


@dataclasses.dataclass(frozen=True)
class EkfConfig:
    """2D-dynamics time-delay EKF parameters (ekf_localizer.hpp:141-171)."""

    predict_frequency: float = 50.0
    extend_state_step: int = 50      # max delay steps of the augmented state
    pose_smoothing_steps: int = 5
    pose_gate_dist: float = 10000.0
    twist_gate_dist: float = 10000.0
    twist_smoothing_steps: int = 2
    proc_stddev_yaw_c: float = 0.005
    enable_yaw_bias_estimation: bool = True
    proc_stddev_yaw_bias_c: float = 0.001
    proc_stddev_vx_c: float = 5.0
    proc_stddev_wz_c: float = 1.0


@dataclasses.dataclass(frozen=True)
class MappingConfig:
    """Keyframe map-building parameters (map.hpp:89-90, odometry.cpp:50)."""

    keyframe_translation_threshold: float = 1.0
    keyframe_rotation_threshold: float = 0.1
    recent_scans_window: int = 7
    max_keyframes: int = 512
    max_map_points: int = 1 << 21


@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    """Device-mesh layout for multi-chip execution (no reference
    counterpart — the reference is single-host CPU, SURVEY.md §2.8)."""

    data_axis: str = "data"       # scans / keyframes sharded over this axis
    model_axis: str = "model"     # residual blocks within one problem
    mesh_shape: Tuple[int, ...] = (1,)


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    # Use the single-matmul compaction extraction path
    # (extract_features_compact): feature compaction AND the surface
    # registration downsample (surface.hpp:111) are fused into dense
    # per-ring algebra + one one-hot matmul — the surface features come
    # out already voxel-thinned at registration's downsample leaf.
    # Only affects the GeometryMaps registration path.
    compact_extraction: bool = False
    extraction: ExtractionConfig = dataclasses.field(
        default_factory=ExtractionConfig)
    registration: RegistrationConfig = dataclasses.field(
        default_factory=RegistrationConfig)
    ekf: EkfConfig = dataclasses.field(default_factory=EkfConfig)
    mapping: MappingConfig = dataclasses.field(default_factory=MappingConfig)
    parallel: ParallelConfig = dataclasses.field(default_factory=ParallelConfig)


def kitti_hdl64() -> PipelineConfig:
    """Config preset for KITTI HDL-64E scans with the reference's
    production extraction parameters (``lidar_feature_launch/config/
    lidar_feature_extraction.param.yaml``: padding=2, neighbor 3 deg,
    edge_threshold=50, max_range=1000; surface_threshold keeps the code
    default 0.05)."""
    return PipelineConfig(
        compact_extraction=True,
        extraction=ExtractionConfig(
            n_rings=64, max_points_per_ring=2304,
            padding=2, neighbor_degree_threshold=3.0,
            edge_threshold=50.0, max_range=1000.0,
            # Multi-select NMS resolves typical scans in < 10 rounds;
            # 48 covers deep suppression chains. Raw surface output on
            # open roads exceeds 30k points before the 1 m registration
            # downsample (padding=2 suppresses only +/-2 per pick).
            nms_rounds=48,
            # Edge counts at edge_threshold=50 are a few hundred to ~2k
            # per scan; 2048 halves the candidate-gather cost vs 4096.
            max_edges=2048, max_surfaces=32768,
            # A ground ring at range r has ~2*pi*r one-meter voxel runs
            # (>400 at HDL-64E ranges): the old cap of 64 silently
            # dropped most surface constraints and measurably hurt
            # closed-loop ATE (r3 bisect: 0.44 m vs 0.037 m on the
            # worldsim drive). 128 columns/ring keeps stratified
            # angular coverage at KITTI ranges.
            surface_runs_per_ring=128))


def vlp16() -> PipelineConfig:
    """Config preset for Velodyne VLP-16 scans."""
    return PipelineConfig(
        extraction=ExtractionConfig(n_rings=16, max_points_per_ring=1856))
