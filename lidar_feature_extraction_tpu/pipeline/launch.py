"""Pipeline assembly — the equivalent of ``lidar_feature_launch``
and ``map_loader`` (SURVEY.md §2.7).

The reference composes its three workloads as ROS 2 launch graphs that
wire nodes through topic remaps and overlay parameter YAML
(``lidar_feature_launch/launch/localization.launch.py:108-185``,
``mapping.launch.py:51-94``, ``odometry.launch.py:52-100``;
``config/lidar_feature_extraction.param.yaml``). Without a process
graph, a "launch" here is a constructor: resolve the config (preset +
file/dict overlays), load the maps (``map_loader/src/map_loader.cpp:44``
+ ``localization/app/localization.cpp:79-83``), and return the
assembled pipeline object.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Mapping, Optional

import numpy as np
import jax.numpy as jnp

from lidar_feature_extraction_tpu import config as config_mod
from lidar_feature_extraction_tpu.config import PipelineConfig
from lidar_feature_extraction_tpu.core.pose import Pose
from lidar_feature_extraction_tpu.io.pcd import load_pcd

PRESETS = {
    "default": PipelineConfig,
    "kitti_hdl64": config_mod.kitti_hdl64,
    "vlp16": config_mod.vlp16,
}


def _replace_nested(obj, overrides: Mapping[str, Any]):
    """dataclasses.replace through nested frozen dataclasses.

    ``{"extraction": {"padding": 2}, "registration": {...}}`` — the
    role of the reference's per-node parameter YAML overlay (a launch
    YAML overrides a subset of each node's declared defaults)."""
    updates = {}
    for key, value in overrides.items():
        if not hasattr(obj, key):
            raise KeyError(f"unknown config field: {key!r} "
                           f"on {type(obj).__name__}")
        current = getattr(obj, key)
        if dataclasses.is_dataclass(current) and isinstance(value, Mapping):
            updates[key] = _replace_nested(current, value)
        else:
            updates[key] = value
    return dataclasses.replace(obj, **updates)


def load_config(preset: str = "default",
                overrides: Optional[Mapping[str, Any]] = None,
                params_file: Optional[str] = None) -> PipelineConfig:
    """Resolve a PipelineConfig: preset -> params file -> dict overrides.

    ``params_file`` accepts JSON always and YAML when pyyaml is
    importable (the reference's param files are YAML; this image has no
    hard yaml dependency)."""
    if preset not in PRESETS:
        raise KeyError(f"unknown preset {preset!r}; "
                       f"have {sorted(PRESETS)}")
    cfg = PRESETS[preset]()
    if params_file is not None:
        with open(params_file) as f:
            text = f.read()
        try:
            data = json.loads(text)
        except json.JSONDecodeError:
            try:
                import yaml
            except ImportError as e:
                raise ValueError(
                    f"{params_file} is not JSON and pyyaml is "
                    "unavailable") from e
            data = yaml.safe_load(text)
        cfg = _replace_nested(cfg, data)
    if overrides:
        cfg = _replace_nested(cfg, overrides)
    return cfg


def load_maps(edge_pcd: str, surface_pcd: str, cfg: PipelineConfig,
              geometry: bool = True):
    """Load edge/surface feature maps from PCD files into device grids.

    The reference's localizer startup (``localization/app/
    localization.cpp:79-83`` loading maps/edge.pcd + maps/surface.pcd,
    via ``map_loader/src/map_loader.cpp:44``). ``geometry=True`` bakes
    per-voxel line/plane fits (GeometryMaps, the fast path);
    ``geometry=False`` keeps raw point grids (FeatureMaps)."""
    from lidar_feature_extraction_tpu.pipeline.localization import (
        build_feature_maps, build_geometry_maps)

    edge = np.asarray(load_pcd(edge_pcd), np.float32)
    surf = np.asarray(load_pcd(surface_pcd), np.float32)
    build = build_geometry_maps if geometry else build_feature_maps
    return build(jnp.asarray(edge), jnp.ones(len(edge), bool),
                 jnp.asarray(surf), jnp.ones(len(surf), bool), cfg)


def launch_localization(edge_pcd: str, surface_pcd: str,
                        cfg: Optional[PipelineConfig] = None,
                        initial_pose: Optional[Pose] = None,
                        geometry: bool = True):
    """Assemble the localization workload: maps + extraction +
    registration + EKF feedback loop (``localization.launch.py:108-185``
    graph: converter -> extraction -> localization <-> ekf)."""
    from lidar_feature_extraction_tpu.pipeline.replay import (
        FusedLocalizationPipeline)

    cfg = cfg or PipelineConfig()
    maps = load_maps(edge_pcd, surface_pcd, cfg, geometry=geometry)
    return FusedLocalizationPipeline(maps, cfg, initial_pose=initial_pose)


def launch_mapping(cfg: Optional[PipelineConfig] = None, **kwargs):
    """Assemble the mapping workload (``mapping.launch.py:51-94``):
    odometry front-end + keyframe store + pose graph + map assembly."""
    from lidar_feature_extraction_tpu.pipeline.slam import MappingPipeline

    return MappingPipeline(cfg or PipelineConfig(), **kwargs)


def launch_odometry(cfg: Optional[PipelineConfig] = None):
    """Assemble scan-to-scan odometry (``odometry.launch.py:52-100``;
    the reference ships the library but never builds the binary,
    ``localization/CMakeLists.txt:33``)."""
    from lidar_feature_extraction_tpu.pipeline.odometry import Odometry

    return Odometry(cfg or PipelineConfig())
