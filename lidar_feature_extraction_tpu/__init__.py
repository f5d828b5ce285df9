"""Accelerator-native LiDAR feature-based SLAM engine.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of
tier4/lidar_feature_extraction (LOAM-style feature extraction, scan-to-map
Gauss-Newton registration, time-delay EKF fusion, map building), built
Fixed-shape range-image tensors, batched kernels, voxel-hash
correspondence search instead of KD-trees, and pjit/shard_map scale-out.
"""

__version__ = "0.1.0"

from lidar_feature_extraction_tpu.config import (  # noqa: F401
    ExtractionConfig,
    RegistrationConfig,
    EkfConfig,
    MappingConfig,
    PipelineConfig,
)
