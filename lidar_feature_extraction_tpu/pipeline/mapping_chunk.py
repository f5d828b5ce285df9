"""Chunked mapping front-end: a BLOCK of scans per device dispatch.

The per-scan mapping loop (pipeline/slam.py process_scan) makes
several device dispatches per scan — extraction, the odometry
registration, occasional fallbacks — with host Python between them.
Where a dispatch costs far more than the work it carries, that
host-device ping-pong, not compute, bounds full-mapping throughput.
This module moves the steady-state inner loop
into ONE jitted ``lax.scan`` over a scan block:

    raycast block [B, rings, pts] -> (extract -> constant-velocity
    prior -> incremental moment-grid registration -> window insert) x B

returning per-scan poses, Hessians, fitness statistics, and compacted
features. The host then replays its cheap bookkeeping (keyframe
gating, loop closure, graph optimization — pipeline/slam.py
``ingest_odometry_result``) over the returned block. Loop closures
and back-end solves still dispatch individually, but they are
per-keyframe-event, not per-scan.

Fallback contract: the in-graph path always applies the
constant-velocity prior (the production fast path). The host checks
each returned scan's fitness (same gate as Odometry
``_registration_suspect``); if any scan in a block is suspect, the
whole block is REPLAYED scan-by-scan through the host ``Odometry``
facade (which owns the re-seed ladder) from the pre-block state — the
block carry is a plain array pytree, so the snapshot costs one
reference. Suspects are rare in steady tracking, so the amortized cost
stays one dispatch per block.

No reference counterpart at any granularity: the reference's mapping
node processes one cloud per ROS callback (``mapping/src/
mapping.cpp:84-103``).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from lidar_feature_extraction_tpu.config import PipelineConfig
from lidar_feature_extraction_tpu.core.pose import Pose
from lidar_feature_extraction_tpu.core.scan import RangeImage
from lidar_feature_extraction_tpu.ops import gauss_newton as gn
from lidar_feature_extraction_tpu.ops.extraction import extract_features
from lidar_feature_extraction_tpu.pipeline.odometry import (
    GeometryOdometryState, geometry_odometry_step, init_geometry_odometry)
from lidar_feature_extraction_tpu.pipeline.slam import MappingPipeline


class ChunkCarry(NamedTuple):
    """Device-resident state threaded between scan blocks."""

    odo: GeometryOdometryState
    prev_q: jnp.ndarray   # pose BEFORE the latest update (CV prior)
    prev_t: jnp.ndarray


class ChunkOutputs(NamedTuple):
    """Per-scan results of one block ([B, ...] leading axis)."""

    pose_q: jnp.ndarray       # [B, 4]
    pose_t: jnp.ndarray       # [B, 3]
    status: jnp.ndarray       # [B]
    hessian: jnp.ndarray      # [B, 6, 6]
    block_errors: jnp.ndarray  # [B, n_blocks]
    edge_pts: jnp.ndarray     # [B, E, 3] sensor frame
    edge_valid: jnp.ndarray   # [B, E]
    surf_pts: jnp.ndarray     # [B, S, 3]
    surf_valid: jnp.ndarray   # [B, S]


def init_chunk_carry(cfg: PipelineConfig) -> ChunkCarry:
    odo = init_geometry_odometry(cfg)
    return ChunkCarry(odo=odo, prev_q=odo.pose_q, prev_t=odo.pose_t)


@partial(jax.jit, static_argnames=("cfg",))
def mapping_chunk_step(carry: ChunkCarry, images: RangeImage,
                       cfg: PipelineConfig):
    """Run extraction + CV-prior odometry for a whole [B, ...] block of
    range images in one compiled program."""

    def body(c, im):
        odo, prev_q, prev_t = c
        feats = extract_features(im, cfg.extraction)
        # Constant-velocity prior: compose the previous inter-scan
        # delta onto the current pose (pipeline/odometry.py update).
        # First scans: prev == cur at init, so the prior degrades to
        # constant-position exactly like the host path.
        cur = Pose(odo.pose_q, odo.pose_t)
        delta = Pose(prev_q, prev_t).inverse().compose(cur)
        prior = cur.compose(delta)
        odo2, result = geometry_odometry_step(
            odo, feats.edge_xyz, feats.edge_valid,
            feats.surface_xyz, feats.surface_valid, cfg,
            prior_q=prior.q, prior_t=prior.t)
        out = ChunkOutputs(
            pose_q=odo2.pose_q, pose_t=odo2.pose_t,
            status=result.status, hessian=result.hessian,
            block_errors=result.block_errors,
            edge_pts=feats.edge_xyz, edge_valid=feats.edge_valid,
            surf_pts=feats.surface_xyz, surf_valid=feats.surface_valid)
        return (odo2, odo.pose_q, odo.pose_t), out

    (odo2, pq, pt), outs = jax.lax.scan(
        body, (carry.odo, carry.prev_q, carry.prev_t), images)
    return ChunkCarry(odo=odo2, prev_q=pq, prev_t=pt), outs


class ChunkedMappingPipeline(MappingPipeline):
    """MappingPipeline whose front end consumes raycast blocks.

    ``process_block(images, stamps)`` registers B scans in one
    dispatch, then runs the standard keyframe / loop-closure /
    back-end bookkeeping on the host. The ``odometry`` facade is kept
    in sync so a suspect block can be replayed through the host
    re-seed ladder, and so checkpointing keeps working.
    """

    def __init__(self, cfg: PipelineConfig, **kwargs):
        super().__init__(cfg, **kwargs)
        self._carry = init_chunk_carry(cfg)

    def process_block(self, images: RangeImage, stamps) -> None:
        """images: RangeImage pytree with a [B, ...] leading axis;
        stamps: length-B sequence of scan timestamps."""
        b = len(stamps)
        carry0 = self._carry
        carry1, outs = mapping_chunk_step(carry0, images, self.cfg)

        status = np.asarray(outs.status)
        block_errors = np.asarray(outs.block_errors)
        if self._block_suspect(status, block_errors):
            # Rare path: re-drive the block scan-by-scan through the
            # host facade (re-seed ladder) from the pre-block state.
            self.odometry.state = carry0.odo
            self.odometry._last_pose = Pose(carry0.prev_q, carry0.prev_t)
            for s in range(b):
                im = jax.tree.map(lambda x: x[s], images)
                feats = self._extract(im)
                self.process_scan(feats.edge_xyz, feats.edge_valid,
                                  feats.surface_xyz, feats.surface_valid,
                                  stamp=float(stamps[s]))
            self._carry = ChunkCarry(
                odo=self.odometry.state,
                prev_q=(self.odometry._last_pose.q
                        if self.odometry._last_pose is not None
                        else self.odometry.state.pose_q),
                prev_t=(self.odometry._last_pose.t
                        if self.odometry._last_pose is not None
                        else self.odometry.state.pose_t))
            return

        self._carry = carry1
        # Keep the facade consistent for checkpoint/resume and any
        # later fallback replay.
        self.odometry.state = carry1.odo
        self.odometry._last_pose = Pose(carry1.prev_q, carry1.prev_t)
        for s in range(b):
            self.ingest_odometry_result(
                outs.edge_pts[s], outs.edge_valid[s],
                outs.surf_pts[s], outs.surf_valid[s],
                Pose(outs.pose_q[s], outs.pose_t[s]),
                hessian=outs.hessian[s], stamp=float(stamps[s]))

    def _block_suspect(self, status: np.ndarray,
                       block_errors: np.ndarray) -> bool:
        """Same gate as Odometry._registration_suspect, vectorized.
        The first scan of a run reports EMPTY_INPUT (no window yet);
        it is exempt exactly like the host path's n_scans > 1 check."""
        first_exempt = 1 if len(self.keyframes) == 0 else 0
        bad_status = np.isin(status[first_exempt:],
                             (gn.EMPTY_INPUT, gn.MAX_ITERATIONS))
        if bad_status.any():
            return True
        gate = self.odometry.edge_gate_distance
        if gate is None:
            return False
        edge_med = np.sqrt(np.maximum(
            block_errors[first_exempt:, 0], 0.0)) / 2.0
        return bool((np.isfinite(edge_med) & (edge_med > gate)).any())

    def _extract(self, image: RangeImage):
        import functools

        if not hasattr(self, "_extract_jit"):
            self._extract_jit = jax.jit(functools.partial(
                extract_features, cfg=self.cfg.extraction))
        return self._extract_jit(image)
