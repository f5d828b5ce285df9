"""Scan-to-map localization: the equivalent of the reference's
``Localizer`` facade + ``LOAMOptimizationProblem``
(``localization/include/lidar_feature_localization/localizer.hpp:50-98``,
``loam_optimization_problem.hpp:51-88``).

One jitted step fuses the per-scan hot path of SURVEY.md §3.1:
range-image organization -> feature extraction -> Gauss-Newton with
voxel-grid correspondence search -> pose. The feature maps live on
device as dense direct-addressed voxel grids (ops/voxel_grid.py; the
voxel-hash table remains available for unbounded worlds).

Correspondence strategy (measured-driven deviation from the reference):
the reference re-searches the KD-tree every GN iteration
(optimizer.hpp:85-86). The candidate gather dominates that cost, so
registration runs ``n_search_rounds`` outer rounds — each gathers
the 27-voxel candidate sets once at the current pose, then the GN inner
loop re-ranks cached candidates per iteration. Equivalent while pose
corrections stay below one voxel; acceptance is ATE parity.
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
from lidar_feature_extraction_tpu.ops.downsample import voxel_downsample
from lidar_feature_extraction_tpu.ops.extraction import (
    extract_features, extract_features_compact)
from lidar_feature_extraction_tpu.ops.residuals import (
    edge_residuals_from_candidates, surface_residuals_from_candidates,
    fit_edge_geometry, fit_surface_geometry,
    edge_rows_from_geometry, surface_rows_from_geometry)
from lidar_feature_extraction_tpu.ops import geometry_grid as gg
from lidar_feature_extraction_tpu.ops import voxel_grid as vg


class FeatureMaps(NamedTuple):
    edge: vg.DenseVoxelGrid
    surface: vg.DenseVoxelGrid


class GeometryMaps(NamedTuple):
    """Precomputed-geometry feature maps (ops/geometry_grid.py): the
    per-voxel line/plane fits are baked at build time, so registration
    re-searches every Gauss-Newton iteration with one 8-float gather
    per point — the reference's per-iteration KD-tree search pattern
    (optimizer.hpp:85-86) at one gather per point.

    ``fused`` is the concatenated edge+surface record table
    (gg.fuse_record_tables) so each GN iteration needs a single gather
    launch; None falls back to two per-grid gathers."""

    edge: gg.GeometryGrid
    surface: gg.GeometryGrid
    fused: jnp.ndarray = None


def build_feature_maps(edge_xyz, edge_mask, surface_xyz, surface_mask,
                       cfg: PipelineConfig) -> FeatureMaps:
    """Hash the pre-built feature map clouds into device voxel grids.

    Replaces the KD-tree construction at localizer startup
    (``localization/app/localization.cpp:79-83`` loads maps/edge.pcd +
    maps/surface.pcd). Grid bounds are computed host-side from the map
    AABB (dims are static -> one compile per map load).
    """
    em = cfg.registration.edge_map
    sm = cfg.registration.surface_map

    def bounds(xyz, mask):
        pts = np.asarray(xyz)[np.asarray(mask)]
        if len(pts) == 0:
            return np.zeros(3, np.float32), np.ones(3, np.float32)
        return pts.min(axis=0), pts.max(axis=0)

    e_lo, e_hi = bounds(edge_xyz, edge_mask)
    s_lo, s_hi = bounds(surface_xyz, surface_mask)
    e_origin, e_dims = vg.grid_for_bounds(e_lo, e_hi, em.voxel_size)
    s_origin, s_dims = vg.grid_for_bounds(s_lo, s_hi, sm.voxel_size)

    return FeatureMaps(
        edge=vg.build_voxel_grid(edge_xyz, edge_mask, em.voxel_size,
                                 e_origin, e_dims, em.points_per_voxel),
        surface=vg.build_voxel_grid(surface_xyz, surface_mask,
                                    sm.voxel_size, s_origin, s_dims,
                                    sm.points_per_voxel),
    )


def build_geometry_maps(edge_xyz, edge_mask, surface_xyz, surface_mask,
                        cfg: PipelineConfig) -> GeometryMaps:
    """Bake per-voxel line/plane geometry from the feature map clouds.

    Same role as ``build_feature_maps`` (KD-tree construction at
    localizer startup, ``localization/app/localization.cpp:79-83``) but
    the neighborhood fits of ``Edge::Make`` / ``Surface::Make`` are
    done here, once, for every map voxel."""
    em = cfg.registration.edge_map
    sm = cfg.registration.surface_map

    def bounds(xyz, mask):
        pts = np.asarray(xyz)[np.asarray(mask)]
        if len(pts) == 0:
            return np.zeros(3, np.float32), np.ones(3, np.float32)
        return pts.min(axis=0), pts.max(axis=0)

    e_lo, e_hi = bounds(edge_xyz, edge_mask)
    s_lo, s_hi = bounds(surface_xyz, surface_mask)
    e_origin, e_dims = vg.grid_for_bounds(e_lo, e_hi, em.voxel_size)
    s_origin, s_dims = vg.grid_for_bounds(s_lo, s_hi, sm.voxel_size)

    edge = gg.build_edge_geometry_grid(edge_xyz, edge_mask,
                                       em.voxel_size, e_origin, e_dims)
    surface = gg.build_surface_geometry_grid(
        surface_xyz, surface_mask, sm.voxel_size, s_origin, s_dims)
    return GeometryMaps(edge=edge, surface=surface,
                        fused=gg.fuse_record_tables(edge, surface))


def register_scan_geometry(maps: GeometryMaps, edge_pts, edge_valid,
                           surf_pts, surf_valid, prior: Pose,
                           cfg: PipelineConfig,
                           pre_downsampled: bool = False) -> gn.GNResult:
    """Gauss-Newton registration against precomputed-geometry maps.

    The per-point correspondence (voxel lookup) is re-done EVERY
    iteration — cheap enough that the reference's per-iteration
    re-search semantics come back for free; no candidate caching, no
    search rounds. ``pre_downsampled`` skips the surface voxel
    downsample (surface.hpp:111) when the extraction path already
    voxel-thinned the surface features (extract_features_compact)."""
    reg = cfg.registration
    if pre_downsampled:
        surf_ds, surf_ds_valid = surf_pts, surf_valid
    else:
        surf_ds, surf_ds_valid = voxel_downsample(
            surf_pts, surf_valid, reg.surface_downsample_leaf,
            reg.max_surface_points)

    def problem_fn(p: Pose) -> gn.Problem:
        if maps.fused is not None:
            eb, sb = gg.fused_rows_from_grids(
                maps.edge, maps.surface, maps.fused, edge_pts, edge_valid,
                surf_ds, surf_ds_valid, p, reg.min_fit_points)
        else:
            eb = gg.edge_rows_from_grid(maps.edge, edge_pts, edge_valid,
                                        p, reg.min_fit_points)
            sb = gg.surface_rows_from_grid(maps.surface, surf_ds,
                                           surf_ds_valid, p,
                                           reg.min_fit_points)
        return gn.make_problem([eb, sb])

    return gn.run_gauss_newton(
        problem_fn, prior,
        max_iterations=reg.max_iterations,
        convergence_tol=reg.convergence_tol,
        huber_k=reg.huber_k,
        degeneracy_threshold=reg.degeneracy_threshold)


def register_scan(maps: FeatureMaps, edge_pts, edge_valid, surf_pts,
                  surf_valid, prior: Pose, cfg: PipelineConfig) -> gn.GNResult:
    """Gauss-Newton registration of extracted features against the maps.

    Equivalent of ``Optimizer::Run`` over ``LOAMOptimizationProblem``.
    The surface scan is voxel-downsampled once (pose-independent; the
    reference recomputes it per iteration inside ``Surface::Make``,
    surface.hpp:106-111 — same result).
    """
    reg = cfg.registration
    surf_ds, surf_ds_valid = voxel_downsample(
        surf_pts, surf_valid, reg.surface_downsample_leaf,
        reg.max_surface_points)

    rounds = max(reg.n_search_rounds, 1)
    iters = -(-reg.max_iterations // rounds)  # ceil split
    # Candidates stay valid while the pose moved less than ~half the
    # smaller map voxel since they were gathered.
    refresh_threshold = 0.5 * min(reg.edge_map.voxel_size,
                                  reg.surface_map.voxel_size)

    def one_round(pose: Pose) -> gn.GNResult:
        cand_e, ok_e = vg.neighborhood_candidates(
            maps.edge, pose.apply(edge_pts))
        cand_s, ok_s = vg.neighborhood_candidates(
            maps.surface, pose.apply(surf_ds))

        if reg.refit_per_iteration:
            def problem_fn(p: Pose) -> gn.Problem:
                eb = edge_residuals_from_candidates(
                    cand_e, ok_e, edge_pts, edge_valid, p, reg.n_neighbors)
                sb = surface_residuals_from_candidates(
                    cand_s, ok_s, surf_ds, surf_ds_valid, p,
                    reg.n_neighbors)
                return gn.make_problem([eb, sb])
        else:
            # Neighbor selection + line/plane fits are pose-independent
            # given the candidate sets: hoist them out of the GN loop so
            # every inner iteration is elementwise rows + two [7, M]
            # matmuls (see RegistrationConfig.refit_per_iteration).
            eg = fit_edge_geometry(cand_e, ok_e, edge_pts, edge_valid,
                                   pose, reg.n_neighbors)
            sg = fit_surface_geometry(cand_s, ok_s, surf_ds,
                                      surf_ds_valid, pose,
                                      reg.n_neighbors)

            def problem_fn(p: Pose) -> gn.Problem:
                eb = edge_rows_from_geometry(eg, edge_pts, p)
                sb = surface_rows_from_geometry(sg, surf_ds, p)
                return gn.make_problem([eb, sb])

        return gn.run_gauss_newton(
            problem_fn, pose,
            max_iterations=iters,
            convergence_tol=reg.convergence_tol,
            huber_k=reg.huber_k,
            degeneracy_threshold=reg.degeneracy_threshold)

    result = one_round(prior)
    prev_pose = prior
    for _ in range(rounds - 1):
        # Later rounds re-gather when the previous round moved the pose
        # out of its candidate neighborhoods — with a good EKF prior the
        # steady state runs a single gather per scan, and lax.cond skips
        # the whole round's work on device. An error/scale-increase
        # abort also triggers a refresh: with per-round frozen geometry
        # those aborts can be artifacts of the frozen problem, and the
        # reference (which refits every iteration) would have continued on
        # the refitted problem.
        moved = jnp.linalg.norm(result.pose.t - prev_pose.t) \
            > refresh_threshold
        aborted = (result.status == gn.ERROR_INCREASED) \
            | (result.status == gn.SCALE_INCREASED)
        rerun = moved | (aborted & ~jnp.asarray(reg.refit_per_iteration))
        prev_pose = result.pose
        result = jax.lax.cond(rerun, one_round, lambda p: result._replace(
            pose=p), result.pose)
    return result


@partial(jax.jit, static_argnames=("cfg",))
def localize_scan(maps: FeatureMaps, image: RangeImage, prior: Pose,
                  cfg: PipelineConfig):
    """Full per-scan hot path: extraction + registration, one jit.

    Returns (GNResult, ExtractionResult) — the pose and the features
    (the reference's node publishes both, subscriber.hpp:128-176 +
    feature_extraction.cpp:168-170).

    Single fused program: right for vmap batching and multi-device
    sharding. ``HostLocalizer`` runs the same math as small programs
    stepped from the host.
    """
    if cfg.compact_extraction and isinstance(maps, GeometryMaps):
        feats = extract_features_compact(
            image, cfg.extraction,
            surface_leaf=cfg.registration.surface_downsample_leaf,
            edges_per_ring=cfg.extraction.edges_per_ring,
            surface_runs_per_ring=cfg.extraction.surface_runs_per_ring,
            surface_centroid=cfg.extraction.compact_surface_centroid)
        result = register_scan_geometry(
            maps, feats.edge_xyz, feats.edge_valid,
            feats.surface_xyz, feats.surface_valid, prior, cfg,
            pre_downsampled=True)
        return result, feats
    feats = extract_features(image, cfg.extraction)
    register = (register_scan_geometry
                if isinstance(maps, GeometryMaps) else register_scan)
    result = register(maps, feats.edge_xyz, feats.edge_valid,
                      feats.surface_xyz, feats.surface_valid,
                      prior, cfg)
    return result, feats


class HostLocalizer:
    """Host-stepped scan-to-map localizer for single-chip serving.

    Identical math to ``localize_scan``, decomposed into small jitted
    programs (extraction / surface downsample / candidate gather / one
    GN iteration) with the reference's loop control
    (``Optimizer::Run`` aborts + convergence, optimizer.hpp:83-121)
    running in Python. Early exit on convergence is free here, unlike
    the fixed-shape while_loop.
    """

    def __init__(self, maps: FeatureMaps, cfg: PipelineConfig):
        self.maps = maps
        self.cfg = cfg
        reg = cfg.registration

        self._compact = (cfg.compact_extraction
                         and isinstance(maps, GeometryMaps))
        if self._compact:
            self._extract = jax.jit(lambda image: extract_features_compact(
                image, cfg.extraction,
                surface_leaf=reg.surface_downsample_leaf,
                edges_per_ring=cfg.extraction.edges_per_ring,
                surface_runs_per_ring=cfg.extraction.surface_runs_per_ring,
                surface_centroid=cfg.extraction.compact_surface_centroid))
        else:
            self._extract = jax.jit(
                lambda image: extract_features(image, cfg.extraction))
        self._downsample = jax.jit(
            lambda pts, valid: voxel_downsample(
                pts, valid, reg.surface_downsample_leaf,
                reg.max_surface_points))

        def gather(maps, e_pts, s_pts, pose):
            pe = pose.apply(e_pts)
            ps = pose.apply(s_pts)
            ce, oe = vg.neighborhood_candidates(maps.edge, pe)
            cs, os_ = vg.neighborhood_candidates(maps.surface, ps)
            return ce, oe, cs, os_

        self._gather = jax.jit(gather)

        def fit(maps, e_pts, e_valid, s_pts, s_valid, pose):
            # Gather + neighbor selection + geometry fits, once per
            # search round (pose-independent inside the round).
            pe = pose.apply(e_pts)
            ps = pose.apply(s_pts)
            ce, oe = vg.neighborhood_candidates(maps.edge, pe)
            cs, os_ = vg.neighborhood_candidates(maps.surface, ps)
            eg = fit_edge_geometry(ce, oe, e_pts, e_valid, pose,
                                   reg.n_neighbors)
            sg = fit_surface_geometry(cs, os_, s_pts, s_valid, pose,
                                      reg.n_neighbors)
            return eg, sg

        self._fit = jax.jit(fit)

        def light_step(eg, sg, e_pts, s_pts, pose):
            eb = edge_rows_from_geometry(eg, e_pts, pose)
            sb = surface_rows_from_geometry(sg, s_pts, pose)
            problem = gn.make_problem([eb, sb])
            return gn.gn_iteration(problem, pose, reg.huber_k,
                                   reg.degeneracy_threshold)

        self._light_step = jax.jit(light_step)

        def step(cand_e, ok_e, cand_s, ok_s, e_pts, e_valid, s_pts,
                 s_valid, pose):
            eb = edge_residuals_from_candidates(
                cand_e, ok_e, e_pts, e_valid, pose, reg.n_neighbors)
            sb = surface_residuals_from_candidates(
                cand_s, ok_s, s_pts, s_valid, pose, reg.n_neighbors)
            problem = gn.make_problem([eb, sb])
            return gn.gn_iteration(problem, pose, reg.huber_k,
                                   reg.degeneracy_threshold)

        self._step = jax.jit(step)

        def geometry_step(maps, e_pts, e_valid, s_pts, s_valid, pose):
            if maps.fused is not None:
                eb, sb = gg.fused_rows_from_grids(
                    maps.edge, maps.surface, maps.fused, e_pts, e_valid,
                    s_pts, s_valid, pose, reg.min_fit_points)
            else:
                eb = gg.edge_rows_from_grid(maps.edge, e_pts, e_valid,
                                            pose, reg.min_fit_points)
                sb = gg.surface_rows_from_grid(maps.surface, s_pts,
                                               s_valid, pose,
                                               reg.min_fit_points)
            problem = gn.make_problem([eb, sb])
            return gn.gn_iteration(problem, pose, reg.huber_k,
                                   reg.degeneracy_threshold)

        self._geometry_step = jax.jit(geometry_step)

    def register(self, edge_pts, edge_valid, surf_pts, surf_valid,
                 prior: Pose) -> gn.GNResult:
        reg = self.cfg.registration
        if isinstance(self.maps, GeometryMaps):
            if self._compact:
                # Compact extraction already voxel-thinned the surfaces.
                surf_ds, surf_ds_valid = surf_pts, surf_valid
            else:
                surf_ds, surf_ds_valid = self._downsample(surf_pts,
                                                          surf_valid)

            def step_fn(p):
                return self._geometry_step(self.maps, edge_pts, edge_valid,
                                           surf_ds, surf_ds_valid, p)

            return gn.run_gauss_newton_host(
                step_fn, prior, reg.max_iterations, reg.convergence_tol)
        surf_ds, surf_ds_valid = self._downsample(surf_pts, surf_valid)
        rounds = max(reg.n_search_rounds, 1)
        iters = -(-reg.max_iterations // rounds)

        refresh_threshold = 0.5 * min(reg.edge_map.voxel_size,
                                      reg.surface_map.voxel_size)
        pose = prior
        result = None
        for _ in range(rounds):
            if reg.refit_per_iteration:
                ce, oe, cs, os_ = self._gather(self.maps, edge_pts,
                                               surf_ds, pose)

                def step_fn(p, ce=ce, oe=oe, cs=cs, os_=os_):
                    return self._step(ce, oe, cs, os_, edge_pts,
                                      edge_valid, surf_ds, surf_ds_valid,
                                      p)
            else:
                eg, sg = self._fit(self.maps, edge_pts, edge_valid,
                                   surf_ds, surf_ds_valid, pose)

                def step_fn(p, eg=eg, sg=sg):
                    return self._light_step(eg, sg, edge_pts, surf_ds, p)

            result = gn.run_gauss_newton_host(
                step_fn, pose, iters, reg.convergence_tol)
            moved = float(jnp.linalg.norm(result.pose.t - pose.t))
            pose = result.pose
            if int(result.status) in (gn.CONVERGED, gn.EMPTY_INPUT):
                break
            aborted = int(result.status) in (gn.ERROR_INCREASED,
                                             gn.SCALE_INCREASED)
            if aborted and not reg.refit_per_iteration:
                continue  # refresh: abort may be a frozen-geometry artifact
            if moved <= refresh_threshold:
                break  # candidates still valid; nothing new to gather
        return result

    def localize(self, image: RangeImage, prior: Pose):
        feats = self._extract(image)
        result = self.register(feats.edge_xyz, feats.edge_valid,
                               feats.surface_xyz, feats.surface_valid,
                               prior)
        return result, feats
