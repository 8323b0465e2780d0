"""Occupancy (log-odds) integration and occupancy -> ESDF (port of
voxblox_tpu/ops/occupancy.py; reference OccupancyIntegrator,
integrator/occupancy_integrator.h:21-200, and EsdfOccIntegrator,
integrator/esdf_occ_integrator.{h,cc}).

- Per scan every ray marks its traversed voxels free and its endpoint
  voxel occupied (rays past the maximum range clear up to it); a voxel is
  updated at most once per scan and occupied wins over free (h:131-140),
  by two boolean masks over the pool. The log-odds update adds
  logodds(p_hit) or logodds(p_miss), clamped to [logodds(th_min),
  logodds(th_max)] (h:60-76).
- Occupancy -> ESDF: occupied voxels (log-odds > 0) seed distance 0 fixed,
  other observed voxels the default distance, then the shared lower sweep
  (``ops/esdf.lower_sweep``: K1 with ``use_pallas_kernel`` and vps 16,
  else the plain sweep).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import grid
from ..core import layer as vlayer
from ..core.config import EsdfIntegratorConfig, OccupancyIntegratorConfig
from . import raycast
from .esdf import FIX, OBS, lower_sweep
from .tsdf import _DUMPS, _drop_to_dumps, allocate_for_rays, transform_points


def _log_odds(p: float) -> float:
    return float(np.log(p / (1 - p)))


def _marks(n: int, idx, ok):
    """bool[n]: the cells ``idx`` where ``ok`` (dropped lanes on dumps)."""
    out = torch.zeros(n + _DUMPS, dtype=torch.bool, device=idx.device)
    out.index_fill_(0, _drop_to_dumps(idx, ok, n), True)
    return out[:n]


def integrate_pointcloud(layer: vlayer.VoxelLayer, T_G_C, points_C,
                         cfg: OccupancyIntegratorConfig):
    """Integrate one posed scan (points_C f32[N,3], sensor frame) into an
    occupancy layer in place. Returns (layer, overflowed)."""
    dev = layer.device
    if isinstance(T_G_C, tuple):
        T_G_C = tuple(torch.as_tensor(x, dtype=torch.float32, device=dev)
                      for x in T_G_C)
    else:
        T_G_C = torch.as_tensor(T_G_C, dtype=torch.float32, device=dev)
    points_G, origin = transform_points(T_G_C, points_C)
    norm = torch.linalg.vector_norm(points_C, dim=-1)
    finite = torch.isfinite(points_C).all(-1)
    valid = finite & (norm >= cfg.min_ray_length_m)
    clearing = valid & (norm > cfg.max_ray_length_m)
    delta = points_G - origin
    unit = delta / torch.clamp(
        torch.linalg.vector_norm(delta, dim=-1, keepdim=True),
        min=grid.FLOAT_EPS)
    end_G = torch.where(
        clearing[:, None],
        raycast.fma(unit, torch.full_like(unit, cfg.max_ray_length_m),
                    origin.expand_as(unit)),
        points_G)
    inv = 1.0 / layer.voxel_size
    start_scaled = origin.expand(end_G.shape) * inv
    end_scaled = end_G * inv
    num_steps = (grid.scaled_point_to_grid_index(end_scaled)
                 - grid.scaled_point_to_grid_index(start_scaled)
                 ).abs().sum(-1).to(torch.int32)
    setup = raycast.RaySetup(start_scaled, end_scaled, num_steps)
    max_steps = cfg.max_steps or raycast.max_steps_hint(
        cfg.max_ray_length_m, 0.0, layer.voxel_size, True)
    layer, overflowed = allocate_for_rays(layer, setup, valid, max_steps)

    voxels, mask = raycast.cast_rays(setup, max_steps, valid)
    step_idx = torch.arange(max_steps, dtype=torch.int32, device=dev)[:, None]
    is_last = step_idx == num_steps[None, :]
    # Rays of <= 2 voxels do not update (occupancy_integrator.h:119-121).
    long_enough = (num_steps + 1 > 2)[None, :]
    occupied_mark = mask & is_last & ~clearing[None, :] & long_enough
    free_mark = mask & ~occupied_mark & long_enough

    vpb = layer.voxels_per_block
    n_flat = layer.max_blocks * vpb
    flat, found = vlayer.global_voxel_to_flat(layer, voxels)
    occ_mask = _marks(n_flat, flat, occupied_mark & found)
    free_mask = _marks(n_flat, flat, free_mark & found) & ~occ_mask

    lo = layer.channels["log_odds"].view(-1)
    obs = layer.channels["occ_observed"].view(-1)
    update = torch.where(occ_mask, _log_odds(cfg.probability_hit),
                         torch.where(free_mask,
                                     _log_odds(cfg.probability_miss), 0.0))
    touched = occ_mask | free_mask
    # The reference skips updates already saturated in the update
    # direction (h:64-71), which the clamp equals.
    new_lo = torch.clamp(lo + update, _log_odds(cfg.threshold_min),
                         _log_odds(cfg.threshold_max))
    lo.copy_(torch.where(touched, new_lo, lo))
    obs.copy_(torch.where(touched, 1, obs).to(torch.uint8))

    # Every touched block becomes exactly ACTIVE | DIRTY_ALL.
    touched_rows = (occupied_mark | free_mark) & found
    rows = torch.where(touched_rows, flat // vpb, 0)
    flags = torch.cat([layer.block_flags,
                       layer.block_flags.new_zeros(_DUMPS)])
    flags.index_fill_(0, _drop_to_dumps(rows, touched_rows, layer.max_blocks),
                      vlayer.ACTIVE | vlayer.DIRTY_ALL)
    layer.block_flags.copy_(flags[:layer.max_blocks])
    return layer, overflowed


def esdf_from_occupancy_batch(esdf_layer: vlayer.VoxelLayer,
                              occ_layer: vlayer.VoxelLayer,
                              cfg: EsdfIntegratorConfig,
                              relax_impl: str = "kernel"):
    """Batch ESDF from an occupancy layer (esdf_occ_integrator.cc:19-120),
    in place: occupied -> 0 fixed, observed free -> +default, then the
    lower sweep (``relax_impl`` as in ``ops/esdf``). Returns (esdf_layer,
    overflow, iters)."""
    for c in esdf_layer.channels.values():
        c.zero_()
    esdf_layer, overflow = vlayer.allocate_blocks(
        esdf_layer, occ_layer.block_ijk, occ_layer.active_mask())
    occ_slot = vlayer.lookup_blocks(occ_layer, esdf_layer.block_ijk)
    sel = esdf_layer.active_mask() & (occ_slot >= 0)
    safe = torch.where(sel, occ_slot, 0).to(torch.int64)
    lo = occ_layer.channels["log_odds"][safe]
    obs = (occ_layer.channels["occ_observed"][safe] != 0) & sel[:, None]
    occupied = obs & (lo > 0.0)
    d = torch.where(occupied, 0.0, cfg.default_distance_m)
    esdf_layer.channels["esdf"].copy_(torch.where(obs, d, 0.0))
    esdf_layer.channels["esdf_flags"].copy_(
        torch.where(obs, torch.where(occupied, OBS | FIX, OBS), 0).to(
            torch.uint8))
    esdf_layer, iters, region_ovf, _ = lower_sweep(esdf_layer, cfg,
                                                   relax_impl=relax_impl)
    return esdf_layer, overflow | region_ovf, iters


def occupancy_probability(layer: vlayer.VoxelLayer):
    """Per-voxel occupancy probability [max_blocks, vpb] (flat order)."""
    return grid.probability_from_log_odds(layer.channels["log_odds"])
