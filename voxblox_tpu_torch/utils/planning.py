"""Planning utilities (port of voxblox_tpu/utils/planning.py; reference
utils/planning_utils and EsdfIntegrator::addNewRobotPosition,
esdf_integrator.cc:20-92):

- ``sphere_voxel_mask``: per-pool-voxel mask of a world-space sphere;
- ``fill_sphere`` / ``clear_sphere``: hallucinated occupied / free voxel
  edits after allocating the sphere's blocks;
- ``add_new_robot_position``: unknown voxels in the clear sphere become
  free, unknown voxels in the occupied sphere around it occupied, both
  hallucinated; touched blocks are marked dirty for the next sweep;
- ``map_bounds``: the block-granular map extent.

Positions may be device tensors: the candidate blocks are built on the
device, so nothing but the allocation's own loop reads the card.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _runtime
from ..core import grid
from ..core import layer as vlayer
from ..core.config import EsdfIntegratorConfig

OBS = vlayer.ESDF_OBSERVED
FIX = vlayer.ESDF_FIXED
HALL = vlayer.ESDF_HALLUCINATED


def _center(layer, center):
    return torch.as_tensor(center, dtype=torch.float32, device=layer.device)


def _allocate_sphere(layer, center, radius: float):
    """Allocate every block whose nearest point to ``center`` lies within
    ``radius``; returns (layer, overflowed)."""
    bs = layer.block_size
    r = int(np.ceil(radius / bs)) + 1
    offs = np.stack(np.meshgrid(*([np.arange(-r, r + 1)] * 3),
                                indexing="ij"), -1).reshape(-1, 3)
    c = _center(layer, center)
    center_block = torch.floor(c / bs).to(torch.int32)
    cand = center_block[None] + _runtime.const(offs, torch.int32, c.device)
    lo = cand.to(torch.float32) * bs
    nearest = torch.clamp(c, lo, lo + bs)
    keep = torch.linalg.vector_norm(nearest - c, dim=-1) <= radius
    return vlayer.allocate_blocks(layer, cand, keep)


def sphere_voxel_mask(layer, center, radius: float):
    """bool[max_blocks, vpb] (linear voxel order): voxel centre in the
    sphere, on active blocks."""
    v = layer.vps
    lin = torch.arange(layer.voxels_per_block, device=layer.device)
    local = grid.linear_to_local(lin, v)
    centers = (layer.block_ijk[:, None, :] * v + local[None]).to(
        torch.float32)
    centers = (centers + 0.5) * layer.voxel_size
    dist = torch.linalg.vector_norm(centers - _center(layer, center), dim=-1)
    return (dist <= radius) & layer.active_mask()[:, None]


def _rows(layer):
    return torch.arange(layer.max_blocks, dtype=torch.int32,
                        device=layer.device)


def _set_sphere(layer, center, radius, distance, flags):
    layer, overflow = _allocate_sphere(layer, center, radius)
    m = sphere_voxel_mask(layer, center, radius)
    ch = layer.channels
    ch["esdf"] = torch.where(m, distance, ch["esdf"])
    ch["esdf_flags"] = torch.where(m, flags, ch["esdf_flags"]).to(torch.uint8)
    return (vlayer.mark_dirty(layer, _rows(layer), m.any(1), vlayer.DIRTY_ALL),
            overflow)


def fill_sphere(layer, center, radius: float, max_distance_m: float):
    """Mark a sphere occupied: distance -max_distance_m, observed,
    hallucinated and fixed (fillSphereAroundPoint)."""
    return _set_sphere(layer, center, radius, -abs(max_distance_m),
                       OBS | HALL | FIX)


def clear_sphere(layer, center, radius: float, max_distance_m: float):
    """Mark a sphere free: distance +max_distance_m, observed and
    hallucinated (clearSphereAroundPoint)."""
    return _set_sphere(layer, center, radius, abs(max_distance_m), OBS | HALL)


def add_new_robot_position(esdf_layer, position, cfg: EsdfIntegratorConfig):
    """Robot-position prior (esdf_integrator.cc:20-92). Observed voxels
    keep their values. Returns (layer, overflowed)."""
    layer, overflow = _allocate_sphere(esdf_layer, position,
                                       cfg.occupied_sphere_radius)
    flags = layer.channels["esdf_flags"]
    observed = (flags & OBS) != 0
    hall = (flags & HALL) != 0
    clear_m = sphere_voxel_mask(layer, position, cfg.clear_sphere_radius)
    occ_m = sphere_voxel_mask(layer, position, cfg.occupied_sphere_radius)
    clearable = clear_m & (~observed | hall)
    occupiable = occ_m & ~observed & ~clearable
    d = layer.channels["esdf"]
    d = torch.where(clearable, cfg.default_distance_m, d)
    d = torch.where(occupiable, -cfg.default_distance_m, d)
    touched = clearable | occupiable
    layer.channels["esdf"] = d
    layer.channels["esdf_flags"] = torch.where(touched, OBS | HALL,
                                               flags).to(torch.uint8)
    return (vlayer.mark_dirty(layer, _rows(layer), touched.any(1),
                              vlayer.DIRTY_ALL), overflow)


def map_bounds(layer):
    """(lower, upper) world bounds of the active blocks
    (computeMapBoundsFromLayer)."""
    active = _runtime.to_host(layer.active_mask())
    if not active.any():
        return np.zeros(3), np.zeros(3)
    bijk = _runtime.to_host(layer.block_ijk)[active]
    return bijk.min(0) * layer.block_size, (bijk.max(0) + 1) * layer.block_size
