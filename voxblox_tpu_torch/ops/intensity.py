"""Intensity (thermal) integration onto the TSDF surface (port of
voxblox_tpu/ops/intensity.py; reference integrator/
intensity_integrator.{h,cc}): bearing vectors are sphere-traced to the
TSDF surface (``render.surface_distance_along_rays``), each hit splats its
intensity into the intersection voxel with a running weighted mean
(weight += 1, capped at ``max_weight``), and unobserved voxels within
``prop_voxel_radius`` voxels along the ray take the same value.

Splat sums are ``index_add_`` (on the GPU in atomics order). The fill
keeps the last lane per voxel, as the JAX CPU scatter does (a plain
``index_put_`` of duplicates on the GPU would keep an arbitrary one).
"""

from __future__ import annotations

import torch

from ..core import grid
from ..core import layer as vlayer
from .raycast import fma
from .render import surface_distance_along_rays
from .tsdf import _DUMPS, _drop_to_dumps


def add_intensity_bearing_vectors(intensity_layer: vlayer.VoxelLayer,
                                  tsdf_layer: vlayer.VoxelLayer, origin,
                                  bearing_vectors, intensities,
                                  max_distance: float = 30.0,
                                  max_weight: float = 100.0,
                                  prop_voxel_radius: int = 2):
    """origin f32[3]; bearing_vectors f32[R,3]; intensities f32[R]. Updates
    the intensity layer in place; returns (intensity_layer, hits)."""
    origins = origin.expand(bearing_vectors.shape)
    t, hit = surface_distance_along_rays(tsdf_layer, origins,
                                         bearing_vectors, max_distance)
    dirs = bearing_vectors / torch.linalg.vector_norm(
        bearing_vectors, dim=-1, keepdim=True)
    surf = fma(t[:, None], dirs, origins)
    vs = intensity_layer.voxel_size
    dev = intensity_layer.device

    # Blocks at the splat sites and along the neighbourhood.
    offsets = torch.arange(-prop_voxel_radius, prop_voxel_radius + 1,
                           dtype=torch.float32, device=dev)
    probe = fma((offsets * vs)[:, None, None], dirs[None], surf[None])
    probe_valid = hit[None].expand(probe.shape[:2])
    intensity_layer, _ = vlayer.allocate_blocks(
        intensity_layer,
        grid.point_to_grid_index(probe, 1.0 / intensity_layer.block_size
                                 ).reshape(-1, 3),
        probe_valid.reshape(-1))

    n_flat = intensity_layer.max_blocks * intensity_layer.voxels_per_block
    flat, found = vlayer.global_voxel_to_flat(
        intensity_layer, grid.point_to_grid_index(surf, 1.0 / vs))
    ok = hit & found
    idx = _drop_to_dumps(flat, ok, n_flat)
    ival = intensity_layer.channels["intensity"].view(-1)
    wval = intensity_layer.channels["intensity_weight"].view(-1)

    def splat(x):
        acc = torch.zeros(n_flat + _DUMPS, dtype=torch.float32, device=dev)
        return acc.index_add_(0, idx, torch.where(ok, x, 0.0))[:n_flat]

    d_n = splat(torch.ones_like(intensities))
    d_i = splat(intensities)
    touched = d_n > 0
    new_w = wval + d_n
    new_i = (ival * wval + d_i) / torch.clamp(new_w, min=1e-12)
    ival_new = torch.where(touched, new_i, ival)
    wval_new = torch.where(touched, torch.clamp(new_w, max=max_weight), wval)

    # Neighbourhood fill, only where still unobserved. NaN marks an
    # unfilled voxel (so a NaN intensity fills nothing, as in the JAX
    # package).
    pflat, pfound = vlayer.global_voxel_to_flat(
        intensity_layer, grid.point_to_grid_index(probe, 1.0 / vs))
    pok = probe_valid & pfound
    pok = pok & (wval_new[torch.where(pok, pflat, 0)] < 1e-6)
    fill_i = torch.full((n_flat,), float("nan"), dtype=torch.float32,
                        device=dev)
    vlayer.put_last(fill_i, pflat, pok,
                    intensities[None].expand(pok.shape))
    fill_mask = ~torch.isnan(fill_i) & (wval_new < 1e-6)
    ival.copy_(torch.where(fill_mask, fill_i, ival_new))
    wval.copy_(torch.where(fill_mask, 1.0, wval_new))
    return intensity_layer, hit
