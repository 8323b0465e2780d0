"""Trilinear interpolation and gradients over voxel layers (port of
voxblox_tpu/ops/interp.py; reference interpolator/interpolator_inl.h).

- 8-corner lookup around the query point with cross-block resolution, as
  one vectorized hash gather over global voxel indices;
- trilinear weights by the Q-vector formulation (interpolator.h:56-63);
- gradients analytically (the exact derivative of the trilinear
  function) or by central differences of interpolated values
  (getGradient, interpolator_inl.h:46-75);
- nearest-voxel values (getDistance(interp=false)) and the adaptive
  distance + gradient with one-sided fallbacks (interpolator_inl.h:77-154).

Queries are f32 [Q,3] on the layer's device.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _runtime
from ..core import grid
from ..core import layer as vlayer

# Corner offsets in x-fastest order, matching the weights below.
_CORNERS = np.asarray([[0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0],
                       [0, 0, 1], [1, 0, 1], [0, 1, 1], [1, 1, 1]], np.int32)


def _corner_setup(points, voxel_size):
    """Lower-corner voxel (whose centre lies at or below the point on
    every axis) and the fractional position in the corner cell."""
    inv = 1.0 / voxel_size
    low = torch.floor(points * inv - 0.5 + grid.EPS).to(torch.int32)
    low_center = (low.to(torch.float32) + 0.5) * voxel_size
    return low, (points - low_center) * inv


def _trilinear_weights(frac):
    fx, fy, fz = frac[..., 0], frac[..., 1], frac[..., 2]
    gx, gy, gz = 1.0 - fx, 1.0 - fy, 1.0 - fz
    return torch.stack([gx * gy * gz, fx * gy * gz, gx * fy * gz,
                        fx * fy * gz, gx * gy * fz, fx * gy * fz,
                        gx * fy * fz, fx * fy * fz], dim=-1)


def _corners(low):
    return low[..., None, :] + _runtime.const(_CORNERS, torch.int32,
                                              low.device)


_VALIDITY = {"tsdf": "weight", "esdf": "esdf_flags",
             "occupancy": "occ_observed"}


def _values_and_validity(layer, ijk, channel: str, min_weight: float,
                         max_psl: int):
    """Channel values at global voxel indices (0 where the block is
    missing) and whether each voxel is observed: block present and TSDF
    weight > min_weight, or the ESDF / occupancy observed flag. One hash
    lookup serves both gathers."""
    flat, found = vlayer.global_voxel_to_flat(layer, ijk, max_psl)
    safe = torch.where(found, flat, 0)

    def gather(name):
        c = layer.channels[name]
        return torch.where(found, c.view(-1)[safe], 0).to(c.dtype)

    vals = gather(channel)
    kind = _VALIDITY.get(layer.layer_type)
    if kind is None:
        return vals, found
    v = gather(kind)
    if kind == "weight":
        return vals, found & (v > min_weight)
    if kind == "esdf_flags":
        return vals, found & ((v & vlayer.ESDF_OBSERVED) != 0)
    return vals, found & (v != 0)


def _distance_channel(layer) -> str:
    return {"tsdf": "tsdf", "esdf": "esdf",
            "occupancy": "log_odds"}[layer.layer_type]


def interpolate(layer, points, channel: str | None = None,
                min_weight: float = 1e-6, max_psl: int | None = None):
    """Trilinear value at world points [Q,3]: (values [Q], valid [Q]);
    valid needs all 8 corners observed. ``max_psl``: the hash table's
    probe bound as a host int (``core/hash.lookup``), for callers that
    query a layer that does not change many times without a host read."""
    channel = channel or _distance_channel(layer)
    if max_psl is None:
        max_psl = _runtime.host_int(layer.table.max_psl)
    low, frac = _corner_setup(points, layer.voxel_size)
    vals, ok = _values_and_validity(layer, _corners(low), channel,
                                    min_weight, max_psl)
    return torch.sum(_trilinear_weights(frac) * vals, dim=-1), ok.all(-1)


def nearest(layer, points, channel: str | None = None,
            min_weight: float = 1e-6, max_psl: int | None = None):
    """Nearest-voxel value: (values [Q], valid [Q])."""
    channel = channel or _distance_channel(layer)
    if max_psl is None:
        max_psl = _runtime.host_int(layer.table.max_psl)
    gvi = grid.point_to_grid_index(points, 1.0 / layer.voxel_size)
    return _values_and_validity(layer, gvi, channel, min_weight, max_psl)


def interpolate_with_gradient(layer, points, channel: str | None = None,
                              min_weight: float = 1e-6):
    """Trilinear value and its exact spatial gradient: (values [Q], grads
    [Q,3], valid [Q])."""
    channel = channel or _distance_channel(layer)
    low, frac = _corner_setup(points, layer.voxel_size)
    vals, ok = _values_and_validity(
        layer, _corners(low), channel, min_weight,
        _runtime.host_int(layer.table.max_psl))
    out = torch.sum(_trilinear_weights(frac) * vals, dim=-1)
    fx, fy, fz = frac[..., 0], frac[..., 1], frac[..., 2]
    gx, gy, gz = 1.0 - fx, 1.0 - fy, 1.0 - fz
    inv = 1.0 / layer.voxel_size
    v = vals.unbind(-1)
    dx = ((v[1] - v[0]) * gy * gz + (v[3] - v[2]) * fy * gz
          + (v[5] - v[4]) * gy * fz + (v[7] - v[6]) * fy * fz) * inv
    dy = ((v[2] - v[0]) * gx * gz + (v[3] - v[1]) * fx * gz
          + (v[6] - v[4]) * gx * fz + (v[7] - v[5]) * fx * fz) * inv
    dz = ((v[4] - v[0]) * gx * gy + (v[5] - v[1]) * fx * gy
          + (v[6] - v[2]) * gx * fy + (v[7] - v[3]) * fx * fy) * inv
    return out, torch.stack([dx, dy, dz], dim=-1), ok.all(-1)


def _axis_offset(ax: int, h: float, device):
    off = np.zeros(3, np.float32)
    off[ax] = h
    return _runtime.const(off, torch.float32, device)


def gradient_central(layer, points, channel: str | None = None,
                     min_weight: float = 1e-6, max_psl: int | None = None):
    """Central differences of interpolated values at +-voxel_size per axis
    (getGradient): (grads [Q,3], valid [Q]). The six stencil points go
    through one ``interpolate`` call."""
    channel = channel or _distance_channel(layer)
    h = layer.voxel_size
    stencil = torch.stack([points + s * _axis_offset(ax, h, points.device)
                           for ax in range(3) for s in (1.0, -1.0)])
    vals, ok = interpolate(layer, stencil, channel, min_weight, max_psl)
    grads = [(vals[2 * ax] - vals[2 * ax + 1]) / (2.0 * h) for ax in range(3)]
    valid = ok.all(0)
    return torch.stack(grads, dim=-1), valid


def adaptive_distance_and_gradient(layer, points, channel: str | None = None,
                                   min_weight: float = 1e-6):
    """getAdaptiveDistanceAndGradient: nearest distance must be valid;
    trilinear distance + central-difference gradient where the stencils
    are complete; otherwise per-axis nearest-mode differences (central,
    one-sided, or invalid with no observed neighbour on an axis), and a
    missing trilinear distance reconstructed from the gradient. Returns
    (distances [Q], grads [Q,3], valid [Q])."""
    channel = channel or _distance_channel(layer)
    h = layer.voxel_size
    psl = _runtime.host_int(layer.table.max_psl)
    nn, nn_ok = nearest(layer, points, channel, min_weight, psl)
    interp_d, interp_ok = interpolate(layer, points, channel, min_weight, psl)
    grad_i, grad_i_ok = gradient_central(layer, points, channel, min_weight,
                                         psl)
    g_fb, fb_ok = [], nn_ok
    for ax in range(3):
        off = _axis_offset(ax, h, points.device)
        right, r_ok = nearest(layer, points + off, channel, min_weight, psl)
        left, l_ok = nearest(layer, points - off, channel, min_weight, psl)
        g_fb.append(torch.where(
            l_ok & r_ok, (right - left) / (2.0 * h),
            torch.where(l_ok, (nn - left) / h,
                        torch.where(r_ok, (right - nn) / h, 0.0))))
        fb_ok = fb_ok & (l_ok | r_ok)
    g_fb = torch.stack(g_fb, dim=-1)
    use_interp_grad = interp_ok & grad_i_ok
    grad = torch.where(use_interp_grad[..., None], grad_i, g_fb)
    gvi = grid.point_to_grid_index(points, 1.0 / h)
    vox_center = (gvi.to(torch.float32) + 0.5) * h
    est = nn + torch.sum((points - vox_center) * grad, dim=-1)
    dist = torch.where(interp_ok, interp_d, est)
    return dist, grad, nn_ok & (use_interp_grad | fb_ok)


def interpolate_trilinear_color(layer, points, max_psl: int | None = None):
    """Trilinear colour of a TSDF layer: (rgb [Q,3], valid [Q]);
    differentiable in ``points`` and the colour channel."""
    low, frac = _corner_setup(points, layer.voxel_size)
    vals, found = vlayer.get_voxels(layer, "color", _corners(low),
                                    max_psl=max_psl)
    out = torch.sum(_trilinear_weights(frac)[..., None] * vals, dim=-2)
    return out, found[..., 0].all(-1)
