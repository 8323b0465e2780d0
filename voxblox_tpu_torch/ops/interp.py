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


def _corner_validity(layer, corners, found, min_weight: float):
    """Block present and voxel observed: TSDF weight > min_weight, ESDF or
    occupancy observed flag."""
    if layer.layer_type == "tsdf":
        w, _ = vlayer.get_voxels(layer, "weight", corners)
        return found & (w > min_weight)
    if layer.layer_type == "esdf":
        f, _ = vlayer.get_voxels(layer, "esdf_flags", corners, fill=0)
        return found & ((f & vlayer.ESDF_OBSERVED) != 0)
    if layer.layer_type == "occupancy":
        f, _ = vlayer.get_voxels(layer, "occ_observed", corners, fill=0)
        return found & (f != 0)
    return found


def _distance_channel(layer) -> str:
    return {"tsdf": "tsdf", "esdf": "esdf",
            "occupancy": "log_odds"}[layer.layer_type]


def interpolate(layer, points, channel: str | None = None,
                min_weight: float = 1e-6):
    """Trilinear value at world points [Q,3]: (values [Q], valid [Q]);
    valid needs all 8 corners observed."""
    channel = channel or _distance_channel(layer)
    low, frac = _corner_setup(points, layer.voxel_size)
    corners = _corners(low)
    vals, found = vlayer.get_voxels(layer, channel, corners)
    ok = _corner_validity(layer, corners, found, min_weight)
    return torch.sum(_trilinear_weights(frac) * vals, dim=-1), ok.all(-1)


def nearest(layer, points, channel: str | None = None,
            min_weight: float = 1e-6):
    """Nearest-voxel value: (values [Q], valid [Q])."""
    channel = channel or _distance_channel(layer)
    gvi = grid.point_to_grid_index(points, 1.0 / layer.voxel_size)
    vals, found = vlayer.get_voxels(layer, channel, gvi)
    return vals, _corner_validity(layer, gvi, found, min_weight)


def interpolate_with_gradient(layer, points, channel: str | None = None,
                              min_weight: float = 1e-6):
    """Trilinear value and its exact spatial gradient: (values [Q], grads
    [Q,3], valid [Q])."""
    channel = channel or _distance_channel(layer)
    low, frac = _corner_setup(points, layer.voxel_size)
    corners = _corners(low)
    vals, found = vlayer.get_voxels(layer, channel, corners)
    ok = _corner_validity(layer, corners, found, min_weight)
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
                     min_weight: float = 1e-6):
    """Central differences of interpolated values at +-voxel_size per axis
    (getGradient): (grads [Q,3], valid [Q])."""
    channel = channel or _distance_channel(layer)
    h = layer.voxel_size
    grads, valid = [], None
    for ax in range(3):
        off = _axis_offset(ax, h, points.device)
        up, vu = interpolate(layer, points + off, channel, min_weight)
        dn, vd = interpolate(layer, points - off, channel, min_weight)
        grads.append((up - dn) / (2.0 * h))
        valid = (vu & vd) if valid is None else (valid & vu & vd)
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
    nn, nn_ok = nearest(layer, points, channel, min_weight)
    interp_d, interp_ok = interpolate(layer, points, channel, min_weight)
    grad_i, grad_i_ok = gradient_central(layer, points, channel, min_weight)
    g_fb, fb_ok = [], nn_ok
    for ax in range(3):
        off = _axis_offset(ax, h, points.device)
        right, r_ok = nearest(layer, points + off, channel, min_weight)
        left, l_ok = nearest(layer, points - off, channel, min_weight)
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


def interpolate_trilinear_color(layer, points):
    """Trilinear colour of a TSDF layer: (rgb [Q,3], valid [Q])."""
    low, frac = _corner_setup(points, layer.voxel_size)
    vals, found = vlayer.get_voxels(layer, "color", _corners(low))
    out = torch.sum(_trilinear_weights(frac)[..., None] * vals, dim=-2)
    return out, found[..., 0].all(-1)
