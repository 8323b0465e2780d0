"""Vectorized Amanatides-Woo DDA ray casting (port of
voxblox_tpu/ops/raycast.py).

All rays advance in lockstep for a static maximum step count, emitting
one global voxel index per (step, ray) with a validity mask; the per-step
recurrence is the reference's (integrator_utils.cc:60-179): advance one
voxel along the axis with the smallest t to its next boundary, ties to
the first such axis (x, then y, then z), as ``jnp.argmin`` breaks them.

The endpoints' multiply-adds are fused multiply-adds (``fma``), as the
JAX CPU backend computes them inside its fused programs: the DDA itself is
exact arithmetic on its inputs, and an ulp in an endpoint can move a
ray's voxels.

Ray endpoints (integrator_utils.cc:72-104):
- normal ray:   end   = point + unit_ray * truncation
                start = carving ? origin : point - unit_ray * truncation
- clearing ray: end   = origin + unit_ray * clamp(len - trunc, 0, max_len)
                start = carving ? origin : end
- cast_from_origin=False swaps start and end (the fast integrator).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import grid


class RaySetup(NamedTuple):
    start_scaled: torch.Tensor  # f32[R,3] start point in voxel units
    end_scaled: torch.Tensor  # f32[R,3]
    num_steps: torch.Tensor  # int32[R] L1 length in voxels


def fma(a, b, c):
    """a * b + c rounded once to float32, as the JAX CPU backend computes
    a multiply feeding an add inside one fused loop: the f32 product is
    exact in float64, so one float64 add and one rounding to float32 give
    the fused result (bar double rounding, ~2^-29 of cases) on any
    device."""
    return (torch.as_tensor(a).double() * torch.as_tensor(b).double()
            + torch.as_tensor(c).double()).to(torch.float32)


def _norm(x):
    # vector_norm sums the squares as a fused multiply-add chain, as the
    # JAX CPU backend does for jnp.linalg.norm.
    return torch.linalg.vector_norm(x, dim=-1, keepdim=True)


def compute_ray_segments(origins, points, is_clearing, voxel_size: float,
                         truncation_distance: float, max_ray_length: float,
                         voxel_carving_enabled: bool,
                         cast_from_origin: bool = True) -> RaySetup:
    """RayCaster's start/end selection; origins, points f32[R,3] (world
    frame), is_clearing bool[R]. Returns the segments in voxel units."""
    delta = points - origins
    ray_len = _norm(delta)
    unit = delta / torch.clamp(ray_len, min=grid.FLOAT_EPS)
    clear_len = torch.clamp(ray_len - truncation_distance, 0.0,
                            max_ray_length)
    trunc = torch.full_like(unit, truncation_distance)
    clear_end = fma(unit, clear_len.expand_as(unit), origins)
    clear_start = origins if voxel_carving_enabled else clear_end
    normal_end = fma(unit, trunc, points)
    normal_start = (origins if voxel_carving_enabled
                    else fma(-unit, trunc, points))
    is_clearing = is_clearing[:, None]
    ray_start = torch.where(is_clearing, clear_start, normal_start)
    ray_end = torch.where(is_clearing, clear_end, normal_end)
    if not cast_from_origin:
        ray_start, ray_end = ray_end, ray_start
    inv = 1.0 / voxel_size
    start_scaled = ray_start * inv
    end_scaled = ray_end * inv
    return RaySetup(start_scaled, end_scaled,
                    _l1_steps(start_scaled, end_scaled))


def _l1_steps(start_scaled, end_scaled):
    si = grid.scaled_point_to_grid_index(start_scaled)
    ei = grid.scaled_point_to_grid_index(end_scaled)
    return (ei - si).abs().sum(-1).to(torch.int32)


class DdaStart(NamedTuple):
    """A walk's state before its first step."""
    voxel: torch.Tensor  # int32[R,3] start voxel
    step: torch.Tensor  # int32[R,3] step signs
    t_next: torch.Tensor  # f32[R,3] t to the next boundary per axis
    t_step: torch.Tensor  # f32[R,3] t between boundaries per axis


def dda_start(setup: RaySetup) -> DdaStart:
    """Per-ray set-up of the DDA; axes with no extent get a huge t, so
    they never win."""
    start = setup.start_scaled
    curr = grid.scaled_point_to_grid_index(start)
    ray_scaled = setup.end_scaled - start
    step_signs = torch.sign(ray_scaled).to(torch.int32)
    corrected_step = torch.clamp(step_signs, min=0).to(torch.float32)
    dist_to_boundary = corrected_step - (start - curr.to(torch.float32))
    safe = ray_scaled.abs() > 0.0
    big = 2.0 ** 30
    one = torch.ones((), dtype=torch.float32, device=start.device)
    den = torch.where(safe, ray_scaled, one)
    t_next = torch.where(safe, dist_to_boundary / den, big)
    t_step = torch.where(safe, step_signs.to(torch.float32) / den, big)
    return DdaStart(curr, step_signs, t_next, t_step)


def cast_rays(setup: RaySetup, max_steps: int, valid=None):
    """Run the DDA for all rays in lockstep: (voxels int32[max_steps, R,
    3], mask bool[max_steps, R]); the mask holds while step <= num_steps
    (the reference emits num_steps + 1 voxels). Rays longer than
    ``max_steps`` lose their farthest voxels."""
    curr, step_signs, t_next, t_step = dda_start(setup)
    dev = curr.device
    if valid is None:
        valid = torch.ones(curr.shape[:-1], dtype=torch.bool, device=dev)
    n = curr.shape[0]
    voxels = torch.empty((max_steps, n, 3), dtype=torch.int32, device=dev)
    mask = torch.empty((max_steps, n), dtype=torch.bool, device=dev)
    for i in range(max_steps):
        voxels[i] = curr
        mask[i] = valid & (setup.num_steps >= i)
        # First minimum, as jnp.argmin: x wins ties with y and z, y with z.
        tx, ty, tz = t_next.unbind(-1)
        ax_x = (tx <= ty) & (tx <= tz)
        ax_y = ~ax_x & (ty <= tz)
        onehot = torch.stack([ax_x, ax_y, ~ax_x & ~ax_y], -1)
        curr = curr + torch.where(onehot, step_signs, 0)
        t_next = t_next + torch.where(onehot, t_step, 0.0)
    return voxels, mask


def max_steps_hint(max_ray_length: float, truncation_distance: float,
                   voxel_size: float, voxel_carving_enabled: bool) -> int:
    """Static DDA step bound: the L1 length is at most sqrt(3) (~1.8x) the
    Euclidean voxel count."""
    if voxel_carving_enabled:
        span = max_ray_length + truncation_distance
    else:
        span = 2.0 * truncation_distance
    return int(span / voxel_size * 1.8) + 4


def block_segments(setup: RaySetup, vps: int) -> RaySetup:
    """The segments scaled by 1/vps, in block units: the set-up of the
    block-granular walk."""
    s = setup.start_scaled / vps
    e = setup.end_scaled / vps
    return RaySetup(s, e, _l1_steps(s, e))
