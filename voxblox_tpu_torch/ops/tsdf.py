"""Ray-casting TSDF integrators: simple, merged and fast (port of
voxblox_tpu/ops/tsdf.py; reference tsdf_integrator.cc).

- ``simple``: every valid point casts a full ray (cc:242-305);
- ``merged``: rays bundled by endpoint voxel (stable sorts + segment
  sums), one cast per bundle with the weighted-mean point and colour,
  optional anti-grazing (cc:307-486);
- ``fast``: one ray per subsampled start cell, cast from the point
  towards the sensor, stopped after ``max_consecutive_ray_collisions``
  voxels seen in earlier frames; epoch-stamped hash arrays stand in for
  the reference's approximate hash sets (cc:488-590).

The per-voxel math is updateTsdfVoxel's (cc:150-228): every (step, ray)
sample adds (w, w*sdf, w*rgb) into pool-wide accumulators and one
renormalize per scan folds them into the running averages. On the CPU
the sums run in lane order, as the JAX CPU backend's scatter runs them;
on the GPU their order is the atomics' order.

On a CUDA device ``simple`` and ``merged`` walk, weigh, look up and
scatter in one launch of a hand-written kernel (``ops/tsdf_walk``); the
chain of [max_steps, R] sample tensors here is its plain version and runs
on the CPU, and for ``fast``, whose early exit sits between walk and
weigh.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import _runtime
from ..core import grid
from ..core import hash as vhash
from ..core import layer as vlayer
from ..core.config import TsdfIntegratorConfig
from ..utils import timing
from . import raycast, tsdf_walk


class FastIntegratorState(NamedTuple):
    """Epoch-stamped dedup array of the fast integrator: a cell is in the
    set of frame f iff stamp[hash] equals f's epoch, so clearing the set
    is a counter bump (approx_hash_array.h:118-124). Stamps and frame
    are int64 here (uint32 in the JAX package; the values stay small)."""

    observed_stamp: torch.Tensor  # int64[2^bits]
    frame: torch.Tensor  # int64[] current frame (starts at 1)


def make_fast_state(bits: int = 21, device=None) -> FastIntegratorState:
    dev = _runtime.resolve_device(device)
    return FastIntegratorState(
        observed_stamp=torch.zeros(1 << bits, dtype=torch.int64, device=dev),
        frame=torch.ones((), dtype=torch.int64, device=dev))


def _hash_gvi(gvi, bits: int):
    """Global voxel indices [..., 3] -> int64 hash in [0, 2^bits), the
    JAX package's uint32 hash (wrapping multiplies done in int64)."""
    u = gvi.to(torch.int64) & vhash._M32
    h = (vhash._mul32(u[..., 0], 0x9E3779B1)
         ^ vhash._mul32(u[..., 1], 0x85EBCA6B)
         ^ vhash._mul32(u[..., 2], 0xC2B2AE35))
    h = h ^ (h >> 15)
    h = vhash._mul32(h, 0x2C1B3C6D)
    h = h ^ (h >> 12)
    return h & ((1 << bits) - 1)


_DUMPS = 4096  # dump cells past the end of a scatter target


def _drop_to_dumps(idx, ok, n: int):
    """``where(ok, idx, n + lane % _DUMPS)`` flat: the lanes a scatter
    drops land on ``_DUMPS`` cells past the end of its target instead of
    one (on the GPU millions of atomics on one address serialize). The
    target needs ``n + _DUMPS`` cells; the kept cells see the same adds
    in the same order."""
    lane = torch.arange(idx.numel(), device=idx.device) & (_DUMPS - 1)
    return torch.where(ok.reshape(-1), idx.reshape(-1).to(torch.int64),
                       n + lane)


# ---------------------------------------------------------------------------
# Point validity and weights (tsdf_integrator.h:112-129, cc:231-240)
# ---------------------------------------------------------------------------


def point_validity(points_C, cfg: TsdfIntegratorConfig,
                   freespace_points=False):
    """(valid, is_clearing) per point: closer than min_ray_length is
    invalid, beyond max_ray_length clears when allowed."""
    norm = torch.linalg.vector_norm(points_C, dim=-1)
    finite = torch.isfinite(points_C).all(-1)
    too_close = norm < cfg.min_ray_length_m
    too_far = norm > cfg.max_ray_length_m
    is_clearing = too_far & (cfg.allow_clear or freespace_points)
    valid = finite & ~too_close & (~too_far | is_clearing)
    return valid, is_clearing


def point_weights(points_C, cfg: TsdfIntegratorConfig):
    """Pre-dropoff weight: 1/z^2 in the sensor frame."""
    if cfg.use_const_weight:
        return torch.ones(points_C.shape[:-1], dtype=torch.float32,
                          device=points_C.device)
    dist_z = points_C[..., 2].abs()
    return torch.where(dist_z > grid.EPS,
                       1.0 / torch.clamp(dist_z, min=grid.EPS) ** 2, 0.0)


# ---------------------------------------------------------------------------
# The fused update
# ---------------------------------------------------------------------------


def _per_sample_contributions(voxels, mask, origin, points_G, ray_weights,
                              voxel_size, cfg):
    """Per-(step, ray) sdf (unclamped) and weight (after dropoff and
    sparsity compensation) of voxels [S,R,3] for endpoints [R,3]."""
    fma = raycast.fma
    half = voxels.to(torch.float32) + 0.5
    v_point_origin = points_G - origin
    dist_G = torch.linalg.vector_norm(v_point_origin, dim=-1)
    # (centre - origin) and the dot product as the fused multiply-adds of
    # the JAX CPU program (see ops/raycast.fma).
    v_voxel_origin = fma(half, torch.full_like(half, voxel_size),
                         -origin.expand_as(half))
    a, b = v_voxel_origin.unbind(-1), v_point_origin.expand_as(
        v_voxel_origin).unbind(-1)
    dot = fma(a[2], b[2], fma(a[1], b[1], a[0] * b[0]))
    sdf = dist_G - dot / torch.clamp(dist_G, min=grid.FLOAT_EPS)
    w = ray_weights.expand(sdf.shape)
    trunc = cfg.default_truncation_distance
    if cfg.use_weight_dropoff:
        dropoff_eps = voxel_size
        ramp = (trunc + sdf) / (trunc - dropoff_eps)
        w = torch.where(sdf < -dropoff_eps, torch.clamp(w * ramp, min=0.0),
                        w)
    if cfg.use_sparsity_compensation_factor:
        w = torch.where(sdf.abs() < trunc,
                        w * cfg.sparsity_compensation_factor, w)
    return sdf, torch.where(mask, w, 0.0)


def accumulate_contributions(layer, voxels, mask, sdf, w, colors, cfg,
                             use_color: bool):
    """Add per-sample contributions into flat pool accumulators: (d_w,
    d_wd, d_wc, d_wcw, dirty), all indexed by flat pool offset; ``dirty``
    bool[max_blocks] marks blocks that took any update."""
    flat, found = vlayer.global_voxel_to_flat(layer, voxels)
    return _accumulate_flat(layer, flat, mask & found, sdf, w, colors, cfg,
                            use_color)


def _accumulate_flat(layer, flat, ok, sdf, w, colors, cfg, use_color: bool):
    """``accumulate_contributions`` once the samples' flat pool offsets
    are looked up (``ok``: in the walk's mask and in an allocated block)."""
    trunc = cfg.default_truncation_distance
    dev = layer.device
    n_flat = layer.max_blocks * layer.voxels_per_block
    idx = _drop_to_dumps(flat, ok, n_flat)
    n_buf = n_flat + _DUMPS
    zeros = dict(dtype=torch.float32, device=dev)
    sdf_c = torch.clamp(sdf, -trunc, trunc)
    d_w = torch.zeros(n_buf, **zeros).index_add_(
        0, idx, torch.where(ok, w, 0.0).reshape(-1))
    d_wd = torch.zeros(n_buf, **zeros).index_add_(
        0, idx, torch.where(ok, w * sdf_c, 0.0).reshape(-1))
    if use_color:
        cw = torch.where(ok & (sdf.abs() < trunc), w, 0.0)
        d_wcw = torch.zeros(n_buf, **zeros).index_add_(
            0, idx, cw.reshape(-1))
        wc = cw[..., None] * colors.expand(sdf.shape + (3,))
        d_wc = torch.zeros((n_buf, 3), **zeros).index_add_(
            0, idx, wc.reshape(-1, 3))
    else:
        d_wcw = torch.zeros(n_buf, **zeros)
        d_wc = torch.zeros((n_buf, 3), **zeros)
    mb = layer.max_blocks
    dirty = torch.zeros(mb + _DUMPS, dtype=torch.bool, device=dev)
    dirty.index_fill_(0, _drop_to_dumps(flat // layer.voxels_per_block, ok,
                                        mb), True)
    return (d_w[:n_flat], d_wd[:n_flat], d_wc[:n_flat], d_wcw[:n_flat],
            dirty[:mb])


def apply_contributions(layer, d_w, d_wd, d_wc, d_wcw, dirty, cfg):
    """Renormalize the accumulators into the layer (updateTsdfVoxel's
    running average, truncation clamp and weight cap) and mark the
    updated blocks ACTIVE | DIRTY_ALL."""
    trunc = cfg.default_truncation_distance
    ch = layer.channels
    tsdf = ch["tsdf"].reshape(-1)
    weight = ch["weight"].reshape(-1)
    color = ch["color"].reshape(-1, 3)
    fma = raycast.fma
    new_w_raw = weight + d_w
    touched = d_w > 0.0
    new_d = torch.clamp(fma(tsdf, weight, d_wd)
                        / torch.clamp(new_w_raw, min=grid.FLOAT_EPS),
                        -trunc, trunc)
    out_d = torch.where(touched & (new_w_raw >= grid.FLOAT_EPS), new_d, tsdf)
    cdenom = torch.clamp(weight + d_wcw, min=grid.FLOAT_EPS)[:, None]
    out_c = torch.where((d_wcw > 0.0)[:, None],
                        fma(color, weight[:, None].expand_as(color), d_wc)
                        / cdenom, color)
    out_w = torch.where(touched, torch.clamp(new_w_raw, max=cfg.max_weight),
                        weight)
    tsdf.copy_(out_d)
    color.copy_(out_c)
    weight.copy_(out_w)
    layer.block_flags.copy_(torch.where(
        dirty, vlayer.ACTIVE | vlayer.DIRTY_ALL, layer.block_flags))
    return layer


# ---------------------------------------------------------------------------
# Allocation
# ---------------------------------------------------------------------------

_DILATE = ((0, 0, 0), (1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0),
           (0, 0, 1), (0, 0, -1))


def allocate_for_rays(layer, setup: raycast.RaySetup, valid,
                      max_steps: int):
    """Block-granular DDA over the same segments, dilated by one block on
    each axis (voxel rays crossing block corners), then the two-phase
    allocation. Returns (layer, overflowed)."""
    block_steps = max(4, max_steps // layer.vps + 3)
    bvox, bmask = raycast.bresenham_hierarchical(setup, layer.vps,
                                                 block_steps, valid)
    offs = _runtime.const(_DILATE, torch.int32, layer.device)
    cand = (bvox[None] + offs[:, None, None, :]).reshape(-1, 3)
    cmask = bmask[None].expand((offs.shape[0],) + bmask.shape).reshape(-1)
    return vlayer.allocate_blocks(layer, cand, cmask)


# ---------------------------------------------------------------------------
# Entry point
# ---------------------------------------------------------------------------


def transform_points(T_G_C, points_C):
    """T_G_C: (R[3,3], t[3]) or [4,4]; points [N,3] -> (points_G, t)."""
    if isinstance(T_G_C, tuple):
        R, t = T_G_C
    else:
        R, t = T_G_C[:3, :3], T_G_C[:3, 3]
    return points_C @ R.T + t, t


def integrate_pointcloud(layer: vlayer.VoxelLayer, T_G_C, points_C, colors,
                         cfg: TsdfIntegratorConfig, method: str = "simple",
                         state: Optional[FastIntegratorState] = None,
                         use_color: bool = True):
    """Integrate one posed cloud (points_C f32[N,3] sensor frame, colours
    f32[N,3] in [0, 255]; pad with NaN or zero-length points). Updates the
    layer in place; returns (layer, state, overflowed)."""
    if method not in ("simple", "merged", "fast"):
        raise ValueError(f"unknown integrator method {method!r}")
    dev = layer.device
    if isinstance(T_G_C, tuple):
        T_G_C = tuple(torch.as_tensor(x, dtype=torch.float32, device=dev)
                      for x in T_G_C)
    else:
        T_G_C = torch.as_tensor(T_G_C, dtype=torch.float32, device=dev)
    points_G, origin = transform_points(T_G_C, points_C)
    valid, clearing = point_validity(points_C, cfg)
    weights = point_weights(points_C, cfg)
    max_steps = cfg.max_steps or raycast.max_steps_hint(
        cfg.max_ray_length_m, cfg.default_truncation_distance,
        layer.voxel_size, cfg.voxel_carving_enabled)
    endpoint_info = None
    # Stage spans are siblings under the caller's span, which launches the
    # first kernels (pose, validity, weights) and the last (the apply):
    # the profiler puts each kernel under its innermost span only.
    if method == "merged":
        with timing.timer("integrate.bundle"):
            (points_G, weights, colors, valid, clearing,
             endpoint_info) = _bundle_rays(layer, points_G, weights, colors,
                                           valid, clearing, use_color)
    if method == "fast":
        assert state is not None, "fast integrator needs FastIntegratorState"
        valid = valid & _fast_select_rays(layer, points_C, valid, cfg)
    setup = raycast.compute_ray_segments(
        origin.expand(points_G.shape), points_G, clearing, layer.voxel_size,
        cfg.default_truncation_distance, cfg.max_ray_length_m,
        cfg.voxel_carving_enabled, cast_from_origin=method != "fast")
    with timing.timer("integrate.allocate"):
        layer, overflowed = allocate_for_rays(layer, setup, valid, max_steps)
    grazing = None
    if method == "merged" and cfg.enable_anti_grazing:
        grazing = (endpoint_info[0], endpoint_info[1], clearing)
    rays = _Rays(setup, valid, origin, points_G, weights,
                 colors if use_color else None, grazing)
    if dev.type == "cuda" and method != "fast":
        with timing.timer("integrate.walk"):
            acc = _walk_kernel(layer, rays, max_steps, cfg)
    else:
        _, sdf, w, flat, ok, fast_state = _chain_samples(
            layer, rays, max_steps, cfg, state if method == "fast" else None)
        if method == "fast":
            state = fast_state
        with timing.timer("integrate.scatter"):
            acc = _accumulate_flat(layer, flat, ok, sdf, w, colors, cfg,
                                   use_color)
    layer = apply_contributions(layer, *acc, cfg)
    return layer, state, overflowed


# ---------------------------------------------------------------------------
# Walk, weigh, lookup and scatter: the chain (CPU; the fast integrator) and
# the kernel (simple and merged on a CUDA device, ops/tsdf_walk)
# ---------------------------------------------------------------------------


class _Rays(NamedTuple):
    """One scan's rays as the walk takes them (after bundling)."""
    setup: raycast.RaySetup
    valid: torch.Tensor  # bool[R]
    origin: torch.Tensor  # f32[3]
    points: torch.Tensor  # f32[R,3] world frame
    weights: torch.Tensor  # f32[R]
    colors: Optional[torch.Tensor]  # f32[R,3]; None without colour
    # merged with anti-grazing: (endpoint voxel int32[R,3], endpoint
    # valid bool[R], clearing bool[R]); else None
    grazing: Optional[tuple]


def _count_walk(rays, max_steps: int, slots):
    """While recording, the walk's counters: ``integrate.walk_samples``
    (``slots`` of lengths, the (step, lane) slots the walk executes) and
    ``integrate.walk_samples_useful`` (those inside a ray)."""
    if not timing.recording():
        return
    lengths = tsdf_walk.walk_lengths(rays.setup.num_steps, rays.valid,
                                     max_steps)
    timing.count("integrate.walk_samples", slots(lengths))
    timing.count("integrate.walk_samples_useful", lengths.sum())


def _chain_samples(layer, rays, max_steps: int, cfg, state=None):
    """The plain walk, weigh and lookup over [max_steps, R] samples: their
    voxels, sdf, weights, flat pool offsets and ``ok`` (in the walk's mask,
    not grazing, in an allocated block), and the fast state (given for the
    fast integrator, whose early exit sits between walk and weigh)."""
    with timing.timer("integrate.walk"):
        voxels, mask = raycast.cast_rays(rays.setup, max_steps, rays.valid)
        _count_walk(rays, max_steps, lambda lengths: mask.numel())
    if state is not None:
        mask, state = _fast_early_exit_and_stamp(voxels, mask, cfg, state)
    with timing.timer("integrate.weigh"):
        sdf, w = _per_sample_contributions(voxels, mask, rays.origin,
                                           rays.points, rays.weights,
                                           layer.voxel_size, cfg)
        if rays.grazing is not None:
            gvi, ends, clearing = rays.grazing
            mask = mask & _anti_grazing_mask(voxels, _endpoint_stamps(
                gvi, ends), gvi, clearing)
            w = torch.where(mask, w, 0.0)
    with timing.timer("integrate.lookup"):
        flat, found = vlayer.global_voxel_to_flat(layer, voxels)
        timing.count("integrate.block_lookups", found.numel())
    return voxels, sdf, w, flat, mask & found, state


def _kernel_inputs(rays, counts=None) -> dict:
    """The kernel's per-ray inputs (``tsdf_walk.make_params``), set up as
    the chain sets them up."""
    v_po = rays.points - rays.origin
    grazing = None
    if rays.grazing is not None:
        gvi, ends, clearing = rays.grazing
        grazing = (_endpoint_stamps(gvi, ends), gvi, clearing)
    return dict(dda=raycast.dda_start(rays.setup),
                num_steps=rays.setup.num_steps, valid=rays.valid,
                origin=rays.origin, v_po=v_po,
                dist=torch.linalg.vector_norm(v_po, dim=-1),
                weights=rays.weights, colors=rays.colors, grazing=grazing,
                counts=counts)


def _walk_kernel(layer, rays, max_steps: int, cfg):
    """Walk, weigh, lookup and scatter in one launch of the kernel; while
    recording, its counters: the warp slots it executes, and the hash
    probes and block lookups it makes (added on the device)."""
    _count_walk(rays, max_steps, tsdf_walk.warp_slots)
    counts = None
    if timing.recording():
        counts = torch.zeros(2, dtype=torch.int64, device=layer.device)
    acc = tsdf_walk.walk_and_accumulate(layer, max_steps, cfg,
                                        **_kernel_inputs(rays, counts))
    if counts is not None:
        timing.count("hash.probes", counts[0])
        timing.count("hash.lookup_lanes", counts[1])
        timing.count("integrate.block_lookups", counts[1])
    return acc


# ---------------------------------------------------------------------------
# Merged bundling (cc:340-431)
# ---------------------------------------------------------------------------


def _bundle_rays(layer, points_G, weights, colors, valid, clearing,
                 use_color):
    """Sort rays by (valid, clearing, endpoint voxel z, y, x) with stable
    sorts, last key first (jnp.lexsort's order); every bundle's head lane
    carries its weighted-mean point and colour and the summed weight
    (clearing bundles keep the head point)."""
    n = points_G.shape[0]
    dev = points_G.device
    gvi = grid.point_to_grid_index(points_G, 1.0 / layer.voxel_size)

    def key(col):
        return torch.where(valid, col, 0x3FFFFFFF)

    order = torch.arange(n, device=dev)
    for k in (key(gvi[:, 0]), key(gvi[:, 1]), key(gvi[:, 2]),
              key(clearing.to(torch.int32)), (~valid).to(torch.int32)):
        perm = torch.sort(k[order], stable=True).indices
        order = order[perm]
    gvi_s = gvi[order]
    valid_s = valid[order]
    clearing_s = clearing[order]
    w_s = torch.where(valid_s, weights[order], 0.0)
    p_s = points_G[order]
    c_s = colors[order]
    same = ((gvi_s[1:] == gvi_s[:-1]).all(-1)
            & (clearing_s[1:] == clearing_s[:-1]) & valid_s[1:]
            & valid_s[:-1])
    head = torch.cat([torch.ones(1, dtype=torch.bool, device=dev), ~same])
    seg_id = torch.cumsum(head.to(torch.int64), 0) - 1
    f32 = dict(dtype=torch.float32, device=dev)
    seg_w = torch.zeros(n, **f32).index_add_(0, seg_id, w_s)
    seg_wp = torch.zeros((n, 3), **f32).index_add_(0, seg_id,
                                                    w_s[:, None] * p_s)
    seg_wc = torch.zeros((n, 3), **f32)
    if use_color:
        seg_wc.index_add_(0, seg_id, w_s[:, None] * c_s)
    denom = torch.clamp(seg_w, min=grid.FLOAT_EPS)
    mean_p = seg_wp / denom[:, None]
    mean_c = seg_wc / denom[:, None]
    rep_valid = head & valid_s
    rep_p = torch.where(clearing_s[:, None], p_s, mean_p[seg_id])
    rep_w = torch.where(clearing_s, w_s, seg_w[seg_id])
    return (rep_p, rep_w, mean_c[seg_id], rep_valid, clearing_s,
            (gvi_s, rep_valid & ~clearing_s))


def _endpoint_stamps(endpoint_gvi, endpoint_valid):
    """bool[2^20]: the stamp table of the non-clearing bundles' endpoint
    voxels (by ``_hash_gvi``, 20 bits)."""
    bits = 20
    return vlayer.scatter_mask(1 << bits, _hash_gvi(endpoint_gvi, bits),
                               endpoint_valid)


def _anti_grazing_mask(voxels, stamp, endpoint_gvi, clearing):
    """False where a visited voxel is another non-clearing bundle's
    endpoint (cc:415-422), through the endpoint stamp table."""
    is_endpoint = stamp[_hash_gvi(voxels, 20)]
    own = (voxels == endpoint_gvi[None]).all(-1) & ~clearing[None, :]
    return ~(is_endpoint & ~own)


# ---------------------------------------------------------------------------
# Fast integrator (cc:488-590)
# ---------------------------------------------------------------------------


def _fast_select_rays(layer, points_C, valid, cfg):
    """One ray per subsampled start cell per scan (cc:514-519): the lowest
    lane claiming a cell wins (a scatter-min, order-free)."""
    sub_inv = cfg.start_voxel_subsampling_factor / layer.voxel_size
    h = _hash_gvi(grid.point_to_grid_index(points_C, sub_inv), 20)
    n = points_C.shape[0]
    lane = torch.arange(n, dtype=torch.int64, device=points_C.device)
    claims = torch.full(((1 << 20) + 1,), 0x7FFFFFFF, dtype=torch.int64,
                        device=points_C.device)
    claims.scatter_reduce_(0, torch.where(valid, h, 1 << 20), lane, "amin")
    return claims[h] == lane


def _fast_early_exit_and_stamp(voxels, mask, cfg, state):
    """Drop samples after more than ``max_consecutive_ray_collisions``
    consecutive voxels seen in earlier frames (cc:531-541), then stamp
    every kept voxel with this frame's epoch (all writers store the same
    value: order-free). The set resets every ``clear_checks_every_n_
    frames`` frames by an epoch bump."""
    n_stamps = state.observed_stamp.shape[0]
    bits = int(np.log2(n_stamps))
    h = _hash_gvi(voxels, bits)
    every = max(cfg.clear_checks_every_n_frames, 1)
    epoch = state.frame // every + 1
    seen_before = state.observed_stamp[h] == epoch
    consec = torch.zeros(voxels.shape[1], dtype=torch.int32,
                         device=voxels.device)
    alive = torch.empty_like(mask)
    for i in range(voxels.shape[0]):
        consec = torch.where(seen_before[i], consec + 1, 0)
        alive[i] = consec <= cfg.max_consecutive_ray_collisions
    mask = mask & alive
    stamps = torch.cat([state.observed_stamp,
                        state.observed_stamp.new_zeros(_DUMPS)])
    idx = _drop_to_dumps(h, mask, n_stamps)
    stamps.scatter_(0, idx, epoch.expand(idx.shape))
    return mask, FastIntegratorState(observed_stamp=stamps[:n_stamps],
                                     frame=state.frame + 1)
