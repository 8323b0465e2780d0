"""Projective (voxel-centric) TSDF integration (port of
voxblox_tpu/ops/projective.py): pinhole and spherical range images, the
single-scan path and the K-scan batch path.

Every voxel gathers its update from a virtual range image of the scan:
candidate blocks around the sensor are culled against a min/max image
pyramid (HiZ) and allocated; each visible block splits into 128-voxel
slabs classified FREE / SKIP / MIXED; FREE slabs take the clamped +trunc
carving update with no image access, MIXED slabs gather per-voxel image
features. The static budgets (``max_visible_blocks``, ``max_mixed_slabs``,
``max_free_slabs``) are part of the semantics: an overflowed scan applies
nothing, so the server can replay it at a grown budget.

What differs from the JAX module is layout only: features are gathered
from planar f32 channels instead of f16x2-packed words — gradients and
colours are rounded through ``torch.float16`` at the same points, so the
stored numbers match — and out-of-range scatters use explicit dump rows.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from .. import _runtime
from ..core import grid
from ..core import layer as vlayer
from ..core.config import TsdfIntegratorConfig
from .compaction import compact_ids

_INF = float("inf")


class RangeImage(NamedTuple):
    rng: torch.Tensor  # f32[H, W]; +inf where no return
    color: torch.Tensor  # f32[H, W, 3]
    # Pinhole (fx, fy, cx, cy); spherical (az0, el0, daz, del).
    params: torch.Tensor  # f32[4]
    kind: str  # "pinhole" | "spherical"


def _f2i(x):
    """f32 -> int32 with XLA's conversion semantics: saturating, NaN -> 0
    (a plain torch cast of an out-of-range float is undefined)."""
    return (torch.nan_to_num(x, nan=0.0).clamp(-2.0 ** 40, 2.0 ** 40)
            .to(torch.int64).clamp(-2 ** 31, 2 ** 31 - 1).to(torch.int32))


def _norm(x):
    # vector_norm sums the squares as a fused multiply-add chain, as the
    # JAX CPU backend does for jnp.linalg.norm: the ranges match exactly.
    return torch.linalg.vector_norm(x, dim=-1)


def _last_lane(n: int, idx, ok):
    """Index of the LAST lane writing each of n cells (-1 if none): the
    order in which the JAX CPU scatter resolves duplicate targets, made
    deterministic on every device."""
    lanes = torch.arange(idx.shape[0], dtype=torch.int64, device=idx.device)
    win = torch.full((n + 1,), -1, dtype=torch.int64, device=idx.device)
    win.scatter_reduce_(0, torch.where(ok, idx.to(torch.int64), n), lanes,
                        "amax")
    return win[:n]


# ---------------------------------------------------------------------------
# Range images
# ---------------------------------------------------------------------------
#
# Every builder takes clouds with any leading batch dims ([..., N, 3] or
# [..., H, W, 3]) and returns images [..., H, W]: the batch path builds
# all K scans' images in one pass. ``params`` is one f32[4] shared by the
# batch (it depends only on the resolution and the intrinsics).


def _bin(points_C, colors, flat, inb, h: int, w: int):
    """Scatter-min binning of flat [..., N] pixel ids: per pixel the
    MINIMUM range wins; among equal ranges the last point's colour."""
    lead = points_C.shape[:-2]
    n_img = h * w
    k = int(np.prod(lead)) if lead else 1
    offs = torch.arange(k, dtype=torch.int64, device=points_C.device)
    flat = flat.reshape(k, -1).to(torch.int64)
    inb = inb.reshape(k, -1)
    g = torch.where(inb, flat + offs[:, None] * n_img, k * n_img).reshape(-1)
    r = _norm(points_C).reshape(-1)
    rng = torch.full((k * n_img + 1,), _INF, dtype=torch.float32,
                     device=points_C.device)
    rng.scatter_reduce_(0, g, torch.where(inb.reshape(-1), r, _INF), "amin")
    won = inb.reshape(-1) & (rng[g] == r)
    win = _last_lane(k * n_img, g, won)
    cflat = torch.where((win >= 0)[:, None],
                        colors.reshape(-1, 3)[torch.clamp(win, min=0)], 0.0)
    return (rng[:k * n_img].reshape(lead + (h, w)),
            cflat.reshape(lead + (h, w, 3)))


def build_pinhole_range_image(points_C, colors, resolution,
                              fov_h_rad: Optional[float] = None,
                              intrinsics=None):
    """Bin sensor-frame clouds [..., N, 3] into pinhole images: per pixel
    the MINIMUM range wins; ties in range keep the last point's colour."""
    w, h = resolution
    if intrinsics is None:
        fx = w / (2.0 * np.tan(fov_h_rad / 2.0))
        intrinsics = (fx, fx, w / 2.0, h / 2.0)
    fx, fy, cx, cy = intrinsics
    z = points_C[..., 2]
    valid = z > 1e-3
    zs = torch.clamp(z, min=1e-6)
    u = _f2i(torch.round(points_C[..., 0] / zs * fx + cx))
    v = _f2i(torch.round(points_C[..., 1] / zs * fy + cy))
    inb = valid & (u >= 0) & (u < w) & (v >= 0) & (v < h)
    rng, color = _bin(points_C, colors, v.to(torch.int64) * w + u, inb, h, w)
    return RangeImage(
        rng=rng, color=color,
        params=_runtime.const(intrinsics, torch.float32, points_C.device),
        kind="pinhole")


def _spherical_params(w: int, h: int, fov_up_deg, fov_down_deg, device):
    el0 = np.deg2rad(fov_down_deg)
    el1 = np.deg2rad(fov_up_deg)
    return el0, el1, _runtime.const(
        [-np.pi, el0, 2 * np.pi / w, (el1 - el0) / h], torch.float32, device)


def build_spherical_range_image(points_C, colors, resolution,
                                fov_up_deg=25.0, fov_down_deg=-25.0):
    """Spherical (azimuth/elevation) binning of unordered clouds [..., N,
    3] (e.g. velodyne): scatter-min as the pinhole builder."""
    w, h = resolution
    el0, el1, params = _spherical_params(w, h, fov_up_deg, fov_down_deg,
                                         points_C.device)
    r = _norm(points_C)
    valid = r > 1e-3
    az = torch.atan2(points_C[..., 1], points_C[..., 0])
    el = torch.asin(points_C[..., 2] / torch.clamp(r, min=1e-6))
    daz = 2 * np.pi / w
    dele = (el1 - el0) / h
    u = _f2i(torch.floor((az + np.pi) / daz))
    v = _f2i(torch.floor((el - el0) / dele))
    inb = valid & (u >= 0) & (u < w) & (v >= 0) & (v < h)
    rng, color = _bin(points_C, colors, v.to(torch.int64) * w + u, inb, h, w)
    return RangeImage(rng=rng, color=color, params=params, kind="spherical")


def build_spherical_range_image_organized(points_C, colors, resolution,
                                          fov_up_deg=25.0,
                                          fov_down_deg=-25.0):
    """Scatter-free binning of raster-ordered spinning-lidar scans
    [..., H*W, 3] (point v*W + u is beam row v's return at azimuth bin u;
    no-return points are 0): a norm and a reshape."""
    w, h = resolution
    _, _, params = _spherical_params(w, h, fov_up_deg, fov_down_deg,
                                     points_C.device)
    lead = points_C.shape[:-2]
    r = _norm(points_C)
    valid = r > 1e-3
    rng = torch.where(valid, r, _INF).reshape(lead + (h, w))
    color = torch.where(valid[..., None], colors, 0.0).reshape(
        lead + (h, w, 3))
    return RangeImage(rng=rng, color=color, params=params, kind="spherical")


def build_pinhole_range_image_organized(points_C, colors, pool: int,
                                        intrinsics):
    """Bin raster-ordered [..., H, W, 3] clouds by exact ``pool x pool``
    min-pooling; the first minimum in raster order gives the colour."""
    h, w, _ = points_C.shape[-3:]
    lead = points_C.shape[:-3]
    assert h % pool == 0 and w % pool == 0, (
        f"pool={pool} must divide the organized image shape ({h}, {w})")
    fx, fy, cx, cy = intrinsics
    hv, wv = h // pool, w // pool
    r = _norm(points_C)
    valid = points_C[..., 2] > 1e-3
    r = torch.where(valid, r, _INF)
    if pool == 1:
        rng, cols = r, colors
    else:
        rr = r.reshape(lead + (hv, pool, wv, pool))
        cc = colors.reshape(lead + (hv, pool, wv, pool, 3))
        rng = torch.amin(rr, dim=(-3, -1))
        cols = torch.zeros(lead + (hv, wv, 3), dtype=colors.dtype,
                           device=colors.device)
        taken = torch.zeros(lead + (hv, wv), dtype=torch.bool,
                            device=colors.device)
        for i in range(pool):
            for j in range(pool):
                win = (rr[..., :, i, :, j] == rng) & ~taken
                cols = torch.where(win[..., None], cc[..., :, i, :, j, :],
                                   cols)
                taken = taken | win
    params = _runtime.const(
        [fx / pool, fy / pool, (cx - (pool - 1) / 2.0) / pool,
         (cy - (pool - 1) / 2.0) / pool], torch.float32, points_C.device)
    return RangeImage(rng=rng,
                      color=torch.where(torch.isfinite(rng)[..., None],
                                        cols, 0.0),
                      params=params, kind="pinhole")


def _project(img: RangeImage, p_C):
    """Sensor-frame points [...,3] -> (u, v, range, in_front)."""
    if img.kind == "pinhole":
        fx, fy, cx, cy = (img.params[0], img.params[1], img.params[2],
                          img.params[3])
        z = p_C[..., 2]
        zs = torch.clamp(z, min=1e-6)
        u = p_C[..., 0] / zs * fx + cx
        v = p_C[..., 1] / zs * fy + cy
        return u, v, _norm(p_C), z > 1e-3
    az0, el0, daz, dele = (img.params[0], img.params[1], img.params[2],
                           img.params[3])
    r = _norm(p_C)
    az = torch.atan2(p_C[..., 1], p_C[..., 0])
    el = torch.asin(p_C[..., 2] / torch.clamp(r, min=1e-6))
    u = (az - az0) / daz - 0.5
    v = (el - el0) / dele - 0.5
    return u, v, r, r > 1e-3


# ---------------------------------------------------------------------------
# Candidate blocks and the HiZ pyramid
# ---------------------------------------------------------------------------


def _candidate_blocks(layer, img, R, t, cfg, hiz=None):
    """Local grid of blocks around the sensor, masked to those whose
    (margin-inflated) projection lands in the image within range and, with
    ``hiz``, that some return in their footprint can update."""
    dev = R.device
    bs = layer.block_size
    reach = min(cfg.max_ray_length_m, 100.0) + cfg.default_truncation_distance
    rad = int(np.ceil(reach / bs))
    ar = torch.arange(-rad, rad + 1, dtype=torch.int32, device=dev)
    cand_offs = torch.stack(torch.meshgrid(ar, ar, ar, indexing="ij"),
                            -1).reshape(-1, 3)
    center_block = grid.point_to_grid_index(t[None, :], 1.0 / bs)[0]
    cand = center_block[None, :] + cand_offs
    centers = (cand.to(torch.float32) + 0.5) * bs
    p_C = (centers - t) @ R
    u, v, r, front = _project(img, p_C)
    h, w = img.rng.shape
    margin_m = bs * float(np.sqrt(3)) / 2.0
    if img.kind == "pinhole":
        # Footprint of a margin_m sphere: focal/depth, bounded through the
        # secant kappa of the corner view angle (see the JAX module).
        fx, fy, cx, cy = (img.params[0], img.params[1], img.params[2],
                          img.params[3])
        f = torch.maximum(fx, fy)
        kappa = torch.sqrt(
            1.0
            + ((torch.maximum(cx, w - cx) + 1.0) / fx) ** 2
            + ((torch.maximum(cy, h - cy) + 1.0) / fy) ** 2
        )
        pix_margin = kappa * f * margin_m / torch.clamp(r - margin_m,
                                                        min=1e-3)
    else:
        pix_margin = (margin_m / torch.clamp(r - margin_m, min=1e-3)
                      / img.params[2])
    ok = (
        (front | (r < 2 * margin_m))
        & (r < reach + margin_m)
        & (u > -pix_margin - 1)
        & (u < w + pix_margin)
        & (v > -pix_margin - 1)
        & (v < h + pix_margin)
    )
    if hiz is not None:
        trunc = cfg.default_truncation_distance
        q0u = torch.clamp(_f2i(torch.floor(u - pix_margin)), 0, w - 1)
        q1u = torch.clamp(_f2i(torch.ceil(u + pix_margin)), 0, w - 1)
        q0v = torch.clamp(_f2i(torch.floor(v - pix_margin)), 0, h - 1)
        q1v = torch.clamp(_f2i(torch.ceil(v + pix_margin)), 0, h - 1)
        _, foot_lo_band, foot_hi = _hiz_query(hiz, q0u, q1u, q0v, q1v)
        updatable = foot_hi > -1e30
        not_behind = torch.clamp(r - margin_m, min=0.0) <= (
            foot_hi + 2 * trunc + layer.voxel_size)
        if not cfg.voxel_carving_enabled:
            updatable &= (r + margin_m + 2 * trunc + layer.voxel_size
                          >= foot_lo_band)
        classifiable = front & (r > 2 * margin_m)
        ok &= ~classifiable | (updatable & not_behind)
    return cand, ok


def _pix_eff(img: RangeImage, cfg):
    """Per-pixel effective range: beyond-max returns clear to
    max_ray - trunc (with allow_clear), no-return pixels are -inf."""
    trunc = cfg.default_truncation_distance
    clear_depth = cfg.max_ray_length_m - trunc
    fin = torch.isfinite(img.rng)
    if cfg.allow_clear:
        return torch.where(
            fin, torch.where(img.rng > cfg.max_ray_length_m, clear_depth,
                             img.rng), -_INF)
    return torch.where(fin & (img.rng <= cfg.max_ray_length_m), img.rng,
                       -_INF)


def _hiz_tables(pix_eff):
    """Min/max mip chain of effective-range images [..., H, W]
    (anisotropic for skewed images): (flat f32[..., N, 4] texels (lo,
    lo_band, hi, 0), int32 meta [(A+1)*(B+1), 4] = (offset, width, eff_a,
    eff_b), (A, B)). The meta depends on the shape only."""
    h, w = pix_eff.shape[-2:]
    lead = pix_eff.shape[:-2]
    a_max = max(1, int(np.ceil(np.log2(w))))
    b_max = max(1, int(np.ceil(np.log2(h))))
    aniso = w >= 4 * h or h >= 4 * w
    lo0 = pix_eff
    band0 = torch.where(torch.isfinite(pix_eff), pix_eff, _INF)
    hi0 = pix_eff

    def half(x, axis, init, op):  # axis -2 (rows) or -1 (columns)
        n = x.shape[axis]
        if n == 1:
            return x
        if n % 2:
            shape = list(x.shape)
            shape[axis] = 1
            x = torch.cat([x, torch.full(shape, init, dtype=x.dtype,
                                         device=x.device)], dim=axis)
        if axis == -2:
            x = x.reshape(x.shape[:-2] + (x.shape[-2] // 2, 2, x.shape[-1]))
            return op(x, dim=-2)
        x = x.reshape(x.shape[:-1] + (x.shape[-1] // 2, 2))
        return op(x, dim=-1)

    def half2(t, axis):
        return (half(t[0], axis, _INF, torch.amin),
                half(t[1], axis, _INF, torch.amin),
                half(t[2], axis, -_INF, torch.amax))

    flats = []
    n_pairs = (a_max + 1) * (b_max + 1)
    meta = np.zeros((n_pairs, 4), np.int32)
    off = 0

    def emit(t, ea, eb):
        nonlocal off
        lo_r, band_r, hi_r = t
        flats.append(torch.stack([lo_r, band_r, hi_r, torch.zeros_like(hi_r)],
                                 -1).reshape(lead + (-1, 4)))
        entry = (off, lo_r.shape[-1], ea, eb)
        off += lo_r.shape[-2] * lo_r.shape[-1]
        return entry

    if aniso:
        col = (lo0, band0, hi0)
        for b in range(b_max + 1):
            row = col
            for a in range(a_max + 1):
                meta[b * (a_max + 1) + a] = emit(row, a, b)
                row = half2(row, -1)
            col = half2(col, -2)
    else:
        cur = (lo0, band0, hi0)
        diag = []
        for m in range(max(a_max, b_max) + 1):
            diag.append(emit(cur, m, m))
            cur = half2(half2(cur, -2), -1)
        for b in range(b_max + 1):
            for a in range(a_max + 1):
                meta[b * (a_max + 1) + a] = diag[max(a, b)]
    return (torch.cat(flats, -2),
            _runtime.const(meta, torch.int32, pix_eff.device),
            (a_max, b_max))


def _hiz_query(hiz, p0u, p1u, p0v, p1v):
    """Conservative (min, min_band, max) of pix_eff over int pixel boxes
    [p0, p1]: at per-axis level ceil(log2(span)) 4 taps cover the box."""
    flat, meta, (a_max, b_max) = hiz

    def level(span, cap):
        # floor(log2(span)) + 1 exactly, from the float exponent (the JAX
        # float log2 is exact on these integers; a test holds it so).
        e = torch.frexp(torch.clamp(span, min=1).to(torch.float32)).exponent
        return torch.clamp(torch.where(span <= 0, 0, e), 0, cap)

    la = level(p1u - p0u, a_max)
    lb = level(p1v - p0v, b_max)
    m = meta[(lb * (a_max + 1) + la).to(torch.int64)]
    o, lw, ea, eb = m[..., 0], m[..., 1], m[..., 2], m[..., 3]
    t0u = p0u >> ea
    t1u = p1u >> ea
    t0v = p0v >> eb
    t1v = p1v >> eb
    idx = torch.stack([o + t0v * lw + t0u, o + t0v * lw + t1u,
                       o + t1v * lw + t0u, o + t1v * lw + t1u], dim=-1)
    taps = flat[idx.to(torch.int64)]
    return (torch.amin(taps[..., 0], -1), torch.amin(taps[..., 1], -1),
            torch.amax(taps[..., 2], -1))


# ---------------------------------------------------------------------------
# Slab classification
# ---------------------------------------------------------------------------


def _slab_shape(vps: int):
    """(ys, n_y_halves, n_slabs, slab_vox): slabs are (1 z-plane, ys
    y-rows, vps x) runs of ~128 voxels."""
    ys = min(vps, max(1, 128 // vps))
    n_yh = vps // ys
    return ys, n_yh, vps * n_yh, ys * vps


def _classify_slabs(layer, safe_rows, row_ok, R, t, img, hiz, cfg):
    """FREE/SKIP/MIXED per slab + per-slab footprint-min range estimate:
    (free, mixed bool[B, n_slabs], z_est f32[B, n_slabs])."""
    dev = R.device
    v = layer.vps
    ys, n_yh, n_slabs, _ = _slab_shape(v)
    bs = layer.block_size
    voxel = layer.voxel_size
    trunc = cfg.default_truncation_distance
    h, w = img.rng.shape
    margin = voxel
    f32 = dict(dtype=torch.float32, device=dev)

    ijk = layer.block_ijk[safe_rows].to(torch.float32)
    origin = ijk * bs
    xl = _runtime.const([0.0, float(v)], torch.float32, dev) * voxel
    yl = torch.arange(n_yh + 1, **f32) * (ys * voxel)
    zl = torch.arange(v + 1, **f32) * voxel
    lat = torch.stack(torch.meshgrid(zl, yl, xl, indexing="ij"), -1)
    lat_xyz = torch.stack([lat[..., 2], lat[..., 1], lat[..., 0]], -1)
    pts = origin[:, None, None, None, :] + lat_xyz[None]
    p_C = (pts - t) @ R

    def slab_corners(x):  # [B, v+1, n_yh+1, 2] -> [B, v, n_yh, 8]
        return torch.stack([
            x[:, :-1, :-1, 0], x[:, :-1, :-1, 1],
            x[:, :-1, 1:, 0], x[:, :-1, 1:, 1],
            x[:, 1:, :-1, 0], x[:, 1:, :-1, 1],
            x[:, 1:, 1:, 0], x[:, 1:, 1:, 1],
        ], dim=-1)

    r_hi = torch.amax(slab_corners(_norm(p_C)), -1)
    zz = torch.arange(v, **f32)[None, :, None]
    yy = torch.arange(n_yh, **f32)[None, None, :]
    box_lo = torch.stack([
        origin[:, 0, None, None].expand(r_hi.shape),
        (origin[:, 1, None, None] + yy * (ys * voxel)).expand(r_hi.shape),
        (origin[:, 2, None, None] + zz * voxel).expand(r_hi.shape),
    ], -1)
    box_hi = box_lo + _runtime.const([v * voxel, ys * voxel, voxel],
                                     torch.float32, dev)
    r_lo = _norm(torch.minimum(torch.maximum(t, box_lo), box_hi) - t)

    if img.kind == "pinhole":
        fx, fy, cx, cy = (img.params[0], img.params[1], img.params[2],
                          img.params[3])
        zc = p_C[..., 2]
        zcs = torch.clamp(zc, min=1e-6)
        cu = slab_corners(p_C[..., 0] / zcs * fx + cx)
        cv = slab_corners(p_C[..., 1] / zcs * fy + cy)
        u0, u1 = torch.amin(cu, -1), torch.amax(cu, -1)
        v0, v1 = torch.amin(cv, -1), torch.amax(cv, -1)
        # Perspective hull containment needs the whole box in front.
        classifiable = torch.all(slab_corners(zc) > 1e-3, -1)
    else:
        # Anisotropic angular footprint from the slab's sensor-frame
        # corners: azimuth extremes at corner vertices (guarded against
        # the +-pi seam and a sensor inside the xy shadow); elevation from
        # the corner z extremes against conservative rho bounds.
        az0, el0, daz, dele = (img.params[0], img.params[1], img.params[2],
                               img.params[3])
        cxs = slab_corners(p_C[..., 0])
        cys = slab_corners(p_C[..., 1])
        czs = slab_corners(p_C[..., 2])
        z_lo, z_hi = torch.amin(czs, -1), torch.amax(czs, -1)
        x_lo, x_hi = torch.amin(cxs, -1), torch.amax(cxs, -1)
        y_lo, y_hi = torch.amin(cys, -1), torch.amax(cys, -1)
        rho_hi = torch.amax(torch.hypot(cxs, cys), -1)
        rho_lo = torch.hypot(
            torch.clamp(torch.maximum(x_lo, -x_hi), min=0.0),
            torch.clamp(torch.maximum(y_lo, -y_hi), min=0.0))
        az_cor = torch.atan2(cys, cxs)
        az_lo, az_hi = torch.amin(az_cor, -1), torch.amax(az_cor, -1)
        classifiable = (rho_lo > 1e-6) & (az_hi - az_lo < np.pi)
        el_hi = torch.maximum(torch.atan2(z_hi, rho_lo),
                              torch.atan2(z_hi, rho_hi))
        el_lo = torch.minimum(torch.atan2(z_lo, rho_lo),
                              torch.atan2(z_lo, rho_hi))
        ua = (az_lo - az0) / daz - 0.5
        ub = (az_hi - az0) / daz - 0.5
        va = (el_lo - el0) / dele - 0.5
        vb = (el_hi - el0) / dele - 0.5
        u0, u1 = torch.minimum(ua, ub), torch.maximum(ua, ub)
        v0, v1 = torch.minimum(va, vb), torch.maximum(va, vb)

    p0u = _f2i(torch.floor(u0 + 0.5))
    p1u = _f2i(torch.floor(u1 + 0.5))
    p0v = _f2i(torch.floor(v0 + 0.5))
    p1v = _f2i(torch.floor(v1 + 0.5))
    outside = (p1u < 0) | (p0u > w - 1) | (p1v < 0) | (p0v > h - 1)
    infl = 1 if cfg.voxel_carving_enabled else 0
    q0u = torch.clamp(p0u - infl, 0, w - 1)
    q1u = torch.clamp(p1u + infl, 0, w - 1)
    q0v = torch.clamp(p0v - infl, 0, h - 1)
    q1v = torch.clamp(p1v + infl, 0, h - 1)
    foot_lo, foot_lo_band, foot_hi = _hiz_query(hiz, q0u, q1u, q0v, q1v)

    classifiable &= row_ok[:, None, None]
    free = (classifiable & ~outside
            & (foot_lo > r_hi + trunc + margin)
            & (foot_lo > cfg.min_ray_length_m + trunc))
    skip = ((classifiable & (r_lo > foot_hi + 2 * trunc + margin))
            | (classifiable & outside))
    if not cfg.voxel_carving_enabled:
        skip |= classifiable & (r_hi + 2 * trunc + margin < foot_lo_band)
    mixed = row_ok[:, None, None] & ~free & ~skip
    z_est = torch.clamp(foot_lo, cfg.min_ray_length_m, cfg.max_ray_length_m)
    shape = (safe_rows.shape[0], n_slabs)
    return free.reshape(shape), mixed.reshape(shape), z_est.reshape(shape)


# ---------------------------------------------------------------------------
# Per-scan update terms
# ---------------------------------------------------------------------------


def _feat_image(img: RangeImage, trunc, carving: bool = True):
    """Planar per-pixel features [..., C, H*W] of images [..., H, W]:
    range, (3x3-min range), du, dv, r, g, b. Gradients (clamped to |g| <
    trunc, zeroed across discontinuities) and colours are rounded through
    float16 exactly where the JAX module packs them as f16 pairs."""
    rng = img.rng
    h, w = rng.shape[-2:]
    lead = rng.shape[:-2]
    chans = [rng]
    if carving:
        chans.append(-F.max_pool2d(-rng.reshape(-1, 1, h, w), 3, stride=1,
                                   padding=1).reshape(rng.shape))
    rpad = F.pad(rng, (1, 1, 1, 1), value=_INF)
    d_up = rpad[..., 1:-1, 2:] - rng
    d_um = rng - rpad[..., 1:-1, :-2]
    d_vp = rpad[..., 2:, 1:-1] - rng
    d_vm = rng - rpad[..., :-2, 1:-1]

    def clamp_grad(a, b):
        ok_a = torch.isfinite(a) & (a.abs() < trunc)
        ok_b = torch.isfinite(b) & (b.abs() < trunc)
        return torch.where(ok_a & ok_b, 0.5 * (a + b),
                           torch.where(ok_a, a, torch.where(ok_b, b, 0.0)))

    def f16(x):
        return x.to(torch.float16).to(torch.float32)

    chans += [f16(clamp_grad(d_up, d_um)), f16(clamp_grad(d_vp, d_vm))]
    chans += [f16(img.color[..., c]) for c in range(3)]
    return torch.stack(chans, -3).reshape(lead + (len(chans), h * w))


def _discover_and_allocate(layer, img, R, t, cfg, hiz,
                           max_visible_blocks: int, allocate: bool):
    """Candidate discovery, compaction and allocation: (layer, cand, c_ok,
    pool_ovf, budget_ovf)."""
    cand, ok = _candidate_blocks(layer, img, R, t, cfg, hiz=hiz)
    n_cand = cand.shape[0]
    max_cand = min(2 * max_visible_blocks, n_cand)
    cidx = compact_ids(ok, max_cand, fill=n_cand)
    c_ok = cidx < n_cand
    cand = cand[torch.where(c_ok, cidx, 0).to(torch.int64)]
    budget_ovf = ok.sum() > max_cand
    pool_ovf = torch.zeros((), dtype=torch.bool, device=R.device)
    if allocate:
        layer, pool_ovf = vlayer.allocate_blocks(layer, cand, c_ok)
    return layer, cand, c_ok, pool_ovf, budget_ovf


def _scan_terms(layer, R, t, img: RangeImage, cfg, use_color: bool,
                max_visible_blocks: int, max_mixed_slabs, feat=None,
                hiz=None, max_free_slabs=None, allocate: bool = True,
                acc=None):
    """Allocate + classify + one scan's weighted-update deltas over the
    compacted visible rows: (layer, rows, row_ok, d6 [B, n_slabs,
    n_ch*slab_vox], (pool_ovf, budget_ovf)). Planes of d6: 0 sum w,
    1 sum w*sdf, 2 sum colour weight, 3-5 sum cw*r/g/b.

    ``feat``/``hiz``: this image's precomputed ``_feat_image`` /
    ``_hiz_tables`` (the batch path builds them for all scans at once).
    ``allocate=False`` only looks blocks up. ``acc``: a batch accumulator
    (``_batch_acc_init``); contributions then add straight into it at
    pool-slab rows and the updated accumulator is returned in place of
    d6."""
    dev = R.device
    if hiz is None:
        hiz = _hiz_tables(_pix_eff(img, cfg))
    layer, cand, c_ok, pool_ovf, budget_ovf = _discover_and_allocate(
        layer, img, R, t, cfg, hiz, max_visible_blocks, allocate)
    mb = layer.max_blocks

    slots = vlayer.lookup_blocks(layer, cand)
    sel = torch.where(c_ok, slots, -1)
    # The JAX scatter also sends the non-visible lanes to row 0 (value
    # False), and the last writer wins; keep that exact rule.
    tgt = torch.where(sel >= 0, sel, 0).to(torch.int64)
    win = _last_lane(mb, tgt, torch.ones_like(c_ok))
    vis_mask = (win >= 0) & (sel >= 0)[torch.clamp(win, min=0)]
    budget_ovf = budget_ovf | (vis_mask.sum() > max_visible_blocks)
    rows = compact_ids(vis_mask, max_visible_blocks, fill=-1)
    row_ok = rows >= 0
    safe_rows = torch.where(row_ok, rows, 0).to(torch.int64)

    v = layer.vps
    ys, n_yh, n_slabs, slab_vox = _slab_shape(v)
    B = max_visible_blocks
    if max_mixed_slabs is None:
        max_mixed_slabs = B * n_slabs
    h, w = img.rng.shape
    trunc = cfg.default_truncation_distance
    clear_depth = cfg.max_ray_length_m - trunc

    free_s, mixed_s, z_est = _classify_slabs(
        layer, safe_rows, row_ok, R, t, img, hiz, cfg)

    lane = torch.arange(slab_vox, dtype=torch.int32, device=dev)
    lane_x = lane % v
    lane_y = lane // v

    def slab_voxel_proj(ids, ok):
        b = torch.where(ok, ids // n_slabs, 0).to(torch.int64)
        s = torch.where(ok, ids % n_slabs, 0)
        z = s // n_yh
        yh = s % n_yh
        base = layer.block_ijk[safe_rows[b]] * v
        gx = base[:, 0, None] + lane_x[None]
        gy = base[:, 1, None] + yh[:, None] * ys + lane_y[None]
        gz = (base[:, 2, None] + z[:, None]).expand(gx.shape)
        gvi = torch.stack([gx, gy, gz], -1)
        centers = grid.grid_index_to_center_point(gvi, layer.voxel_size)
        p_C = (centers - t) @ R
        u, vv_, r_vox, front = _project(img, p_C)
        ui = _f2i(torch.round(u))
        vi = _f2i(torch.round(vv_))
        inb = (front & (ui >= 0) & (ui < w) & (vi >= 0) & (vi < h)
               & ok[:, None])
        return p_C, u, vv_, r_vox, ui, vi, inb

    n_all = B * n_slabs
    n_ch = 6 if use_color else 2
    if acc is None:
        # Row n_all is the dump row for dropped slab lanes.
        d6 = torch.zeros((n_all + 1, n_ch * slab_vox), dtype=torch.float32,
                         device=dev)

        def to_addr(ids, ok):
            return torch.where(ok, ids, n_all).to(torch.int64)
    else:
        d6 = acc
        n_lim = mb * n_slabs  # the accumulator's dump row

        def to_addr(ids, ok):
            # Visible-set slab id -> pool-domain slab id.
            b = torch.where(ok, ids // n_slabs, 0).to(torch.int64)
            return torch.where(ok, safe_rows[b] * n_slabs + ids % n_slabs,
                               n_lim).to(torch.int64)

    if cfg.voxel_carving_enabled:
        free_flat = free_s.reshape(-1)
        mfs = n_all if max_free_slabs is None else max_free_slabs
        free_ids = compact_ids(free_flat, mfs, fill=n_all)
        free_ok = free_ids < n_all
        budget_ovf = budget_ovf | (free_flat.sum() > mfs)
        inb_f = slab_voxel_proj(free_ids, free_ok)[-1]
        if cfg.use_const_weight:
            wf = torch.where(inb_f, 1.0, 0.0)
        else:
            zf = z_est.reshape(-1)[torch.where(free_ok, free_ids, 0)
                                   .to(torch.int64)]
            wf = torch.where(
                inb_f, (1.0 / torch.clamp(zf * zf, min=1e-6))[:, None], 0.0)
        vals_f = torch.cat([wf, trunc * wf]
                           + [torch.zeros_like(wf)] * (n_ch - 2), -1)
        d6.index_add_(0, to_addr(free_ids, free_ok), vals_f)

    mixed_flat = mixed_s.reshape(-1)
    slab_ids = compact_ids(mixed_flat, max_mixed_slabs, fill=n_all)
    slab_valid = slab_ids < n_all
    budget_ovf = budget_ovf | (mixed_flat.sum() > max_mixed_slabs)
    p_C_m, u_m, v_m, r_m, ui_m, vi_m, inb_m = slab_voxel_proj(
        slab_ids, slab_valid)

    carving = cfg.voxel_carving_enabled
    if feat is None:
        feat = _feat_image(img, trunc, carving=carving)
    # Out-of-image voxels read nothing: range channels +inf, the others 0
    # (the JAX gather's fill, after its unpack-and-clean step).
    pix = torch.where(inb_m, vi_m.to(torch.int64) * w + ui_m, 0)
    g = feat[:, pix]
    base = 2 if carving else 1
    r_nearest = torch.where(inb_m, g[0], _INF)
    r_min = torch.where(inb_m, g[1], _INF) if carving else r_nearest
    du, dv = (torch.where(inb_m, g[base + i], 0.0) for i in range(2))
    pix_color3 = [torch.where(inb_m, g[base + 2 + c], 0.0) for c in range(3)]
    r_img = r_nearest + du * (u_m - ui_m) + dv * (v_m - vi_m)

    def effective(r):
        has_ret = torch.isfinite(r)
        beyond = has_ret & (r > cfg.max_ray_length_m)
        surf = has_ret & ~beyond
        if cfg.allow_clear:
            return torch.where(surf, r, torch.where(beyond, clear_depth,
                                                    -_INF)), surf
        return torch.where(surf, r, -_INF), surf

    eff_range, has_surface = effective(r_img)
    eff_min, _ = effective(r_min)
    too_close = eff_range < cfg.min_ray_length_m
    sdf = eff_range - r_m
    sdf_carve = eff_min - r_m
    in_band = has_surface & (sdf.abs() < trunc)
    free = sdf_carve >= trunc
    upd = inb_m & ~too_close & (in_band | free)
    sdf = torch.where(in_band, sdf, torch.clamp(sdf, min=trunc))
    if not cfg.voxel_carving_enabled:
        upd = upd & in_band

    if cfg.use_const_weight:
        w0 = torch.ones_like(sdf)
    else:
        if img.kind == "pinhole":
            cos_theta = p_C_m[..., 2] / torch.clamp(r_m, min=1e-6)
            z_surf = eff_range * cos_theta
        else:
            z_surf = eff_range
        w0 = 1.0 / torch.clamp(z_surf * z_surf, min=1e-6)
    if cfg.use_weight_dropoff:
        dropoff_eps = layer.voxel_size
        ramp = (trunc + sdf) / (trunc - dropoff_eps)
        w0 = torch.where(sdf < -dropoff_eps, torch.clamp(w0 * ramp, min=0.0),
                         w0)
    if cfg.use_sparsity_compensation_factor:
        w0 = torch.where(sdf.abs() < trunc,
                         w0 * cfg.sparsity_compensation_factor, w0)
    w0 = torch.where(upd, w0, 0.0)
    sdf_c = torch.clamp(sdf, -trunc, trunc)

    planes = [w0, w0 * sdf_c]
    if use_color:
        cw = torch.where((w0 > 0) & (sdf.abs() < trunc) & has_surface, w0,
                         0.0)
        planes += [cw] + [cw * pc for pc in pix_color3]
    d6.index_add_(0, to_addr(slab_ids, slab_valid), torch.cat(planes, -1))
    if acc is not None:
        return layer, rows, row_ok, d6, (pool_ovf, budget_ovf)
    return (layer, rows, row_ok,
            d6[:n_all].reshape(B, n_slabs, n_ch * slab_vox),
            (pool_ovf, budget_ovf))


def _delta_plane(d6, c, slab_vox):
    """Channel-c plane of a [.., n_slabs, n_ch*slab_vox] delta buffer ->
    [.., vpb] in flat voxel order."""
    plane = d6[..., c * slab_vox:(c + 1) * slab_vox]
    return plane.reshape(plane.shape[:-2] + (-1,))


def _integrate_image(layer, R, t, img: RangeImage, cfg: TsdfIntegratorConfig,
                     use_color: bool, max_visible_blocks: int,
                     max_mixed_slabs, max_free_slabs=None):
    """Classify, accumulate and fold one scan into the running averages
    (updateTsdfVoxel, tsdf_integrator.cc:186-208). TRANSACTIONAL: on any
    overflow nothing but the (idempotent) allocation is applied.
    Returns (layer, pool_ovf, budget_ovf) as device booleans."""
    layer, rows, row_ok, d6, (pool_ovf, budget_ovf) = _scan_terms(
        layer, R, t, img, cfg, use_color, max_visible_blocks,
        max_mixed_slabs, max_free_slabs=max_free_slabs)
    apply_ok = ~(pool_ovf | budget_ovf)
    trunc = cfg.default_truncation_distance
    safe_rows = torch.where(row_ok, rows, 0).to(torch.int64)
    vpb = layer.voxels_per_block
    slab_vox = _slab_shape(layer.vps)[3]
    B = d6.shape[0]
    d_w = _delta_plane(d6, 0, slab_vox).reshape(B, vpb)
    d_wd = _delta_plane(d6, 1, slab_vox).reshape(B, vpb)
    ch = layer.channels
    old_d = ch["tsdf"][safe_rows]
    old_w = ch["weight"][safe_rows]
    new_w_raw = old_w + d_w
    new_d = torch.clamp((old_d * old_w + d_wd)
                        / torch.clamp(new_w_raw, min=grid.FLOAT_EPS),
                        -trunc, trunc)
    touched = (d_w > 0.0) & apply_ok
    out_d = torch.where(touched, new_d, old_d)
    out_w = torch.where(touched, torch.clamp(new_w_raw, max=cfg.max_weight),
                        old_w)
    if use_color:
        old_cf = ch["color"][safe_rows]
        d_cw = _delta_plane(d6, 2, slab_vox).reshape(B, vpb)
        denom_c = torch.clamp(old_w + d_cw, min=grid.FLOAT_EPS)
        ctouched = (d_cw > 0) & apply_ok
        planes = [
            torch.where(
                ctouched,
                (old_cf[:, c::3] * old_w
                 + _delta_plane(d6, 3 + c, slab_vox).reshape(B, vpb))
                / denom_c,
                old_cf[:, c::3])
            for c in range(3)
        ]
        vlayer.put_rows(ch["color"], rows, row_ok,
                        torch.stack(planes, -1).reshape(B, vpb * 3))
    vlayer.put_rows(ch["tsdf"], rows, row_ok, out_d)
    vlayer.put_rows(ch["weight"], rows, row_ok, out_w)
    row_touched = touched.any(-1)
    vlayer.put_rows(layer.block_flags, rows, row_ok & row_touched,
                    torch.full_like(rows, vlayer.ACTIVE | vlayer.DIRTY_ALL))
    return layer, pool_ovf, budget_ovf


def _pose(T_G_C, device):
    if isinstance(T_G_C, tuple):
        R, t = T_G_C
    else:
        T = torch.as_tensor(T_G_C, dtype=torch.float32)
        R, t = T[:3, :3], T[:3, 3]
    return (torch.as_tensor(R, dtype=torch.float32, device=device),
            torch.as_tensor(t, dtype=torch.float32, device=device))


def integrate_range_image(layer, T_G_C, img: RangeImage,
                          cfg: TsdfIntegratorConfig, use_color: bool = True,
                          max_visible_blocks: int = 512,
                          max_mixed_slabs: int | None = None,
                          max_free_slabs: int | None = None):
    """Integrate a pre-binned range image: (layer, pool_ovf, budget_ovf)."""
    R, t = _pose(T_G_C, layer.device)
    return _integrate_image(layer, R, t, img, cfg, use_color,
                            max_visible_blocks, max_mixed_slabs,
                            max_free_slabs)


def _make_image(points_C, colors, kind, resolution, fov_h_rad,
                fov_up_deg, fov_down_deg):
    if kind == "pinhole":
        return build_pinhole_range_image(points_C, colors, resolution,
                                         fov_h_rad)
    if kind == "spherical_organized":
        return build_spherical_range_image_organized(
            points_C, colors, resolution, fov_up_deg, fov_down_deg)
    if kind == "spherical":
        return build_spherical_range_image(points_C, colors, resolution,
                                           fov_up_deg, fov_down_deg)
    raise ValueError(f"unknown projective kind {kind!r}")


def integrate_pointcloud_projective(
    layer, T_G_C, points_C, colors, cfg: TsdfIntegratorConfig,
    resolution=(320, 240), fov_h_rad: float = float(np.deg2rad(90.0)),
    kind: str = "pinhole", use_color: bool = True,
    max_visible_blocks: int = 512, max_mixed_slabs: int | None = None,
    max_free_slabs: int | None = None,
    fov_up_deg: float = 25.0, fov_down_deg: float = -25.0,
):
    """Point-cloud front end: bin into a range image, then integrate.
    ``kind``: "pinhole", "spherical" (unordered cloud, scatter binning) or
    "spherical_organized" (raster-ordered lidar scan, scatter-free).
    Returns (layer, pool_ovf, budget_ovf); on any overflow the scan's
    value updates were withheld."""
    img = _make_image(points_C, colors, kind, resolution, fov_h_rad,
                      fov_up_deg, fov_down_deg)
    return integrate_range_image(layer, T_G_C, img, cfg, use_color,
                                 max_visible_blocks, max_mixed_slabs,
                                 max_free_slabs)


def integrate_organized_projective(
    layer, T_G_C, points_C, colors, cfg: TsdfIntegratorConfig, intrinsics,
    pool: int = 2, use_color: bool = True, max_visible_blocks: int = 512,
    max_mixed_slabs: int | None = None, max_free_slabs: int | None = None,
):
    """Organized-cloud front end (points_C f32[H, W, 3] raster-ordered):
    min-pool binning, then integrate."""
    img = build_pinhole_range_image_organized(points_C, colors, pool,
                                              intrinsics)
    return integrate_range_image(layer, T_G_C, img, cfg, use_color,
                                 max_visible_blocks, max_mixed_slabs,
                                 max_free_slabs)


# ---------------------------------------------------------------------------
# Batched multi-scan integration
# ---------------------------------------------------------------------------
#
# The fused update accumulates (sum w, sum w*sdf, ...) and renormalizes,
# so K scans in one call equal K sequential calls but for the max_weight
# clamp, which applies per batch. Unlike the single-scan path the batch
# is not transactional: it folds whatever it accumulated and returns the
# overflow flag.


def _batch_acc_init(layer, use_color: bool):
    """Zero batch accumulator in the pool-slab domain: [(mb + 1) *
    n_slabs, n_ch * slab_vox]; rows from mb * n_slabs on are the dump
    (one pool row's worth, so a [mb + 1, n_slabs, ...] view has a dump
    row too)."""
    _, _, n_slabs, slab_vox = _slab_shape(layer.vps)
    n_ch = 6 if use_color else 2
    return torch.zeros(((layer.max_blocks + 1) * n_slabs, n_ch * slab_vox),
                       dtype=torch.float32, device=layer.device)


def _build_batch_images(points_C, colors, cfg, make_img):
    """All K range images, feature tables and HiZ pyramids in one pass
    over [K, ...]: (images [K, H, W], feats [K, C, H*W], hiz flats [K, N,
    4], hiz meta, hiz levels)."""
    img = make_img(points_C, colors)
    feats = _feat_image(img, cfg.default_truncation_distance,
                        carving=cfg.voxel_carving_enabled)
    flats, meta, levels = _hiz_tables(_pix_eff(img, cfg))
    return img, feats, flats, meta, levels


def _fold_batch_acc(layer, geom, acc, cfg, use_color):
    """Fold the batch accumulator into the running averages
    (updateTsdfVoxel, tsdf_integrator.cc:186-208, telescoped over the
    batch) and adopt the batch's allocation from ``geom``."""
    mb = layer.max_blocks
    vpb = layer.voxels_per_block
    _, _, n_slabs, slab_vox = _slab_shape(layer.vps)
    trunc = cfg.default_truncation_distance
    acc = acc[:mb * n_slabs].reshape(mb, n_slabs, -1)
    d_w = _delta_plane(acc, 0, slab_vox)
    d_wd = _delta_plane(acc, 1, slab_vox)
    ch = layer.channels
    old_d, old_w = ch["tsdf"], ch["weight"]
    new_w_raw = old_w + d_w
    touched = d_w > 0.0
    new_d = torch.clamp((old_d * old_w + d_wd)
                        / torch.clamp(new_w_raw, min=grid.FLOAT_EPS),
                        -trunc, trunc)
    out_d = torch.where(touched, new_d, old_d)
    out_w = torch.where(touched, torch.clamp(new_w_raw, max=cfg.max_weight),
                        old_w)
    if use_color:
        d_cw = _delta_plane(acc, 2, slab_vox)
        old_cf = ch["color"]
        denom_c = torch.clamp(old_w + d_cw, min=grid.FLOAT_EPS)
        ctouched = d_cw > 0
        planes = [torch.where(
            ctouched,
            (old_cf[:, c::3] * old_w + _delta_plane(acc, 3 + c, slab_vox))
            / denom_c,
            old_cf[:, c::3]) for c in range(3)]
        ch["color"].copy_(torch.stack(planes, -1).reshape(mb, vpb * 3))
    ch["tsdf"].copy_(out_d)
    ch["weight"].copy_(out_w)
    row_touched = touched.any(-1)
    layer.table = geom.table
    layer.block_ijk = geom.block_ijk
    layer.num_blocks = geom.num_blocks
    layer.block_flags = torch.where(
        row_touched, vlayer.ACTIVE | vlayer.DIRTY_ALL,
        geom.block_flags).to(torch.uint8)
    return layer


def _integrate_batch(layer, Rs, ts, points_C, colors, cfg, use_color,
                     max_visible_blocks, max_mixed_slabs, make_img,
                     max_free_slabs=None):
    """Shared K-scan batch core; make_img(points [K, ...], colors) -> a
    RangeImage of all K images. Returns (layer, overflowed)."""
    dev = layer.device
    mb = layer.max_blocks
    Rs = torch.as_tensor(Rs, dtype=torch.float32, device=dev)
    ts = torch.as_tensor(ts, dtype=torch.float32, device=dev)
    geom = dataclasses.replace(layer, channels={})
    acc = _batch_acc_init(layer, use_color)
    img, feats, hiz_flats, hiz_meta, hiz_lv = _build_batch_images(
        points_C, colors, cfg, make_img)
    # Adding contributions straight into the pool-domain accumulator skips
    # the per-scan visible-set buffer but loses scatter locality: the JAX
    # package takes it only for big pools. The sums are the same.
    direct_acc = mb >= 8192
    _, _, n_slabs, _ = _slab_shape(layer.vps)
    acc3 = acc.view(mb + 1, n_slabs, -1)
    ovf = torch.zeros((), dtype=torch.bool, device=dev)
    for k in range(Rs.shape[0]):
        img_k = RangeImage(rng=img.rng[k], color=img.color[k],
                           params=img.params, kind=img.kind)
        geom, rows, row_ok, d6, (p_o, b_o) = _scan_terms(
            geom, Rs[k], ts[k], img_k, cfg, use_color, max_visible_blocks,
            max_mixed_slabs, feat=feats[k],
            hiz=(hiz_flats[k], hiz_meta, hiz_lv),
            max_free_slabs=max_free_slabs,
            acc=acc if direct_acc else None)
        ovf = ovf | p_o | b_o
        if not direct_acc:
            acc3.index_add_(0, torch.where(row_ok, rows, mb).to(torch.int64),
                            d6)
    return _fold_batch_acc(layer, geom, acc, cfg, use_color), ovf


def integrate_pointcloud_projective_batch(
    layer, Rs, ts, points_C, colors, cfg: TsdfIntegratorConfig,
    resolution=(320, 240), fov_h_rad: float = float(np.deg2rad(90.0)),
    kind: str = "pinhole", use_color: bool = True,
    max_visible_blocks: int = 512, max_mixed_slabs: int | None = None,
    max_free_slabs: int | None = None,
    fov_up_deg: float = 25.0, fov_down_deg: float = -25.0,
):
    """Integrate K posed scans in one call: Rs f32[K,3,3], ts f32[K,3],
    points_C f32[K,N,3], colors f32[K,N,3]; ``kind`` as in
    ``integrate_pointcloud_projective``. Returns (layer, overflowed)."""
    def make_img(pts, cols):
        return _make_image(pts, cols, kind, resolution, fov_h_rad,
                           fov_up_deg, fov_down_deg)
    return _integrate_batch(layer, Rs, ts, points_C, colors, cfg, use_color,
                            max_visible_blocks, max_mixed_slabs, make_img,
                            max_free_slabs=max_free_slabs)


def integrate_organized_projective_batch(
    layer, Rs, ts, points_C, colors, cfg: TsdfIntegratorConfig,
    intrinsics, pool: int = 2, use_color: bool = True,
    max_visible_blocks: int = 512, max_mixed_slabs: int | None = None,
    max_free_slabs: int | None = None,
):
    """Batched organized-cloud integration: points_C f32[K,H,W,3]
    raster-ordered, binned by min-pooling. Returns (layer, overflowed)."""
    def make_img(pts, cols):
        return build_pinhole_range_image_organized(pts, cols, pool,
                                                   intrinsics)
    return _integrate_batch(layer, Rs, ts, points_C, colors, cfg, use_color,
                            max_visible_blocks, max_mixed_slabs, make_img,
                            max_free_slabs=max_free_slabs)
