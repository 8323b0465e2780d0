"""Projective TSDF integration, written plainly: one dense pass over every
voxel of every candidate block of a scan.

The rule is the one the program defines for its projective integrator
(the voxblox projective update with the program's free-space slabs):

- the scan is binned into a range image: an organized H x W cloud by
  exact ``pool x pool`` min-pooling of the ranges, a flat cloud by
  scattering each point to its rounded pinhole pixel (minimum range);
- candidate blocks lie around the sensor within reach, inside the image
  (margin-inflated), and not wholly behind the surface by a min/max
  pyramid (HiZ) of the image;
- a block is cut into slabs of 8 y-rows by 16 x of one z-plane; a slab
  wholly in front of its footprint's nearest return by truncation plus a
  voxel is free (every voxel in the image gets the truncation distance
  at weight 1 / z^2 of that nearest return), a slab wholly behind or
  outside is skipped, and every voxel of any other slab projects to its
  nearest pixel, reads range and gradient there, and updates where it is
  within truncation of the surface or in front of the 3x3-minimum range
  by truncation;
- the voxel's new distance is the weighted mean of its old one and the
  new sample, clamped to truncation; the weight adds up to a cap.

Everything is computed in ``dtype``.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from .store import BlockStore

INF = float("inf")
EPS = 1e-6  # point -> grid index
FLOAT_EPS = 1e-6


def _f2i(x):
    """float -> int32, saturating, NaN -> 0."""
    return (torch.nan_to_num(x.float(), nan=0.0).clamp(-2.0 ** 40, 2.0 ** 40)
            .to(torch.int64).clamp(-2 ** 31, 2 ** 31 - 1).to(torch.int32))


def _norm(x):
    return torch.linalg.vector_norm(x, dim=-1)


class Image:
    """A pinhole range image: rng [H, W] (+inf = no return) and params
    (fx, fy, cx, cy) as 0-d tensors."""

    def __init__(self, rng, params):
        self.rng = rng
        self.fx, self.fy, self.cx, self.cy = params


def organized_image(points, pool, intr, dtype):
    """Exact pool x pool min-pooling of an organized [H, W, 3] cloud."""
    h, w, _ = points.shape
    p = points.to(dtype)
    r = torch.where(p[..., 2] > 1e-3, _norm(p), INF)
    rng = torch.amin(r.reshape(h // pool, pool, w // pool, pool),
                     dim=(1, 3))
    fx, fy, cx, cy = intr
    params = torch.tensor([fx / pool, fy / pool,
                           (cx - (pool - 1) / 2.0) / pool,
                           (cy - (pool - 1) / 2.0) / pool],
                          dtype=torch.float32).to(dtype).to(points.device)
    return Image(rng, params)


def flat_image(points, resolution, fov_deg, dtype):
    """Scatter-min binning of a flat [N, 3] cloud into a W x H pinhole
    image of the given horizontal field of view. The pixel is the
    rounded ``x / z * f + c`` with one rounding of the multiply-add."""
    w, h = resolution
    fx = w / (2.0 * math.tan(math.radians(fov_deg) / 2.0))
    cx, cy = w / 2.0, h / 2.0
    p = points.to(dtype)
    z = p[:, 2]
    zs = torch.clamp(z, min=1e-6)
    if dtype == torch.float32:
        f32 = np.float32
        u = torch.round(((p[:, 0] / zs).double() * float(f32(fx))
                         + float(f32(cx))).float())
        v = torch.round(((p[:, 1] / zs).double() * float(f32(fx))
                         + float(f32(cy))).float())
    else:
        u = torch.round(p[:, 0] / zs * fx + cx)
        v = torch.round(p[:, 1] / zs * fx + cy)
    u, v = _f2i(u), _f2i(v)
    inb = (z > 1e-3) & (u >= 0) & (u < w) & (v >= 0) & (v < h)
    flat = torch.where(inb, v.to(torch.int64) * w + u, h * w)
    rng = torch.full((h * w + 1,), INF, dtype=dtype, device=p.device)
    rng.scatter_reduce_(0, flat, torch.where(inb, _norm(p), INF), "amin")
    params = torch.tensor([fx, fx, cx, cy], dtype=torch.float32).to(
        dtype).to(points.device)
    return Image(rng[:h * w].reshape(h, w), params)


def _project(img, p):
    z = p[..., 2]
    zs = torch.clamp(z, min=1e-6)
    u = p[..., 0] / zs * img.fx + img.cx
    v = p[..., 1] / zs * img.fy + img.cy
    return u, v, _norm(p), z > 1e-3


def _pix_eff(rng, cfg):
    trunc = cfg["default_truncation_distance"]
    clear = cfg["max_ray_length_m"] - trunc
    fin = torch.isfinite(rng)
    return torch.where(fin, torch.where(rng > cfg["max_ray_length_m"],
                                        torch.full_like(rng, clear), rng),
                       -INF)


def _hiz(pix_eff):
    """Min/max pyramid of the effective ranges: per level (lo, band,
    hi), each level halving both axes (an odd axis padded)."""
    h, w = pix_eff.shape
    a_max = max(1, int(np.ceil(np.log2(w))))
    b_max = max(1, int(np.ceil(np.log2(h))))
    assert not (w >= 4 * h or h >= 4 * w), "anisotropic images unsupported"
    levels = []
    cur = (pix_eff, torch.where(torch.isfinite(pix_eff), pix_eff, INF),
           pix_eff)

    def half(x, axis, init, op):
        n = x.shape[axis]
        if n == 1:
            return x
        if n % 2:
            pad = [0, 0, 0, 0]
            pad[1 if axis == 1 else 3] = 1
            x = F.pad(x[None], pad, value=init)[0]
        if axis == 0:
            return op(x.reshape(x.shape[0] // 2, 2, x.shape[1]), 1)
        return op(x.reshape(x.shape[0], x.shape[1] // 2, 2), 2)

    def half2(t, axis):
        return (half(t[0], axis, INF, torch.amin),
                half(t[1], axis, INF, torch.amin),
                half(t[2], axis, -INF, torch.amax))

    for _ in range(max(a_max, b_max) + 1):
        levels.append(cur)
        cur = half2(half2(cur, 0), 1)
    return levels, a_max, b_max


def _hiz_query(hiz, p0u, p1u, p0v, p1v):
    """Conservative (min, min band, max) over pixel boxes [p0, p1]: four
    taps at the level floor(log2(span)) + 1 of the larger span."""
    levels, a_max, b_max = hiz

    def level(span, cap):
        e = torch.frexp(torch.clamp(span, min=1).to(torch.float32)).exponent
        return torch.clamp(torch.where(span <= 0, 0, e), 0, cap)

    lvl = torch.maximum(level(p1u - p0u, a_max), level(p1v - p0v, b_max))
    out_lo = torch.empty(p0u.shape, dtype=levels[0][0].dtype,
                         device=p0u.device)
    out_band = torch.empty_like(out_lo)
    out_hi = torch.empty_like(out_lo)
    for m, (lo, band, hi) in enumerate(levels):
        sel = lvl == m
        if not bool(sel.any()):
            continue
        lw = lo.shape[1]
        cols = [c[sel].to(torch.int64) >> m for c in (p0u, p1u)]
        rows = [r[sel].to(torch.int64) >> m for r in (p0v, p1v)]
        taps = [ry * lw + cx for ry in rows for cx in cols]
        for img, out, op in ((lo, out_lo, torch.minimum),
                             (band, out_band, torch.minimum),
                             (hi, out_hi, torch.maximum)):
            f = img.reshape(-1)
            v = f[taps[0]]
            for t in taps[1:]:
                v = op(v, f[t])
            out[sel] = v
    return out_lo, out_band, out_hi


def candidate_blocks(img, hiz, R, t, cfg, voxel, vps, dtype):
    """Block indices [M, 3] of the scan's candidate blocks."""
    dev = R.device
    bs = voxel * vps
    trunc = cfg["default_truncation_distance"]
    reach = min(cfg["max_ray_length_m"], 100.0) + trunc
    rad = int(np.ceil(reach / bs))
    ar = torch.arange(-rad, rad + 1, dtype=torch.int32, device=dev)
    offs = torch.stack(torch.meshgrid(ar, ar, ar, indexing="ij"),
                       -1).reshape(-1, 3)
    centre = torch.floor(t.float() * (1.0 / bs) + EPS).to(torch.int32)
    cand = centre[None, :] + offs
    centers = ((cand.to(torch.float32) + 0.5) * bs).to(dtype)
    p = (centers - t) @ R
    u, v, r, front = _project(img, p)
    h, w = img.rng.shape
    margin = bs * float(np.sqrt(3)) / 2.0
    f = torch.maximum(img.fx, img.fy)
    kappa = torch.sqrt(1.0
                       + ((torch.maximum(img.cx, w - img.cx) + 1.0)
                          / img.fx) ** 2
                       + ((torch.maximum(img.cy, h - img.cy) + 1.0)
                          / img.fy) ** 2)
    pix_margin = kappa * f * margin / torch.clamp(r - margin, min=1e-3)
    ok = ((front | (r < 2 * margin)) & (r < reach + margin)
          & (u > -pix_margin - 1) & (u < w + pix_margin)
          & (v > -pix_margin - 1) & (v < h + pix_margin))
    q0u = torch.clamp(_f2i(torch.floor(u - pix_margin)), 0, w - 1)
    q1u = torch.clamp(_f2i(torch.ceil(u + pix_margin)), 0, w - 1)
    q0v = torch.clamp(_f2i(torch.floor(v - pix_margin)), 0, h - 1)
    q1v = torch.clamp(_f2i(torch.ceil(v + pix_margin)), 0, h - 1)
    _, _, foot_hi = _hiz_query(hiz, q0u, q1u, q0v, q1v)
    updatable = foot_hi > -1e30
    not_behind = torch.clamp(r - margin, min=0.0) <= (
        foot_hi + 2 * trunc + voxel)
    classifiable = front & (r > 2 * margin)
    ok &= ~classifiable | (updatable & not_behind)
    return cand[ok]


SLAB_Y = 8  # y-rows per slab (16 x 8 = 128 voxels)


def classify_slabs(bijk, img, hiz, R, t, cfg, voxel, vps, dtype):
    """free, mixed bool [B, vps, vps // 8] (z, y-half) and the free
    slabs' weight depth z_est."""
    dev = R.device
    ys, n_yh = SLAB_Y, vps // SLAB_Y
    bs = voxel * vps
    trunc = cfg["default_truncation_distance"]
    h, w = img.rng.shape
    margin = voxel
    origin = (bijk.to(torch.float32) * bs).to(dtype)
    xl = torch.tensor([0.0, float(vps)], device=dev) * voxel
    yl = torch.arange(n_yh + 1, dtype=torch.float32, device=dev) * (ys * voxel)
    zl = torch.arange(vps + 1, dtype=torch.float32, device=dev) * voxel
    lat = torch.stack(torch.meshgrid(zl, yl, xl, indexing="ij"), -1)
    lat_xyz = torch.stack([lat[..., 2], lat[..., 1], lat[..., 0]],
                          -1).to(dtype)
    pts = origin[:, None, None, None, :] + lat_xyz[None]
    p = (pts - t) @ R

    def corners(x):  # [B, v+1, n_yh+1, 2] -> [B, v, n_yh, 8]
        return torch.stack([x[:, :-1, :-1, 0], x[:, :-1, :-1, 1],
                            x[:, :-1, 1:, 0], x[:, :-1, 1:, 1],
                            x[:, 1:, :-1, 0], x[:, 1:, :-1, 1],
                            x[:, 1:, 1:, 0], x[:, 1:, 1:, 1]], -1)

    r_hi = torch.amax(corners(_norm(p)), -1)
    zz = torch.arange(vps, dtype=torch.float32, device=dev)[None, :, None]
    yy = torch.arange(n_yh, dtype=torch.float32, device=dev)[None, None, :]
    shape = r_hi.shape
    box_lo = torch.stack([
        origin[:, 0, None, None].expand(shape),
        (origin[:, 1, None, None] + (yy * (ys * voxel)).to(dtype)
         ).expand(shape),
        (origin[:, 2, None, None] + (zz * voxel).to(dtype)).expand(shape),
    ], -1)
    box_hi = box_lo + torch.tensor([vps * voxel, ys * voxel, voxel],
                                   dtype=torch.float32).to(dtype).to(dev)
    r_lo = _norm(torch.minimum(torch.maximum(t, box_lo), box_hi) - t)
    zc = p[..., 2]
    zcs = torch.clamp(zc, min=1e-6)
    cu = corners(p[..., 0] / zcs * img.fx + img.cx)
    cv = corners(p[..., 1] / zcs * img.fy + img.cy)
    u0, u1 = torch.amin(cu, -1), torch.amax(cu, -1)
    v0, v1 = torch.amin(cv, -1), torch.amax(cv, -1)
    classifiable = torch.all(corners(zc) > 1e-3, -1)
    p0u = _f2i(torch.floor(u0 + 0.5))
    p1u = _f2i(torch.floor(u1 + 0.5))
    p0v = _f2i(torch.floor(v0 + 0.5))
    p1v = _f2i(torch.floor(v1 + 0.5))
    outside = (p1u < 0) | (p0u > w - 1) | (p1v < 0) | (p0v > h - 1)
    q0u = torch.clamp(p0u - 1, 0, w - 1)
    q1u = torch.clamp(p1u + 1, 0, w - 1)
    q0v = torch.clamp(p0v - 1, 0, h - 1)
    q1v = torch.clamp(p1v + 1, 0, h - 1)
    foot_lo, _, foot_hi = _hiz_query(hiz, q0u, q1u, q0v, q1v)
    free = (classifiable & ~outside & (foot_lo > r_hi + trunc + margin)
            & (foot_lo > cfg["min_ray_length_m"] + trunc))
    skip = ((classifiable & (r_lo > foot_hi + 2 * trunc + margin))
            | (classifiable & outside))
    mixed = ~free & ~skip
    z_est = torch.clamp(foot_lo, cfg["min_ray_length_m"],
                        cfg["max_ray_length_m"])
    return free, mixed, z_est


def features(rng, trunc):
    """range, 3x3-minimum range and the clamped image gradients (rounded
    through float16) of a range image [H, W]."""
    h, w = rng.shape
    rmin = -F.max_pool2d(-rng.reshape(1, 1, h, w), 3, stride=1,
                         padding=1).reshape(h, w)
    rp = F.pad(rng[None], (1, 1, 1, 1), value=INF)[0]
    d_up = rp[1:-1, 2:] - rng
    d_um = rng - rp[1:-1, :-2]
    d_vp = rp[2:, 1:-1] - rng
    d_vm = rng - rp[:-2, 1:-1]

    def grad(a, b):
        ok_a = torch.isfinite(a) & (a.abs() < trunc)
        ok_b = torch.isfinite(b) & (b.abs() < trunc)
        g = torch.where(ok_a & ok_b, 0.5 * (a + b),
                        torch.where(ok_a, a, torch.where(ok_b, b, 0.0)))
        return g.to(torch.float16).to(rng.dtype)

    return rng, rmin, grad(d_up, d_um), grad(d_vp, d_vm)


def scan_update(bijk, img, R, t, cfg, voxel, vps, dtype, hiz=None):
    """One scan's samples for the voxels of blocks bijk [B, 3]: (w, w *
    sdf) [B, vps^3] in x-fastest order; w = 0 where not updated."""
    dev = R.device
    trunc = cfg["default_truncation_distance"]
    if hiz is None:
        hiz = _hiz(_pix_eff(img.rng, cfg))
    free, mixed, z_est = classify_slabs(bijk, img, hiz, R, t, cfg, voxel,
                                        vps, dtype)
    ar = torch.arange(vps, device=dev)
    zz, yy, xx = torch.meshgrid(ar, ar, ar, indexing="ij")  # flat x-fastest
    local = torch.stack([xx, yy, zz], -1).reshape(-1, 3).to(torch.int32)
    gvi = bijk.to(torch.int32)[:, None, :] * vps + local[None]
    centers = ((gvi.to(torch.float32) + 0.5) * voxel).to(dtype)
    p = (centers - t) @ R
    u, v, r, front = _project(img, p)
    h, w = img.rng.shape
    ui = _f2i(torch.round(u))
    vi = _f2i(torch.round(v))
    inb = front & (ui >= 0) & (ui < w) & (vi >= 0) & (vi < h)
    slab = (zz * (vps // SLAB_Y) + yy // SLAB_Y).reshape(-1)
    free_v = free.reshape(bijk.shape[0], -1)[:, slab]
    mixed_v = mixed.reshape(bijk.shape[0], -1)[:, slab]
    zf = z_est.reshape(bijk.shape[0], -1)[:, slab]

    rng, rmin, du, dv = features(img.rng, trunc)
    pix = torch.where(inb, vi.to(torch.int64) * w + ui, 0)
    r_near = torch.where(inb, rng.reshape(-1)[pix], INF)
    r_min = torch.where(inb, rmin.reshape(-1)[pix], INF)
    g_u = torch.where(inb, du.reshape(-1)[pix], 0.0)
    g_v = torch.where(inb, dv.reshape(-1)[pix], 0.0)
    r_img = r_near + g_u * (u - ui) + g_v * (v - vi)
    max_ray = cfg["max_ray_length_m"]
    clear = max_ray - trunc

    def effective(x):
        has = torch.isfinite(x)
        beyond = has & (x > max_ray)
        surf = has & ~beyond
        far = torch.where(beyond, torch.full_like(x, clear),
                          torch.full_like(x, -INF))
        return torch.where(surf, x, far), surf

    eff, has_surface = effective(r_img)
    eff_min, _ = effective(r_min)
    too_close = eff < cfg["min_ray_length_m"]
    sdf = eff - r
    in_band = has_surface & (sdf.abs() < trunc)
    upd = inb & ~too_close & (in_band | (eff_min - r >= trunc))
    sdf = torch.where(in_band, sdf, torch.clamp(sdf, min=trunc))
    cos_theta = p[..., 2] / torch.clamp(r, min=1e-6)
    z_surf = eff * cos_theta
    w0 = 1.0 / torch.clamp(z_surf * z_surf, min=1e-6)
    ramp = (trunc + sdf) / (trunc - voxel)
    w0 = torch.where(sdf < -voxel, torch.clamp(w0 * ramp, min=0.0), w0)
    w_mixed = torch.where(upd & mixed_v, w0, 0.0)
    wd_mixed = w_mixed * torch.clamp(sdf, -trunc, trunc)
    w_free = torch.where(inb & free_v,
                         1.0 / torch.clamp(zf * zf, min=1e-6), 0.0)
    return w_mixed + w_free, wd_mixed + trunc * w_free


def samples(store, R, t, img, cfg, dtype):
    """One scan's samples for its candidate blocks: (block indices [B,
    3], w, w * sdf [B, vps^3]). The samples do not depend on the map, so
    a scan seen again reuses them."""
    voxel = cfg["voxel_size"]
    R = R.to(dtype)
    t = t.to(dtype)
    hiz = _hiz(_pix_eff(img.rng, cfg))
    cand = candidate_blocks(img, hiz, R, t, cfg, voxel, store.vps, dtype)
    parts = [scan_update(cand[lo:lo + 1024], img, R, t, cfg, voxel,
                         store.vps, dtype, hiz)
             for lo in range(0, cand.shape[0], 1024)]
    dw = torch.cat([p[0] for p in parts])
    dwd = torch.cat([p[1] for p in parts])
    return cand, dw, dwd


def fold(store, ijk, dw, dwd, cfg):
    """Fold samples of blocks ijk [B, 3] into the running weighted means,
    adding the blocks the store lacks; returns which blocks took an
    update."""
    trunc = cfg["default_truncation_distance"]
    rows = store.add(ijk)
    old_d = store.ch["tsdf"][rows]
    old_w = store.ch["weight"][rows]
    new_w = old_w + dw
    new_d = torch.clamp((old_d * old_w + dwd)
                        / torch.clamp(new_w, min=FLOAT_EPS), -trunc, trunc)
    hit = dw > 0.0
    store.ch["tsdf"][rows] = torch.where(hit, new_d, old_d)
    store.ch["weight"][rows] = torch.where(
        hit, torch.clamp(new_w, max=cfg["max_weight"]), old_w)
    return hit.any(1)


def make_image(scan, cloud, sensor, server, dtype):
    """The range image the program bins from this scan: the organized
    cloud min-pooled, or the flat cloud scattered at the server's
    virtual resolution and the camera's field of view."""
    pts = scan[2]
    if cloud == "organized":
        from ..scene import intrinsics
        return organized_image(pts, server["projective_pool"],
                               intrinsics(sensor), dtype)
    return flat_image(pts.reshape(-1, 3), server["projective_resolution"],
                      sensor["fov_deg"], dtype)


def new_store(voxel, vps, cap, device, dtype):
    s = BlockStore(vps, cap, {"tsdf": dtype, "weight": dtype}, device)
    s.voxel_size = voxel
    return s
