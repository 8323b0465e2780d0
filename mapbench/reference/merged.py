"""voxblox's merged TSDF integrator, written plainly: the points of a scan
bundled by the voxel they end in, one ray cast per bundle.

The rule (voxblox ``MergedTsdfIntegrator``, ``tsdf_integrator.cc``):

- a point is valid when finite and at least ``min_ray_length_m`` from the
  sensor; beyond ``max_ray_length_m`` it is a clearing point (with
  ``allow_clear``), else invalid. Its weight is 1 / z^2 in the sensor
  frame;
- valid points are bundled by (clearing, the global voxel of the point).
  A surface bundle casts one ray to the weighted mean of its points with
  the summed weight; a clearing bundle casts the ray of its first point
  (in the scan's order) with that point's weight;
- with voxel carving a surface ray runs from the sensor to truncation
  past its point, a clearing ray from the sensor to
  ``min(length - truncation, max_ray_length_m)`` along it. The voxels
  are those of the Amanatides-Woo walk from the start's voxel, one axis
  a step (the smallest distance to its next boundary, ties to x, then
  y), ``L1(end voxel - start voxel) + 1`` voxels;
- each voxel visited takes the sample sdf = |p - o| - (c - o).(p - o) /
  |p - o| (c its centre, p the ray's point, o the sensor) at the ray's
  weight, ramped down linearly behind the surface past one voxel
  (weight dropoff); a scan's samples add up per voxel, then the voxel's
  distance becomes the weighted mean of its old value and the scan's
  (clamped to truncation), and its weight the sum, capped.

Everything is computed in ``dtype``; in float32 the multiply-adds that
place a ray's end and a voxel's offset are rounded once, as a fused
multiply-add does.
"""

from __future__ import annotations

import torch

from .store import BlockStore

EPS = 1e-6  # point -> grid index
FLOAT_EPS = 1e-6


def _mul_add(a, b, c, dtype):
    """a * b + c, rounded once in float32 (a fused multiply-add)."""
    if dtype == torch.float32:
        return (a.double() * b.double() + c.double()).float()
    return a * b + c


def _grid(x, dtype):
    return torch.floor(x + torch.tensor(EPS, dtype=dtype)).to(torch.int64)


def rays(points_C, R, t, cfg, dtype):
    """The scan's bundled rays: (point [M, 3], weight [M], clearing [M])
    in the world frame; ``points_C`` [N, 3] in the sensor frame."""
    p_C = points_C.to(dtype)
    R, t = R.to(dtype), t.to(dtype)
    p_G = p_C @ R.T + t
    norm = torch.linalg.vector_norm(p_C, dim=-1)
    finite = torch.isfinite(p_C).all(-1)
    far = norm > cfg["max_ray_length_m"]
    clearing = far & bool(cfg["allow_clear"])
    valid = finite & (norm >= cfg["min_ray_length_m"]) & (~far | clearing)
    z = p_C[:, 2].abs()
    w = torch.where(z > EPS, 1.0 / torch.clamp(z, min=EPS) ** 2,
                    torch.zeros_like(z))
    idx = torch.nonzero(valid).flatten()
    p_G, w, clearing = p_G[idx], w[idx], clearing[idx]
    inv = torch.tensor(1.0 / cfg["voxel_size"], dtype=dtype)
    gvi = _grid(p_G * inv, dtype)
    key = torch.cat([clearing[:, None].to(torch.int64), gvi], 1)
    uniq, bundle = torch.unique(key, dim=0, return_inverse=True)
    m = uniq.shape[0]
    is_clear = uniq[:, 0] == 1
    # Surface bundles: weighted mean point, summed weight.
    sw = torch.zeros(m, dtype=dtype, device=p_G.device).index_add_(
        0, bundle, w)
    swp = torch.zeros((m, 3), dtype=dtype, device=p_G.device).index_add_(
        0, bundle, w[:, None] * p_G)
    mean = swp / torch.clamp(sw, min=FLOAT_EPS)[:, None]
    # Clearing bundles: the first point of the bundle in the scan's order.
    lane = torch.arange(idx.shape[0], device=p_G.device)
    first = torch.full((m,), idx.shape[0], dtype=torch.int64,
                       device=p_G.device).scatter_reduce_(0, bundle, lane,
                                                          "amin")
    point = torch.where(is_clear[:, None], p_G[first], mean)
    weight = torch.where(is_clear, w[first], sw)
    return point, weight, is_clear


def segments(point, origin, clearing, cfg, dtype):
    """Start and end of each ray in voxel units."""
    trunc = cfg["default_truncation_distance"]
    delta = point - origin
    length = torch.linalg.vector_norm(delta, dim=-1, keepdim=True)
    unit = delta / torch.clamp(length, min=FLOAT_EPS)
    if not cfg["voxel_carving_enabled"]:
        raise ValueError("the reference casts carving rays only")
    clear_len = torch.clamp(length - trunc, 0.0, cfg["max_ray_length_m"])
    end = torch.where(
        clearing[:, None],
        _mul_add(unit, clear_len.expand_as(unit), origin.expand_as(unit),
                 dtype),
        _mul_add(unit, torch.full_like(unit, trunc), point, dtype))
    inv = torch.tensor(1.0 / cfg["voxel_size"], dtype=dtype)
    return origin.expand_as(end) * inv, end * inv


def walk(start, end, dtype):
    """Amanatides-Woo voxel walks: (voxels [S, M, 3] int64, mask [S, M])."""
    cur = _grid(start, dtype)
    n_steps = (_grid(end, dtype) - cur).abs().sum(-1)
    d = end - start
    sign = torch.sign(d).to(torch.int64)
    moving = d != 0
    one = torch.ones((), dtype=dtype, device=d.device)
    den = torch.where(moving, d, one)
    boundary = torch.clamp(sign, min=0).to(dtype) - (start - cur.to(dtype))
    big = torch.tensor(2.0 ** 30, dtype=dtype, device=d.device)
    t_next = torch.where(moving, boundary / den, big)
    t_step = torch.where(moving, sign.to(dtype) / den, big)
    n = int(n_steps.max()) + 1 if n_steps.numel() else 0
    voxels, mask = [], []
    for i in range(n):
        voxels.append(cur)
        mask.append(n_steps >= i)
        tx, ty, tz = t_next.unbind(-1)
        ax = torch.where((tx <= ty) & (tx <= tz), 0, torch.where(ty <= tz,
                                                                 1, 2))
        pick = torch.nn.functional.one_hot(ax, 3).bool()
        cur = cur + torch.where(pick, sign, 0)
        t_next = t_next + torch.where(pick, t_step, 0)
    if not voxels:
        return (torch.zeros((0, 0, 3), dtype=torch.int64),
                torch.zeros((0, 0), dtype=torch.bool))
    return torch.stack(voxels), torch.stack(mask)


def sample_values(voxels, point, origin, weight, cfg, dtype):
    """sdf and weight of each voxel of each walk."""
    voxel = cfg["voxel_size"]
    trunc = cfg["default_truncation_distance"]
    half = voxels.to(dtype) + 0.5
    b = point - origin
    dist = torch.linalg.vector_norm(b, dim=-1)
    a = _mul_add(half, torch.full_like(half, voxel),
                 (-origin).expand_as(half), dtype)
    b = b.expand_as(a)
    dot = _mul_add(a[..., 2], b[..., 2],
                   _mul_add(a[..., 1], b[..., 1], a[..., 0] * b[..., 0],
                            dtype), dtype)
    sdf = dist - dot / torch.clamp(dist, min=FLOAT_EPS)
    w = weight.expand(sdf.shape)
    ramp = (trunc + sdf) / (trunc - voxel)
    w = torch.where(sdf < -voxel, torch.clamp(w * ramp, min=0.0), w)
    return sdf, w


def samples(store, R, t, points_C, cfg, dtype, chunk=65536):
    """One scan's samples, summed per voxel, for the blocks its walks
    visit: (block indices [B, 3], w, w * sdf [B, vps^3]). The samples do
    not depend on the map, so a scan seen again reuses them."""
    vps = store.vps
    trunc = cfg["default_truncation_distance"]
    origin = t.to(dtype)
    point, weight, clearing = rays(points_C, R, t, cfg, dtype)
    flat_parts, w_parts, wd_parts = [], [], []
    for lo in range(0, point.shape[0], chunk):
        p, wt, cl = (x[lo:lo + chunk] for x in (point, weight, clearing))
        start, end = segments(p, origin, cl, cfg, dtype)
        vox, mask = walk(start, end, dtype)
        sdf, w = sample_values(vox, p, origin, wt, cfg, dtype)
        flat_parts.append(vox[mask])
        w_parts.append(w[mask])
        wd_parts.append((w * torch.clamp(sdf, -trunc, trunc))[mask])
    dev = store.device
    if not flat_parts:
        empty = torch.zeros((0, vps ** 3), dtype=dtype, device=dev)
        return (torch.zeros((0, 3), dtype=torch.int64, device=dev), empty,
                empty)
    gvi = torch.cat(flat_parts)
    blocks = torch.div(gvi, vps, rounding_mode="floor")
    local = gvi - blocks * vps
    ub, inv = torch.unique(blocks, dim=0, return_inverse=True)
    lin = local[:, 0] + vps * (local[:, 1] + vps * local[:, 2])
    cell = inv * vps ** 3 + lin
    n = ub.shape[0] * vps ** 3
    dw = torch.zeros(n, dtype=dtype, device=dev).index_add_(
        0, cell, torch.cat(w_parts)).view(-1, vps ** 3)
    dwd = torch.zeros(n, dtype=dtype, device=dev).index_add_(
        0, cell, torch.cat(wd_parts)).view(-1, vps ** 3)
    return ub, dw, dwd


def new_store(voxel, vps, cap, device, dtype):
    s = BlockStore(vps, cap, {"tsdf": dtype, "weight": dtype}, device)
    s.voxel_size = voxel
    return s
