"""Analytic simulation objects: exact signed distance and exact ray
intersection for spheres, cubes, planes and cylinders (port of
voxblox_tpu/sim/objects.py).

All objects live in one padded SoA container; per-type formulas are
computed for every (point or ray, object) pair and selected by type code.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

EPS = 1e-6
SPHERE, CUBE, PLANE, CYLINDER = 0, 1, 2, 3  # the JAX package's type codes
BIG = float("inf")


@dataclasses.dataclass
class ObjectSet:
    """params per kind: sphere [radius, 0, 0]; cube [sx, sy, sz] (full
    sides); plane [nx, ny, nz] (unit normal); cylinder [radius, height, 0]
    (axis +z)."""

    kind: torch.Tensor  # int32[N]
    center: torch.Tensor  # f32[N,3]
    params: torch.Tensor  # f32[N,3]
    color: torch.Tensor  # f32[N,3]
    valid: torch.Tensor  # bool[N]


def make_object_set(objs, device) -> ObjectSet:
    n = max(len(objs), 1)
    kind = np.zeros(n, np.int32)
    center = np.zeros((n, 3), np.float32)
    params = np.zeros((n, 3), np.float32)
    color = np.zeros((n, 3), np.float32)
    valid = np.zeros(n, bool)
    for i, o in enumerate(objs):
        kind[i] = o["kind"]
        center[i] = o["center"]
        params[i] = o["params"]
        color[i] = o.get("color", (255, 255, 255))
        valid[i] = True
    return ObjectSet(*(torch.as_tensor(a, device=device)
                       for a in (kind, center, params, color, valid)))


def _norm(x):
    # vector_norm sums the squares as a fused multiply-add chain, as the
    # JAX CPU backend does for jnp.linalg.norm: the ranges match exactly.
    return torch.linalg.vector_norm(x, dim=-1)


def _select(kind, per_kind, shape, device):
    """Per-object value by type code (BIG where no formula applies)."""
    out = torch.full(shape, BIG, dtype=torch.float32, device=device)
    for code, val in per_kind:
        out = torch.where(kind == code, val, out)
    return out


# ---------------------------------------------------------------------------
# Signed distance
# ---------------------------------------------------------------------------


def _sphere_dist(p, c, prm):
    return _norm(c - p) - prm[..., 0]


def _cube_dist(p, c, prm):
    half = prm / 2.0
    lo = c - half - p
    hi = p - c - half
    outside = _norm(torch.maximum(torch.clamp(lo, min=0.0), hi))
    inside = torch.amax(torch.maximum(lo, hi), dim=-1)
    return torch.where(outside < EPS, inside, outside)


def _plane_dist(p, c, prm):
    n = prm
    d = -torch.sum(n * c, dim=-1)
    return torch.sum(n * p, dim=-1) + d / _norm(n)


def _cylinder_dist(p, c, prm):
    r = prm[..., 0]
    h = prm[..., 1]
    dz = p[..., 2] - c[..., 2]
    radial2 = torch.sum((p[..., :2] - c[..., :2]) ** 2, dim=-1)
    radial = torch.sqrt(radial2)
    in_band = dz.abs() <= h / 2.0
    cap_dz = dz.abs() - h / 2.0
    side = radial - r
    corner = torch.sqrt(torch.clamp(radial2 - r * r, min=0.0)
                        + cap_dz * cap_dz)
    return torch.where(in_band, side, corner)


def object_distances(objects: ObjectSet, points):
    """points f32[...,3] -> distances f32[..., N] to every object."""
    p = points[..., None, :]
    c = objects.center
    prm = objects.params
    d = _select(objects.kind, (
        (SPHERE, _sphere_dist(p, c, prm)),
        (CUBE, _cube_dist(p, c, prm)),
        (PLANE, _plane_dist(p, c, prm)),
        (CYLINDER, _cylinder_dist(p, c, prm)),
    ), torch.broadcast_shapes(p.shape, c.shape)[:-1], c.device)
    return torch.where(objects.valid, d, BIG)


# ---------------------------------------------------------------------------
# Ray intersection: t in [0, inf), miss = +inf
# ---------------------------------------------------------------------------


def _sphere_ray(o, d, c, prm):
    r = prm[..., 0]
    oc = o - c
    b = torch.sum(d * oc, dim=-1)
    disc = b * b - torch.sum(oc * oc, dim=-1) + r * r
    t = -b - torch.sqrt(torch.clamp(disc, min=0.0))
    return torch.where((disc >= 0.0) & (t >= 0.0), t, BIG)


def _cube_ray(o, d, c, prm):
    half = prm / 2.0
    inv = 1.0 / d  # inf on zero components (IEEE slab method)
    t0 = (c - half - o) * inv
    t1 = (c + half - o) * inv
    tmin = torch.amax(torch.minimum(t0, t1), dim=-1)
    tmax = torch.amin(torch.maximum(t0, t1), dim=-1)
    hit = tmax >= torch.clamp(tmin, min=0.0)
    t = torch.where(tmin >= 0.0, tmin, tmax)
    return torch.where(hit & (t >= 0.0), t, BIG)


def _plane_ray(o, d, c, prm):
    n = prm
    denom = torch.sum(d * n, dim=-1)
    t = torch.sum((c - o) * n, dim=-1) / torch.where(
        denom.abs() < EPS, 1.0, denom)
    return torch.where((denom.abs() >= EPS) & (t >= 0.0), t, BIG)


def _cylinder_ray(o, d, c, prm):
    r = prm[..., 0]
    h = prm[..., 1]
    e = o - c
    a = d[..., 0] ** 2 + d[..., 1] ** 2
    b = 2.0 * (e[..., 0] * d[..., 0] + e[..., 1] * d[..., 1])
    cc = e[..., 0] ** 2 + e[..., 1] ** 2 - r * r
    disc = b * b - 4.0 * a * cc
    safe_a = torch.where(a.abs() < EPS, 1.0, a)
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    t1 = (-b + sq) / (2.0 * safe_a)
    t2 = (-b - sq) / (2.0 * safe_a)
    z1 = e[..., 2] + t1 * d[..., 2]
    z2 = e[..., 2] + t2 * d[..., 2]
    side_ok = (a.abs() >= EPS) & (disc >= 0.0)
    t1_ok = side_ok & (t1 >= 0.0) & (z1.abs() <= h / 2.0)
    t2_ok = side_ok & (t2 >= 0.0) & (z2.abs() <= h / 2.0)
    dz = d[..., 2]
    safe_dz = torch.where(dz.abs() < EPS, 1.0, dz)
    t3 = (-h / 2.0 - e[..., 2]) / safe_dz
    t4 = (h / 2.0 - e[..., 2]) / safe_dz
    q3 = e[..., :2] + t3[..., None] * d[..., :2]
    q4 = e[..., :2] + t4[..., None] * d[..., :2]
    cap_ok = dz.abs() >= EPS
    t3_ok = cap_ok & (t3 >= 0.0) & (_norm(q3) < r)
    t4_ok = cap_ok & (t4 >= 0.0) & (_norm(q4) < r)
    return torch.minimum(
        torch.minimum(torch.where(t1_ok, t1, BIG), torch.where(t2_ok, t2, BIG)),
        torch.minimum(torch.where(t3_ok, t3, BIG), torch.where(t4_ok, t4, BIG)),
    )


def object_ray_intersections(objects: ObjectSet, origins, directions):
    """origins/directions f32[...,3] -> t f32[..., N] (inf = miss)."""
    o = origins[..., None, :]
    d = directions[..., None, :]
    c = objects.center
    prm = objects.params
    t = _select(objects.kind, (
        (SPHERE, _sphere_ray(o, d, c, prm)),
        (CUBE, _cube_ray(o, d, c, prm)),
        (PLANE, _plane_ray(o, d, c, prm)),
        (CYLINDER, _cylinder_ray(o, d, c, prm)),
    ), torch.broadcast_shapes(o.shape, c.shape)[:-1], c.device)
    return torch.where(objects.valid, t, BIG)
