"""Analytic simulation objects: exact ray intersection (port of the parts
of voxblox_tpu/sim/objects.py that render the bench's scene — planes and
cylinders; spheres and cubes are not ported yet).

All objects live in one padded SoA container; per-type formulas are
computed for every (ray, object) pair and selected by type code.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

EPS = 1e-6
PLANE, CYLINDER = 2, 3  # the JAX package's type codes
BIG = float("inf")


@dataclasses.dataclass
class ObjectSet:
    kind: torch.Tensor  # int32[N]
    center: torch.Tensor  # f32[N,3]
    params: torch.Tensor  # f32[N,3]
    color: torch.Tensor  # f32[N,3]
    valid: torch.Tensor  # bool[N]


def make_object_set(objs, device) -> ObjectSet:
    if any(o["kind"] not in (PLANE, CYLINDER) for o in objs):
        raise NotImplementedError("only planes and cylinders are ported")
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
    k = objects.kind
    t = torch.full(torch.broadcast_shapes(o.shape, c.shape)[:-1], BIG,
                   dtype=torch.float32, device=c.device)
    for code, fn in ((CYLINDER, _cylinder_ray), (PLANE, _plane_ray)):
        t = torch.where(k == code, fn(o, d, c, prm), t)
    return torch.where(objects.valid, t, BIG)
