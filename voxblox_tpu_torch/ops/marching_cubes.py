"""Marching cubes: table generation + vectorized per-cube surface
extraction (port of voxblox_tpu/ops/marching_cubes.py; the port keeps its
own copy of the table derivation, which is plain numpy).

The 256-case triangle table is derived at import from first principles:

- corner ordering of the reference cube: columns x=(0,1,1,0,0,1,1,0),
  y=(0,0,1,1,0,0,1,1), z=(0,0,0,0,1,1,1,1);
- edge ordering of the reference's edge index pairs;
- for each of the 256 sign configurations the isosurface patch boundary is
  traced across the 6 cube faces with marching-squares connectivity;
  ambiguous (saddle) faces use the viewpoint-invariant rule "separate the
  inside corners", so adjacent cubes agree on shared faces and the global
  mesh is watertight;
- each closed loop of crossed edges is fan-triangulated and oriented so
  triangle normals (p1-p0)x(p2-p0) point toward positive SDF (outside).

The per-cube config index has bit i set iff sdf(corner i) < 0, and edge
vertices use the linear zero-crossing interpolation
t = sdf0 / (sdf0 - sdf1).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _runtime

# Reference corner order.
CORNERS = np.array(
    [
        [0, 0, 0],
        [1, 0, 0],
        [1, 1, 0],
        [0, 1, 0],
        [0, 0, 1],
        [1, 0, 1],
        [1, 1, 1],
        [0, 1, 1],
    ],
    np.int32,
)

# Reference edge order.
EDGES = np.array(
    [
        [0, 1], [1, 2], [2, 3], [3, 0],
        [4, 5], [5, 6], [6, 7], [7, 4],
        [0, 4], [1, 5], [2, 6], [3, 7],
    ],
    np.int32,
)

# Cube faces as corner cycles (each viewed from outside the cube).
_FACES = [
    (0, 3, 2, 1),  # z = 0
    (4, 5, 6, 7),  # z = 1
    (0, 1, 5, 4),  # y = 0
    (2, 3, 7, 6),  # y = 1
    (0, 4, 7, 3),  # x = 0
    (1, 2, 6, 5),  # x = 1
]

MAX_TRIS = 5


def _edge_id(a: int, b: int) -> int:
    for i, (x, y) in enumerate(EDGES):
        if (x, y) == (a, b) or (x, y) == (b, a):
            return i
    raise KeyError((a, b))


def _face_segments(face, inside):
    """Marching squares on one face: return list of (edge_id, edge_id)
    segments. Saddle rule: separate the *inside* corners (each inside
    corner is cut off by its own segment) — a function of the sign pattern
    alone, hence consistent between the two cubes sharing the face."""
    c = list(face)
    ins = [inside[k] for k in c]
    crossed = []
    for i in range(4):
        a, b = c[i], c[(i + 1) % 4]
        if inside[a] != inside[b]:
            crossed.append((i, _edge_id(a, b)))
    if not crossed:
        return []
    if len(crossed) == 2:
        return [(crossed[0][1], crossed[1][1])]
    # 4 crossings: diagonal saddle. Cut off each inside corner.
    segs = []
    for i in range(4):
        if ins[i]:
            prev_e = _edge_id(c[(i - 1) % 4], c[i])
            next_e = _edge_id(c[i], c[(i + 1) % 4])
            segs.append((prev_e, next_e))
    # Exactly the two segments belonging to the 2 diagonal inside corners.
    assert len(segs) == 2
    return segs


def _build_tri_table():
    table = np.full((256, MAX_TRIS * 3 + 1), -1, np.int8)
    edge_mid = (CORNERS[EDGES[:, 0]] + CORNERS[EDGES[:, 1]]) / 2.0
    for config in range(256):
        inside = [(config >> i) & 1 == 1 for i in range(8)]
        if config in (0, 255):
            continue
        # Adjacency: each crossed edge appears in exactly two face segments.
        adj: dict[int, list[int]] = {}
        for face in _FACES:
            for a, b in _face_segments(face, inside):
                adj.setdefault(a, []).append(b)
                adj.setdefault(b, []).append(a)
        for e, ns in adj.items():
            assert len(ns) == 2, (config, e, ns)
        # Trace closed loops.
        loops = []
        seen = set()
        for start in sorted(adj):
            if start in seen:
                continue
            loop = [start]
            seen.add(start)
            prev, cur = None, start
            while True:
                nxt = [n for n in adj[cur] if n != prev]
                # Both neighbors equal prev can happen for 2-loops; forbid.
                nxt = nxt[0] if nxt else adj[cur][0]
                if nxt == start:
                    break
                loop.append(nxt)
                seen.add(nxt)
                prev, cur = cur, nxt
            assert len(loop) >= 3, (config, loop)
            loops.append(loop)
        # Orient + fan-triangulate.
        tris = []
        for loop in loops:
            pts = edge_mid[loop]
            # Newell normal of the polygon.
            n = np.zeros(3)
            for i in range(len(loop)):
                p, q = pts[i], pts[(i + 1) % len(loop)]
                n += np.cross(p, q)
            # Outward direction: sum over loop edges of (outside - inside)
            # corner positions.
            outward = np.zeros(3)
            for e in loop:
                a, b = EDGES[e]
                pa, pb = CORNERS[a].astype(float), CORNERS[b].astype(float)
                if inside[a]:
                    outward += pb - pa
                else:
                    outward += pa - pb
            if np.dot(n, outward) < 0:
                loop = loop[::-1]
            for i in range(1, len(loop) - 1):
                tris.append((loop[0], loop[i], loop[i + 1]))
        assert len(tris) <= MAX_TRIS, (config, len(tris))
        flat = [e for t in tris for e in t]
        table[config, : len(flat)] = flat
    return table


TRI_TABLE = _build_tri_table()  # int8 [256, 16], -1 terminated
# Per-config triangle count.
TRI_COUNT = np.sum(TRI_TABLE[:, 0 : MAX_TRIS * 3 : 3] >= 0, axis=1).astype(
    np.int32
)
# Every non-trivial config emits at least one triangle — ops/mesh's
# compact-first march classifies surface cubes by config != {0, 255}
# alone.
assert TRI_COUNT[0] == 0 and TRI_COUNT[255] == 0
assert (TRI_COUNT[1:255] > 0).all()


# ---------------------------------------------------------------------------
# Vectorized extraction
# ---------------------------------------------------------------------------


def edge_crossings(corner_pos, corner_sdf):
    """Zero-crossing parameter t [..., 12] and point [..., 12, 3] on each
    of the 12 cube edges (clamped linear interpolation)."""
    dev = corner_sdf.device
    e0 = _runtime.const(EDGES[:, 0], torch.int64, dev)
    e1 = _runtime.const(EDGES[:, 1], torch.int64, dev)
    s0 = corner_sdf[..., e0]
    s1 = corner_sdf[..., e1]
    diff = s0 - s1
    t = s0 / torch.where(diff.abs() < 1e-12, 1e-12, diff)
    t = torch.clamp(t, 0.0, 1.0)
    p0 = corner_pos[..., e0, :]
    p1 = corner_pos[..., e1, :]
    return t, p0 + t[..., None] * (p1 - p0)


def cube_config(corner_sdf):
    """int64[...] sign configuration: bit i set iff sdf(corner i) < 0."""
    config = torch.zeros(corner_sdf.shape[:-1], dtype=torch.int64,
                         device=corner_sdf.device)
    for i in range(8):
        config = config | ((corner_sdf[..., i] < 0.0).to(torch.int64) << i)
    return config


def mesh_cubes(corner_pos, corner_sdf, corner_valid):
    """Extract triangles for a batch of cubes.

    Args:
      corner_pos: f32[..., 8, 3] world positions of the cube corners.
      corner_sdf: f32[..., 8] SDF at the corners.
      corner_valid: bool[...] cube has all corners observed.

    Returns:
      tri_verts: f32[..., MAX_TRIS, 3, 3] triangle vertex positions.
      tri_mask: bool[..., MAX_TRIS].
    """
    dev = corner_sdf.device
    config = cube_config(corner_sdf)
    _, edge_pts = edge_crossings(corner_pos, corner_sdf)  # [..., 12, 3]
    rows = _runtime.const(TRI_TABLE, torch.int64, dev)[config]  # [..., 16]
    counts = _runtime.const(TRI_COUNT, torch.int64, dev)[config]
    tri_edge_ids = rows[..., : MAX_TRIS * 3].reshape(
        rows.shape[:-1] + (MAX_TRIS, 3))
    tri_verts = _gather_tri_verts(edge_pts, tri_edge_ids.clamp(min=0))
    tidx = torch.arange(MAX_TRIS, device=dev)
    tri_mask = corner_valid[..., None] & (tidx < counts[..., None])
    return tri_verts, tri_mask


def _gather_tri_verts(edge_pts, safe_ids):
    """edge_pts [...,12,3], safe_ids [...,T,3] -> [...,T,3,3]."""
    batch = safe_ids.shape[:-2]
    flat_ids = safe_ids.reshape(batch + (MAX_TRIS * 3, 1)).expand(
        batch + (MAX_TRIS * 3, 3))
    gathered = torch.gather(edge_pts, -2, flat_ids)
    return gathered.reshape(batch + (MAX_TRIS, 3, 3))


def triangle_normals(tri_verts):
    """Flat normals n = (p1-p0)x(p2-p0), normalized."""
    a = tri_verts[..., 1, :] - tri_verts[..., 0, :]
    b = tri_verts[..., 2, :] - tri_verts[..., 0, :]
    n = torch.linalg.cross(a, b)
    return n / torch.clamp(torch.linalg.vector_norm(n, dim=-1, keepdim=True),
                           min=1e-12)
