"""Mesh colour modes for export (port of voxblox_tpu/utils/mesh_vis.py;
reference mesh_vis.h:44-51): vertex colours, rainbow by height, normals
as RGB, gray, Lambertian shading (plain or over the vertex colours).
Host numpy code over a MeshLayer's combined buffers."""

from __future__ import annotations

import numpy as np

from .color_maps import rainbow_color_map

LIGHT_DIR = np.array([0.8, -0.2, 0.66], np.float64)
LIGHT_DIR /= np.linalg.norm(LIGHT_DIR)


def apply_color_mode(vertices, normals, colors, mode: str = "color"):
    """uint8[N,3] per-vertex colours for ``mode``."""
    n = len(vertices)
    if mode == "color":
        return np.asarray(colors, np.uint8)
    if mode == "height":
        z = vertices[:, 2]
        lo, hi = (z.min(), z.max()) if n else (0.0, 1.0)
        return rainbow_color_map((z - lo) / max(hi - lo, 1e-6))
    if mode == "normals":
        return np.clip((normals * 0.5 + 0.5) * 255, 0, 255).astype(np.uint8)
    if mode == "gray":
        return np.full((n, 3), 127, np.uint8)
    if mode in ("lambert", "lambert_color"):
        lam = np.clip(normals @ LIGHT_DIR, 0.0, 1.0) * 0.8 + 0.2
        base = (np.asarray(colors, np.float64) if mode == "lambert_color"
                else np.full((n, 3), 220.0))
        return np.clip(base * lam[:, None], 0, 255).astype(np.uint8)
    raise ValueError(f"unknown color mode {mode!r}")


def export_mesh(mesh_layer, path, mode: str = "color", connected=True):
    """MeshLayer -> PLY with a colour mode applied."""
    from ..io.ply import write_mesh_ply
    from ..ops.mesh import weld_vertices

    verts, normals, colors = mesh_layer.combined()
    shaded = apply_color_mode(verts, normals, colors, mode)
    if connected and len(verts):
        uv, un, uc, inv = weld_vertices(verts, normals, shaded)
        write_mesh_ply(path, uv, un, uc, inv.reshape(-1, 3))
    else:
        write_mesh_ply(path, verts, normals, shaded,
                       np.arange(len(verts)).reshape(-1, 3))
