"""PLY export: meshes and coloured SDF point clouds (port of
voxblox_tpu/io/ply.py; reference io/mesh_ply.cc, io/sdf_ply.h).

Binary little-endian PLY by default (``ascii=True`` for the reference's
ascii files). Host numpy code.
"""

from __future__ import annotations

import numpy as np

from .. import _runtime


def write_mesh_ply(path, vertices, normals=None, colors=None, faces=None,
                   ascii=False):
    """Write a triangle mesh (or a point set if ``faces`` is None)."""
    vertices = np.asarray(vertices, np.float32)
    n = len(vertices)
    has_n = normals is not None and len(normals) == n
    has_c = colors is not None and len(colors) == n
    header = ["ply",
              "format ascii 1.0" if ascii else "format binary_little_endian 1.0",
              f"element vertex {n}",
              "property float x", "property float y", "property float z"]
    if has_n:
        header += ["property float nx", "property float ny",
                   "property float nz"]
    if has_c:
        header += ["property uchar red", "property uchar green",
                   "property uchar blue"]
    if faces is not None:
        header.append(f"element face {len(faces)}")
        header.append("property list uchar int vertex_indices")
    header.append("end_header")

    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode())
        if ascii:
            for i in range(n):
                row = list(vertices[i])
                if has_n:
                    row += list(normals[i])
                line = " ".join(f"{x:.6f}" for x in row)
                if has_c:
                    line += " " + " ".join(str(int(c)) for c in colors[i])
                f.write((line + "\n").encode())
            if faces is not None:
                for face in faces:
                    f.write(("3 " + " ".join(str(int(v)) for v in face)
                             + "\n").encode())
            return
        fields = [("v", np.float32, 3)]
        if has_n:
            fields.append(("n", np.float32, 3))
        if has_c:
            fields.append(("c", np.uint8, 3))
        rec = np.zeros(n, dtype=fields)
        rec["v"] = vertices
        if has_n:
            rec["n"] = normals
        if has_c:
            rec["c"] = colors
        f.write(rec.tobytes())
        if faces is not None:
            faces = np.asarray(faces, np.int32)
            frec = np.zeros(len(faces),
                            dtype=[("k", np.uint8), ("f", np.int32, 3)])
            frec["k"] = 3
            frec["f"] = faces
            f.write(frec.tobytes())


_TYPES = {"x": np.float32, "y": np.float32, "z": np.float32,
          "nx": np.float32, "ny": np.float32, "nz": np.float32,
          "red": np.uint8, "green": np.uint8, "blue": np.uint8,
          "alpha": np.uint8, "intensity": np.float32}


def read_ply(path):
    """Minimal PLY reader (binary_le / ascii; x y z [+nx ny nz][+rgb],
    optional faces) -> dict of vertices/normals/colors/faces."""
    with open(path, "rb") as f:
        props, counts, order, fmt = [], {}, [], None
        while True:
            line = f.readline().decode().strip()
            if line.startswith("format"):
                fmt = line.split()[1]
            elif line.startswith("element"):
                _, name, cnt = line.split()
                counts[name] = int(cnt)
                order.append(name)
            elif (line.startswith("property") and order
                  and order[-1] == "vertex"):
                props.append(line.split()[-1])
            elif line == "end_header":
                break
        nv, nf = counts.get("vertex", 0), counts.get("face", 0)
        if fmt == "ascii":
            arr = np.array([f.readline().split() for _ in range(nv)],
                           np.float64)
            data = {p: arr[:, i] for i, p in enumerate(props)}
            faces = []
            for _ in range(nf):
                parts = f.readline().split()
                faces.append([int(x) for x in parts[1:1 + int(parts[0])]])
            faces = np.asarray(faces, np.int32) if faces else None
        else:
            dt = np.dtype([(p, _TYPES.get(p, np.float32)) for p in props])
            rec = np.frombuffer(f.read(nv * dt.itemsize), dt, count=nv)
            data = {p: rec[p] for p in props}
            faces = None
            if nf:
                fdt = np.dtype([("k", np.uint8), ("f", np.int32, 3)])
                faces = np.frombuffer(f.read(nf * fdt.itemsize), fdt,
                                      count=nf)["f"].copy()
    out = {"vertices": np.stack([data["x"], data["y"], data["z"]],
                                -1).astype(np.float32)}
    if "nx" in data:
        out["normals"] = np.stack([data["nx"], data["ny"], data["nz"]],
                                  -1).astype(np.float32)
    if "red" in data:
        out["colors"] = np.stack([data["red"], data["green"], data["blue"]],
                                 -1).astype(np.uint8)
    if faces is not None:
        out["faces"] = faces
    return out


def mesh_layer_to_ply(mesh_layer, path, connected: bool = True):
    """Export a MeshLayer (io/mesh_ply.cc:40-60): welded with face indices
    when ``connected``, else the raw triangle soup."""
    from ..ops.mesh import weld_vertices

    verts, normals, colors = mesh_layer.combined()
    if connected and len(verts):
        uv, un, uc, inv = weld_vertices(verts, normals, colors)
        write_mesh_ply(path, uv, un, uc, inv.reshape(-1, 3))
    else:
        write_mesh_ply(path, verts, normals, colors,
                       np.arange(len(verts)).reshape(-1, 3))


def sdf_layer_to_pointcloud_ply(layer, path, surface_distance=None,
                                color_map=None):
    """Coloured SDF voxel cloud (io/sdf_ply.h): every observed voxel of an
    active block becomes a point, coloured by its distance. Returns the
    number of points."""
    if layer.layer_type == "tsdf":
        obs = _runtime.to_host(layer.channels["weight"]) > 1e-6
    elif layer.layer_type == "esdf":
        obs = (_runtime.to_host(layer.channels["esdf_flags"]) & 1) != 0
    else:
        obs = _runtime.to_host(layer.channels["occ_observed"]) != 0
    ch = {"tsdf": "tsdf", "esdf": "esdf", "occupancy": "log_odds"}
    d = _runtime.to_host(layer.channels[ch[layer.layer_type]])
    obs = obs & _runtime.to_host(layer.active_mask())[:, None]
    v = layer.vps
    lin = np.arange(layer.voxels_per_block)
    local = np.stack([lin % v, (lin // v) % v, lin // (v * v)], -1)
    gvi = _runtime.to_host(layer.block_ijk)[:, None, :] * v + local[None]
    centers = (gvi + 0.5) * layer.voxel_size
    sel = obs
    if surface_distance is not None:
        sel = sel & (np.abs(d) < surface_distance)
    pts, dist = centers[sel], d[sel]
    if color_map is None:
        from ..utils.color_maps import rainbow_color_map

        span = max(np.abs(dist).max(), 1e-6) if len(dist) else 1.0
        colors = rainbow_color_map(0.5 + 0.5 * dist / span)
    else:
        colors = color_map(dist)
    write_mesh_ply(path, pts.astype(np.float32), colors=colors)
    return len(pts)
