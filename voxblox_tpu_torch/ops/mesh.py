"""Incremental per-block meshing over the voxel pool (port of
voxblox_tpu/ops/mesh.py).

- For each updated block (the mesh dirty bit) all vps^3 cubes are marched
  in one vectorized pass; interior cubes and the 3 border planes are
  handled uniformly by gathering a +1 voxel halo from neighbour blocks.
- Cube corners must all be observed (weight > min_weight on a TSDF layer,
  the observed flag on an ESDF layer).
- Vertex colours come from the nearest voxel.
- ``MeshPool`` keeps per-block triangle buffers on the device, row-aligned
  with the voxel pool; ``update_mesh_pool`` marches the dirty rows,
  compacts their triangles and scatters them into the pool without a host
  read. Triangles cross to the host only on export
  (``pool_to_mesh_layer``), into a ``MeshLayer`` of per-block triangle
  soups with flat normals; ``weld_vertices`` welds them for a connected
  mesh.

The reference is one XLA program per update; here it is eager PyTorch.
The pool and the layer's block flags are updated in place. Writes to the
reference's out-of-range drop rows go through ``layer.put_rows`` or an
explicit dump slot. Colour words are packed in int32 (24 bits) and
bit-cast into the float32 rows.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .. import _runtime
from ..core import layer as vlayer
from ..core.config import MeshIntegratorConfig
from . import marching_cubes as mc
from .compaction import compact_ids
from .esdf import probe_neighbor_rows


def _shell_slices(o, v):
    """(dst, src) slices along one axis of a [v+2] halo-padded cube for
    neighbour offset ``o``."""
    if o == -1:
        return slice(0, 1), slice(v - 1, v)
    if o == 1:
        return slice(v + 1, v + 2), slice(0, 1)
    return slice(1, v + 1), slice(0, v)


def _padded_from_pool(values, nbr_sel, fill, v):
    """Halo-padded cubes [B, v+2, v+2, v+2] for selected rows, gathered
    from the flat pool channel ``values`` [mb, vpb]; ``nbr_sel`` int[B, 27]
    pool slots of each row's 3x3x3 neighbourhood (-1 missing -> fill;
    offset k = ((dx+1)*3+(dy+1))*3+(dz+1), centre k=13)."""
    mb = values.shape[0]
    b = nbr_sel.shape[0]
    ok = nbr_sel >= 0
    safe = nbr_sel.clamp(min=0, max=mb - 1).to(torch.int64)
    fill_t = torch.full((), fill, dtype=values.dtype, device=values.device)
    padded = torch.full((b, v + 2, v + 2, v + 2), fill, dtype=values.dtype,
                        device=values.device)
    k = 0
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dz in (-1, 0, 1):
                rows_k = torch.where(
                    ok[:, k, None], values[safe[:, k]], fill_t).view(
                        b, v, v, v)
                (dz_d, dz_s), (dy_d, dy_s), (dx_d, dx_s) = (
                    _shell_slices(o, v) for o in (dz, dy, dx))
                padded[:, dz_d, dy_d, dx_d] = rows_k[:, dz_s, dy_s, dx_s]
                k += 1
    return padded


@dataclasses.dataclass
class BlockMesh:
    """Per-block triangle soup."""

    vertices: np.ndarray  # f32[N,3]
    normals: np.ndarray  # f32[N,3]
    colors: np.ndarray  # uint8[N,3]
    indices: np.ndarray  # int32[N] (trivial 0..N-1 soup, welded on export)


class MeshLayer:
    """Block-hash map of BlockMesh, on the host."""

    def __init__(self, block_size: float):
        self.block_size = block_size
        self.blocks: Dict[Tuple[int, int, int], BlockMesh] = {}

    def update_block(self, index, mesh: Optional[BlockMesh]):
        key = tuple(int(i) for i in index)
        if mesh is None or len(mesh.vertices) == 0:
            self.blocks.pop(key, None)
        else:
            self.blocks[key] = mesh

    def combined(self):
        """Concatenate all block meshes -> (vertices, normals, colors)."""
        if not self.blocks:
            z = np.zeros((0, 3), np.float32)
            return z, z, np.zeros((0, 3), np.uint8)
        vs = np.concatenate([b.vertices for b in self.blocks.values()])
        ns = np.concatenate([b.normals for b in self.blocks.values()])
        cs = np.concatenate([b.colors for b in self.blocks.values()])
        return vs, ns, cs

    def num_vertices(self) -> int:
        return sum(len(b.vertices) for b in self.blocks.values())


def weld_vertices(vertices, normals, colors, tol: float = 1e-6):
    """Weld identical vertices -> (unique_verts, unique_normals(avg),
    unique_colors, tri_indices); positions are quantized by ``tol``."""
    if len(vertices) == 0:
        return vertices, normals, colors, np.zeros((0,), np.int64)
    q = np.round(vertices / tol).astype(np.int64)
    _, first, inv = np.unique(q, axis=0, return_index=True,
                              return_inverse=True)
    inv = inv.reshape(-1)
    uv = vertices[first]
    uc = colors[first]
    un = np.zeros_like(uv)
    np.add.at(un, inv, normals)
    norm = np.linalg.norm(un, axis=1, keepdims=True)
    un = un / np.maximum(norm, 1e-12)
    return uv, un, uc, inv


# ---------------------------------------------------------------------------
# Dense march of a batch of pool rows (host export paths)
# ---------------------------------------------------------------------------


def _march_core(layer: vlayer.VoxelLayer, rows, min_weight: float,
                use_color: bool):
    """March all vps^3 cubes of the selected pool rows (``rows`` int32[B],
    -1 = padding, masked out). Works on TSDF and ESDF layers: validity is
    weight > min_weight, or the observed flag. Returns (tri_verts
    f32[B, C, 5, 3, 3], tri_mask bool[B, C, 5], corner_pos [B, C, 8, 3],
    corner_color [B, C, 8, 3] or None) with C = vps^3 cubes."""
    v = layer.vps
    dev = layer.device
    row_ok = rows >= 0
    safe_rows = torch.where(row_ok, rows, 0).to(torch.int64)
    nbr_sel = probe_neighbor_rows(layer, safe_rows,
                                  layer.active_mask()[safe_rows])

    def padded_sel(values, fill):
        return _padded_from_pool(values, nbr_sel, fill, v)

    ch = layer.channels
    if layer.layer_type == "esdf":
        sdf_pad = padded_sel(ch["esdf"], 0.0)
        flags_pad = padded_sel(ch["esdf_flags"], 0)
        w_pad = ((flags_pad & vlayer.ESDF_OBSERVED) != 0).to(torch.float32)
        min_weight = 0.5  # validity = observed flag
    else:
        sdf_pad = padded_sel(ch["tsdf"], 0.0)
        w_pad = padded_sel(ch["weight"], 0.0)
    if use_color:
        color_pad = torch.stack(
            [padded_sel(ch["color"][:, c::3], 0.0) for c in range(3)], -1)

    # Cube at local (z,y,x) uses padded [1+z+dz, ...] (pool cubes are
    # [z,y,x]; mc.CORNERS are (x,y,z) offsets).
    corner_sdf, corner_w, corner_color = [], [], []
    for cx, cy, cz in mc.CORNERS.tolist():
        sl = (slice(None), slice(1 + cz, 1 + cz + v),
              slice(1 + cy, 1 + cy + v), slice(1 + cx, 1 + cx + v))
        corner_sdf.append(sdf_pad[sl])
        corner_w.append(w_pad[sl])
        if use_color:
            corner_color.append(color_pad[sl])
    corner_sdf = torch.stack(corner_sdf, -1)  # [B, v,v,v, 8]
    corner_w = torch.stack(corner_w, -1)
    cube_valid = (corner_w > min_weight).all(-1)
    cube_valid = cube_valid & row_ok[:, None, None, None]

    block_origin = layer.block_ijk[safe_rows].to(torch.float32) \
        * layer.block_size  # [B,3]
    ar = torch.arange(v, device=dev)
    zz, yy, xx = torch.meshgrid(ar, ar, ar, indexing="ij")
    local = torch.stack([xx, yy, zz], -1).to(torch.float32)  # [v,v,v,3]
    corner_off = _runtime.const(mc.CORNERS, torch.float32, dev)  # [8,3]
    # SDF samples live at voxel centres (+0.5); the cube spans the centres
    # of voxel (i,j,k) and its +1 neighbours.
    corner_pos = (
        block_origin[:, None, None, None, None, :]
        + (local[None, :, :, :, None, :] + corner_off + 0.5)
        * layer.voxel_size)  # [B, v,v,v, 8, 3]

    b = rows.shape[0]
    corner_pos = corner_pos.reshape(b, v ** 3, 8, 3)
    corner_sdf = corner_sdf.reshape(b, v ** 3, 8)
    cube_valid = cube_valid.reshape(b, v ** 3)
    tri_verts, tri_mask = mc.mesh_cubes(corner_pos, corner_sdf, cube_valid)
    if use_color:
        corner_color = torch.stack(corner_color, -2).reshape(b, v ** 3, 8, 3)
    else:
        corner_color = None
    return tri_verts, tri_mask, corner_pos, corner_color


def _nearest_corner_colors(verts, cpos, ccol):
    """Colour of the corner nearest each vertex: verts [..., K, 3], cpos
    and ccol [..., 8, 3] -> [..., K, 3] (first minimum wins)."""
    d2 = ((verts[..., :, None, :] - cpos[..., None, :, :]) ** 2).sum(-1)
    nearest = _first_argmin(d2)  # [..., K]
    return torch.gather(ccol, -2, nearest[..., None].expand(
        nearest.shape + (3,)))


def _first_argmin(x):
    """argmin over the last axis with ties to the lowest index (torch's
    argmin leaves the tie order open)."""
    n = x.shape[-1]
    is_min = x == x.amin(-1, keepdim=True)
    idx = torch.arange(n, device=x.device)
    return torch.where(is_min, idx, n).amin(-1)


def _march_rows(layer: vlayer.VoxelLayer, rows, min_weight: float,
                use_color: bool):
    """Dense (uncompacted) march — the fallback when a packed path's
    triangle budget overflows. Returns (tri_verts, tri_mask, tri_colors)
    over all cubes."""
    tri_verts, tri_mask, corner_pos, corner_color = _march_core(
        layer, rows, min_weight, use_color)
    if corner_color is not None:
        b, c = tri_verts.shape[:2]
        cols = _nearest_corner_colors(
            tri_verts.reshape(b, c, mc.MAX_TRIS * 3, 3), corner_pos,
            corner_color)
        tri_colors = cols.reshape(tri_verts.shape)
    else:
        tri_colors = torch.zeros_like(tri_verts)
    return tri_verts, tri_mask, tri_colors


def _pack_words(cols):
    """float rgb [..., 3] -> int32 words r | g<<8 | b<<16."""
    cc = torch.clamp(cols, 0, 255).to(torch.int32)
    return cc[..., 0] | (cc[..., 1] << 8) | (cc[..., 2] << 16)


def _pack_compacted(tv, corner_pos, corner_color, ids, n_flat,
                    max_tris: int):
    """Gather the ``max_tris`` compacted triangles selected by ``ids``
    (flat cube*5 indices, fill = n_flat) into packed rows
    f32[max_tris, 12]: columns 0-8 the 3 vertices, 9-11 per-vertex rgb as
    packed colour words (bit-cast)."""
    live = ids < n_flat
    safe = torch.where(live, ids, 0).to(torch.int64)
    vv = tv.reshape(n_flat, 9)[safe]
    if corner_color is not None:
        cube = safe // 5
        cols = _nearest_corner_colors(
            vv.reshape(-1, 3, 3), corner_pos.reshape(-1, 8, 3)[cube],
            corner_color.reshape(-1, 8, 3)[cube])
        cw = _pack_words(cols)  # [T,3]
    else:
        cw = torch.zeros((max_tris, 3), dtype=torch.int32, device=tv.device)
    packed = torch.cat([vv, cw.view(torch.float32)], -1)
    return torch.where(live[:, None], packed, 0.0)


def _march_rows_packed(layer: vlayer.VoxelLayer, rows, min_weight: float,
                       use_color: bool, max_tris: int):
    """_march_rows + device-side triangle compaction: (packed
    f32[max_tris, 12], counts int32[B], overflow bool); triangles are
    block-major so a cumsum of counts splits them per block."""
    tv, tm, corner_pos, corner_color = _march_core(
        layer, rows, min_weight, use_color)
    b = rows.shape[0]
    flat_m = tm.reshape(-1)
    n_flat = flat_m.shape[0]
    ids = compact_ids(flat_m, max_tris, fill=n_flat)
    overflow = flat_m.sum() > max_tris
    packed = _pack_compacted(tv, corner_pos, corner_color, ids, n_flat,
                             max_tris)
    counts = tm.reshape(b, -1).sum(-1).to(torch.int32)
    return packed, counts, overflow


# ---------------------------------------------------------------------------
# Device-resident mesh pool
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class MeshPool:
    """Device-resident per-block triangle buffers, row-aligned with the
    voxel pool. ``tris`` is flat [max_blocks, tri_cap*12]; a triangle is 9
    vertex floats + 3 packed colour words (the ``_pack_compacted`` row)."""

    tris: torch.Tensor  # f32[max_blocks, tri_cap*12]
    counts: torch.Tensor  # int32[max_blocks]
    overflow_rows: torch.Tensor  # bool[max_blocks]: count clipped at tri_cap
    tri_cap: int

    @property
    def max_blocks(self) -> int:
        return self.counts.shape[0]


def make_mesh_pool(max_blocks: int, tri_cap: int = 512,
                   device=None) -> MeshPool:
    dev = _runtime.resolve_device(device)
    return MeshPool(
        tris=torch.zeros((max_blocks, tri_cap * 12), dtype=torch.float32,
                         device=dev),
        counts=torch.zeros(max_blocks, dtype=torch.int32, device=dev),
        overflow_rows=torch.zeros(max_blocks, dtype=torch.bool, device=dev),
        tri_cap=int(tri_cap),
    )


def mesh_pool_to_numpy(pool: MeshPool) -> dict:
    """Plain dict of numpy arrays (``tris``, ``counts``, ``overflow_rows``)
    and ``tri_cap``."""
    return dict(tris=pool.tris.cpu().numpy(),
                counts=pool.counts.cpu().numpy(),
                overflow_rows=pool.overflow_rows.cpu().numpy(),
                tri_cap=pool.tri_cap)


def mesh_pool_from_numpy(d: dict, device=None) -> MeshPool:
    """Inverse of ``mesh_pool_to_numpy`` onto ``device``."""
    dev = _runtime.resolve_device(device)

    def t(x, dtype):
        return torch.from_numpy(np.array(x)).to(dtype=dtype, device=dev)

    return MeshPool(tris=t(d["tris"], torch.float32),
                    counts=t(d["counts"], torch.int32),
                    overflow_rows=t(d["overflow_rows"], torch.bool),
                    tri_cap=int(d["tri_cap"]))


_PLUS8 = np.array([[(k & 1), (k >> 1) & 1, (k >> 2) & 1] for k in range(8)],
                  np.int32)  # [8, 3] (x, y, z), k = oz*4 + oy*2 + ox


def _nbr8_for_rows(layer: vlayer.VoxelLayer, rows, row_ok):
    """int32[B, 8] pool slots of each selected row's +1 neighbourhood
    (k = oz*4 + oy*2 + ox; -1 missing): B*8 hash probes."""
    safe_rows = torch.where(row_ok, rows, 0).to(torch.int64)
    offs = _runtime.const(_PLUS8, torch.int32, layer.device)
    nbr_ijk = layer.block_ijk[safe_rows][:, None, :] + offs[None]
    slots = vlayer.lookup_blocks(layer, nbr_ijk)
    return torch.where(row_ok[:, None], slots, -1)


def _plus_shell(dst, cube_of):
    """Fill the plus-side shell of ``dst`` [B, v+1, v+1, v+1] from the 7
    plus-side neighbour cubes ``cube_of(k)`` [B, v, v, v]."""
    v = dst.shape[1] - 1
    full, one, first = slice(0, v), slice(v, v + 1), slice(0, 1)
    for k in range(1, 8):
        oz, oy, ox = (k >> 2) & 1, (k >> 1) & 1, k & 1
        d = (slice(None), one if oz else full, one if oy else full,
             one if ox else full)
        s = (slice(None), first if oz else full, first if oy else full,
             first if ox else full)
        dst[d] = cube_of(k)[s]
    return dst


def _plus_halo_sel(values, rows, row_ok, nbr8, fill, v):
    """Plus-side halo cubes [B, v+1, v+1, v+1] for selected rows of the
    flat pool channel ``values``. The centre cube reads ``values[rows]``
    directly (not through the hash self-lookup nbr8[:, 0]); cube corner
    taps only ever read indices 0..v, so no minus-side halo is built."""
    mb = values.shape[0]
    b = nbr8.shape[0]
    fill_t = torch.full((), fill, dtype=values.dtype, device=values.device)

    def rows_at(k):
        sel = nbr8[:, k]
        r = values[sel.clamp(min=0, max=mb - 1).to(torch.int64)]
        return torch.where((sel >= 0)[:, None], r, fill_t).view(b, v, v, v)

    center = torch.where(
        row_ok[:, None],
        values[torch.where(row_ok, rows, 0).to(torch.int64)], fill_t)
    padded = torch.full((b, v + 1, v + 1, v + 1), fill, dtype=values.dtype,
                        device=values.device)
    padded[:, :v, :v, :v] = center.view(b, v, v, v)
    return _plus_shell(padded, rows_at)


def update_mesh_pool(layer: vlayer.VoxelLayer, pool: MeshPool,
                     cfg: MeshIntegratorConfig = MeshIntegratorConfig(),
                     bucket: int = 64, only_updated: bool = True):
    """March up to ``bucket`` dirty rows and replace their mesh-pool rows,
    with no host read: row selection, marching, per-block triangle
    compaction and the pool scatter all run on the device. The mesh dirty
    bit of the processed rows is cleared and their publish-pending bit
    set; rows beyond the bucket stay dirty for the next call.

    Compact-first march: the dense phase computes only per-cube sign
    configs and corner validity; every gather, edge interpolation and
    colour lookup runs on the compacted surface-cube set (at most
    ``min(march_cube_budget, bucket * tri_cap)`` cubes, block-major, each
    row guarded at ``tri_cap`` cubes). Rows whose triangles exceed
    ``tri_cap`` or whose cubes spill the budget are flagged in
    ``overflow_rows`` and re-meshed densely on export.

    Updates ``pool`` and ``layer.block_flags`` in place. Returns (layer,
    pool, more) where ``more`` is a device bool: dirty rows remain."""
    use_color = cfg.use_color and "color" in layer.channels
    min_weight = cfg.min_weight
    cube_budget = cfg.march_cube_budget
    dev = layer.device
    if only_updated:
        mask = vlayer.dirty_mask(layer, vlayer.DIRTY_MESH)
    else:
        mask = layer.active_mask()
    b = int(bucket)
    rows = compact_ids(mask, b, fill=-1)
    more = mask.sum() > b
    row_ok = rows >= 0

    v = layer.vps
    vpb = v ** 3
    cap = pool.tri_cap
    nbr8 = _nbr8_for_rows(layer, rows, row_ok)
    ch = layer.channels
    if layer.layer_type == "esdf":
        sdf_pad = _plus_halo_sel(ch["esdf"], rows, row_ok, nbr8, 0.0, v)
        flags_pad = _plus_halo_sel(ch["esdf_flags"], rows, row_ok, nbr8, 0,
                                   v)
        w_pad = ((flags_pad & vlayer.ESDF_OBSERVED) != 0).to(torch.float32)
        min_weight = 0.5  # validity = observed flag
    else:
        sdf_pad = _plus_halo_sel(ch["tsdf"], rows, row_ok, nbr8, 0.0, v)
        w_pad = _plus_halo_sel(ch["weight"], rows, row_ok, nbr8, 0.0, v)

    # ---- dense phase: sign config + validity only ----------------------
    corners = mc.CORNERS.tolist()  # (x, y, z)
    config = torch.zeros((b, v, v, v), dtype=torch.int32, device=dev)
    valid = row_ok[:, None, None, None].expand(b, v, v, v)
    for i, (cx, cy, cz) in enumerate(corners):
        sl = (slice(None), slice(cz, cz + v), slice(cy, cy + v),
              slice(cx, cx + v))
        config = config | ((sdf_pad[sl] < 0.0).to(torch.int32) << i)
        valid = valid & (w_pad[sl] > min_weight)
    # Every config outside {0, 255} emits >= 1 triangle (asserted on the
    # derived table), so the surface-cube mask needs no table lookup.
    surf = (valid & (config != 0) & (config != 255)).reshape(b, vpb)

    n_cubes = b * vpb
    t_budget = b * cap
    if cube_budget is not None:
        t_budget = min(int(cube_budget), t_budget)
    incl = torch.cumsum(surf.to(torch.int32), 1, dtype=torch.int32)
    # Per-row guard: beyond cap surface cubes the row overflows tri_cap
    # anyway (>= 1 triangle each); capping its compacted share keeps one
    # dense row from eating the whole cube budget.
    keep_cube = surf & (incl <= cap)
    ovf = (surf & (incl > cap)).any(1)
    if t_budget < b * cap:
        # The compaction keeps the first t_budget surviving cubes in
        # block-major order, so any spill hits the trailing bucket rows:
        # flag every row whose cumulative kept-cube count passes the
        # budget (its content may be partial).
        kept_per_row = keep_cube.sum(1)
        ovf = ovf | (torch.cumsum(kept_per_row, 0) > t_budget)
    inclk = torch.clamp(incl, max=cap)  # = per-row cumsum of keep_cube
    row_tot = inclk[:, -1].to(torch.int64)
    row_base = torch.cumsum(row_tot, 0) - row_tot  # [b] exclusive
    gdst = row_base[:, None] + inclk - 1
    flat_id = torch.arange(n_cubes, dtype=torch.int64, device=dev).view(
        b, vpb)
    # Dropped cubes all land on the dump slot t_budget, which is cut off.
    wdst = torch.where(keep_cube & (gdst < t_budget), gdst, t_budget)
    cid = torch.full((t_budget + 1,), n_cubes, dtype=torch.int64, device=dev)
    cid[wdst.reshape(-1)] = flat_id.reshape(-1)
    cid = cid[:t_budget]
    ok = cid < n_cubes
    safe_cid = torch.where(ok, cid, 0)
    cb = safe_cid // vpb
    cc = safe_cid % vpb
    cz = cc // (v * v)
    cy = (cc // v) % v
    cx = cc % v

    # Corner taps read the assembled [B, v+1, v+1, v+1] halo pad (corner
    # offsets never leave it).
    corner_t = _runtime.const(mc.CORNERS, torch.int64, dev)  # [8,3]
    tx = cx[:, None] + corner_t[None, :, 0]
    ty = cy[:, None] + corner_t[None, :, 1]
    tz = cz[:, None] + corner_t[None, :, 2]
    vp = v + 1
    addr_pad = ((cb[:, None] * vp + tz) * vp + ty) * vp + tx  # [T,8]
    csdf = sdf_pad.reshape(-1)[addr_pad]  # [T,8]; fill=0 off-map

    # Corner world positions (SDF samples at voxel centres).
    safe_rows = torch.where(row_ok, rows, 0).to(torch.int64)
    block_origin = layer.block_ijk[safe_rows[cb]].to(torch.float32) \
        * layer.block_size  # [T,3]
    base = torch.stack([cx, cy, cz], -1).to(torch.float32)  # [T,3]
    cpos = (block_origin[:, None, :]
            + (base[:, None, :] + corner_t.to(torch.float32)[None] + 0.5)
            * layer.voxel_size)  # [T,8,3]
    t, edge_pts = mc.edge_crossings(cpos, csdf)  # [T,12], [T,12,3]

    config_c = mc.cube_config(csdf)
    table = _runtime.const(mc.TRI_TABLE, torch.int64, dev)
    ids15 = table[config_c][:, : mc.MAX_TRIS * 3].clamp(min=0)  # [T,15]
    count_c = torch.where(
        ok, _runtime.const(mc.TRI_COUNT, torch.int64, dev)[config_c], 0)

    # Per-block triangle slot starts on the compacted set (compacted ids
    # ascend block-major, so a block's first cube carries the block-minimum
    # exclusive prefix). Slot b is the dump for dropped cubes.
    g_excl = torch.cumsum(count_c, 0) - count_c
    cb_or_dump = torch.where(ok, cb, b)
    first_g = torch.full((b + 1,), 1 << 30, dtype=torch.int64, device=dev)
    first_g.scatter_reduce_(0, cb_or_dump, g_excl, "amin")
    start_c = g_excl - torch.where(ok, first_g[cb], 0)
    tot = torch.zeros(b + 1, dtype=torch.int64, device=dev)
    tot.index_add_(0, cb_or_dump, count_c)
    tot = tot[:b]
    counts = torch.clamp(tot, max=cap)
    ovf = ovf | (tot > cap)

    # The reference contracts a one-hot over the 12 edges at full
    # precision, which selects exactly; a gather does the same.
    verts = torch.gather(edge_pts, 1, ids15[:, :, None].expand(-1, -1, 3))
    verts = verts.reshape(-1, mc.MAX_TRIS, 9)  # [T,5,9]

    if use_color:
        # Colours as one packed-word plane over the bucket's neighbourhood
        # rows, padded like the SDF and tapped with the same addresses.
        mb = layer.max_blocks
        sel = nbr8.reshape(-1)
        col512 = ch["color"][sel.clamp(min=0, max=mb - 1).to(torch.int64)]
        word512 = _pack_words(col512.view(b * 8, vpb, 3))  # [B*8, vpb]
        word512 = torch.where((sel >= 0)[:, None], word512, 0).view(
            b, 8, v, v, v)
        word_pad = torch.zeros((b, vp, vp, vp), dtype=torch.int32,
                               device=dev)
        word_pad[:, :v, :v, :v] = word512[:, 0]
        _plus_shell(word_pad, lambda k: word512[:, k])
        cword = word_pad.reshape(-1)[addr_pad]  # [T,8]

        # Vertex colour = nearest corner. A vertex lies on edge (e0, e1) at
        # parameter t, so the nearest of the 8 corners is e0 iff t < 0.5
        # (ties resolve to the lower corner index, matching the dense
        # path's argmin).
        cw15 = torch.zeros((csdf.shape[0], mc.MAX_TRIS * 3),
                           dtype=torch.int32, device=dev)
        for e in range(12):
            ce0, ce1 = int(mc.EDGES[e, 0]), int(mc.EDGES[e, 1])
            te = t[:, e]
            pick0 = (te < 0.5) | ((te == 0.5) & (ce0 < ce1))
            wsel = torch.where(pick0, cword[:, ce0], cword[:, ce1])  # [T]
            cw15 = torch.where(ids15 == e, wsel[:, None], cw15)
        cw = cw15.view(-1, mc.MAX_TRIS, 3)
    else:
        cw = torch.zeros((csdf.shape[0], mc.MAX_TRIS, 3), dtype=torch.int32,
                         device=dev)
    packed = torch.cat([verts, cw.view(torch.float32)], -1)  # [T,5,12]

    # Scatter each kept triangle straight to its (block, slot) row; dropped
    # triangles land on the dump slot n_slots. Content covers all bucket
    # slots (b * cap) regardless of the cube budget.
    tidx = torch.arange(mc.MAX_TRIS, device=dev)[None, :]
    slot = start_c[:, None] + tidx  # [T,5]
    keep_tri = ok[:, None] & (tidx < count_c[:, None]) & (slot < cap)
    n_slots = b * cap
    dst = torch.where(keep_tri, cb[:, None] * cap + slot, n_slots)
    content = torch.zeros((n_slots + 1, 12), dtype=torch.float32, device=dev)
    content[dst.reshape(-1)] = packed.reshape(-1, 12)
    content = content[:n_slots].view(b, cap * 12)

    # Counts must never claim slots the compaction did not scatter: a
    # cube-budget spill drops trailing cubes of the boundary row and all
    # cubes of later rows. Each row's scattered triangles are a prefix of
    # its slots, so clamping counts to the per-row scattered total keeps
    # counts consistent with content.
    scattered = torch.zeros(b + 1, dtype=torch.int64, device=dev)
    scattered.index_add_(0, cb_or_dump, keep_tri.sum(1))
    counts = torch.minimum(counts, scattered[:b])

    vlayer.put_rows(pool.tris, rows, row_ok, content)
    vlayer.put_rows(pool.counts, rows, row_ok, counts)
    vlayer.put_rows(pool.overflow_rows, rows, row_ok, ovf)
    clear_inactive_rows(pool, layer)
    # Processed rows: mesh dirty bit off, publish-pending bit on.
    cur = layer.block_flags[safe_rows]
    vlayer.put_rows(layer.block_flags, rows, row_ok,
                    (cur & (~vlayer.DIRTY_MESH & 0xFF)) | vlayer.DIRTY_PUB)
    return layer, pool, more


def clear_inactive_rows(pool: MeshPool, layer: vlayer.VoxelLayer):
    """Empty the mesh rows of inactive blocks (count 0, no overflow flag):
    a removed block's row then exports nothing, and the block a reused
    row holds next shows none of its triangles before it is marched."""
    active = layer.active_mask()
    pool.counts.mul_(active)
    pool.overflow_rows.logical_and_(active)
    return pool


def _export_pool(pool: MeshPool, active, total_cap: int):
    """Device-side compaction of every active row's triangles into one
    block-major packed buffer f32[total_cap, 12] (+ int32[total_cap] pool
    rows, -1 past the end, and the total)."""
    mb = pool.max_blocks
    cap = pool.tri_cap
    counts = torch.where(active, pool.counts, 0).to(torch.int64)
    ends = torch.cumsum(counts, 0)
    starts = ends - counts
    total = ends[-1]
    i = torch.arange(total_cap, dtype=torch.int64, device=counts.device)
    ok = i < total
    row_of = torch.searchsorted(ends, i, right=True).clamp(max=mb - 1)
    t = i - starts[row_of]
    flat = pool.tris.view(mb * cap, 12)
    src = torch.where(ok, row_of * cap + t, 0)
    out = torch.where(ok[:, None], flat[src], 0.0)
    return out, torch.where(ok, row_of, -1).to(torch.int32), total


def _unpack_rows(data):
    """packed f32[T,12] -> (verts [T,3,3], colors [T,3,3] float)."""
    verts = data[:, :9].reshape(-1, 3, 3)
    cw = np.ascontiguousarray(data[:, 9:12]).view(np.uint32)
    cols = np.stack([cw & 0xFF, (cw >> 8) & 0xFF, (cw >> 16) & 0xFF],
                    axis=-1).astype(np.float32)
    return verts, cols


def _emit_dense(mesh_layer, layer, block_ijk, rows_np, cfg, batch: int = 64):
    """Dense march of the given pool rows into ``mesh_layer``."""
    use_color = cfg.use_color and "color" in layer.channels
    for s in range(0, len(rows_np), batch):
        chunk = rows_np[s:s + batch].astype(np.int32)
        pad = np.full(batch, -1, np.int32)
        pad[: len(chunk)] = chunk
        tv, tm, tc = (_runtime.to_host(x) for x in _march_rows(
            layer, torch.from_numpy(pad).to(layer.device), cfg.min_weight,
            use_color))
        for bi, row in enumerate(chunk):
            m = tm[bi]
            verts = tv[bi][m]
            if len(verts) == 0:
                mesh_layer.update_block(block_ijk[row], None)
            else:
                _emit_block(mesh_layer, block_ijk[row], verts,
                            np.clip(tc[bi][m], 0, 255))


def pool_to_mesh_layer(layer: vlayer.VoxelLayer, pool: MeshPool,
                       mesh_layer: MeshLayer,
                       cfg: MeshIntegratorConfig = MeshIntegratorConfig()):
    """Export the device mesh pool into a host MeshLayer (per-block
    triangle soups). Rows flagged ``overflow_rows`` are re-meshed through
    the dense fallback."""
    active_t = layer.active_mask()
    active = _runtime.to_host(active_t)
    counts = np.where(active, _runtime.to_host(pool.counts), 0)
    total = int(counts.sum())
    block_ijk = _runtime.to_host(layer.block_ijk)
    mesh_layer.blocks.clear()
    if total > 0:
        total_cap = 1 << max(10, int(total - 1).bit_length())
        out, _, _ = _export_pool(pool, active_t, total_cap)
        verts, cols = _unpack_rows(_runtime.to_host(out)[:total])
        offs = np.concatenate([[0], np.cumsum(counts)])
        for row in np.nonzero(counts)[0]:
            sl = slice(offs[row], offs[row + 1])
            _emit_block(mesh_layer, block_ijk[row], verts[sl], cols[sl])
    ovf_rows = np.nonzero(_runtime.to_host(pool.overflow_rows) & active)[0]
    if len(ovf_rows):
        _emit_dense(mesh_layer, layer, block_ijk, ovf_rows, cfg)
    return mesh_layer


# ---------------------------------------------------------------------------
# Host path
# ---------------------------------------------------------------------------


def _emit_block(mesh_layer, index, verts, cols):
    """numpy triangles [T,3,3] + colours [T,3,3] -> BlockMesh with flat
    normals."""
    a = verts[:, 1] - verts[:, 0]
    b = verts[:, 2] - verts[:, 0]
    n = np.cross(a, b)
    n = n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-12)
    flat_v = verts.reshape(-1, 3)
    mesh_layer.update_block(
        index,
        BlockMesh(
            vertices=flat_v,
            normals=np.repeat(n, 3, axis=0).astype(np.float32),
            colors=cols.reshape(-1, 3).astype(np.uint8),
            indices=np.arange(len(flat_v), dtype=np.int32),
        ),
    )


def generate_mesh(layer: vlayer.VoxelLayer, mesh_layer: MeshLayer,
                  cfg: MeshIntegratorConfig = MeshIntegratorConfig(),
                  only_updated: bool = True, clear_updated_flag: bool = True,
                  batch: int = 64):
    """Re-mesh updated (or all) blocks into ``mesh_layer`` through the
    host path (march, compact, transfer per batch of rows). Returns the
    (possibly dirty-bit-cleared) voxel layer."""
    if only_updated:
        rows_mask = vlayer.dirty_mask(layer, vlayer.DIRTY_MESH)
    else:
        rows_mask = layer.active_mask()
    rows = np.nonzero(_runtime.to_host(rows_mask))[0].astype(np.int32)
    block_ijk = _runtime.to_host(layer.block_ijk)
    use_color = cfg.use_color and "color" in layer.channels
    max_tris = batch * 512
    for s in range(0, len(rows), batch):
        chunk = rows[s: s + batch]
        pad = np.full(batch, -1, np.int32)
        pad[: len(chunk)] = chunk
        data, counts, overflow = (_runtime.to_host(x) for x in (
            _march_rows_packed(layer, torch.from_numpy(pad).to(layer.device),
                               cfg.min_weight, use_color, max_tris)))
        if bool(overflow):
            _emit_dense(mesh_layer, layer, block_ijk, chunk, cfg, batch)
            continue
        offs = np.concatenate([[0], np.cumsum(counts)])
        verts, cols = _unpack_rows(data[: offs[-1]])
        for bi, row in enumerate(chunk):
            if counts[bi] == 0:
                mesh_layer.update_block(block_ijk[row], None)
                continue
            sl = slice(offs[bi], offs[bi + 1])
            _emit_block(mesh_layer, block_ijk[row], verts[sl], cols[sl])
    if clear_updated_flag:
        layer = vlayer.clear_dirty(layer, vlayer.DIRTY_MESH)
    return layer
