"""Incremental mesh wire format: uint16-quantized per-block deltas (port
of voxblox_tpu/io/mesh_msg.py).

The reference's streaming mesh channel (voxblox_msgs/MeshBlock.msg,
generateVoxbloxMeshMsg in mesh_vis.h:153-231, the rviz plugin's decoder):
- each re-meshed block ships its whole triangle soup (vertices in groups
  of 3), replacing the receiver's copy of that block;
- vertices are quantized to uint16 in normalized block coordinates
  n = 0.5 * (v / block_size - block_index), steps of 2 * block_size / 65535;
- colours are uint8 RGB (optional);
- a block with zero vertices deletes the block on the receiver.

Encoding runs on the device over the MeshPool's rows with the
publish-pending bit (DIRTY_PUB): triangle compaction (``ops/mesh.
_export_pool``) and quantization, then one copy of the ~9 bytes a vertex
to the host. Two host reads per publish: the row set with its counts and
overflow flags, then the payload. Rows whose pool content overflowed are
re-marched densely instead.

Framing (little-endian):

    magic b"VMSH" | u8 version (1) | u8 has_color | f32 block_edge_length
    u32 n_blocks, then per block:
        i64[3] block index | u32 n_verts (0 = delete block)
        u16[n] x | u16[n] y | u16[n] z | u8[n] r, g, b (if has_color)
"""

from __future__ import annotations

import dataclasses
import struct
from typing import List, Optional, Tuple

import numpy as np
import torch

from .. import _runtime
from ..core import layer as vlayer
from ..ops import mesh as mesh_ops

_MAGIC = b"VMSH"
_VERSION = 1


@dataclasses.dataclass
class MeshBlockMsg:
    """One block's delta (voxblox_msgs/MeshBlock.msg fields)."""

    index: Tuple[int, int, int]
    x: np.ndarray  # uint16[n]
    y: np.ndarray
    z: np.ndarray
    r: Optional[np.ndarray] = None  # uint8[n]
    g: Optional[np.ndarray] = None
    b: Optional[np.ndarray] = None


@dataclasses.dataclass
class MeshMsg:
    """voxblox_msgs/Mesh.msg: header + per-block deltas."""

    block_edge_length: float
    blocks: List[MeshBlockMsg]
    has_color: bool = True


def _quantize(verts, idx, block_size: float):
    """f32 world vertices [N,3] and their block indices -> uint16 wire
    coordinates as int32 [N,3]."""
    n = 0.5 * (verts / np.float32(block_size) - idx.to(torch.float32))
    return torch.clamp(torch.round(n * 65535.0), 0.0, 65535.0).to(torch.int32)


def _encode_payload(pool, block_ijk, mask, total_cap: int,
                    block_size: float):
    """Compact the selected rows' triangles and quantize on the device:
    uint8 [total_cap * 3, 9], per vertex x, y, z as little-endian uint16
    and r, g, b. Vertex k of packed triangle t is row t * 3 + k."""
    packed, row_of, _ = mesh_ops._export_pool(pool, mask, total_cap)
    verts = packed[:, :9].reshape(-1, 3)
    idx = block_ijk[row_of.clamp(0, block_ijk.shape[0] - 1).to(torch.int64)]
    q = _quantize(verts, torch.repeat_interleave(idx, 3, dim=0), block_size)
    qb = q.to(torch.int32).contiguous().view(torch.uint8).view(-1, 3, 4)
    cw = packed[:, 9:12].contiguous().view(torch.int32).reshape(-1)
    cb = cw.contiguous().view(torch.uint8).view(-1, 4)[:, :3]
    return torch.cat([qb[:, :, :2].reshape(-1, 6), cb], 1)


def encode_mesh_msg(layer: vlayer.VoxelLayer, pool: mesh_ops.MeshPool,
                    use_color: bool = True, clear_pub_flag: bool = True,
                    rows_mask=None):
    """Encode the publish-pending rows (DIRTY_PUB) into a MeshMsg; rows
    whose march produced no triangle ship empty (delete downstream).
    ``rows_mask`` (bool[max_blocks]) overrides the row selection. Returns
    (msg, layer) with the publish bits cleared."""
    if rows_mask is None:
        rows_mask = vlayer.dirty_mask(layer, vlayer.DIRTY_PUB)
    mb = layer.max_blocks
    state = _runtime.to_host(torch.stack([
        rows_mask.to(torch.int32), pool.counts.to(torch.int32),
        pool.overflow_rows.to(torch.int32)]))
    mask_np, counts_np, ovf_np = state[0] != 0, state[1], state[2] != 0
    # An overflowed row holds partial pool content; a block message
    # replaces the receiver's block, so those rows go through the dense
    # march below instead.
    ovf_np = ovf_np & mask_np
    wire_np = mask_np & ~ovf_np
    rows = np.flatnonzero(wire_np)
    counts = np.where(wire_np, counts_np, 0)
    total = int(counts.sum())
    blocks: List[MeshBlockMsg] = []
    ovf_rows = np.flatnonzero(ovf_np)
    q = np.zeros((0, 3), np.uint16)
    rgb = np.zeros((0, 3), np.uint8)
    block_ijk = None
    if total > 0:
        total_cap = 1 << max(8, int(total - 1).bit_length())
        payload = _encode_payload(
            pool, layer.block_ijk,
            torch.from_numpy(wire_np).to(layer.device), total_cap,
            layer.block_size)
        host = _runtime.to_host(torch.cat([
            payload.reshape(-1),
            layer.block_ijk.contiguous().view(torch.uint8).reshape(-1)]))
        nv = total_cap * 3
        data = host[:nv * 9].reshape(nv, 9)
        q = data[:, :6].copy().view(np.uint16)
        rgb = data[:, 6:9]
        block_ijk = host[nv * 9:].view(np.int32).reshape(mb, 3)
    elif len(rows) or len(ovf_rows):
        block_ijk = _runtime.to_host(layer.block_ijk)

    start = 0
    for row in rows:
        nv = int(counts[row]) * 3
        sl = slice(start * 3, start * 3 + nv)
        blk = MeshBlockMsg(index=tuple(int(v) for v in block_ijk[row]),
                           x=q[sl, 0].copy(), y=q[sl, 1].copy(),
                           z=q[sl, 2].copy())
        if use_color:
            blk.r, blk.g, blk.b = (rgb[sl, k].copy() for k in range(3))
        blocks.append(blk)
        start += int(counts[row])

    # Dense fallback for overflowed rows: march the whole geometry and
    # quantize on the host, so a receiver never holds a truncated block.
    for s in range(0, len(ovf_rows), 64):
        chunk = ovf_rows[s:s + 64].astype(np.int32)
        pad = np.full(64, -1, np.int32)
        pad[:len(chunk)] = chunk
        tv, tm, tc = (_runtime.to_host(x) for x in mesh_ops._march_rows(
            layer, torch.from_numpy(pad).to(layer.device), 1e-6, use_color))
        for bi, row in enumerate(chunk):
            m = tm[bi]
            verts = tv[bi][m].reshape(-1, 3)
            idx = block_ijk[row].astype(np.float32)
            n = 0.5 * (verts / np.float32(layer.block_size) - idx[None, :])
            qv = np.clip(np.round(n * 65535.0), 0.0, 65535.0).astype(np.uint16)
            blk = MeshBlockMsg(index=tuple(int(v) for v in block_ijk[row]),
                               x=qv[:, 0].copy(), y=qv[:, 1].copy(),
                               z=qv[:, 2].copy())
            if use_color:
                cols = np.clip(tc[bi][m].reshape(-1, 3), 0, 255).astype(
                    np.uint8)
                blk.r, blk.g, blk.b = cols[:, 0], cols[:, 1], cols[:, 2]
            blocks.append(blk)

    msg = MeshMsg(block_edge_length=float(layer.block_size), blocks=blocks,
                  has_color=use_color)
    if clear_pub_flag:
        layer = vlayer.clear_dirty(layer, vlayer.DIRTY_PUB)
    return msg, layer


def serialize_mesh_msg(msg: MeshMsg) -> bytes:
    out = [_MAGIC, struct.pack("<BBfI", _VERSION, int(msg.has_color),
                               msg.block_edge_length, len(msg.blocks))]
    for blk in msg.blocks:
        out.append(struct.pack("<3qI", *blk.index, len(blk.x)))
        for a in (blk.x, blk.y, blk.z):
            out.append(np.ascontiguousarray(a, np.uint16).tobytes())
        if msg.has_color:
            for a in (blk.r, blk.g, blk.b):
                out.append(np.ascontiguousarray(a, np.uint8).tobytes())
    return b"".join(out)


def deserialize_mesh_msg(data: bytes) -> MeshMsg:
    if data[:4] != _MAGIC:
        raise ValueError("not a mesh message")
    ver, has_color, edge, n_blocks = struct.unpack_from("<BBfI", data, 4)
    if ver != _VERSION:
        raise ValueError(f"unsupported mesh msg version {ver}")
    off = 4 + struct.calcsize("<BBfI")
    blocks = []
    for _ in range(n_blocks):
        ix, iy, iz, n = struct.unpack_from("<3qI", data, off)
        off += struct.calcsize("<3qI")

        def arr(dtype):
            nonlocal off
            a = np.frombuffer(data, dtype, n, off).copy()
            off += a.nbytes
            return a

        blk = MeshBlockMsg(index=(ix, iy, iz), x=arr(np.uint16),
                           y=arr(np.uint16), z=arr(np.uint16))
        if has_color:
            blk.r, blk.g, blk.b = arr(np.uint8), arr(np.uint8), arr(np.uint8)
        blocks.append(blk)
    return MeshMsg(block_edge_length=edge, blocks=blocks,
                   has_color=bool(has_color))


def dequantize_block(msg: MeshMsg, blk: MeshBlockMsg) -> np.ndarray:
    """uint16 wire coordinates -> f32 world vertices (the rviz plugin's
    2/65535 conversion, voxblox_mesh_visual.cc:41-57)."""
    conv = 2.0 / 65535.0
    idx = np.asarray(blk.index, np.float32)
    q = np.stack([blk.x, blk.y, blk.z], axis=-1).astype(np.float32)
    return (q * conv + idx[None, :]) * msg.block_edge_length


def apply_mesh_msg(mesh_layer: mesh_ops.MeshLayer, msg: MeshMsg):
    """Apply a delta to a host MeshLayer (the subscriber side: replace
    each block's soup; an empty block deletes it)."""
    for blk in msg.blocks:
        n = len(blk.x)
        if n == 0:
            mesh_layer.update_block(blk.index, None)
            continue
        verts = dequantize_block(msg, blk)
        colors = (np.stack([blk.r, blk.g, blk.b], -1).astype(np.uint8)
                  if msg.has_color else np.zeros((n, 3), np.uint8))
        tri = verts.reshape(-1, 3, 3)
        nrm = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
        nrm /= np.maximum(np.linalg.norm(nrm, axis=-1, keepdims=True), 1e-12)
        mesh_layer.update_block(blk.index, mesh_ops.BlockMesh(
            vertices=verts, normals=np.repeat(nrm, 3, axis=0), colors=colors,
            indices=np.arange(n, dtype=np.int32)))
    return mesh_layer


def message_bytes(msg: MeshMsg) -> int:
    """Wire size: 28 B a block header + 9 B a vertex with colour (6
    without)."""
    per_v = 9 if msg.has_color else 6
    return (4 + struct.calcsize("<BBfI")
            + sum(struct.calcsize("<3qI") + per_v * len(b.x)
                  for b in msg.blocks))
