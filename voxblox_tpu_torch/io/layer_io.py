""".vxblx layer files (port of voxblox_tpu/io/layer_io.py), wire-compatible
with the reference.

A file is ``varint32 message_count`` followed by that many varint-delimited
protobuf messages: one LayerProto header, then one BlockProto per block
(``io/wire.py`` writes and reads them). Several layers may follow one
another in one file (the ESDF server appends its ESDF after the TSDF).

Voxel payloads are uint32 words in the reference's bit layouts:
- tsdf:      3 words: f32 distance | f32 weight | r<<24|g<<16|b<<8|a
- esdf:      2 words: f32 distance | px<<24|py<<16|pz<<8|flags, flags on
             the wire observed=1, hallucinated=2, in_queue=4, fixed=8
             (the layer's own bits are observed=1, fixed=2,
             hallucinated=4, in_queue=8 and are remapped)
- occupancy: 2 words: f32 log_odds | observed
- intensity: 2 words: f32 intensity | f32 weight

Packing runs on the layer's device over all rows at once with bit views
of the channels, and the words cross to the host in one copy per layer;
loading uploads a layer's words once and unpacks them on the device.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import _runtime
from ..core import layer as vlayer
from . import wire

# BlockMergingStrategy (reference core/layer.h:54).
PROHIBIT, OVERWRITE, DISCARD, MERGE = range(4)

WORDS_PER_VOXEL = {"tsdf": 3, "esdf": 2, "occupancy": 2, "intensity": 2}


# ---------------------------------------------------------------------------
# Voxel word packing, on the device
# ---------------------------------------------------------------------------


def _word(x):
    """float32 [...] or uint8 [..., 4] (little-endian bytes) -> int32 [...]
    with the same bits."""
    if x.dtype == torch.uint8:
        return x.contiguous().view(torch.int32)[..., 0]
    return x.contiguous().view(torch.int32)


def _bytes(word):
    """int32 [n, v] -> uint8 [n, v, 4], least significant byte first."""
    n, v = word.shape
    return word.contiguous().view(torch.uint8).view(n, v, 4)


def pack_voxels(layer_type: str, channels: dict, rows) -> torch.Tensor:
    """Pool rows -> int32 [len(rows), vpb * words] holding the uint32
    voxel words of each row in linear voxel order."""
    rows = rows.to(torch.int64)
    if layer_type == "tsdf":
        d, w = channels["tsdf"][rows], channels["weight"][rows]
        n, vpb = d.shape
        c = channels["color"][rows].view(n, vpb, 3)
        cb = torch.clamp(torch.round(c), 0, 255).to(torch.uint8)
        rgba = torch.stack([torch.full_like(cb[..., 0], 255), cb[..., 2],
                            cb[..., 1], cb[..., 0]], -1)
        out = torch.stack([_word(d), _word(w), _word(rgba)], -1)
    elif layer_type == "esdf":
        d, f = channels["esdf"][rows], channels["esdf_flags"][rows]
        n, vpb = d.shape
        p = channels["parent"][rows].view(n, vpb, 3).view(torch.uint8)
        wire_flags = (((f & vlayer.ESDF_OBSERVED) != 0).to(torch.uint8)
                      | ((f & vlayer.ESDF_HALLUCINATED) != 0).to(torch.uint8)
                      << 1
                      | ((f & vlayer.ESDF_IN_QUEUE) != 0).to(torch.uint8) << 2
                      | ((f & vlayer.ESDF_FIXED) != 0).to(torch.uint8) << 3)
        word2 = torch.stack([wire_flags, p[..., 2], p[..., 1], p[..., 0]], -1)
        out = torch.stack([_word(d), _word(word2)], -1)
    elif layer_type == "occupancy":
        d, o = channels["log_odds"][rows], channels["occ_observed"][rows]
        out = torch.stack([_word(d), (o != 0).to(torch.int32)], -1)
    elif layer_type == "intensity":
        i, w = channels["intensity"][rows], channels["intensity_weight"][rows]
        out = torch.stack([_word(i), _word(w)], -1)
    else:
        raise ValueError(layer_type)
    return out.reshape(out.shape[0], -1)


def unpack_voxels(layer_type: str, words, vpb: int) -> dict:
    """int32 [n, vpb * words] -> dict of channel tensors [n, vpb] (colour
    and parent [n, vpb, 3]), in the channels' order."""
    n = words.shape[0]
    w = words.reshape(n, vpb, WORDS_PER_VOXEL[layer_type])

    def f32(k):
        return w[..., k].contiguous().view(torch.float32)

    if layer_type == "tsdf":
        b = _bytes(w[..., 2])
        color = torch.stack([b[..., 3], b[..., 2], b[..., 1]], -1)
        return {"tsdf": f32(0), "weight": f32(1),
                "color": color.to(torch.float32)}
    if layer_type == "esdf":
        b = _bytes(w[..., 1])
        wf = b[..., 0]
        flags = (((wf & 1) != 0).to(torch.uint8) * vlayer.ESDF_OBSERVED
                 | ((wf & 8) != 0).to(torch.uint8) * vlayer.ESDF_FIXED
                 | ((wf & 2) != 0).to(torch.uint8) * vlayer.ESDF_HALLUCINATED
                 | ((wf & 4) != 0).to(torch.uint8) * vlayer.ESDF_IN_QUEUE)
        parent = torch.stack([b[..., 3], b[..., 2], b[..., 1]], -1)
        return {"esdf": f32(0), "esdf_flags": flags,
                "parent": parent.view(torch.int8)}
    if layer_type == "occupancy":
        return {"log_odds": f32(0),
                "occ_observed": ((w[..., 1] & 0xFF) != 0).to(torch.uint8)}
    if layer_type == "intensity":
        return {"intensity": f32(0), "intensity_weight": f32(1)}
    raise ValueError(layer_type)


# ---------------------------------------------------------------------------
# Save
# ---------------------------------------------------------------------------


def layer_stream(layer: vlayer.VoxelLayer, mask=None):
    """The layer's rows selected by ``mask`` (default: active rows) as
    a count, a delimited header and delimited blocks: a stream of
    bytes-like pieces. Two host reads: the mask, then the packed rows
    with their block indices in one copy."""
    mask = layer.active_mask() if mask is None else mask
    rows = np.flatnonzero(_runtime.to_host(mask))
    rows_t = torch.from_numpy(rows).to(layer.device)
    packed = torch.cat([layer.block_ijk[rows_t],
                        pack_voxels(layer.layer_type, layer.channels, rows_t)],
                       1)
    host = _runtime.to_host(packed)
    origins = host[:, :3].astype(np.float64) * layer.block_size
    yield wire.varint(len(rows) + 1)
    yield wire.delimited(wire.layer_header(layer.voxel_size, layer.vps,
                                           layer.layer_type))
    yield from wire.block_messages(layer.vps, layer.voxel_size, origins,
                                   host[:, 3:].view(np.uint32))


def save_layer(layer: vlayer.VoxelLayer, path: str, append: bool = False):
    """Write a layer as a .vxblx stream (LayerProto + BlockProtos);
    ``append`` adds it after the layers already in the file."""
    with open(path, "ab" if append else "wb") as f:
        for piece in layer_stream(layer):
            f.write(piece)


# ---------------------------------------------------------------------------
# Load
# ---------------------------------------------------------------------------


def load_layer(path: str, layer_type: Optional[str] = None,
               max_blocks: int = 4096, strategy: int = OVERWRITE,
               into: Optional[vlayer.VoxelLayer] = None,
               device=None) -> vlayer.VoxelLayer:
    """Load the first layer of ``layer_type`` (any, if None) from a .vxblx
    file onto ``device`` (default CUDA; ``into``'s device if given).

    With ``into``, blocks are merged into it by ``strategy``: PROHIBIT
    raises on a block it already has, OVERWRITE replaces, DISCARD keeps
    the existing block, MERGE combines voxels (layer_inl.h:191-240)."""
    with open(path, "rb") as f:
        reader = wire.Reader(f.read())
    while True:
        if reader.at_end():
            raise ValueError(f"no layer of type {layer_type!r} found in {path}")
        count = reader.varint()
        hdr = reader.layer_header()
        if layer_type is not None and hdr.type != layer_type:
            for _ in range(count - 1):
                reader.skip()
            continue
        return load_blocks(reader, hdr, count - 1, max_blocks, strategy, into,
                           device)


def load_blocks(reader: wire.Reader, hdr: wire.LayerProto, n_blocks: int,
                max_blocks: int, strategy: int,
                into: Optional[vlayer.VoxelLayer], device=None):
    """Read ``n_blocks`` BlockProtos from ``reader`` into a new layer (or
    ``into``, by ``strategy``)."""
    vps = int(hdr.voxels_per_side)
    voxel_size = float(hdr.voxel_size)
    if into is None:
        layer = vlayer.make_layer(hdr.type, voxel_size, vps=vps,
                                  max_blocks=max(max_blocks, n_blocks),
                                  device=device)
    else:
        layer = into
        if layer.vps != vps or abs(layer.voxel_size - voxel_size) >= 1e-9:
            raise ValueError("isCompatible failed: voxel_size/vps mismatch")
        if layer.layer_type != hdr.type:
            raise ValueError(f"layer type {hdr.type!r} into a "
                             f"{layer.layer_type!r} layer")
    block_size = voxel_size * vps
    ijk, payloads = [], []
    for _ in range(n_blocks):
        bp = reader.block()
        ijk.append(np.round(np.array([bp.origin_x, bp.origin_y, bp.origin_z])
                            / block_size).astype(np.int32))
        payloads.append(bp.voxel_data)
    if not ijk:
        return layer

    dev = layer.device
    n = len(ijk)
    vpb = vps ** 3
    idx = torch.from_numpy(np.stack(ijk)).to(dev)
    existing = vlayer.lookup_blocks(layer, idx) >= 0
    if strategy == PROHIBIT and _runtime.host_bool(existing.any()):
        raise ValueError("BlockMergingStrategy.PROHIBIT: duplicate blocks")
    layer, overflow = vlayer.allocate_blocks(
        layer, idx, torch.ones(n, dtype=torch.bool, device=dev))
    if _runtime.host_bool(overflow):
        raise MemoryError("pool overflow during load; raise max_blocks")
    slots = vlayer.lookup_blocks(layer, idx)
    words = torch.from_numpy(np.stack(payloads).view(np.int32)).to(dev)
    vals = unpack_voxels(hdr.type, words, vpb)
    write = (~existing if strategy == DISCARD
             else torch.ones(n, dtype=torch.bool, device=dev))
    # Channel by channel in the voxel's order: a MERGE of the colour sees
    # the weight already merged, as the reference's loop does.
    for name, arr in vals.items():
        tgt = layer.channels[name]
        new = arr.reshape(n, -1)
        if strategy == MERGE:
            merged = _merge_voxels(hdr.type, name, tgt[slots.to(torch.int64)],
                                   new, vals, layer.channels, slots, vpb)
            new = torch.where(existing[:, None], merged, new)
        vlayer.put_rows(tgt, slots, write, new)
    return layer


def _merge_voxels(layer_type, name, old, new, new_all, channels, slots, vpb):
    """mergeVoxelAIntoVoxelB (utils/voxel_utils.cc:9-39): weighted average
    for TSDF, plain average for ESDF, sum for occupancy. Rows [n, vpb*k]."""
    if layer_type == "tsdf":
        n = old.shape[0]
        old_w = channels["weight"][slots.to(torch.int64)]
        new_w = new_all["weight"].reshape(n, vpb)
        tot = torch.clamp(old_w + new_w, min=1e-12)
        if name == "tsdf":
            return (old * old_w + new * new_w) / tot
        if name == "color":
            o, c = old.view(n, vpb, 3), new.reshape(n, vpb, 3)
            return ((o * old_w[..., None] + c * new_w[..., None])
                    / tot[..., None]).reshape(n, -1)
        if name == "weight":
            return old + new
    if layer_type == "occupancy" and name == "log_odds":
        return old + new
    if layer_type == "esdf" and name == "esdf":
        return (old + new) / 2.0
    return new


def read_headers(path: str):
    """[(LayerProto, block count)] of every layer in a file."""
    with open(path, "rb") as f:
        reader = wire.Reader(f.read())
    out = []
    while not reader.at_end():
        count = reader.varint()
        out.append((reader.layer_header(), count - 1))
        for _ in range(count - 1):
            reader.skip()
    return out


def load_layer_header(path: str) -> wire.LayerProto:
    """The first LayerProto of a file."""
    with open(path, "rb") as f:
        wire.read_varint_stream(f)
        size = wire.read_varint_stream(f)
        data = f.read(size)
    return wire.parse_layer_header(data, 0, len(data))
