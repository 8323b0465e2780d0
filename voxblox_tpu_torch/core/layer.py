"""Voxel layers: a preallocated block pool + spatial hash (port of
voxblox_tpu/core/layer.py).

Channels are stored flat, ``[max_blocks, vps^3 * k]`` in x-fastest voxel
order, exactly the JAX package's layout, so ``layer_from_numpy`` /
``layer_to_numpy`` carry a map across the two packages row for row.
Mutation is in place: functions return the layer they were given (or a
shallow replacement) with its tensors updated.

Out-of-bounds writes: JAX scatters with ``mode="drop"`` discard lanes
aimed at row ``max_blocks``; torch raises on the CPU and asserts on the
GPU, so every such write goes through ``put_rows`` (dropped lanes repeat
a kept lane's write) or an explicit dump row.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from .. import _runtime
from ..utils import timing
from . import grid
from . import hash as vhash

DIRTY_MAP = 1
DIRTY_MESH = 2
DIRTY_ESDF = 4
DIRTY_ALL = 7
DIRTY_PUB = 8
SWEEP_DEBT = 16
ACTIVE = 128

LAYER_CHANNELS: Dict[str, Dict[str, tuple]] = {
    "tsdf": {"tsdf": (), "weight": (), "color": (3,)},
    "esdf": {"esdf": (), "esdf_flags": (), "parent": (3,)},
    "occupancy": {"log_odds": (), "occ_observed": ()},
    "intensity": {"intensity": (), "intensity_weight": ()},
}

CHANNEL_DTYPES = {
    "esdf_flags": torch.uint8,
    "occ_observed": torch.uint8,
    "parent": torch.int8,
}

ESDF_OBSERVED = 1
ESDF_FIXED = 2
ESDF_HALLUCINATED = 4
ESDF_IN_QUEUE = 8


@dataclasses.dataclass
class VoxelLayer:
    table: vhash.HashTable
    block_ijk: torch.Tensor  # int32[max_blocks, 3]
    block_flags: torch.Tensor  # uint8[max_blocks]; bit 7 = active
    # int32[] high-water row count: no row at or above it was ever handed
    # out; rows below it may be free (inactive) once blocks are removed.
    num_blocks: torch.Tensor
    channels: Dict[str, torch.Tensor]
    voxel_size: float
    vps: int
    layer_type: str

    @property
    def device(self) -> torch.device:
        return self.block_flags.device

    @property
    def max_blocks(self) -> int:
        return self.block_flags.shape[0]

    @property
    def voxels_per_block(self) -> int:
        return self.vps ** 3

    @property
    def block_size(self) -> float:
        return self.voxel_size * self.vps

    def active_mask(self):
        return (self.block_flags & ACTIVE) != 0

    def memory_bytes(self) -> int:
        return sum(c.numel() * c.element_size()
                   for c in self.channels.values())


def make_layer(layer_type: str, voxel_size: float, vps: int = 16,
               max_blocks: int = 4096, table_capacity: int | None = None,
               device=None) -> VoxelLayer:
    """Empty layer with a preallocated pool on ``device`` (default CUDA;
    raises without a GPU unless ``device="cpu"``)."""
    dev = _runtime.resolve_device(device)
    assert vps & (vps - 1) == 0, "vps must be a power of two"
    if table_capacity is None:
        table_capacity = max(64, 4 * max_blocks)
        table_capacity = 1 << (table_capacity - 1).bit_length()
    channels = {}
    for name, extra in LAYER_CHANNELS[layer_type].items():
        k = int(np.prod(extra)) if extra else 1
        channels[name] = torch.zeros(
            (max_blocks, vps ** 3 * k),
            dtype=CHANNEL_DTYPES.get(name, torch.float32), device=dev,
        )
    return VoxelLayer(
        table=vhash.make_table(table_capacity, dev),
        block_ijk=torch.zeros((max_blocks, 3), dtype=torch.int32, device=dev),
        block_flags=torch.zeros(max_blocks, dtype=torch.uint8, device=dev),
        num_blocks=torch.zeros((), dtype=torch.int32, device=dev),
        channels=channels,
        voxel_size=float(voxel_size),
        vps=int(vps),
        layer_type=layer_type,
    )


def clone_layer(layer: VoxelLayer) -> VoxelLayer:
    """Deep copy (every tensor cloned): the in-place updates work on it
    while the original stays as it was."""
    return dataclasses.replace(
        layer,
        table=vhash.HashTable(**{f.name: getattr(layer.table, f.name).clone()
                                 for f in dataclasses.fields(vhash.HashTable)}),
        block_ijk=layer.block_ijk.clone(),
        block_flags=layer.block_flags.clone(),
        num_blocks=layer.num_blocks.clone(),
        channels={k: v.clone() for k, v in layer.channels.items()},
    )


# ---------------------------------------------------------------------------
# Sentinel-safe row writes
# ---------------------------------------------------------------------------


def put_rows(dst, rows, ok, vals):
    """In-place ``dst.at[where(ok, rows, len(dst))].set(vals, mode="drop")``.

    Kept rows must be distinct. Dropped lanes repeat the first kept
    lane's write (same row, same value), so duplicates agree and no dump
    row is needed; with no kept lane they rewrite row 0 with itself."""
    if rows.shape[0] == 0:
        return dst
    # A [1] index, not a 0-dim one: indexing with a 0-dim tensor reads it
    # on the host (a sync on the GPU).
    first = torch.argmax(ok.to(torch.uint8)).view(1)
    any_ok = ok.any()
    r0 = torch.where(any_ok, rows[first].to(torch.int64), 0)
    tgt = torch.where(ok, rows.to(torch.int64), r0)
    vals = vals.to(dst.dtype)
    v0 = torch.where(any_ok, vals[first], dst[:1])
    okb = ok.view((-1,) + (1,) * (vals.dim() - 1))
    dst[tgt] = torch.where(okb, vals, v0)
    return dst


def put_last(dst, idx, ok, vals):
    """In-place ``dst.at[where(ok, idx, len(dst))].set(vals, mode="drop")``
    with duplicate targets: the last lane wins, as in the JAX CPU
    scatter's lane order, made explicit with a scatter-max of lane ids (a
    plain ``index_put_`` of duplicates on the GPU keeps an arbitrary one)."""
    n = dst.shape[0]
    idx = idx.reshape(-1).to(torch.int64)
    ok = ok.reshape(-1)
    lanes = torch.arange(idx.shape[0], dtype=torch.int64, device=dst.device)
    win = torch.full((n + 1,), -1, dtype=torch.int64, device=dst.device)
    win.scatter_reduce_(0, torch.where(ok, idx, n), lanes, "amax")
    win = win[:n]
    hit = win >= 0
    src = vals.reshape((-1,) + dst.shape[1:])[torch.where(hit, win, 0)]
    okb = hit.view((-1,) + (1,) * (dst.dim() - 1))
    dst.copy_(torch.where(okb, src.to(dst.dtype), dst))
    return dst


def scatter_mask(n: int, idx, ok):
    """bool[n]: ``zeros(n+1).at[where(ok, idx, n)].set(True)[:-1]``."""
    out = torch.zeros(n + 1, dtype=torch.bool, device=idx.device)
    # index_fill_ takes the scalar as is; ``out[idx] = True`` would upload
    # it from host memory (a stream sync on the GPU).
    out.index_fill_(0, torch.where(ok, idx.to(torch.int64), n).reshape(-1),
                    True)
    return out[:n]


# ---------------------------------------------------------------------------
# Channel views and lookup
# ---------------------------------------------------------------------------


def channel_extra(layer: VoxelLayer, name: str) -> tuple:
    k = layer.channels[name].shape[1] // layer.voxels_per_block
    return () if k == 1 else (k,)


def cube_rows(layer: VoxelLayer, name: str, rows):
    """Cube view [len(rows), v, v, v, *extra] ([z, y, x]) of pool rows."""
    v = layer.vps
    sub = layer.channels[name][rows]
    return sub.reshape(sub.shape[:-1] + (v, v, v)
                       + channel_extra(layer, name))


def lookup_blocks(layer: VoxelLayer, block_ijk, max_psl: int | None = None):
    """int32[...,3] block indices -> int32[...] pool rows (-1 missing).
    ``max_psl``: the table's probe bound as a host int, if already read
    (``vhash.lookup``). A key inserted past a full pool has no row and
    reads as missing (JAX drops the writes aimed past the pool)."""
    w0, w1 = grid.pack_block_index(block_ijk)
    slot = vhash.lookup(layer.table, w0, w1, max_psl)
    return torch.where(slot < layer.max_blocks, slot, -1)


def global_voxel_to_flat(layer: VoxelLayer, global_ijk,
                         max_psl: int | None = None):
    block, local = grid.split_global(global_ijk, layer.vps)
    slot = lookup_blocks(layer, block, max_psl)
    found = slot >= 0
    lin = grid.local_to_linear(local, layer.vps)
    flat = torch.where(found, slot.to(torch.int64) * layer.voxels_per_block
                       + lin, -1)
    return flat, found


# ---------------------------------------------------------------------------
# Two-phase allocation
# ---------------------------------------------------------------------------


def free_rows(layer: VoxelLayer, k: int):
    """int32[k]: the pool rows the next ``k`` new blocks take, in order.
    First the free rows at or above the high-water mark ``num_blocks``,
    from it up, as a pool that never removed a block hands them out; then
    the rows below it that a removal freed, lowest first; then ids past
    the pool, which mark an overflow (``num_blocks + i`` where nothing was
    freed)."""
    mb = layer.max_blocks
    dev = layer.device
    r = torch.arange(mb, dtype=torch.int64, device=dev)
    free = ~layer.active_mask()
    fresh = free & (r >= layer.num_blocks)
    freed = free & ~fresh
    order = torch.where(fresh, torch.cumsum(fresh, 0),
                        fresh.sum() + torch.cumsum(freed, 0)) - 1
    i = torch.arange(k + 1, dtype=torch.int64, device=dev)
    out = mb + i - free.sum()
    out.scatter_(0, torch.where(free & (order < k), order, k), r)
    return out[:k].to(torch.int32)


def allocate_blocks(layer: VoxelLayer, block_ijk, valid,
                    pending_size: int = 8192):
    """Ensure blocks exist; returns (layer, overflowed bool[]).

    Discovery dedupes missing candidates through a pending buffer indexed
    by key hash, then a parallel hash insert claims pool rows; candidates
    that collide in the buffer wait for the next round. The buffer keeps
    the LAST colliding lane (the JAX CPU scatter's order), made explicit
    here with a scatter-max of lane ids so w0/w1 can never mix lanes.
    New blocks take rows in ``free_rows`` order: a pool that never
    removed a block hands them out from the high-water mark up, as the
    JAX package does, and a full pool reuses the rows removal freed."""
    w0, w1 = grid.pack_block_index(block_ijk.reshape(-1, 3))
    valid = valid.reshape(-1)
    dev = layer.device
    mb = layer.max_blocks
    lanes = torch.arange(w0.shape[0], dtype=torch.int64, device=dev)
    ph = vhash.hash_words(w0, w1) & (pending_size - 1)
    # Lanes that are not missing scatter to 4096 dump cells past the
    # buffer, not one: millions of atomics on one address serialize.
    dump = pending_size + (lanes & 4095)
    overflowed = torch.zeros((), dtype=torch.bool, device=dev)
    table = layer.table
    for _ in range(8):
        missing = valid & (vhash.lookup(table, w0, w1) < 0)
        if not _runtime.host_bool(missing.any()):
            break
        win = torch.full((pending_size + 4096,), -1, dtype=torch.int64,
                         device=dev)
        win.scatter_reduce_(0, torch.where(missing, ph, dump), lanes, "amax")
        win = win[:pending_size]
        new_mask = win >= 0
        src = torch.where(new_mask, win, 0)
        pend_w0 = torch.where(new_mask, w0[src], 0)
        pend_w1 = torch.where(new_mask, w1[src], grid.EMPTY_W1)
        table, slots, ok = vhash.insert(table, pend_w0, pend_w1, new_mask,
                                        base_slot=layer.num_blocks,
                                        rows=free_rows(layer, pending_size))
        overflow_mask = ok & (slots >= mb)
        overflowed = overflowed | overflow_mask.any()
        keep = ok & ~overflow_mask
        if timing.recording():
            timing.count("layer.rows_reused",
                         (keep & (slots < layer.num_blocks)).sum())
        new_ijk = grid.unpack_block_index(pend_w0, pend_w1)
        put_rows(layer.block_ijk, slots, keep, new_ijk)
        put_rows(layer.block_flags, slots, keep,
                 torch.full_like(slots, ACTIVE | DIRTY_ALL))
        layer.num_blocks = torch.clamp(table.count, max=mb)
        layer.table = table
    return layer, overflowed


def remove_blocks(layer: VoxelLayer, rows, valid):
    """Deactivate pool rows, tombstone their keys, zero their voxels. A
    freed row stays below the high-water mark ``num_blocks``; once the
    rows above it are used up, ``allocate_blocks`` hands it out again,
    and the block it then holds starts empty."""
    with timing.timer("rolling.remove.hash"):
        w0, w1 = grid.pack_block_index(layer.block_ijk[rows])
        layer.table, _ = vhash.remove(layer.table, w0, w1, valid)
    with timing.timer("rolling.remove.clear"):
        put_rows(layer.block_flags, rows, valid, torch.zeros_like(
            rows, dtype=torch.uint8))
        for c in layer.channels.values():
            put_rows(c, rows, valid, torch.zeros(
                (rows.shape[0], c.shape[1]), dtype=c.dtype, device=c.device))
        if timing.recording():
            timing.count("layer.blocks_removed", valid.sum())
    return layer


def remove_distant_blocks(layer: VoxelLayer, center, max_distance: float):
    """Remove active blocks whose centre lies farther than
    ``max_distance`` from ``center`` (Layer::removeDistantBlocks,
    core/layer.h:170-182). The high-water mark ``num_blocks`` stays where
    it was: the rows freed lie below it, for ``allocate_blocks`` to reuse
    once the pool's rows above it are used up."""
    with timing.timer("rolling.remove.select"):
        centers = ((layer.block_ijk.to(torch.float32) + 0.5)
                   * layer.block_size)
        center = torch.as_tensor(center, dtype=torch.float32,
                                 device=layer.device)
        dist = torch.linalg.vector_norm(centers - center[None, :], dim=-1)
        doomed = layer.active_mask() & (dist > max_distance)
        rows = torch.arange(layer.max_blocks, dtype=torch.int32,
                            device=layer.device)
    return remove_blocks(layer, rows, doomed)


# A table whose tombstones fill more than this share of its cells is
# rebuilt: at the default capacity (4 cells a pool row) that is as many
# tombstones as the pool has rows, with at most another quarter of the
# cells live.
TOMBSTONE_SHARE = 0.25


def tombstones_due(layer: VoxelLayer):
    """Device bool: the table's tombstones fill more than
    ``TOMBSTONE_SHARE`` of its cells. Counts them and the cells."""
    tomb = (layer.table.keys_w1 == grid.TOMBSTONE_W1).sum()
    timing.count("hash.tombstone_cells", tomb)
    timing.count("hash.table_cells", layer.table.capacity)
    return tomb > int(TOMBSTONE_SHARE * layer.table.capacity)


def rebuild_table(layer: VoxelLayer):
    """Re-insert the live blocks' keys into a fresh table, each at its
    pool row: no tombstones are left, and the probe bound ``max_psl`` is
    a fresh insert's. The table's high-water counter is kept."""
    w0, w1 = grid.pack_block_index(layer.block_ijk)
    table = vhash.rebuild(layer.table, w0, w1, layer.active_mask())
    layer.table = dataclasses.replace(table, count=layer.table.count)
    timing.count("hash.rebuilds", 1)
    return layer


def mark_dirty(layer: VoxelLayer, rows, valid, bits: int):
    cur = layer.block_flags[torch.where(valid, rows, 0).to(torch.int64)]
    put_rows(layer.block_flags, rows, valid, cur | bits)
    return layer


def clear_dirty(layer: VoxelLayer, bits: int, rows=None, valid=None):
    keep = ~bits & 0xFF
    if rows is None:
        layer.block_flags &= keep
    else:
        cur = layer.block_flags[torch.where(valid, rows, 0).to(torch.int64)]
        put_rows(layer.block_flags, rows, valid, cur & keep)
    return layer


def dirty_mask(layer: VoxelLayer, bits: int):
    return layer.active_mask() & ((layer.block_flags & bits) != 0)


# ---------------------------------------------------------------------------
# Voxel access
# ---------------------------------------------------------------------------


def get_voxels(layer: VoxelLayer, channel: str, global_ijk, fill=0.0,
               max_psl: int | None = None):
    flat, found = global_voxel_to_flat(layer, global_ijk, max_psl)
    c = layer.channels[channel]
    extra = channel_extra(layer, channel)
    flatc = c.reshape((-1,) + extra)
    vals = flatc[torch.where(found, flat, 0)]
    if extra:
        found = found[..., None]
    return torch.where(found, vals, fill).to(c.dtype), found


def set_voxels(layer: VoxelLayer, channel: str, global_ijk, values,
               valid=None):
    """Scatter-set voxel values (drops missing blocks). Targets must be
    distinct voxels."""
    flat, found = global_voxel_to_flat(layer, global_ijk)
    if valid is not None:
        found = found & valid
    c = layer.channels[channel]
    extra = channel_extra(layer, channel)
    flatc = c.view((-1,) + extra)
    put_rows(flatc, flat.reshape(-1), found.reshape(-1),
             values.reshape((-1,) + extra))
    return layer


# ---------------------------------------------------------------------------
# Map state carried across packages
# ---------------------------------------------------------------------------

_TABLE_FIELDS = ("keys_w0", "keys_w1", "slot", "max_psl", "count")


def layer_to_numpy(layer: VoxelLayer) -> dict:
    """Plain dict of numpy arrays: channels by name, ``block_ijk``,
    ``block_flags``, ``num_blocks``, the table's ``keys_w0/keys_w1/slot/
    max_psl/count``, and ``voxel_size``/``vps``/``layer_type``."""
    d = {f"channel/{k}": v.cpu().numpy() for k, v in layer.channels.items()}
    d.update({f"table/{k}": getattr(layer.table, k).cpu().numpy()
              for k in _TABLE_FIELDS})
    d["block_ijk"] = layer.block_ijk.cpu().numpy()
    d["block_flags"] = layer.block_flags.cpu().numpy()
    d["num_blocks"] = layer.num_blocks.cpu().numpy()
    d["voxel_size"] = layer.voxel_size
    d["vps"] = layer.vps
    d["layer_type"] = layer.layer_type
    return d


def layer_from_numpy(d: dict, device=None) -> VoxelLayer:
    """Inverse of ``layer_to_numpy`` onto ``device``."""
    dev = _runtime.resolve_device(device)

    def t(x, dtype):
        return torch.from_numpy(np.array(x)).to(dtype=dtype, device=dev)

    channels = {
        k.split("/", 1)[1]: t(v, CHANNEL_DTYPES.get(k.split("/", 1)[1],
                                                    torch.float32))
        for k, v in d.items() if k.startswith("channel/")
    }
    table = vhash.HashTable(**{
        k: t(d[f"table/{k}"], torch.int32) for k in _TABLE_FIELDS
    })
    return VoxelLayer(
        table=table,
        block_ijk=t(d["block_ijk"], torch.int32),
        block_flags=t(d["block_flags"], torch.uint8),
        num_blocks=t(d["num_blocks"], torch.int32),
        channels=channels,
        voxel_size=float(d["voxel_size"]),
        vps=int(d["vps"]),
        layer_type=str(d["layer_type"]),
    )
