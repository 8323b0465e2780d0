"""Open-addressing spatial hash table (port of voxblox_tpu/core/hash.py).

Keys are packed block-index words, values pool rows. Insertion is the
same parallel claim protocol as the JAX table — each round every pending
key scatter-mins its rank (lane index) onto its probe cell, the lowest
rank wins, winners get ascending slot ids in lane order — so pool rows
come out identical to the JAX rows and maps compare row by row.

The JAX ``lax.while_loop``s are Python loops here; each loop test reads
one device value (``_runtime.host_bool``/``host_int``).
"""

from __future__ import annotations

import dataclasses

import torch

from .. import _runtime
from . import grid

MAX_INSERT_ROUNDS = 64
_M32 = 0xFFFFFFFF
_INT32_MAX = 0x7FFFFFFF


@dataclasses.dataclass
class HashTable:
    keys_w0: torch.Tensor  # int32[capacity]
    keys_w1: torch.Tensor  # int32[capacity]; < 0 = empty/tombstone
    slot: torch.Tensor  # int32[capacity]
    max_psl: torch.Tensor  # int32[] probe-length bound
    count: torch.Tensor  # int32[] high-water slot counter

    @property
    def capacity(self) -> int:
        return self.keys_w1.shape[0]


def make_table(capacity: int, device) -> HashTable:
    assert capacity & (capacity - 1) == 0, "capacity must be a power of two"
    i32 = dict(dtype=torch.int32, device=device)
    return HashTable(
        keys_w0=torch.zeros(capacity, **i32),
        keys_w1=torch.full((capacity,), grid.EMPTY_W1, **i32),
        slot=torch.full((capacity,), -1, **i32),
        max_psl=torch.zeros((), **i32),
        count=torch.zeros((), **i32),
    )


def _mul32(a, c: int):
    """(a * c) mod 2^32 for a in [0, 2^32) held in int64. The 16-bit split
    keeps every partial product below 2^63: torch has no wrapping uint32
    multiply, and an int64 product of two 32-bit values can overflow."""
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def hash_words(w0, w1):
    """Murmur-style avalanche of the key words; uint32 values in int64."""
    h = _mul32(w0.to(torch.int64) & _M32, 0x9E3779B1)
    h = h ^ _mul32(w1.to(torch.int64) & _M32, 0x85EBCA6B)
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    h = h ^ (h >> 16)
    return h


def _set_cells(arr, idx, vals, ok):
    """``arr.at[where(ok, idx, cap)].set(vals, mode="drop")`` for a
    table array: dropped lanes aim at a dump cell past the end (JAX drops
    out-of-range scatter indices; torch raises, so the sentinel cell is
    explicit)."""
    cap = arr.shape[0]
    ext = torch.cat([arr, arr[:1]])
    ext[torch.where(ok, idx, cap)] = vals.to(arr.dtype)
    return ext[:cap]


def lookup(table: HashTable, w0, w1, max_psl: int | None = None):
    """Vectorized lookup -> int32 slots, -1 where missing. Probes
    0..max_psl: the JAX loop also stops early once every lane resolved,
    which changes nothing (resolved lanes keep their result), so reading
    ``max_psl`` once replaces a sync per probe round. A caller that looks
    up many times in a table that does not change passes the bound as a
    host int (read once) and the lookup reads nothing."""
    if max_psl is None:
        max_psl = _runtime.host_int(table.max_psl)
    mask = table.capacity - 1
    h = hash_words(w0, w1)
    out = torch.full(w0.shape, -1, dtype=torch.int32, device=w0.device)
    done = torch.zeros(w0.shape, dtype=torch.bool, device=w0.device)
    for p in range(max_psl + 1):
        idx = (h + p) & mask
        k1 = table.keys_w1[idx]
        hit = (table.keys_w0[idx] == w0) & (k1 == w1)
        out = torch.where(hit & ~done, table.slot[idx], out)
        done = done | hit | (k1 == grid.EMPTY_W1)
    return out


def insert(table: HashTable, w0, w1, valid, base_slot=None):
    """Parallel insert of mutually unique keys. Returns (table, slots
    int32[K] (-1 where not inserted), ok bool[K])."""
    cap = table.capacity
    mask = cap - 1
    k = w0.shape[0]
    dev = w0.device
    h = hash_words(w0, w1)
    rank = torch.arange(k, dtype=torch.int32, device=dev)
    assigned = table.count if base_slot is None else base_slot
    assigned = torch.as_tensor(assigned, dtype=torch.int32, device=dev)
    keys_w0, keys_w1, slot_arr = table.keys_w0, table.keys_w1, table.slot
    max_psl = table.max_psl
    disp = torch.zeros(k, dtype=torch.int64, device=dev)
    out = torch.full((k,), -1, dtype=torch.int32, device=dev)
    pending = valid.clone()
    for _ in range(MAX_INSERT_ROUNDS):
        if not _runtime.host_bool(pending.any()):
            break
        idx = (h + disp) & mask
        k0 = keys_w0[idx]
        k1 = keys_w1[idx]
        equal = pending & (k0 == w0) & (k1 == w1)
        attempt = pending & (k1 < 0) & ~equal
        # Claim: lowest rank wins each cell (cell ``cap`` is the dump).
        claims = torch.full((cap + 1,), _INT32_MAX, dtype=torch.int32,
                            device=dev)
        claims.scatter_reduce_(0, torch.where(attempt, idx, cap), rank,
                               "amin")
        won = attempt & (claims[idx] == rank)
        new_ids = assigned + torch.cumsum(won.to(torch.int32), 0,
                                          dtype=torch.int32) - 1
        keys_w0 = _set_cells(keys_w0, idx, w0, won)
        keys_w1 = _set_cells(keys_w1, idx, w1, won)
        slot_arr = _set_cells(slot_arr, idx, new_ids, won)
        out = torch.where(won, new_ids, out)
        out = torch.where(equal, slot_arr[idx], out)
        finished = won | equal
        max_psl = torch.maximum(
            max_psl, torch.where(finished, disp, 0).max().to(torch.int32)
        )
        assigned = assigned + won.sum(dtype=torch.int32)
        pending = pending & ~finished
        disp = torch.where(pending, disp + 1, disp)
    new_table = HashTable(keys_w0=keys_w0, keys_w1=keys_w1, slot=slot_arr,
                          max_psl=max_psl, count=assigned)
    return new_table, out, valid & ~pending


def remove(table: HashTable, w0, w1, valid):
    """Tombstone-delete unique keys. Returns (table, removed count)."""
    mask = table.capacity - 1
    h = hash_words(w0, w1)
    keys_w1, slot_arr = table.keys_w1, table.slot
    removed = torch.zeros((), dtype=torch.int32, device=w0.device)
    pending = valid.clone()
    for p in range(MAX_INSERT_ROUNDS):
        if not _runtime.host_bool(pending.any()):
            break
        idx = (h + p) & mask
        k1 = keys_w1[idx]
        hit = pending & (table.keys_w0[idx] == w0) & (k1 == w1)
        keys_w1 = _set_cells(keys_w1, idx,
                             torch.full_like(w1, grid.TOMBSTONE_W1), hit)
        slot_arr = _set_cells(slot_arr, idx, torch.full_like(w1, -1), hit)
        removed = removed + hit.sum(dtype=torch.int32)
        pending = pending & ~hit & ~(k1 == grid.EMPTY_W1)
    return dataclasses.replace(table, keys_w1=keys_w1, slot=slot_arr), removed


def _locate(table: HashTable, w0, w1, valid):
    """Cell index holding each key (must exist where valid)."""
    mask = table.capacity - 1
    h = hash_words(w0, w1)
    out = torch.zeros(w0.shape, dtype=torch.int64, device=w0.device)
    done = ~valid
    for p in range(MAX_INSERT_ROUNDS):
        if _runtime.host_bool(done.all()):
            break
        idx = (h + p) & mask
        hit = ((table.keys_w0[idx] == w0) & (table.keys_w1[idx] == w1)
               & ~done)
        out = torch.where(hit, idx, out)
        done = done | hit
    return out


def rebuild(table: HashTable, block_w0, block_w1, active_mask) -> HashTable:
    """Re-insert active (w0, w1) -> row-index pairs into a fresh table."""
    fresh = make_table(table.capacity, block_w0.device)
    fresh, _, _ = insert(fresh, block_w0, block_w1, active_mask)
    rows = torch.arange(block_w0.shape[0], dtype=torch.int32,
                        device=block_w0.device)
    idx = _locate(fresh, block_w0, block_w1, active_mask)
    slot_arr = _set_cells(fresh.slot, idx, rows, active_mask)
    return dataclasses.replace(fresh, slot=slot_arr)
