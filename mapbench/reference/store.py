"""Voxel blocks keyed by block index (x, y, z), rows appended as blocks
appear and closed up as blocks go; x-fastest voxel order inside a block,
as the program lays out a block's channels, so a block converts row for
row."""

from __future__ import annotations

import torch

_OFF = 1 << 20


def keys_of(ijk):
    """int64 key of int block indices [..., 3] (each within +-2^20)."""
    b = ijk.to(torch.int64) + _OFF
    return (b[..., 0] << 42) | (b[..., 1] << 21) | b[..., 2]


class BlockStore:
    """Rows of named channels [cap, vps^3] plus their block indices. A
    sorted copy of the keys answers lookups (``rows_of``)."""

    def __init__(self, vps, cap, channels, device):
        self.vps = vps
        self.cap = cap
        self.device = device
        self.n = 0
        self.ijk = torch.zeros((cap, 3), dtype=torch.int64, device=device)
        self.ch = {name: torch.zeros((cap, vps ** 3), dtype=dt,
                                     device=device)
                   for name, dt in channels.items()}
        self._sorted = torch.zeros(0, dtype=torch.int64, device=device)
        self._order = torch.zeros(0, dtype=torch.int64, device=device)

    def clone(self):
        out = BlockStore.__new__(BlockStore)
        out.__dict__.update(self.__dict__)
        out.ijk = self.ijk.clone()
        out.ch = {k: v.clone() for k, v in self.ch.items()}
        return out

    def _reindex(self):
        k = keys_of(self.ijk[:self.n])
        self._sorted, self._order = torch.sort(k)

    def rows_of(self, ijk):
        """Row of each block index [..., 3], -1 where absent."""
        k = keys_of(ijk)
        if self.n == 0:
            return torch.full(k.shape, -1, dtype=torch.int64,
                              device=k.device)
        pos = torch.searchsorted(self._sorted, k).clamp(max=self.n - 1)
        hit = self._sorted[pos] == k
        return torch.where(hit, self._order[pos], -1)

    def add(self, ijk):
        """Append the absent blocks of ijk [N, 3] (duplicates allowed);
        returns the rows of all of ijk."""
        k = keys_of(ijk)
        new = torch.unique(k[self.rows_of(ijk) < 0])
        m = int(new.shape[0])
        if m:
            if self.n + m > self.cap:
                raise MemoryError(f"reference store full: {self.n} + {m} "
                                  f"blocks > {self.cap}")
            b = torch.stack([(new >> 42) & (2 * _OFF - 1),
                             (new >> 21) & (2 * _OFF - 1),
                             new & (2 * _OFF - 1)], -1) - _OFF
            self.ijk[self.n:self.n + m] = b
            self.n += m
            self._reindex()
        return self.rows_of(ijk)

    def remove(self, doomed):
        """Drop the blocks of the rows where ``doomed`` [n] holds: the
        others close up, the freed rows are zeroed, so a block added
        again later starts empty."""
        keep = torch.nonzero(~doomed).flatten()
        m = int(keep.shape[0])
        if m == self.n:
            return
        self.ijk[:m] = self.ijk[keep]
        for c in self.ch.values():
            c[:m] = c[keep]
            c[m:self.n] = 0
        self.n = m
        self._reindex()

    @classmethod
    def from_rows(cls, ijk, channels, cap, vps):
        """A store holding the given blocks (ijk [N, 3]) and channel rows
        ({name: [N, vps^3]}), copied."""
        n = ijk.shape[0]
        s = cls(vps, cap, {k: v.dtype for k, v in channels.items()},
                ijk.device)
        s.n = n
        s.ijk[:n] = ijk.to(torch.int64)
        for k, v in channels.items():
            s.ch[k][:n] = v
        s._reindex()
        return s


def neighbour_rows(store, offsets):
    """Rows of each block's neighbours at ``offsets`` [K, 3]: [n, K], -1
    where absent."""
    off = torch.as_tensor(offsets, dtype=torch.int64, device=store.device)
    return store.rows_of(store.ijk[:store.n, None, :] + off[None])


def remove_distant_blocks(store, origin, max_distance):
    """voxblox's ``Layer::removeDistantBlocks`` (core/layer.h:170-182):
    drop every block whose centre, (ijk + 0.5) * block size in float32,
    lies farther than ``max_distance`` from ``origin``."""
    bs = store.voxel_size * store.vps
    centres = (store.ijk[:store.n].to(torch.float32) + 0.5) * bs
    dist = torch.linalg.vector_norm(centres - origin.to(torch.float32),
                                    dim=-1)
    store.remove(dist > max_distance)
