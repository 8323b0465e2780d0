"""Grid index math (port of voxblox_tpu/core/grid.py).

floor(p * inv + 1e-6) point->index, power-of-2 global/block/local split,
x-fastest linear voxel order, and the two-word block-index packing of the
hash table. ``ijk`` tensors are ``[..., 3]`` int32.
"""

from __future__ import annotations

import torch

EPS = 1e-6
FLOAT_EPS = 1e-6

PACK_MIN = -(1 << 15)
PACK_MAX = (1 << 15) - 1
EMPTY_W1 = -1
TOMBSTONE_W1 = -2


def point_to_grid_index(points, grid_size_inv):
    return torch.floor(points * grid_size_inv + EPS).to(torch.int32)


def scaled_point_to_grid_index(scaled_points):
    return torch.floor(scaled_points + EPS).to(torch.int32)


def grid_index_to_center_point(ijk, grid_size):
    return (ijk.to(torch.float32) + 0.5) * grid_size


def grid_index_to_origin_point(ijk, grid_size):
    return ijk.to(torch.float32) * grid_size


def global_from_block_and_local(block_ijk, local_ijk, vps: int):
    return block_ijk * vps + local_ijk


def block_from_global(global_ijk, vps: int):
    """Arithmetic shift = floor division for negative indices too."""
    return global_ijk >> (vps.bit_length() - 1)


def local_from_global(global_ijk, vps: int):
    return global_ijk & (vps - 1)


def split_global(global_ijk, vps: int):
    return block_from_global(global_ijk, vps), local_from_global(global_ijk, vps)


def local_to_linear(local_ijk, vps: int):
    return (local_ijk[..., 0] + local_ijk[..., 1] * vps
            + local_ijk[..., 2] * vps * vps)


def linear_to_local(lin, vps: int):
    x = lin % vps
    y = (lin // vps) % vps
    z = lin // (vps * vps)
    return torch.stack([x, y, z], dim=-1)


def pack_block_index(block_ijk):
    """int32[...,3] -> (w0, w1): w0 = (x & 0xffff) | (y + 2^15) << 16,
    w1 = z + 2^15. Computed in int64 and wrapped to int32 like the JAX
    int32 shift."""
    b = block_ijk.to(torch.int64)
    x, y, z = b[..., 0], b[..., 1], b[..., 2]
    w0 = (x & 0xFFFF) | (((y + (1 << 15)) & 0xFFFF) << 16)
    w0 = torch.where(w0 >= (1 << 31), w0 - (1 << 32), w0)
    w1 = z + (1 << 15)
    return w0.to(torch.int32), w1.to(torch.int32)


def unpack_block_index(w0, w1):
    w = w0.to(torch.int64) & 0xFFFFFFFF
    lo = w & 0xFFFF
    x = torch.where(lo >= (1 << 15), lo - (1 << 16), lo)
    y = ((w >> 16) & 0xFFFF) - (1 << 15)
    z = w1.to(torch.int64) - (1 << 15)
    return torch.stack([x, y, z], dim=-1).to(torch.int32)
