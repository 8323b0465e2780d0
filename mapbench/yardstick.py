"""The yardstick of the ESDF relaxation, frozen: the operations and bytes
a call needs, counted from its inputs, and the card's peaks.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet): 3.35e12 bytes/s of
HBM, and the float32 instruction rate outside the tensor cores, 132 SMs x
128 lanes x 1.98 GHz. The relaxation is min, max, compare, select and
add, one instruction a lane a clock (the data sheet's 67 TFLOP/s is this
rate with an FMA counted twice; none occurs here).

Operations of a unit sweep of one block, by the best arrangement known:
each padded voxel packed once as a source (10); per padded plane and
packed field the in-plane partial extrema the three centres around the
plane share; per interior voxel and field five extrema recombining three
planes; the per-voxel group finish (49). That is 416,976 a block. Only
the blocks a sweep needs count: none for a block that is inactive or
has no voxel that may be written, and a repeated sweep only where the
previous one changed the block (the same sweep on an unchanged state
changes nothing). Bytes: ``d`` read and the output written for every
block, the active flags, ``upd`` for active blocks, ``obs`` for blocks
with a voxel to write.
"""

from __future__ import annotations

import torch

from .reference import relax as frelax

PEAK_BYTES = 3.35e12
PEAK_OPS = 132 * 128 * 1.98e9

P = frelax.P
OPS_PACK = 10
FIELDS = 4
OPS_PLANE = FIELDS * (P * (P - 2) + 3 * (P - 2) ** 2)
OPS_RECOMBINE = FIELDS * 5
OPS_FINISH = 49
OPS_PER_BLOCK_SWEEP = (P ** 3 * OPS_PACK + P * OPS_PLANE
                       + (P - 2) ** 3 * (OPS_RECOMBINE + OPS_FINISH))


def entries_needed(d, obs, upd, active, sweeps, voxel, max_distance,
                   min_diff):
    """bool [sweeps, n]: which blocks each unit sweep needs."""
    need, cur = [active & upd.flatten(1).any(1)], d
    for _ in range(sweeps - 1):
        new = frelax.relax(cur, obs, upd, need[-1], 1, voxel, max_distance,
                           min_diff)
        need.append(need[-1] & (new != cur).flatten(1).any(1))
        cur = new
    return torch.stack(need)


def relax_work(d, obs, upd, active, sweeps, voxel, max_distance, min_diff):
    """(operations, bytes) a unit-stride relaxation of ``sweeps`` sweeps
    needs for these inputs."""
    need = entries_needed(d, obs, upd, active, sweeps, voxel, max_distance,
                          min_diff)
    n = d.shape[0]
    ops = int(need.sum()) * OPS_PER_BLOCK_SWEEP
    nbytes = (n * P ** 3 * (4 + 4) + n + int(active.sum()) * P ** 3
              + int(need[0].sum()) * P ** 3)
    return ops, nbytes


def bound_seconds(ops, nbytes):
    """The least time the card could take: the larger of the two."""
    return max(ops / PEAK_OPS, nbytes / PEAK_BYTES)
