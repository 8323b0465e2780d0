"""The ESDF relaxation on padded blocks, frozen: a copy of the program's
plain relaxation (the arithmetic of the TPU kernel it was ported from),
unit strides only, computed in ``dtype``.

``d`` [N, 18, 18, 18] ([z, y, x], the 1-voxel ring holds the neighbours'
values), bool ``obs``/``upd`` of the same shape, bool ``active`` [N]. A
sweep sets each voxel that may update to the best of its 26 neighbours
plus the step length (positive side: the least; negative: the greatest),
where a neighbour is a source if observed and within the max distance,
caps a sign flip at the step, and keeps the change only above
``min_diff``. ``sweeps`` such sweeps run, each on the result of the last.
"""

from __future__ import annotations

import numpy as np
import torch

P = 18
BIG = 1e9

_OFFSETS = [(dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1)
            for dz in (-1, 0, 1) if (dx, dy, dz) != (0, 0, 0)]
GROUPS: dict = {}
for _o in _OFFSETS:
    GROUPS.setdefault(round(float(np.linalg.norm(_o)), 6), []).append(_o)
GROUPS = dict(sorted(GROUPS.items()))


def step_constants(voxel_size: float, k: int = 1):
    """The three step lengths, each rounded once to float32."""
    return [float(np.float32(dist * voxel_size * k)) for dist in GROUPS]


def relax(d, obs, upd, active, sweeps: int, voxel_size: float,
          max_distance: float, min_diff: float, dtype=torch.float32):
    v = P - 2
    d = d.to(dtype)
    cur = d
    upd_c = upd[:, 1:-1, 1:-1, 1:-1]
    steps = step_constants(voxel_size)
    for _ in range(sweeps):
        src = obs & (cur.abs() < max_distance)
        pos = cur > 0.0
        dp = torch.where(src & pos, cur, BIG)
        dn = torch.where(src & ~pos, cur, -BIG)
        c = cur[:, 1:-1, 1:-1, 1:-1]
        pc = c > 0.0
        best_pos = torch.full_like(c, BIG)
        best_neg = torch.full_like(c, -BIG)
        trips = []
        for step, offs in zip(steps, GROUPS.values()):
            gp = torch.full_like(c, BIG)
            gn = torch.full_like(c, -BIG)
            tvn = torch.full_like(c, BIG)
            tvp = torch.full_like(c, -BIG)
            for dx, dy, dz in offs:
                sl = (slice(None), slice(1 + dz, 1 + dz + v),
                      slice(1 + dy, 1 + dy + v), slice(1 + dx, 1 + dx + v))
                ndp, ndn = dp[sl], dn[sl]
                gp = torch.minimum(gp, ndp)
                gn = torch.maximum(gn, ndn)
                tvn = torch.minimum(tvn, torch.where(ndn > -BIG / 2, ndn, BIG))
                tvp = torch.maximum(tvp, torch.where(ndp < BIG / 2, ndp, -BIG))
            best_pos = torch.minimum(best_pos, gp + step)
            best_neg = torch.maximum(best_neg, gn - step)
            trips.append((step, ((tvn < c - 2 * step) & pc)
                          | ((tvp > c + 2 * step) & ~pc)))
        cand = torch.where(pc, torch.minimum(c, best_pos),
                           torch.maximum(c, best_neg))
        sgn = torch.where(pc, 1.0, -1.0).to(dtype)
        for step, trip in reversed(trips):
            cand = torch.where(trip & (cand.abs() > step), sgn * step, cand)
        improved = (cand - c).abs() > min_diff
        nxt = cur.clone()
        nxt[:, 1:-1, 1:-1, 1:-1] = torch.where(upd_c & improved, cand, c)
        cur = nxt
    return torch.where(active.view(-1, 1, 1, 1), cur, d)
