"""Mask compaction (port of voxblox_tpu/ops/compaction.py).

``jnp.nonzero(mask, size=k, fill_value=f)`` keeps the first k set
indices in ascending order and pads with ``f``; ``torch.nonzero`` has no
``size`` (and its dynamic shape is a host sync on the GPU), so the cut
and the padding are done with a cumsum and one scatter into a buffer
with a dump slot.
"""

from __future__ import annotations

import torch


def compact_ids(mask, size: int, fill=None):
    """Ascending indices of True lanes of flat bool ``mask``, cut to
    ``size`` and padded with ``fill`` (default ``len(mask)``); int32."""
    n = mask.shape[0]
    if fill is None:
        fill = n
    incl = torch.cumsum(mask.to(torch.int64), 0)
    ids = torch.arange(n, dtype=torch.int32, device=mask.device)
    dst = torch.where(mask & (incl <= size), incl - 1, size)
    out = torch.full((size + 1,), fill, dtype=torch.int32,
                     device=mask.device)
    # Kept lanes have distinct slots; every dropped lane lands on the dump
    # slot ``size``, which is cut off.
    out[dst] = ids
    return out[:size]
