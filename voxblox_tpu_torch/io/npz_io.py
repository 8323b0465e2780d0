"""Whole-map checkpoints to .npz (port of voxblox_tpu/io/npz_io.py).

The archive holds the pool arrays and the hash table under the JAX
package's keys (``keys_w0``, ``keys_w1``, ``slot``, ``max_psl``,
``count``, ``block_ijk``, ``block_flags``, ``num_blocks``, ``meta``,
``ch_<name>``), so each package loads the other's files and a map comes
back bit for bit, rows and table included.
"""

from __future__ import annotations

import json

import numpy as np

from .. import _runtime
from ..core import layer as vlayer

_TABLE_KEYS = ("keys_w0", "keys_w1", "slot", "max_psl", "count")


def save_npz(layer: vlayer.VoxelLayer, path: str):
    meta = {
        "voxel_size": layer.voxel_size,
        "vps": layer.vps,
        "layer_type": layer.layer_type,
        "channel_names": sorted(layer.channels),
    }
    arrays = {k: _runtime.to_host(getattr(layer.table, k))
              for k in _TABLE_KEYS}
    arrays.update(block_ijk=_runtime.to_host(layer.block_ijk),
                  block_flags=_runtime.to_host(layer.block_flags),
                  num_blocks=_runtime.to_host(layer.num_blocks),
                  meta=np.frombuffer(json.dumps(meta).encode(), np.uint8))
    for name, arr in layer.channels.items():
        arrays[f"ch_{name}"] = _runtime.to_host(arr)
    np.savez_compressed(path, **arrays)


def load_npz(path: str, device=None) -> vlayer.VoxelLayer:
    """The layer in ``path`` on ``device`` (default CUDA)."""
    z = np.load(path)
    meta = json.loads(bytes(z["meta"]).decode())
    d = {f"table/{k}": z[k] for k in _TABLE_KEYS}
    # reshape(mb, -1): archives written before the flat channel storage
    # carry cube-shaped arrays; the bytes are the same.
    d.update({f"channel/{name}": z[f"ch_{name}"].reshape(
        z[f"ch_{name}"].shape[0], -1) for name in meta["channel_names"]})
    d.update(block_ijk=z["block_ijk"], block_flags=z["block_flags"],
             num_blocks=z["num_blocks"], voxel_size=meta["voxel_size"],
             vps=meta["vps"], layer_type=meta["layer_type"])
    return vlayer.layer_from_numpy(d, device)
