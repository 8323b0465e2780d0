"""Block-set exchange messages (port of voxblox_tpu/io/conversions.py):
a layer, or its updated blocks, as bytes another process applies.

The reference's layer pub/sub (voxblox_msgs/Layer.msg, conversions.h):
a message is one action byte (UPDATE / MERGE / RESET), then the .vxblx
stream of one layer (count, LayerProto, BlockProtos).
"""

from __future__ import annotations

import io as _io
from typing import Optional

from ..core import layer as vlayer
from . import layer_io, wire

# Actions (voxblox_msgs/Layer.msg: ACTION_UPDATE/MERGE/RESET).
UPDATE, MERGE, RESET = 0, 1, 2


def serialize_layer_msg(layer: vlayer.VoxelLayer, action: int = UPDATE,
                        only_updated: bool = False,
                        clear_updated_flag: bool = True):
    """Layer (or its blocks with the DIRTY_MAP bit) -> (bytes, layer),
    the bit cleared after an ``only_updated`` message."""
    mask = (vlayer.dirty_mask(layer, vlayer.DIRTY_MAP) if only_updated
            else layer.active_mask())
    buf = _io.BytesIO()
    buf.write(bytes([action]))
    for piece in layer_io.layer_stream(layer, mask):
        buf.write(piece)
    if only_updated and clear_updated_flag:
        layer = vlayer.clear_dirty(layer, vlayer.DIRTY_MAP)
    return buf.getvalue(), layer


def deserialize_layer_msg(data: bytes,
                          layer: Optional[vlayer.VoxelLayer] = None,
                          max_blocks: int = 4096, device=None):
    """Apply a layer message; returns the updated layer (a new one on
    ``device`` when ``layer`` is None).

    UPDATE overwrites the received blocks, MERGE voxel-merges them into
    existing ones, RESET clears the local layer first."""
    action = data[0]
    reader = wire.Reader(data[1:])
    count = reader.varint()
    hdr = reader.layer_header()
    if layer is None:
        layer = vlayer.make_layer(hdr.type, float(hdr.voxel_size),
                                  vps=int(hdr.voxels_per_side),
                                  max_blocks=max_blocks, device=device)
    elif action == RESET:
        layer = vlayer.make_layer(layer.layer_type, layer.voxel_size,
                                  vps=layer.vps, max_blocks=layer.max_blocks,
                                  device=layer.device)
    strategy = layer_io.MERGE if action == MERGE else layer_io.OVERWRITE
    return layer_io.load_blocks(reader, hdr, count - 1, layer.max_blocks,
                                strategy, layer)
