"""The protobuf wire format of voxblox's ``LayerProto`` and ``BlockProto``,
written and read with numpy (no protobuf package).

Both are proto2 messages (voxblox/proto/voxblox/{Layer,Block}.proto):

    LayerProto  1 voxel_size double | 2 voxels_per_side uint32 | 3 type string
    BlockProto  1 voxels_per_side int32 | 2 voxel_size double |
                3-5 origin_x/y/z double | 6 has_data bool |
                7 voxel_data repeated uint32

Messages are written field by field in field order, every field present,
``voxel_data`` unpacked (one tag byte 0x38 and one varint per word), the
way the C++ reference and Python protobuf serialize them, so a file is
byte for byte what those write. The reader takes ``voxel_data`` packed or
unpacked and skips unknown fields.

Voxel words are encoded and decoded vectorized: varint byte counts from
the thresholds 2^7/2^14/2^21/2^28, offsets by a cumulative sum, bytes by
masked shifts; on the way back the bytes below 0x80 (tags and varint
terminators) split the stream.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Iterator, List, Optional, Tuple

import numpy as np

_TAG_VOXEL = 0x38  # field 7, wire type 0 (varint)
_U64 = (1 << 64) - 1


@dataclasses.dataclass
class LayerProto:
    voxel_size: float = 0.0
    voxels_per_side: int = 0
    type: str = ""


@dataclasses.dataclass
class BlockProto:
    voxels_per_side: int = 0
    voxel_size: float = 0.0
    origin_x: float = 0.0
    origin_y: float = 0.0
    origin_z: float = 0.0
    has_data: bool = False
    voxel_data: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, np.uint32))


# ---------------------------------------------------------------------------
# Scalar varints
# ---------------------------------------------------------------------------


def varint(value: int) -> bytes:
    """One varint; a negative value as its 64-bit two's complement (how
    protobuf writes a negative int32)."""
    value &= _U64
    out = bytearray()
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def read_varint(buf, pos: int) -> Tuple[Optional[int], int]:
    """(value, next position); (None, pos) at the end of ``buf``. Raises
    on a varint cut short."""
    if pos >= len(buf):
        return None, pos
    shift = out = 0
    while True:
        if pos >= len(buf):
            raise ValueError("truncated varint")
        b = buf[pos]
        pos += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, pos
        shift += 7


def read_varint_stream(f) -> Optional[int]:
    """A varint from a file object; None at its end."""
    shift = out = 0
    while True:
        c = f.read(1)
        if not c:
            if shift:
                raise ValueError("truncated varint")
            return None
        out |= (c[0] & 0x7F) << shift
        if not c[0] & 0x80:
            return out
        shift += 7


def delimited(msg: bytes) -> bytes:
    return varint(len(msg)) + msg


# ---------------------------------------------------------------------------
# Vectorized uint32 varints
# ---------------------------------------------------------------------------


def varint_sizes(words: np.ndarray) -> np.ndarray:
    """Bytes of each uint32's varint (1-5), int64."""
    w = np.asarray(words, np.uint32)
    n = np.ones(w.shape, np.int64)
    for t in (7, 14, 21, 28):
        n += w >= np.uint32(1 << t)
    return n


def encode_uint32s(words: np.ndarray, tag: Optional[int] = None):
    """uint32 words -> uint8 stream of their varints, each after the
    one-byte ``tag`` if given. Returns (stream, bytes per word incl. tag)."""
    w = np.ascontiguousarray(words, np.uint32).reshape(-1)
    nb = varint_sizes(w)
    lead = 0 if tag is None else 1
    step = nb + lead
    ends = np.cumsum(step)
    out = np.empty(int(ends[-1]) if w.size else 0, np.uint8)
    base = ends - nb  # first varint byte of each word
    if tag is not None:
        out[base - 1] = tag
    for j in range(5):
        sel = np.flatnonzero(nb > j) if j else None
        wj = w if sel is None else w[sel]
        more = (nb > j + 1) if sel is None else (nb[sel] > j + 1)
        byte = ((wj >> np.uint32(7 * j)) & np.uint32(0x7F)).astype(np.uint8)
        byte |= more.astype(np.uint8) << 7
        out[(base if sel is None else base[sel]) + j] = byte
    return out, step


def _varint_values(seg: np.ndarray, starts: np.ndarray, ends: np.ndarray):
    """uint32 values of the varints seg[starts[k] .. ends[k]] (inclusive;
    ``ends`` are the terminators), truncated to 32 bits as protobuf
    truncates a uint32 field."""
    nb = ends - starts + 1
    val = np.zeros(starts.shape, np.uint64)
    for j in range(int(nb.max()) if nb.size else 0):
        sel = np.flatnonzero(nb > j)
        part = (seg[starts[sel] + j] & 0x7F).astype(np.uint64)
        val[sel] |= part << np.uint64(7 * j)
    return (val & np.uint64(0xFFFFFFFF)).astype(np.uint32)


def decode_packed_uint32s(blob: np.ndarray) -> np.ndarray:
    """A packed run of varints (uint8 array) -> uint32 values."""
    ends = np.flatnonzero(blob < 0x80)
    if ends.size and ends[-1] != blob.size - 1:
        raise ValueError("truncated packed varints")
    starts = np.concatenate([[0], ends[:-1] + 1]).astype(np.int64)
    return _varint_values(blob, starts, ends)


def _decode_unpacked_run(seg: np.ndarray):
    """Decode the leading run of unpacked field-7 entries (tag 0x38 +
    varint) of ``seg`` (seg[0] == 0x38). Inside such a run the bytes below
    0x80 alternate tag, terminator, tag, ...; the run ends where that
    pattern breaks (another field follows). Returns (values, bytes used)."""
    low = np.flatnonzero(seg < 0x80)
    tags, ends = low[0::2], low[1::2]
    n = ends.size
    tags = tags[:n]
    ok = seg[tags] == _TAG_VOXEL
    ok[1:] &= tags[1:] == ends[:-1] + 1
    bad = np.flatnonzero(~ok)
    if bad.size:
        n = int(bad[0])
    if n == 0:
        raise ValueError("truncated voxel_data entry")
    values = _varint_values(seg, tags[:n] + 1, ends[:n])
    return values, int(ends[n - 1]) + 1


# ---------------------------------------------------------------------------
# Messages
# ---------------------------------------------------------------------------


def _double(tag: int, v: float) -> bytes:
    return bytes([tag]) + struct.pack("<d", float(v))


def layer_header(voxel_size: float, vps: int, layer_type: str) -> bytes:
    """Serialized LayerProto."""
    t = layer_type.encode()
    return (_double(0x09, voxel_size) + b"\x10" + varint(vps) + b"\x1a"
            + varint(len(t)) + t)


def block_prefix(vps: int, voxel_size: float, origin) -> bytes:
    """Serialized BlockProto fields 1-6 (``has_data`` true)."""
    return (b"\x08" + varint(int(vps)) + _double(0x11, voxel_size)
            + _double(0x19, origin[0]) + _double(0x21, origin[1])
            + _double(0x29, origin[2]) + b"\x30\x01")


def block_messages(vps: int, voxel_size: float, origins: np.ndarray,
                   words: np.ndarray, chunk: int = 256) -> Iterator:
    """Delimited BlockProto messages of blocks with ``origins`` f64[n,3]
    and voxel words uint32[n, m], as a stream of bytes-like pieces. The
    voxel data of ``chunk`` blocks is encoded in one vectorized pass."""
    n, m = words.shape
    for s in range(0, n, chunk):
        w = words[s:s + chunk]
        body, step = encode_uint32s(w, _TAG_VOXEL)
        lens = step.reshape(w.shape[0], m).sum(1)
        offs = np.concatenate([[0], np.cumsum(lens)])
        view = memoryview(body)
        for i in range(w.shape[0]):
            prefix = block_prefix(vps, voxel_size, origins[s + i])
            yield varint(len(prefix) + int(lens[i])) + prefix
            yield view[offs[i]:offs[i + 1]]


def _skip_field(buf, pos: int, wire_type: int) -> int:
    if wire_type == 0:
        _, pos = read_varint(buf, pos)
        return pos
    if wire_type == 1:
        return pos + 8
    if wire_type == 2:
        n, pos = read_varint(buf, pos)
        return pos + n
    if wire_type == 5:
        return pos + 4
    raise ValueError(f"unsupported wire type {wire_type}")


def parse_layer_header(buf, pos: int, end: int) -> LayerProto:
    hdr = LayerProto()
    while pos < end:
        tag, pos = read_varint(buf, pos)
        field, wt = tag >> 3, tag & 7
        if field == 1 and wt == 1:
            hdr.voxel_size = struct.unpack_from("<d", buf, pos)[0]
            pos += 8
        elif field == 2 and wt == 0:
            hdr.voxels_per_side, pos = read_varint(buf, pos)
        elif field == 3 and wt == 2:
            n, pos = read_varint(buf, pos)
            hdr.type = bytes(buf[pos:pos + n]).decode()
            pos += n
        else:
            pos = _skip_field(buf, pos, wt)
    if pos != end:
        raise ValueError("truncated layer header")
    return hdr


def parse_block(arr: np.ndarray, pos: int, end: int) -> BlockProto:
    """BlockProto from the uint8 array ``arr`` [pos, end)."""
    bp = BlockProto()
    pieces: List[np.ndarray] = []
    buf = memoryview(arr)
    doubles = {2: "voxel_size", 3: "origin_x", 4: "origin_y", 5: "origin_z"}
    while pos < end:
        if arr[pos] == _TAG_VOXEL:
            vals, used = _decode_unpacked_run(arr[pos:end])
            pieces.append(vals)
            pos += used
            continue
        tag, pos = read_varint(buf, pos)
        field, wt = tag >> 3, tag & 7
        if field in doubles and wt == 1:
            setattr(bp, doubles[field], struct.unpack_from("<d", buf, pos)[0])
            pos += 8
        elif field == 1 and wt == 0:
            v, pos = read_varint(buf, pos)
            bp.voxels_per_side = v - (1 << 64) if v >= 1 << 63 else v
        elif field == 6 and wt == 0:
            v, pos = read_varint(buf, pos)
            bp.has_data = bool(v)
        elif field == 7 and wt == 2:
            n, pos = read_varint(buf, pos)
            pieces.append(decode_packed_uint32s(arr[pos:pos + n]))
            pos += n
        else:
            pos = _skip_field(buf, pos, wt)
    if pos != end:
        raise ValueError("truncated block message")
    if pieces:
        bp.voxel_data = (pieces[0] if len(pieces) == 1
                         else np.concatenate(pieces))
    return bp


class Reader:
    """Sequential reader of a varint-framed stream held in memory: a
    count, then delimited messages."""

    def __init__(self, data):
        self.arr = np.frombuffer(data, np.uint8)
        self.buf = memoryview(self.arr)
        self.pos = 0

    def at_end(self) -> bool:
        return self.pos >= self.arr.size

    def varint(self) -> Optional[int]:
        v, self.pos = read_varint(self.buf, self.pos)
        return v

    def _span(self):
        n = self.varint()
        if n is None or self.pos + n > self.arr.size:
            raise ValueError("truncated message stream")
        start = self.pos
        self.pos += n
        return start, self.pos

    def layer_header(self) -> LayerProto:
        return parse_layer_header(self.buf, *self._span())

    def block(self) -> BlockProto:
        return parse_block(self.arr, *self._span())

    def skip(self):
        self._span()
