"""Pure-python ROS1 bag (v2.0) reading/writing + message codecs (copy of
voxblox_tpu/io/rosbag.py; ``run_rosbag`` feeds the port's servers).

The reference framework is fed by ROS topics; its canonical datasets
(cow-and-lady, EuRoC) ship as rosbags of ``sensor_msgs/PointCloud2``
scans plus a pose source (``geometry_msgs/TransformStamped`` topic or
TF tree) — see voxblox_ros/launch/cow_and_lady_dataset.launch:9-14 and
the Transformer's transform-topic mode (voxblox_ros transformer.cc).
This module replays those bags without ROS:

- bag container: the self-describing record format of
  http://wiki.ros.org/Bags/Format/2.0 — records of (header-fields, data),
  chunks with none/bz2 compression (lz4 gated on availability);
- message codecs: ROS1's little-endian packed serialization for
  PointCloud2, TransformStamped, tf2_msgs/TFMessage, PoseStamped;
- a writer that emits the full indexed rosbag-record layout (chunked,
  IndexData + ChunkInfo records, trailing connection/index section) or
  minimal unindexed "active" bags — used for committed test fixtures
  and for exporting synthetic datasets other tools can open.

Only the stdlib is used (bz2); no rosbag/rospy dependency.
"""

from __future__ import annotations

import bz2
import dataclasses
import struct
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

MAGIC = b"#ROSBAG V2.0\n"

OP_MSG = 0x02
OP_BAG_HEADER = 0x03
OP_INDEX = 0x04
OP_CHUNK = 0x05
OP_CHUNK_INFO = 0x06
OP_CONNECTION = 0x07

# PointField datatypes (sensor_msgs/PointField).
PF_DTYPES = {
    1: np.dtype("<i1"), 2: np.dtype("<u1"), 3: np.dtype("<i2"),
    4: np.dtype("<u2"), 5: np.dtype("<i4"), 6: np.dtype("<u4"),
    7: np.dtype("<f4"), 8: np.dtype("<f8"),
}


# ---------------------------------------------------------------------------
# Record-level IO
# ---------------------------------------------------------------------------


def _encode_fields(fields: Dict[str, bytes]) -> bytes:
    out = b""
    for name, value in fields.items():
        item = name.encode() + b"=" + value
        out += struct.pack("<I", len(item)) + item
    return out


def _decode_fields(buf: bytes) -> Dict[str, bytes]:
    fields = {}
    i = 0
    while i < len(buf):
        (n,) = struct.unpack_from("<I", buf, i)
        i += 4
        item = buf[i : i + n]
        i += n
        eq = item.index(b"=")
        fields[item[:eq].decode()] = item[eq + 1 :]
    return fields


def _write_record(f, fields: Dict[str, bytes], data: bytes):
    hdr = _encode_fields(fields)
    f.write(struct.pack("<I", len(hdr)))
    f.write(hdr)
    f.write(struct.pack("<I", len(data)))
    f.write(data)


def _read_record(buf: bytes, i: int):
    """-> (fields, data, next_offset) or None at end."""
    if i + 4 > len(buf):
        return None
    (hlen,) = struct.unpack_from("<I", buf, i)
    i += 4
    fields = _decode_fields(buf[i : i + hlen])
    i += hlen
    (dlen,) = struct.unpack_from("<I", buf, i)
    i += 4
    data = buf[i : i + dlen]
    return fields, data, i + dlen


def _time_to_bytes(t_sec: float) -> bytes:
    sec = int(t_sec)
    nsec = int(round((t_sec - sec) * 1e9))
    if nsec >= 1_000_000_000:
        sec, nsec = sec + 1, nsec - 1_000_000_000
    return struct.pack("<II", sec, nsec)


def _time_from_bytes(b: bytes) -> float:
    sec, nsec = struct.unpack("<II", b)
    return sec + nsec * 1e-9


@dataclasses.dataclass
class Connection:
    conn_id: int
    topic: str
    msg_type: str
    md5sum: str = "*"
    message_definition: str = ""


# ---------------------------------------------------------------------------
# Reader
# ---------------------------------------------------------------------------


def read_messages(
    path: str, topics: Optional[List[str]] = None
) -> Iterator[Tuple[str, str, float, bytes]]:
    """Yield (topic, msg_type, stamp_sec, raw_serialized_message).

    Iterates chunk-by-chunk in file order (no index needed — also reads
    unindexed/"active" bags). Compression: none, bz2; lz4 if the lz4
    package is importable.
    """
    with open(path, "rb") as f:
        magic = f.readline()
        if magic != MAGIC:
            raise ValueError(f"{path}: not a ROS bag v2.0 (got {magic!r})")
        buf = f.read()

    conns: Dict[int, Connection] = {}

    def handle_records(blob: bytes):
        i = 0
        while True:
            rec = _read_record(blob, i)
            if rec is None:
                return
            fields, data, i = rec
            op = fields["op"][0]
            if op == OP_CONNECTION:
                cid = struct.unpack("<I", fields["conn"])[0]
                chdr = _decode_fields(data)
                conns[cid] = Connection(
                    conn_id=cid,
                    topic=chdr.get(
                        "topic", fields.get("topic", b"")
                    ).decode(),
                    msg_type=chdr.get("type", b"").decode(),
                    md5sum=chdr.get("md5sum", b"*").decode(),
                    message_definition=chdr.get(
                        "message_definition", b""
                    ).decode(),
                )
            elif op == OP_CHUNK:
                compression = fields.get("compression", b"none").decode()
                if compression == "none":
                    inner = data
                elif compression == "bz2":
                    inner = bz2.decompress(data)
                elif compression == "lz4":
                    try:
                        import lz4.frame  # type: ignore
                    except ImportError as e:  # pragma: no cover
                        raise ValueError(
                            "bag uses lz4 chunks and the lz4 package is "
                            "not available"
                        ) from e
                    inner = lz4.frame.decompress(data)
                else:  # pragma: no cover
                    raise ValueError(f"unknown compression {compression!r}")
                yield from handle_messages(inner)
            elif op == OP_MSG:
                yield fields, data

    def handle_messages(blob: bytes):
        i = 0
        while True:
            rec = _read_record(blob, i)
            if rec is None:
                return
            fields, data, i = rec
            op = fields["op"][0]
            if op == OP_CONNECTION:
                cid = struct.unpack("<I", fields["conn"])[0]
                chdr = _decode_fields(data)
                conns[cid] = Connection(
                    conn_id=cid,
                    topic=chdr.get("topic", b"").decode(),
                    msg_type=chdr.get("type", b"").decode(),
                    md5sum=chdr.get("md5sum", b"*").decode(),
                    message_definition=chdr.get(
                        "message_definition", b""
                    ).decode(),
                )
            elif op == OP_MSG:
                yield fields, data

    for fields, data in handle_records(buf):
        cid = struct.unpack("<I", fields["conn"])[0]
        conn = conns.get(cid)
        if conn is None:  # pragma: no cover
            continue
        if topics is not None and conn.topic not in topics:
            continue
        yield conn.topic, conn.msg_type, _time_from_bytes(
            fields["time"]
        ), data


# ---------------------------------------------------------------------------
# Writer (unindexed but spec-conformant records; fixtures + export)
# ---------------------------------------------------------------------------


# Real md5sums of the message types this module codes for — written
# into connection records so the fixtures match what a genuine
# rosbag-record'ed dataset (e.g. cow-and-lady) carries.
_MSG_MD5 = {
    "sensor_msgs/PointCloud2": "1158d486dd51d683ce2f1be655c3c181",
    "geometry_msgs/TransformStamped": "b5764a33bfeb3588febc2682852579b0",
    "geometry_msgs/PoseStamped": "d3812c3cbc69362b77dc0b19b345f8f5",
    "tf2_msgs/TFMessage": "94810edda583a504dfda3829e70d7eec",
}


def write_bag(path: str, messages, compression: str = "none",
              indexed: bool = True, chunk_threshold: int = 768 * 1024):
    """messages: iterable of (topic, msg_type, stamp_sec, raw_bytes).

    ``indexed=True`` writes the full rosbag-record file layout
    (http://wiki.ros.org/Bags/Format/2.0): multiple chunks split at
    ~``chunk_threshold`` uncompressed bytes, IndexData records after
    each chunk, and a trailing index section (connection records +
    ChunkInfo records) pointed to by the bag header's index_pos — the
    structure real datasets ship with, so reading a committed fixture
    exercises the same record skips a genuine bag does.
    ``indexed=False`` emits the old single-chunk "active" (unindexed)
    bag."""
    msgs = list(messages)
    topics: Dict[Tuple[str, str], int] = {}
    for topic, msg_type, _, _ in msgs:
        topics.setdefault((topic, msg_type), len(topics))

    def conn_record(f, topic, msg_type, cid):
        conn_hdr = _encode_fields(
            {
                "topic": topic.encode(),
                "type": msg_type.encode(),
                "md5sum": _MSG_MD5.get(msg_type, "*").encode(),
                "message_definition":
                    f"# {msg_type} (definition elided)\n".encode(),
            }
        )
        _write_record(
            f,
            {
                "op": bytes([OP_CONNECTION]),
                "conn": struct.pack("<I", cid),
                "topic": topic.encode(),
            },
            conn_hdr,
        )

    if compression not in ("none", "bz2"):
        raise ValueError(f"unsupported compression {compression!r}")

    import io as _io

    # Split messages into chunks (indexed mode only; unindexed keeps one).
    groups: List[List[Tuple[str, str, float, bytes]]] = [[]]
    size = 0
    for m in msgs:
        groups[-1].append(m)
        size += len(m[3]) + 64
        if indexed and size >= chunk_threshold:
            groups.append([])
            size = 0
    if len(groups) > 1 and not groups[-1]:
        groups.pop()

    with open(path, "wb") as f:
        f.write(MAGIC)
        # Bag header record, padded to 4096 bytes with spaces (spec).
        # index_pos is back-patched after the chunks are written.
        hdr_pos = f.tell()

        def bag_header(index_pos):
            hdr_fields = {
                "op": bytes([OP_BAG_HEADER]),
                "index_pos": struct.pack("<Q", index_pos),
                "conn_count": struct.pack("<I", len(topics)),
                "chunk_count": struct.pack("<I", len(groups)),
            }
            hdr = _encode_fields(hdr_fields)
            pad = 4096 - len(hdr)
            f.write(struct.pack("<I", len(hdr)))
            f.write(hdr)
            f.write(struct.pack("<I", pad))
            f.write(b" " * pad)

        bag_header(0)
        chunk_infos = []  # (chunk_pos, t0, t1, {cid: count})
        for gi, group in enumerate(groups):
            cf = _io.BytesIO()
            # Connection records live inside the first chunk (as rosbag
            # record does) AND in the index section below.
            if gi == 0:
                for (topic, msg_type), cid in topics.items():
                    conn_record(cf, topic, msg_type, cid)
            index: Dict[int, List[Tuple[float, int]]] = {}
            for topic, msg_type, t_sec, raw in group:
                cid = topics[(topic, msg_type)]
                index.setdefault(cid, []).append((t_sec, cf.tell()))
                _write_record(
                    cf,
                    {
                        "op": bytes([OP_MSG]),
                        "conn": struct.pack("<I", cid),
                        "time": _time_to_bytes(t_sec),
                    },
                    raw,
                )
            chunk = cf.getvalue()
            payload = bz2.compress(chunk) if compression == "bz2" else chunk
            chunk_pos = f.tell()
            _write_record(
                f,
                {
                    "op": bytes([OP_CHUNK]),
                    "compression": compression.encode(),
                    "size": struct.pack("<I", len(chunk)),
                },
                payload,
            )
            if indexed:
                for cid, entries in index.items():
                    _write_record(
                        f,
                        {
                            "op": bytes([OP_INDEX]),
                            "ver": struct.pack("<I", 1),
                            "conn": struct.pack("<I", cid),
                            "count": struct.pack("<I", len(entries)),
                        },
                        b"".join(
                            _time_to_bytes(t) + struct.pack("<I", off)
                            for t, off in entries
                        ),
                    )
                stamps = [m[2] for m in group] or [0.0]
                chunk_infos.append(
                    (chunk_pos, min(stamps), max(stamps),
                     {c: len(e) for c, e in index.items()})
                )
        if indexed:
            index_pos = f.tell()
            for (topic, msg_type), cid in topics.items():
                conn_record(f, topic, msg_type, cid)
            for chunk_pos, t0, t1, counts in chunk_infos:
                _write_record(
                    f,
                    {
                        "op": bytes([OP_CHUNK_INFO]),
                        "ver": struct.pack("<I", 1),
                        "chunk_pos": struct.pack("<Q", chunk_pos),
                        "start_time": _time_to_bytes(t0),
                        "end_time": _time_to_bytes(t1),
                        "count": struct.pack("<I", len(counts)),
                    },
                    b"".join(
                        struct.pack("<II", c, n)
                        for c, n in counts.items()
                    ),
                )
            f.seek(hdr_pos)
            bag_header(index_pos)


# ---------------------------------------------------------------------------
# ROS1 message codecs (little-endian packed)
# ---------------------------------------------------------------------------


def _pack_string(s: str) -> bytes:
    b = s.encode()
    return struct.pack("<I", len(b)) + b


def _unpack_string(buf: bytes, i: int) -> Tuple[str, int]:
    (n,) = struct.unpack_from("<I", buf, i)
    return buf[i + 4 : i + 4 + n].decode(), i + 4 + n


def _pack_header(stamp_sec: float, frame_id: str, seq: int = 0) -> bytes:
    return struct.pack("<I", seq) + _time_to_bytes(stamp_sec) + _pack_string(
        frame_id
    )


def _unpack_header(buf: bytes, i: int):
    seq, sec, nsec = struct.unpack_from("<III", buf, i)
    frame_id, i = _unpack_string(buf, i + 12)
    return (seq, sec + nsec * 1e-9, frame_id), i


def encode_pointcloud2(
    points: np.ndarray,
    colors: Optional[np.ndarray] = None,
    stamp_sec: float = 0.0,
    frame_id: str = "camera",
    height: int = 1,
) -> bytes:
    """points f32[N,3] (+ colors uint8-range [N,3]) -> sensor_msgs/
    PointCloud2 bytes with the standard x,y,z,rgb float32 layout (the
    packed-float rgb PCL convention the reference decodes,
    voxblox_ros conversions.h:104-130)."""
    points = np.asarray(points, np.float32)
    n = len(points)
    has_rgb = colors is not None
    step = 16 if has_rgb else 12
    data = np.zeros((n, step), np.uint8)
    data[:, :12] = points.view(np.uint8).reshape(n, 12)
    if has_rgb:
        c = np.asarray(colors)
        c = np.clip(c, 0, 255).astype(np.uint32)
        packed = (c[:, 0] << 16) | (c[:, 1] << 8) | c[:, 2]
        data[:, 12:16] = packed.astype(np.uint32).view(np.uint8).reshape(
            n, 4
        )
    width = n // height
    out = _pack_header(stamp_sec, frame_id)
    out += struct.pack("<II", height, width)
    fields = [("x", 0, 7), ("y", 4, 7), ("z", 8, 7)]
    if has_rgb:
        fields.append(("rgb", 12, 7))
    out += struct.pack("<I", len(fields))
    for name, off, dt in fields:
        out += _pack_string(name) + struct.pack("<IBI", off, dt, 1)
    out += struct.pack("<BII", 0, step, step * width)  # bigendian, steps
    flat = data.reshape(-1)
    out += struct.pack("<I", len(flat)) + flat.tobytes()
    out += struct.pack("<B", 1)  # is_dense
    return out


def decode_pointcloud2(raw: bytes):
    """-> dict(stamp, frame_id, points f32[N,3], colors f32[N,3] | None,
    intensity f32[N] | None). Arbitrary field layouts supported via
    offset-based structured dtypes."""
    (_, stamp, frame_id), i = _unpack_header(raw, 0)
    height, width = struct.unpack_from("<II", raw, i)
    i += 8
    (nf,) = struct.unpack_from("<I", raw, i)
    i += 4
    fields = {}
    for _ in range(nf):
        name, i = _unpack_string(raw, i)
        off, dt, count = struct.unpack_from("<IBI", raw, i)
        i += 9
        fields[name] = (off, dt, count)
    is_bigendian, point_step, row_step = struct.unpack_from("<BII", raw, i)
    i += 9
    (dlen,) = struct.unpack_from("<I", raw, i)
    i += 4
    if is_bigendian:
        raise ValueError(
            "decode_pointcloud2: big-endian PointCloud2 data is not "
            "supported (is_bigendian=1)"
        )
    data = np.frombuffer(raw, np.uint8, dlen, i)
    n = height * width
    if row_step != width * point_step:
        # Organized cloud with padded rows: slice the payload per row.
        if row_step < width * point_step or dlen < height * row_step:
            raise ValueError(
                "decode_pointcloud2: inconsistent row_step "
                f"({row_step}) for width={width} point_step={point_step}"
            )
        data = (
            data[: height * row_step]
            .reshape(height, row_step)[:, : width * point_step]
            .reshape(-1)
        )
    rows = data[: n * point_step].reshape(n, point_step)

    def field(name):
        if name not in fields:
            return None
        off, dt, _ = fields[name]
        dtype = PF_DTYPES[dt]
        view = np.dtype(
            {"names": [name], "formats": [dtype], "offsets": [off],
             "itemsize": point_step}
        )
        return rows.reshape(-1).view(view)[name].reshape(n)

    x, y, z = field("x"), field("y"), field("z")
    pts = np.stack(
        [np.asarray(v, np.float32) for v in (x, y, z)], -1
    )
    colors = None
    rgbf = field("rgb") if "rgb" in fields else field("rgba")
    if rgbf is not None:
        packed = np.ascontiguousarray(rgbf).view(np.uint32)
        colors = np.stack(
            [
                (packed >> 16) & 255,
                (packed >> 8) & 255,
                packed & 255,
            ],
            -1,
        ).astype(np.float32)
    intensity = field("intensity")
    if intensity is not None:
        intensity = np.asarray(intensity, np.float32)
    return {
        "stamp": stamp,
        "frame_id": frame_id,
        "points": pts,
        "colors": colors,
        "intensity": intensity,
        "height": height,
        "width": width,
    }


def encode_transform_stamped(
    stamp_sec: float, frame_id: str, child_frame_id: str, t, q
) -> bytes:
    """geometry_msgs/TransformStamped (t [3], q [x,y,z,w])."""
    out = _pack_header(stamp_sec, frame_id)
    out += _pack_string(child_frame_id)
    out += struct.pack("<3d", *np.asarray(t, np.float64))
    out += struct.pack("<4d", *np.asarray(q, np.float64))
    return out


def decode_transform_stamped(raw: bytes, i: int = 0):
    (_, stamp, frame_id), i = _unpack_header(raw, i)
    child, i = _unpack_string(raw, i)
    t = np.asarray(struct.unpack_from("<3d", raw, i))
    q = np.asarray(struct.unpack_from("<4d", raw, i + 24))
    return {
        "stamp": stamp,
        "frame_id": frame_id,
        "child_frame_id": child,
        "translation": t,
        "quaternion": q,
    }, i + 56


def encode_tf_message(transforms) -> bytes:
    """tf2_msgs/TFMessage: list of (stamp, frame, child, t, q)."""
    out = struct.pack("<I", len(transforms))
    for stamp, frame, child, t, q in transforms:
        out += encode_transform_stamped(stamp, frame, child, t, q)
    return out


def decode_tf_message(raw: bytes):
    (n,) = struct.unpack_from("<I", raw, 0)
    i = 4
    out = []
    for _ in range(n):
        tr, i = decode_transform_stamped(raw, i)
        out.append(tr)
    return out


# ---------------------------------------------------------------------------
# Dataset-level helpers
# ---------------------------------------------------------------------------


def trajectory_from_bag(
    path: str,
    topic: str,
    child_frame_id: Optional[str] = None,
    **traj_kw,
):
    """Build a TumTrajectory pose source from a bag's transform stream.

    Accepts geometry_msgs/TransformStamped topics (the reference
    Transformer's use_tf_transforms=false mode — cow-and-lady's
    kinect/vrpn_client/estimated_transform), tf2_msgs/TFMessage /
    tf/tfMessage (filtered by child_frame_id), and
    geometry_msgs/PoseStamped.
    """
    from ..server.dataset import TumTrajectory

    stamps, ts, qs = [], [], []
    for _topic, msg_type, t_sec, raw in read_messages(path, [topic]):
        short = msg_type.rsplit("/", 1)[-1]
        if short == "TransformStamped":
            tr, _ = decode_transform_stamped(raw)
            entries = [tr]
        elif short in ("TFMessage", "tfMessage"):
            entries = [
                tr
                for tr in decode_tf_message(raw)
                if child_frame_id is None
                or tr["child_frame_id"] == child_frame_id
            ]
        elif short == "PoseStamped":
            (_, stamp, _), i = _unpack_header(raw, 0)
            t = np.asarray(struct.unpack_from("<3d", raw, i))
            q = np.asarray(struct.unpack_from("<4d", raw, i + 24))
            entries = [
                {"stamp": stamp, "translation": t, "quaternion": q}
            ]
        else:  # pragma: no cover
            raise ValueError(f"unsupported pose message type {msg_type}")
        for tr in entries:
            stamps.append(tr["stamp"])
            ts.append(tr["translation"])
            qs.append(tr["quaternion"])
    if not stamps:
        raise ValueError(f"no poses on topic {topic!r} in {path}")
    order = np.argsort(stamps)
    return TumTrajectory(
        timestamps=np.asarray(stamps)[order],
        positions=np.asarray(ts)[order],
        quaternions=np.asarray(qs)[order],
        **traj_kw,
    )


class RosbagPointcloudDataset:
    """Iterate (stamp, points_C f32[N,3], colors f32[N,3]) scans from a
    bag's PointCloud2 topic (the subscriber side of
    tsdf_server.cc:353-405 without ROS)."""

    def __init__(self, path: str, topic: str):
        self.path = path
        self.topic = topic

    def __iter__(self):
        for _t, msg_type, t_sec, raw in read_messages(
            self.path, [self.topic]
        ):
            if not msg_type.endswith("PointCloud2"):  # pragma: no cover
                continue
            d = decode_pointcloud2(raw)
            colors = d["colors"]
            if colors is None:
                if d["intensity"] is not None:
                    inten = np.clip(d["intensity"], 0, 255)
                    colors = np.stack([inten] * 3, -1).astype(np.float32)
                else:
                    colors = np.zeros_like(d["points"])
            yield d["stamp"], d["points"], colors


def run_rosbag(
    server,
    bag_path: str,
    pointcloud_topic: str,
    pose_topic: str,
    child_frame_id: Optional[str] = None,
    T_B_C=None,
    update_esdf_every: int = 0,
    update_mesh_every: int = 0,
):
    """Replay a bag through a mapper service (cow-and-lady style:
    launch/cow_and_lady_dataset.launch wiring without ROS).

    Returns per-frame stats like server.dataset.run_dataset."""
    traj = trajectory_from_bag(
        bag_path, pose_topic, child_frame_id=child_frame_id, T_B_C=T_B_C
    )
    stats = {"integrated": 0, "skipped_no_pose": 0}
    i = 0
    for stamp, pts, cols in RosbagPointcloudDataset(
        bag_path, pointcloud_topic
    ):
        pose = traj.lookup(stamp)
        if pose is None:
            stats["skipped_no_pose"] += 1
            continue
        server.insert_pointcloud(pose, pts, cols)
        stats["integrated"] += 1
        i += 1
        if update_esdf_every and i % update_esdf_every == 0:
            server.update_esdf()
        if update_mesh_every and i % update_mesh_every == 0:
            server.update_mesh()
    # Final flush for the tail frames (the reference's periodic timers
    # keep firing after the bag ends; we fold that into one last update).
    if update_esdf_every and stats["integrated"] % update_esdf_every:
        server.update_esdf()
    if update_mesh_every and stats["integrated"] % update_mesh_every:
        server.update_mesh()
    # Resolve any overflow deferred by overflow_check_interval > 1 before
    # the caller reads/saves the map (nothing later would check it).
    server.check_overflow()
    return stats
