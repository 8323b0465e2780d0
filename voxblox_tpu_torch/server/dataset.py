"""Dataset input: pose providers + depth-scan iterators (copy of
voxblox_tpu/server/dataset.py; ``run_dataset`` feeds the port's servers).

The ROS-free replacement of the reference's input plumbing:
- ``TumTrajectory`` replaces the TF-tree/transform-topic ``Transformer``
  (voxblox_ros transformer.{h,cc}): pose lookup by timestamp with
  interpolation and a match tolerance, plus the static sensor extrinsic
  T_B_C (body->camera).
- ``DepthFolderDataset`` iterates (timestamp, depth, color) from a folder
  of .npy/.npz/png frames — the cow-and-lady-style RGB-D pipeline without
  rosbag decoding.
- ``depth_image_to_pointcloud`` converts a depth image + intrinsics to the
  sensor-frame cloud the integrators consume.
- ``run_dataset`` drives a TsdfServer/EsdfServer over a dataset
  (tsdf_server.cc insertPointcloud loop semantics: skip frames without a
  pose within tolerance).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Iterator, Optional, Tuple

import numpy as np


def quaternion_to_rotation(q):
    """[qx, qy, qz, qw] -> R[3,3] (TUM convention)."""
    x, y, z, w = q
    n = np.sqrt(x * x + y * y + z * z + w * w)
    x, y, z, w = x / n, y / n, z / n, w / n
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ],
        np.float64,
    )


@dataclasses.dataclass
class TumTrajectory:
    """Timestamped pose source (Transformer equivalent).

    File format: ``timestamp tx ty tz qx qy qz qw`` per line (# comments).
    """

    timestamps: np.ndarray  # f64[N]
    positions: np.ndarray  # f64[N,3]
    quaternions: np.ndarray  # f64[N,4]
    timestamp_tolerance_s: float = 0.1
    # Static extrinsic body->camera (Transformer's T_B_C).
    T_B_C: Optional[Tuple[np.ndarray, np.ndarray]] = None

    @classmethod
    def load(cls, path: str, **kw) -> "TumTrajectory":
        rows = []
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                parts = [float(x) for x in line.split()]
                if len(parts) >= 8:
                    rows.append(parts[:8])
        arr = np.asarray(rows, np.float64)
        order = np.argsort(arr[:, 0])
        arr = arr[order]
        return cls(
            timestamps=arr[:, 0],
            positions=arr[:, 1:4],
            quaternions=arr[:, 4:8],
            **kw,
        )

    def lookup(self, timestamp: float):
        """Interpolated T_G_B at timestamp -> (R, t) or None if outside
        tolerance (Transformer::lookupTransform semantics)."""
        i = np.searchsorted(self.timestamps, timestamp)
        if i == 0:
            i0 = i1 = 0
        elif i >= len(self.timestamps):
            i0 = i1 = len(self.timestamps) - 1
        else:
            i0, i1 = i - 1, i
        bracketed = (
            i0 != i1
            and self.timestamps[i0] <= timestamp <= self.timestamps[i1]
        )
        if not bracketed and min(
            abs(self.timestamps[i0] - timestamp),
            abs(self.timestamps[i1] - timestamp),
        ) > self.timestamp_tolerance_s:
            # Only off-trajectory queries are tolerance-gated; bracketed
            # stamps always interpolate (Transformer semantics).
            return None
        if i0 == i1:
            t = self.positions[i0]
            R = quaternion_to_rotation(self.quaternions[i0])
        else:
            t0, t1 = self.timestamps[i0], self.timestamps[i1]
            a = 0.0 if t1 == t0 else (timestamp - t0) / (t1 - t0)
            t = (1 - a) * self.positions[i0] + a * self.positions[i1]
            q0, q1 = self.quaternions[i0], self.quaternions[i1]
            if np.dot(q0, q1) < 0:
                q1 = -q1
            q = (1 - a) * q0 + a * q1  # nlerp
            R = quaternion_to_rotation(q)
        if self.T_B_C is not None:
            Rc, tc = self.T_B_C
            R, t = R @ Rc, R @ tc + t
        return R.astype(np.float32), t.astype(np.float32)


def depth_image_to_pointcloud(depth, intrinsics, color=None,
                              depth_scale: float = 1.0):
    """depth f32[H,W] (meters after depth_scale) + (fx, fy, cx, cy) ->
    (points_C [H*W,3], colors [H*W,3]). Invalid depths give zero points."""
    fx, fy, cx, cy = intrinsics
    h, w = depth.shape
    z = depth.astype(np.float32) * depth_scale
    valid = np.isfinite(z) & (z > 0)
    z = np.where(valid, z, 0.0)
    us, vs = np.meshgrid(np.arange(w), np.arange(h))
    x = (us - cx) / fx * z
    y = (vs - cy) / fy * z
    pts = np.stack([x, y, z], -1).reshape(-1, 3).astype(np.float32)
    if color is None:
        cols = np.zeros_like(pts)
    else:
        cols = color.reshape(-1, 3).astype(np.float32)
    return pts, cols


class DepthFolderDataset:
    """Frames from a folder: ``<stamp>.npy`` / ``.npz`` depth files
    (meters), optional ``<stamp>_color.npy`` uint8 color."""

    def __init__(self, root: str, intrinsics, depth_scale: float = 1.0):
        self.root = root
        self.intrinsics = intrinsics
        self.depth_scale = depth_scale
        self.frames = sorted(
            f for f in os.listdir(root)
            if f.endswith((".npy", ".npz")) and "_color" not in f
        )

    def __len__(self):
        return len(self.frames)

    def __iter__(self) -> Iterator[Tuple[float, np.ndarray, np.ndarray]]:
        for fname in self.frames:
            stamp = float(os.path.splitext(fname)[0])
            path = os.path.join(self.root, fname)
            if fname.endswith(".npz"):
                z = np.load(path)
                depth = z[z.files[0]]
            else:
                depth = np.load(path)
            cpath = os.path.join(
                self.root, os.path.splitext(fname)[0] + "_color.npy"
            )
            color = np.load(cpath) if os.path.exists(cpath) else None
            yield stamp, depth, color


def run_dataset(
    server,
    dataset,
    trajectory: TumTrajectory,
    update_esdf_every: int = 0,
    update_mesh_every: int = 0,
):
    """Drive a mapper service over a dataset (the subscriber loop of
    tsdf_server.cc:326-405 without ROS). Returns per-frame stats."""
    stats = {"integrated": 0, "skipped_no_pose": 0}
    for i, (stamp, depth, color) in enumerate(dataset):
        pose = trajectory.lookup(stamp)
        if pose is None:
            stats["skipped_no_pose"] += 1
            continue
        pts, cols = depth_image_to_pointcloud(
            depth, dataset.intrinsics, color, dataset.depth_scale
        )
        server.insert_pointcloud(pose, pts, cols)
        stats["integrated"] += 1
        if update_esdf_every and (i + 1) % update_esdf_every == 0:
            server.update_esdf()
        if update_mesh_every and (i + 1) % update_mesh_every == 0:
            server.update_mesh()
    # Final flush for tail frames (periodic-timer semantics at bag end).
    if update_esdf_every and stats["integrated"] % update_esdf_every:
        server.update_esdf()
    if update_mesh_every and stats["integrated"] % update_mesh_every:
        server.update_mesh()
    # Resolve any overflow deferred by overflow_check_interval > 1 before
    # the caller reads/saves the map (nothing later would check it).
    server.check_overflow()
    return stats
