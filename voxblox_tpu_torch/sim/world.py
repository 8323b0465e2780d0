"""Simulation world: synthetic depth and lidar scans, analytic distances
and ground-truth layers (port of voxblox_tpu/sim/world.py).

Pinhole rays follow the reference pixel convention (focal = W / (2 tan
(fov/2))); ``organized_pointcloud_from_transform`` renders the raster-
ordered [H, W, 3] clouds the online bench feeds the mapper, and
``spherical_pointcloud_from_transform`` the ring-major scans of a
spinning lidar. ``generate_gt_layer`` fills a dense TSDF or ESDF layer
with the scene's distances over the world's bounds.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

from .. import _runtime
from ..core import grid
from ..core import layer as vlayer
from . import objects as sim_objects
from .objects import ObjectSet, make_object_set


@dataclasses.dataclass
class SimulationWorld:
    objects: List[dict] = dataclasses.field(default_factory=list)
    min_bound: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([-5.0, -5.0, -1.0], np.float32))
    max_bound: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([5.0, 5.0, 9.0], np.float32))

    def add_sphere(self, center, radius, color=(255, 255, 255)):
        self.objects.append(dict(kind=sim_objects.SPHERE, center=center,
                                 params=(radius, 0, 0), color=color))

    def add_cube(self, center, size, color=(255, 255, 255)):
        self.objects.append(dict(kind=sim_objects.CUBE, center=center,
                                 params=size, color=color))

    def add_plane(self, center, normal, color=(255, 255, 255)):
        n = np.asarray(normal, np.float64)
        n = n / np.linalg.norm(n)
        self.objects.append(dict(kind=sim_objects.PLANE, center=center,
                                 params=tuple(n), color=color))

    def add_cylinder(self, center, radius, height, color=(255, 255, 255)):
        self.objects.append(dict(kind=sim_objects.CYLINDER, center=center,
                                 params=(radius, height, 0), color=color))

    def add_ground_level(self, height, color=(127, 127, 127)):
        self.add_plane((0.0, 0.0, height), (0.0, 0.0, 1.0), color)

    def add_plane_boundaries(self, x_min, x_max, y_min, y_max):
        """Four inward-facing walls (simulation_world.cc:35-48)."""
        self.add_plane((x_min, 0.0, 0.0), (1.0, 0.0, 0.0))
        self.add_plane((x_max, 0.0, 0.0), (-1.0, 0.0, 0.0))
        self.add_plane((0.0, y_min, 0.0), (0.0, 1.0, 0.0))
        self.add_plane((0.0, y_max, 0.0), (0.0, -1.0, 0.0))

    def freeze(self, device=None) -> ObjectSet:
        return make_object_set(self.objects, _runtime.resolve_device(device))


def distance_to_point(objects: ObjectSet, points, max_dist):
    """Min distance over objects, capped at ``max_dist``, and the colour
    of the nearest object (getDistanceToPoint)."""
    d = sim_objects.object_distances(objects, points)
    dmin, arg = torch.min(d, dim=-1)
    return torch.clamp(dmin, max=max_dist), objects.color[arg]


def rotation_from_two_vectors(a, b):
    """Rotation taking unit vector a to unit vector b (f32 [3,3])."""
    a = torch.as_tensor(a, dtype=torch.float32)
    b = torch.as_tensor(b, dtype=torch.float32, device=a.device)
    a = a / torch.linalg.norm(a)
    b = b / torch.linalg.norm(b)
    v = torch.linalg.cross(a, b)
    c = torch.dot(a, b)
    eye = torch.eye(3, dtype=a.dtype, device=a.device)
    ortho = torch.where(
        a[0].abs() < 0.9,
        torch.tensor([1.0, 0.0, 0.0], device=a.device),
        torch.tensor([0.0, 1.0, 0.0], device=a.device),
    )
    anti_axis = torch.linalg.cross(a, ortho)
    anti_axis = anti_axis / torch.linalg.norm(anti_axis)
    zero = torch.zeros((), dtype=a.dtype, device=a.device)
    vx = torch.stack([
        torch.stack([zero, -v[2], v[1]]),
        torch.stack([v[2], zero, -v[0]]),
        torch.stack([-v[1], v[0], zero]),
    ])
    k = 1.0 / torch.clamp(1.0 + c, min=1e-8)
    R = eye + vx + vx @ vx * k
    R_anti = 2.0 * torch.outer(anti_axis, anti_axis) - eye
    return torch.where(c < -1.0 + 1e-6, R_anti, R)


def camera_rays(camera_res, fov_h_rad, device):
    """Nominal (+x forward) pixel rays, u-major; f32[W*H, 3]."""
    w, h = camera_res
    focal = w / (2.0 * np.tan(fov_h_rad / 2.0))
    u = torch.arange(-(w // 2), w // 2, dtype=torch.float32, device=device)
    v = torch.arange(-(h // 2), h // 2, dtype=torch.float32, device=device)
    uu, vv = torch.meshgrid(u, v, indexing="ij")
    dirs = torch.stack([torch.ones_like(uu), uu / focal, vv / focal],
                       dim=-1).reshape(-1, 3)
    return dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)


def _cast(objects, origin, dirs, max_dist):
    t = sim_objects.object_ray_intersections(
        objects, origin.expand_as(dirs), dirs)
    tmin, arg = torch.min(t, dim=-1)
    valid = torch.isfinite(tmin) & (tmin <= max_dist)
    tmin = torch.where(valid, tmin, 0.0)
    return tmin, objects.color[arg], valid


def pointcloud_from_viewpoint(objects: ObjectSet, view_origin,
                              view_direction, camera_res, fov_h_rad,
                              max_dist):
    """Render a scan: (points_G [P,3], colors [P,3], valid [P]); invalid
    pixels carry point = origin."""
    dev = objects.center.device
    dirs_cam = camera_rays(camera_res, fov_h_rad, dev)
    R = rotation_from_two_vectors(
        torch.tensor([1.0, 0.0, 0.0], device=dev),
        torch.as_tensor(view_direction, dtype=torch.float32, device=dev))
    dirs = dirs_cam @ R.T
    origin = torch.as_tensor(view_origin, dtype=torch.float32, device=dev)
    tmin, colors, valid = _cast(objects, origin, dirs, max_dist)
    return origin + dirs * tmin[:, None], colors, valid


def pointcloud_from_transform(objects: ObjectSet, T_G_C, camera_res,
                              fov_h_rad, max_dist):
    """Reference getPointcloudFromTransform: view direction R @ +z, origin
    the translation. Returns world-frame (points, colors, valid)."""
    R, tr = T_G_C
    R = torch.as_tensor(R, dtype=torch.float32, device=objects.center.device)
    view = R @ torch.tensor([0.0, 0.0, 1.0], device=R.device)
    return pointcloud_from_viewpoint(objects, tr, view, camera_res,
                                     fov_h_rad, max_dist)


def organized_pointcloud_from_transform(objects: ObjectSet, T_G_C,
                                        camera_res, fov_h_rad, max_dist):
    """Raster-ordered sensor-frame scan: (points_C f32[H,W,3] (0 where
    invalid), colors f32[H,W,3], valid bool[H,W], (fx, fy, cx, cy))."""
    w, h = camera_res
    dev = objects.center.device
    focal = w / (2.0 * np.tan(fov_h_rad / 2.0))
    cx, cy = w / 2.0, h / 2.0
    u = torch.arange(w, dtype=torch.float32, device=dev) - cx
    v = torch.arange(h, dtype=torch.float32, device=dev) - cy
    vv, uu = torch.meshgrid(v, u, indexing="ij")
    dirs_C = torch.stack([uu / focal, vv / focal, torch.ones_like(uu)],
                         dim=-1).reshape(-1, 3)
    dirs_C = dirs_C / torch.linalg.norm(dirs_C, dim=-1, keepdim=True)
    R, tr = T_G_C
    dirs_G = dirs_C @ R.T
    origin = torch.as_tensor(tr, dtype=torch.float32, device=dev)
    tmin, colors, valid = _cast(objects, origin, dirs_G, max_dist)
    points_C = dirs_C * tmin[:, None]
    return (points_C.reshape(h, w, 3), colors.reshape(h, w, 3),
            valid.reshape(h, w), (focal, focal, cx, cy))


def spherical_pointcloud_from_transform(objects: ObjectSet, T_G_C,
                                        resolution, fov_up_deg: float,
                                        fov_down_deg: float, max_dist):
    """Velodyne-style scan, ``resolution`` = (W azimuth bins, H beams):
    beam (v, u) points along azimuth -pi + (u+0.5)*2pi/W and elevation
    fov_down + (v+0.5)*delta (sensor frame, +x forward, +z up). Returns
    (points_C f32[W*H, 3] ring-major, 0 where no return, colors, valid)."""
    w, h = resolution
    dev = objects.center.device
    el0 = np.deg2rad(fov_down_deg)
    el1 = np.deg2rad(fov_up_deg)
    az = -np.pi + (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) \
        * (2 * np.pi / w)
    el = el0 + (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) \
        * ((el1 - el0) / h)
    ee, aa = torch.meshgrid(el, az, indexing="ij")  # [h, w]
    dirs_C = torch.stack([torch.cos(ee) * torch.cos(aa),
                          torch.cos(ee) * torch.sin(aa), torch.sin(ee)],
                         dim=-1).reshape(-1, 3)
    R, tr = T_G_C
    R = torch.as_tensor(R, dtype=torch.float32, device=dev)
    origin = torch.as_tensor(tr, dtype=torch.float32, device=dev)
    tmin, colors, valid = _cast(objects, origin, dirs_C @ R.T, max_dist)
    return dirs_C * tmin[:, None], colors, valid


def world_points_to_sensor(T_G_C, points_G, valid):
    """Inverse-transform world points; invalid lanes get the zero point."""
    R, t = T_G_C
    p = (points_G - t) @ R
    return torch.where(valid[:, None], p, 0.0)


# ---------------------------------------------------------------------------
# Ground-truth SDF layers
# ---------------------------------------------------------------------------

_GT_CHUNK = 1 << 20  # voxel centres evaluated per pass


def generate_gt_layer(objects: ObjectSet, layer_type: str, voxel_size: float,
                      min_bound, max_bound, max_dist: float, vps: int = 16,
                      max_blocks: int = 8192) -> vlayer.VoxelLayer:
    """A dense GT layer over [min_bound, max_bound] on the objects' device
    (simulation_world_inl.h:13-70): every voxel centre of the covering
    blocks gets distance = max(min over objects, -max_dist); inside the
    bounds a TSDF has weight 1 and the object's colour, an ESDF the
    observed flag. Raises AssertionError when the pool is too small."""
    dev = objects.center.device
    block_size = voxel_size * vps
    min_b = np.asarray(min_bound, np.float64) - block_size / 2.0
    max_b = np.asarray(max_bound, np.float64) + block_size / 2.0
    lo = np.floor(min_b / block_size).astype(np.int64)
    hi = np.floor(max_b / block_size).astype(np.int64)
    axes = [np.arange(lo[i], hi[i] + 1) for i in range(3)]
    blocks = np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 3)
    n = len(blocks)
    assert n <= max_blocks, f"GT world needs {n} blocks > pool {max_blocks}"
    layer = vlayer.make_layer(layer_type, voxel_size, vps=vps,
                              max_blocks=max_blocks, device=dev)
    ijk = torch.as_tensor(blocks, dtype=torch.int32, device=dev)
    layer, overflow = vlayer.allocate_blocks(
        layer, ijk, torch.ones(n, dtype=torch.bool, device=dev))
    assert not _runtime.host_bool(overflow)
    slots = vlayer.lookup_blocks(layer, ijk).to(torch.int64)
    vpb = vps ** 3
    local = grid.linear_to_local(
        torch.arange(vpb, dtype=torch.int32, device=dev), vps)
    lo_t = torch.as_tensor(np.asarray(min_bound, np.float32), device=dev)
    hi_t = torch.as_tensor(np.asarray(max_bound, np.float32), device=dev)
    ch = layer.channels
    if layer_type not in ("tsdf", "esdf"):
        raise ValueError(layer_type)
    step = max(1, _GT_CHUNK // vpb)
    for b0 in range(0, n, step):
        rows = slots[b0:b0 + step]
        gvi = ijk[b0:b0 + step, None, :] * vps + local
        centres = grid.grid_index_to_center_point(gvi, voxel_size)
        d, color = distance_to_point(objects, centres, max_dist)
        d = torch.clamp(d, min=-max_dist)
        inside = ((centres >= lo_t) & (centres <= hi_t)).all(-1)
        if layer_type == "tsdf":
            ch["tsdf"][rows] = torch.where(inside, d, 0.0)
            ch["weight"][rows] = inside.to(torch.float32)
            ch["color"][rows] = torch.where(
                inside[..., None], color, 0.0).reshape(len(rows), -1)
        else:
            ch["esdf"][rows] = torch.where(inside, d, 0.0)
            ch["esdf_flags"][rows] = torch.where(
                inside, vlayer.ESDF_OBSERVED, 0).to(torch.uint8)
    return layer
