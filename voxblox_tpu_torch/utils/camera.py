"""Camera frustum for view culling (port of voxblox_tpu/utils/camera.py;
reference utils/camera_model.{h,cc}): a pinhole frustum as six bounding
planes and an AABB, built on the host from the field of view and the
pose, and vectorized point and block tests on the device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import _runtime


@dataclasses.dataclass
class Frustum:
    """Six planes with outward normals: a point is inside iff n.x <= d for
    all of them."""

    normals: torch.Tensor  # f32[6,3]
    offsets: torch.Tensor  # f32[6]
    aabb_min: torch.Tensor  # f32[3]
    aabb_max: torch.Tensor  # f32[3]


def _np(x):
    if isinstance(x, torch.Tensor):
        return _runtime.to_host(x).astype(np.float64)
    return np.asarray(x, np.float64)


def frustum_from_fov(T_G_C, fov_h_rad: float, fov_v_rad: float,
                     min_depth: float, max_depth: float,
                     device=None) -> Frustum:
    """The frustum in the world frame on ``device`` (default CUDA); the
    camera looks along +z."""
    dev = _runtime.resolve_device(device)
    R, t = (_np(x) for x in T_G_C)
    th = np.tan(fov_h_rad / 2.0)
    tv = np.tan(fov_v_rad / 2.0)
    # Camera-frame outward plane normals (camera_model.cc).
    normals_C = np.array([
        [0.0, 0.0, -1.0],  # near
        [0.0, 0.0, 1.0],  # far
        [1.0, 0.0, -th],  # right (x <= th * z)
        [-1.0, 0.0, -th],  # left
        [0.0, 1.0, -tv],  # bottom
        [0.0, -1.0, -tv],  # top
    ])
    normals_C[2:] /= np.linalg.norm(normals_C[2:], axis=1, keepdims=True)
    offsets_C = np.array([-min_depth, max_depth, 0.0, 0.0, 0.0, 0.0])
    normals_G = normals_C @ R.T
    offsets_G = offsets_C + normals_G @ t
    corners_C = [[sx * th * z, sy * tv * z, z]
                 for z in (min_depth, max_depth)
                 for sx in (-1, 1) for sy in (-1, 1)]
    corners_G = np.asarray(corners_C) @ R.T + t

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    return Frustum(normals=f32(normals_G), offsets=f32(offsets_G),
                   aabb_min=f32(corners_G.min(0)),
                   aabb_max=f32(corners_G.max(0)))


def points_in_frustum(frustum: Frustum, points):
    """bool[...] for world points [...,3]."""
    s = torch.einsum("...k,pk->...p", points, frustum.normals)
    return (s <= frustum.offsets + 1e-6).all(-1)


def blocks_in_frustum(frustum: Frustum, block_ijk, block_size: float):
    """Conservative bool[...] for blocks: the centre within the frustum
    grown by the block's circumradius (camera_model view culling)."""
    centres = (block_ijk.to(torch.float32) + 0.5) * block_size
    margin = block_size * np.sqrt(3.0) / 2.0
    s = torch.einsum("...k,pk->...p", centres, frustum.normals)
    return (s <= frustum.offsets + margin).all(-1)
