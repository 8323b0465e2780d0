"""Minimal SO(3)/SE(3) utilities (port of voxblox_tpu/utils/lie.py): exp,
log, compose and inverse for the ICP's information-weighted pose blend
(icp.cc:205-215: delta <- exp(w .* log(delta))).

Convention: an se(3) vector is [rho(3), phi(3)] with T = exp([rho, phi]).
The small-angle branches select with ``torch.where`` over both branches,
as the JAX functions do, so nothing reads a value on the host.
"""

from __future__ import annotations

import torch

EPS = 1e-8


def _eye(like):
    return torch.eye(3, dtype=like.dtype, device=like.device)


def hat(w):
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack([torch.stack([z, -wz, wy], -1),
                        torch.stack([wz, z, -wx], -1),
                        torch.stack([-wy, wx, z], -1)], -2)


def so3_exp(phi):
    theta = torch.linalg.vector_norm(phi, dim=-1, keepdim=True)
    th = torch.clamp(theta, min=EPS)
    a = torch.sin(th) / th
    b = (1.0 - torch.cos(th)) / (th * th)
    k = hat(phi)
    return _eye(phi) + a[..., None] * k + b[..., None] * (k @ k)


def _vee_skew(R):
    return torch.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0],
                        R[..., 1, 0] - R[..., 0, 1]], -1)


def so3_log(R):
    cos = torch.clamp((R.diagonal(dim1=-2, dim2=-1).sum(-1) - 1.0) / 2.0,
                      -1.0, 1.0)
    theta = torch.arccos(cos)
    th = torch.clamp(theta, min=EPS)
    w = (_vee_skew(R) * 0.5 * th[..., None]
         / torch.clamp(torch.sin(th), min=EPS)[..., None])
    return torch.where((theta < 1e-6)[..., None], _vee_skew(R) * 0.5, w)


def _left_jacobian(phi):
    theta = torch.linalg.vector_norm(phi)
    th = torch.clamp(theta, min=EPS)
    k = hat(phi / th)
    a = (1.0 - torch.cos(th)) / th
    b = 1.0 - torch.sin(th) / th
    J = _eye(phi) + a * k + b * (k @ k)
    return torch.where(theta < 1e-6, _eye(phi) + 0.5 * hat(phi), J)


def _left_jacobian_inv(phi):
    theta = torch.linalg.vector_norm(phi)
    th = torch.clamp(theta, min=EPS)
    k = hat(phi / th)
    half = th / 2.0
    cot = half / torch.tan(half)
    J = _eye(phi) - half * k + (1.0 - cot) * (k @ k)
    return torch.where(theta < 1e-6, _eye(phi) - 0.5 * hat(phi), J)


def se3_exp(xi):
    """xi = [rho, phi] -> (R, t)."""
    rho, phi = xi[..., :3], xi[..., 3:]
    return so3_exp(phi), (_left_jacobian(phi) @ rho[..., None])[..., 0]


def se3_log(R, t):
    phi = so3_log(R)
    rho = (_left_jacobian_inv(phi) @ t[..., None])[..., 0]
    return torch.cat([rho, phi], -1)


def compose(T1, T2):
    R1, t1 = T1
    R2, t2 = T2
    return R1 @ R2, (R1 @ t2[..., None])[..., 0] + t1


def inverse(T):
    R, t = T
    Rt = R.transpose(-1, -2)
    return Rt, -(Rt @ t[..., None])[..., 0]
