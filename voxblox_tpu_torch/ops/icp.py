"""ICP scan-to-map alignment against the TSDF (port of
voxblox_tpu/ops/icp.py; reference alignment/icp.{h,cc}).

Each point's match is synthesized from the TSDF field, target = p -
d(p) * normalize(grad d(p)) (icp.cc:140-146), with the nearest-voxel
distance corrected along the gradient. Transforms come from weighted
Kabsch over the matched pairs (yaw only by default, all three angles with
``refine_roll_pitch``), blended into the running pose with the
information weighting delta <- exp(w .* log(delta)), w = est_info /
(base_info + est_info) (icp.cc:186-215).

The mini-batches run one after another (``lax.scan`` in the JAX package,
a Python loop here); no step reads a device value on the host. The hash
table's probe bound is read once per call, since the layer does not
change during ICP, the batch gate is a ``torch.where`` and the 3x3 SVD of
``refine_roll_pitch`` is a fixed number of Jacobi sweeps. One host read a
call.

The batch order: the JAX package shuffles with ``jax.random.permutation(
PRNGKey(0), n)``, which needs JAX to reproduce. The port draws its order
with ``torch.randperm`` from a CPU generator seeded 0 (the same order on
the CPU and on the card); ``perm`` takes any other order, e.g. JAX's.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import _runtime
from ..core import grid
from ..core.config import IcpConfig
from ..utils import lie
from . import interp

_PERMS: dict = {}
_JACOBI_SWEEPS = 6


class IcpResult(NamedTuple):
    R: torch.Tensor  # [3,3] refined rotation R_G_C
    t: torch.Tensor  # [3]
    num_updates: torch.Tensor  # int32[] batches that produced an update


def default_perm(n: int, device) -> torch.Tensor:
    """The port's batch order for ``n`` points: ``torch.randperm`` from a
    CPU generator seeded 0, uploaded once per (n, device)."""
    key = (n, str(device))
    p = _PERMS.get(key)
    if p is None:
        g = torch.Generator(device="cpu").manual_seed(0)
        p = _PERMS[key] = torch.randperm(n, generator=g).to(device)
    return p


def _det3(m):
    return (m[0, 0] * (m[1, 1] * m[2, 2] - m[1, 2] * m[2, 1])
            - m[0, 1] * (m[1, 0] * m[2, 2] - m[1, 2] * m[2, 0])
            + m[0, 2] * (m[1, 0] * m[2, 1] - m[1, 1] * m[2, 0]))


def _kabsch(H):
    """R = V diag(1, 1, d) U^T for H = U S V^T, d = sign(det(V U^T)) (the
    JAX package's ``jnp.linalg.svd`` rule), in float64 without a host
    read: one-sided Jacobi sweeps orthogonalize H's columns (H V = U S),
    u1, u2 are the two strongest directions and u3 = u1 x u2. R does not
    depend on the sign of u3: flipping it flips d."""
    dev = H.device
    A = H.to(torch.float64)
    V = torch.eye(3, dtype=torch.float64, device=dev)
    eye = V.clone()
    for _ in range(_JACOBI_SWEEPS):
        for p, q in ((0, 1), (0, 2), (1, 2)):
            ap, aq = A[:, p], A[:, q]
            alpha, beta = (ap * ap).sum(), (aq * aq).sum()
            gamma = (ap * aq).sum()
            tiny = gamma.abs() <= 1e-300 + 1e-15 * torch.sqrt(alpha * beta)
            g = torch.where(tiny, 1.0, gamma)
            zeta = (beta - alpha) / (2.0 * g)
            sgn = torch.where(zeta >= 0, 1.0, -1.0)
            t = sgn / (zeta.abs() + torch.sqrt(1.0 + zeta * zeta))
            c = torch.where(tiny, 1.0, 1.0 / torch.sqrt(1.0 + t * t))
            s = torch.where(tiny, 0.0, c * t)
            J = eye.clone()
            J[p, p], J[q, q], J[p, q], J[q, p] = c, c, s, -s
            A, V = A @ J, V @ J
    sv = torch.linalg.vector_norm(A, dim=0)
    order = torch.argsort(sv, descending=True)
    A, V, sv = A[:, order], V[:, order], sv[order]
    u1 = A[:, 0] / torch.clamp(sv[0], min=1e-300)
    u2 = A[:, 1] / torch.clamp(sv[1], min=1e-300)
    U = torch.stack([u1, u2, torch.linalg.cross(u1, u2)], 1)
    d = torch.sign(_det3(V))
    D = torch.diag(torch.stack([torch.ones_like(d), torch.ones_like(d), d]))
    return (V @ D @ U.T).to(H.dtype)


def _rotation_from_matched(src_d, tgt_d, w, refine_roll_pitch: bool):
    """Weighted Kabsch on demeaned points (icp.cc:20-75); yaw only (about
    +z) unless ``refine_roll_pitch``."""
    if refine_roll_pitch:
        return _kabsch((src_d * w[:, None]).T @ tgt_d)
    sxy, txy = src_d[:, :2], tgt_d[:, :2]
    a = torch.sum(w * (sxy[:, 0] * txy[:, 1] - sxy[:, 1] * txy[:, 0]))
    b = torch.sum(w * (sxy[:, 0] * txy[:, 0] + sxy[:, 1] * txy[:, 1]))
    yaw = torch.atan2(a, b)
    c, s = torch.cos(yaw), torch.sin(yaw)
    z, o = torch.zeros_like(c), torch.ones_like(c)
    return torch.stack([torch.stack([c, -s, z]), torch.stack([s, c, z]),
                        torch.stack([z, z, o])])


def _match_batch(layer, pts_sensor, R, t, max_psl: int,
                 min_grad_mag: float = 0.1):
    """matchPoints (icp.cc:103-150): nearest-voxel distance and central
    gradient, the distance corrected to the query point; the information
    vector (addNormalizedPointInfo, icp.cc:78-100)."""
    p = pts_sensor @ R.T + t
    d_nn, valid_d = interp.nearest(layer, p, max_psl=max_psl)
    g, valid_g = interp.gradient_central(layer, p, max_psl=max_psl)
    gnorm2 = torch.sum(g * g, dim=-1)
    ok = valid_d & valid_g & (gnorm2 > min_grad_mag)
    ghat = g / torch.sqrt(torch.clamp(gnorm2, min=1e-12))[:, None]
    center = grid.grid_index_to_center_point(
        grid.point_to_grid_index(p, 1.0 / layer.voxel_size), layer.voxel_size)
    dist = d_nn + torch.sum(ghat * (p - center), dim=-1)
    tgt = p - dist[:, None] * ghat
    rel = p - t
    nn = ghat * ghat
    okf = ok[:, None]
    info_t = 2.0 * torch.sum(torch.where(okf, nn, 0.0), dim=0)
    rr = rel * rel
    terms = torch.stack([rr[:, 1] * nn[:, 2] + rr[:, 2] * nn[:, 1],
                         rr[:, 0] * nn[:, 2] + rr[:, 2] * nn[:, 0],
                         rr[:, 0] * nn[:, 1] + rr[:, 1] * nn[:, 0]], -1)
    info_r = 2.0 * torch.sum(torch.where(okf, terms, 0.0), dim=0)
    info = torch.cat([info_t, info_r]) + grid.FLOAT_EPS
    return p, tgt, ok, info


def run_icp(layer, points_C, T_G_C_init, cfg: IcpConfig = IcpConfig(),
            perm=None) -> IcpResult:
    """Refine T_G_C (a (R, t) pair or a 4x4) against a TSDF layer from the
    points ``points_C`` f32[N,3] (padding rows drop out by the field's
    validity). ``perm``: the batch order (default ``default_perm``).
    The initial prior information is the config's initial weightings
    (icp.cc:232-239)."""
    if isinstance(T_G_C_init, tuple):
        R, t = T_G_C_init
    else:
        R, t = T_G_C_init[:3, :3], T_G_C_init[:3, 3]
    if perm is None:
        perm = default_perm(points_C.shape[0], points_C.device)
    pts = points_C[perm.to(points_C.device)]
    max_psl = _runtime.host_int(layer.table.max_psl)
    return icp_steps(layer, pts, R, t, cfg, max_psl)


def icp_steps(layer, pts, R, t, cfg: IcpConfig, max_psl: int) -> IcpResult:
    """The mini-batch loop of ``run_icp`` over points already in batch
    order, given the table's probe bound: no host read."""
    dev = pts.device
    bs = cfg.mini_batch_size
    n_batches = max(1, int(pts.shape[0] * cfg.subsample_keep_ratio) // bs)
    base_info = _runtime.const(
        [cfg.inital_translation_weighting] * 3
        + [cfg.inital_rotation_weighting] * 3, torch.float32, dev)
    need = max(3.0, bs * cfg.min_match_ratio)
    n_upd = torch.zeros((), dtype=torch.int32, device=dev)
    for b in range(n_batches):
        src, tgt, ok, est_info = _match_batch(layer, pts[b * bs:(b + 1) * bs],
                                              R, t, max_psl)
        w = ok.to(torch.float32)
        n_ok = torch.sum(w)
        enough = n_ok >= need
        wsum = torch.clamp(n_ok, min=1.0)
        src_c = torch.sum(src * w[:, None], 0) / wsum
        tgt_c = torch.sum(tgt * w[:, None], 0) / wsum
        okf = ok[:, None]
        src_d = torch.where(okf, src - src_c, 0.0)
        tgt_d = torch.where(okf, tgt - tgt_c, 0.0)
        dR = _rotation_from_matched(src_d, tgt_d, w, cfg.refine_roll_pitch)
        dt = tgt_c - dR @ src_c
        # The delta in the current sensor frame (icp.cc:199-203).
        cur = (R, t)
        delta = lie.compose(lie.inverse(cur), lie.compose((dR, dt), cur))
        xi = lie.se3_log(*delta)
        weight = est_info / (base_info + est_info)
        R_new, t_new = lie.compose(cur, lie.se3_exp(weight * xi))
        R = torch.where(enough, R_new, R)
        t = torch.where(enough, t_new, t)
        base_info = torch.where(enough, base_info + est_info, base_info)
        n_upd = n_upd + enough.to(torch.int32)
    return IcpResult(R=R, t=t, num_updates=n_upd)
