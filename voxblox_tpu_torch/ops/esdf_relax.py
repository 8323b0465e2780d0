"""K1: ESDF 26-neighbour relaxation on padded blocks — the CUDA kernel
(csrc/esdf_relax.cu), its wrapper and its plain PyTorch version.

Port of voxblox_tpu/ops/pallas/esdf_relax.py ``_relax_kernel`` (unit
strides). The TPU kernel's 2D lane layout ([B*18, 384] rows with lane
rolls) is not carried over: the port works on padded cubes
``[N, 18, 18, 18]`` ([z, y, x], the 1-voxel ring holds the neighbours'
halo) with bool ``obs``/``upd`` masks and a bool ``active[N]`` gate.

``relax`` is the entry point the sweep calls: on a CUDA tensor it
launches the kernel (building it with nvcc into ``voxblox_tpu_torch/
_build/`` at first use) and counts the launch in ``LAUNCHES``; on a CPU
tensor it runs ``relax_plain``; anything else raises. There is no
fallback from one to the other. The strided schedule (K2) is not ported
and raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

P = 18  # padded block side
BIG = 1e9  # validity sentinel (exact in f32), as in the TPU kernel
# Operations one sweep of one block needs (derivation in the note of
# csrc/esdf_relax.cu), used for the bound: packing each padded voxel once
# as a source, four running extrema per interior voxel and neighbour, and
# the per-voxel group finish.
OPS_PACK = 10
OPS_NEIGHBOUR = 4
OPS_FINISH = 49
OPS_PER_BLOCK_SWEEP = (P ** 3 * OPS_PACK
                       + (P - 2) ** 3 * (26 * OPS_NEIGHBOUR + OPS_FINISH))

LAUNCHES = 0  # kernel launches through ``relax``

_PKG = Path(__file__).resolve().parents[1]
_SRC = _PKG / "csrc" / "esdf_relax.cu"
_BUILD_DIR = _PKG / "_build"
_LIB = None
BUILD_INFO: dict = {}

# Offsets grouped by step length in voxels, rounded to 6 decimals exactly
# as the TPU kernel groups them (faces, edges, corners).
_OFFSETS = [(dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1)
            for dz in (-1, 0, 1) if (dx, dy, dz) != (0, 0, 0)]
_GROUPS: dict = {}
for _o in _OFFSETS:
    _GROUPS.setdefault(round(float(np.linalg.norm(_o)), 6), []).append(_o)
_GROUPS = dict(sorted(_GROUPS.items()))


def step_constants(voxel_size: float):
    """The three f32 step lengths, built like the TPU kernel's
    ``np.float32(round(norm, 6) * voxel_size * k)`` (in float64, then
    cast). Both the plain version and the kernel use these values, and
    ``2 * step`` is exact in f32, so the flip thresholds round alike."""
    return [float(np.float32(dist * voxel_size * 1)) for dist in _GROUPS]


def relax_plain(d, obs, upd, active, inner_sweeps: int, voxel_size: float,
                max_distance: float, min_diff: float):
    """Plain PyTorch version of K1, a straight transcription of the TPU
    kernel's arithmetic: 26 shifted slices, per-group extrema, flip caps
    applied largest step first. Returns the updated copy of ``d``."""
    steps = step_constants(voxel_size)
    v = P - 2
    out = d.clone()
    cur = d
    upd_c = upd[:, 1:-1, 1:-1, 1:-1]
    for _ in range(inner_sweeps):
        src = obs & (cur.abs() < max_distance)
        pos = cur > 0.0
        dp = torch.where(src & pos, cur, BIG)
        dn = torch.where(src & ~pos, cur, -BIG)
        c = cur[:, 1:-1, 1:-1, 1:-1]
        pc = c > 0.0
        best_pos = torch.full_like(c, BIG)
        best_neg = torch.full_like(c, -BIG)
        trips = []
        for step, offs in zip(steps, _GROUPS.values()):
            gp = torch.full_like(c, BIG)
            gn = torch.full_like(c, -BIG)
            tvn = torch.full_like(c, BIG)
            tvp = torch.full_like(c, -BIG)
            for dx, dy, dz in offs:
                sl = (slice(None), slice(1 + dz, 1 + dz + v),
                      slice(1 + dy, 1 + dy + v), slice(1 + dx, 1 + dx + v))
                ndp, ndn = dp[sl], dn[sl]
                gp = torch.minimum(gp, ndp)
                gn = torch.maximum(gn, ndn)
                tvn = torch.minimum(tvn, torch.where(ndn > -BIG / 2, ndn, BIG))
                tvp = torch.maximum(tvp, torch.where(ndp < BIG / 2, ndp, -BIG))
            best_pos = torch.minimum(best_pos, gp + step)
            best_neg = torch.maximum(best_neg, gn - step)
            trips.append((step, ((tvn < c - 2 * step) & pc)
                          | ((tvp > c + 2 * step) & ~pc)))
        cand = torch.where(pc, torch.minimum(c, best_pos),
                           torch.maximum(c, best_neg))
        sgn = torch.where(pc, 1.0, -1.0)
        for step, trip in reversed(trips):
            cand = torch.where(trip & (cand.abs() > step), sgn * step, cand)
        improved = (cand - c).abs() > min_diff
        nxt = cur.clone()
        nxt[:, 1:-1, 1:-1, 1:-1] = torch.where(upd_c & improved, cand, c)
        cur = nxt
    act = active.view(-1, 1, 1, 1)
    out.copy_(torch.where(act, cur, d))
    return out


# ---------------------------------------------------------------------------
# Build and bind (nvcc -> shared library -> ctypes)
# ---------------------------------------------------------------------------


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return os.path.join(home, "bin", "nvcc")


def build() -> Path:
    """Compile csrc/esdf_relax.cu for sm_90a into _build/ (keyed by the
    source hash; reused when present). Records the command, seconds and
    ptxas report in ``BUILD_INFO``."""
    src = _SRC.read_bytes()
    tag = hashlib.sha1(src).hexdigest()[:12]
    out = _BUILD_DIR / f"libesdf_relax_{tag}.so"
    if out.exists():
        return out
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
           "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
           "-o", str(tmp), str(_SRC)]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    os.replace(tmp, out)
    BUILD_INFO.update(cmd=" ".join(cmd), seconds=time.perf_counter() - t0,
                      ptxas=res.stderr.strip())
    return out


def _lib():
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        fn = lib.esdf_relax_k1
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [
            ctypes.c_float] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _check(d, obs, upd, active):
    n = d.shape[0]
    if d.dim() != 4 or tuple(d.shape[1:]) != (P, P, P):
        raise ValueError(f"d must be [N, {P}, {P}, {P}], got {tuple(d.shape)}")
    if d.dtype != torch.float32:
        raise TypeError(f"d must be float32, got {d.dtype}")
    for name, m in (("obs", obs), ("upd", upd)):
        if m.shape != d.shape or m.dtype != torch.bool:
            raise TypeError(f"{name} must be bool {tuple(d.shape)}")
    if active.shape != (n,) or active.dtype != torch.bool:
        raise TypeError(f"active must be bool [{n}]")
    for name, x in (("d", d), ("obs", obs), ("upd", upd),
                    ("active", active)):
        if x.device != d.device:
            raise ValueError(f"{name} is on {x.device}, d on {d.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def relax(d, obs, upd, active, inner_sweeps: int, voxel_size: float,
          max_distance: float, min_diff: float, strides=None):
    """``inner_sweeps`` relaxations of padded blocks; returns the updated
    copy of ``d`` (only interior voxels of active blocks change)."""
    global LAUNCHES
    if strides is not None and any(int(k) != 1 for k in strides):
        raise NotImplementedError(
            "the strided relaxation schedule (K2) is not ported")
    _check(d, obs, upd, active)
    if d.device.type == "cpu":
        return relax_plain(d, obs, upd, active, inner_sweeps, voxel_size,
                           max_distance, min_diff)
    if d.device.type != "cuda":
        raise ValueError(f"relax runs on cuda or cpu, not {d.device}")
    s1, s2, s3 = step_constants(voxel_size)
    out = d.clone()
    with torch.cuda.device(d.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().esdf_relax_k1(
            out.data_ptr(), obs.data_ptr(), upd.data_ptr(),
            active.data_ptr(), d.shape[0], int(inner_sweeps), s1, s2, s3,
            float(max_distance), float(min_diff), stream)
    if err != 0:
        raise RuntimeError(f"esdf_relax_k1 launch failed: cudaError {err}")
    LAUNCHES += 1
    return out
