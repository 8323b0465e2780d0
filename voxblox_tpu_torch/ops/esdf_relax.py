"""K1 and K2: ESDF 26-neighbour relaxation on padded blocks — the CUDA
kernels (csrc/esdf_relax.cu), their wrapper and their plain PyTorch
version.

Port of voxblox_tpu/ops/pallas/esdf_relax.py ``_relax_kernel``: K1 is the
unit-stride schedule, K2 a schedule with any stride k > 1 (one relaxation
per entry of ``strides``; a stride-k sweep reads the neighbour k voxels
away at cost ``k * step``, gated per voxel by admissibility codes). The
TPU kernel's 2D lane layout ([B*18, 384] rows with lane rolls) is not
carried over: the port works on padded cubes ``[N, 18, 18, 18]``
([z, y, x], the 1-voxel ring holds the neighbours' halo) with bool
``obs``/``upd`` masks, a bool ``active[N]`` gate and, for K2, two uint8
code cubes ``(code_pos, code_neg)`` holding levels 0..3.

``relax`` is the entry point the sweep calls: on a CUDA tensor it
launches a kernel (building it with nvcc into ``voxblox_tpu_torch/
_build/`` at first use) and counts the launch in ``LAUNCHES`` (and in
``STRIDED_LAUNCHES`` when the schedule has a stride > 1); on a CPU tensor
it runs ``relax_plain``; anything else raises. There is no fallback from
one to the other. The kernels read ``d`` and write every voxel of a fresh
output tensor (skipped blocks are copied through on the card), so the
wrapper makes no copy of its own.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np
import torch

from . import _nvcc

P = 18  # padded block side
BIG = 1e9  # validity sentinel (exact in f32), as in the TPU kernel
MAX_SCHEDULE = 16  # entries the kernel's schedule argument holds

LAUNCHES = 0  # kernel launches through ``relax`` (K1 and K2)
STRIDED_LAUNCHES = 0  # of these, launches of K2 (a stride > 1)

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


def step_constants(voxel_size: float, k: int = 1):
    """The three f32 step lengths of a stride-``k`` sweep, built like the
    TPU kernel's ``np.float32(round(norm, 6) * voxel_size * k)`` (in
    float64, then cast). Both the plain version and the kernels use these
    values, and ``2 * step`` is exact in f32, so the flip thresholds
    round alike."""
    return [float(np.float32(dist * voxel_size * k)) for dist in _GROUPS]


def stride_radii(strides) -> tuple:
    """Erosion radii the admissibility codes must capture, in level
    order: level i+1 belongs to the i-th distinct stride > 1 (ascending),
    whose jumps need a traversable Chebyshev ball of radius k - 1."""
    return tuple(k - 1 for k in sorted({int(k) for k in strides if k > 1}))


def _levels(strides) -> dict:
    """stride k > 1 -> code level (1 for the smallest such stride)."""
    return {k: i + 1 for i, k in enumerate(
        sorted({int(k) for k in strides if k > 1}))}


def _schedule(inner_sweeps: int, strides):
    """The relaxations one launch runs: ``strides`` when given (then
    ``inner_sweeps`` is ignored), else ``inner_sweeps`` unit sweeps."""
    return tuple(int(k) for k in strides) if strides else (1,) * inner_sweeps


def relax_plain(d, obs, upd, active, inner_sweeps: int, voxel_size: float,
                max_distance: float, min_diff: float, strides=None,
                codes=None):
    """Plain PyTorch version of K1 and K2, a straight transcription of
    the TPU kernel's arithmetic: 26 shifted slices, per-group extrema,
    and at stride 1 the flip caps applied largest step first. A stride-k
    sweep (k > 1) reads the source k voxels away inside the same padded
    cube, only where the centre's code for that sign reaches the stride's
    level and the candidate stays inside the max-distance window, and has
    no flip rule. Returns the updated copy of ``d``."""
    schedule = _schedule(inner_sweeps, strides)
    levels = _levels(schedule)
    if levels and codes is None:
        raise ValueError("strided schedules require codes (code_pos, "
                         "code_neg); see stride_radii")
    v = P - 2
    out = d.clone()
    cur = d
    upd_c = upd[:, 1:-1, 1:-1, 1:-1]
    if levels:
        code_pos = codes[0][:, 1:-1, 1:-1, 1:-1]
        code_neg = codes[1][:, 1:-1, 1:-1, 1:-1]
    for k in schedule:
        steps = step_constants(voxel_size, k)
        flips = k == 1
        src = obs & (cur.abs() < max_distance)
        pos = cur > 0.0
        dp = torch.where(src & pos, cur, BIG)
        dn = torch.where(src & ~pos, cur, -BIG)
        if k > 1:
            # Sources outside the padded cube read as invalid: pad by
            # k - 1 so every shifted slice below stays inside the tensor.
            gate_pos = code_pos >= levels[k]
            gate_neg = code_neg >= levels[k]
            w = (k - 1,) * 6
            dp = torch.nn.functional.pad(dp, w, value=BIG)
            dn = torch.nn.functional.pad(dn, w, value=-BIG)
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
                sl = (slice(None), slice(k + k * dz, k + k * dz + v),
                      slice(k + k * dy, k + k * dy + v),
                      slice(k + k * dx, k + k * dx + v))
                ndp, ndn = dp[sl], dn[sl]
                if k > 1:
                    ndp = torch.where(
                        gate_pos & (ndp + step < max_distance), ndp, BIG)
                    ndn = torch.where(
                        gate_neg & (ndn - step > -max_distance), ndn, -BIG)
                gp = torch.minimum(gp, ndp)
                gn = torch.maximum(gn, ndn)
                if flips:
                    tvn = torch.minimum(
                        tvn, torch.where(ndn > -BIG / 2, ndn, BIG))
                    tvp = torch.maximum(
                        tvp, torch.where(ndp < BIG / 2, ndp, -BIG))
            best_pos = torch.minimum(best_pos, gp + step)
            best_neg = torch.maximum(best_neg, gn - step)
            if flips:
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


def build() -> Path:
    """Compile csrc/esdf_relax.cu for sm_90a into _build/ (keyed by the
    source hash; reused when present). Records the command, seconds and
    ptxas report in ``BUILD_INFO``."""
    return _nvcc.build("esdf_relax", info=BUILD_INFO)


def _lib():
    """The built library, bound. At first use both kernels are allowed the
    tile's dynamic shared memory (93,312 B, above the 48 KB a kernel gets
    unasked); a card that refuses raises here, once."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        fn = lib.esdf_relax_k1
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 + [
            ctypes.c_float] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fn = lib.esdf_relax_k2
        fn.argtypes = [ctypes.c_void_p] * 7 + [
            ctypes.c_int, ctypes.POINTER(_Schedule), ctypes.c_float,
            ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.esdf_relax_init.argtypes = []
        lib.esdf_relax_init.restype = ctypes.c_int
        lib.esdf_relax_ctas_per_sm.argtypes = [ctypes.c_int]
        lib.esdf_relax_ctas_per_sm.restype = ctypes.c_int
        err = lib.esdf_relax_init()
        if err != 0:
            raise RuntimeError(
                "esdf_relax: the card refused the kernels' dynamic shared "
                f"memory (cudaFuncSetAttribute: cudaError {err})")
        _LIB = lib
    return _LIB


def ctas_per_sm(strided: bool) -> int:
    """CTAs of K1 (or K2, ``strided``) that fit on an SM of the current
    card (the CUDA occupancy calculator's answer; for the records)."""
    return int(_lib().esdf_relax_ctas_per_sm(int(strided)))


class _Schedule(ctypes.Structure):
    """The kernel's schedule argument (struct Schedule in the .cu file):
    per relaxation its stride, its code level (0 at stride 1) and its
    three step lengths."""
    _fields_ = [("n", ctypes.c_int),
                ("stride", ctypes.c_int * MAX_SCHEDULE),
                ("level", ctypes.c_int * MAX_SCHEDULE),
                ("step", (ctypes.c_float * 3) * MAX_SCHEDULE)]


def _schedule_arg(schedule, voxel_size: float) -> _Schedule:
    if len(schedule) > MAX_SCHEDULE:
        raise ValueError(f"a schedule holds at most {MAX_SCHEDULE} "
                         f"relaxations, got {len(schedule)}")
    levels = _levels(schedule)
    if len(levels) > 3:
        raise ValueError("at most 3 distinct strides > 1 (code levels 1..3)")
    arg = _Schedule()
    arg.n = len(schedule)
    for i, k in enumerate(schedule):
        if k < 1 or k > P - 2:
            raise ValueError(f"stride {k} outside [1, {P - 2}]")
        arg.stride[i] = k
        arg.level[i] = levels.get(k, 0)
        for g, s in enumerate(step_constants(voxel_size, k)):
            arg.step[i][g] = s
    return arg


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
          max_distance: float, min_diff: float, strides=None, codes=None):
    """One launch of relaxations on padded blocks: ``inner_sweeps`` unit
    sweeps, or one sweep per entry of ``strides`` when given (a schedule
    with a stride > 1 requires ``codes`` = (code_pos, code_neg), uint8
    levels). Returns a new tensor, the updated copy of ``d`` (only interior
    voxels of active blocks change); ``d`` is not written. A unit schedule
    launches K1, any other K2."""
    global LAUNCHES, STRIDED_LAUNCHES
    schedule = _schedule(inner_sweeps, strides)
    strided = any(k > 1 for k in schedule)
    if strided and codes is None:
        raise ValueError("strided schedules require codes (code_pos, "
                         "code_neg); see stride_radii")
    _check(d, obs, upd, active)
    if strided:
        for name, c in zip(("code_pos", "code_neg"), codes):
            if (c.shape != d.shape or c.dtype != torch.uint8
                    or c.device != d.device or not c.is_contiguous()):
                raise TypeError(f"{name} must be contiguous uint8 "
                                f"{tuple(d.shape)} on {d.device}")
    if d.device.type == "cpu":
        return relax_plain(d, obs, upd, active, inner_sweeps, voxel_size,
                           max_distance, min_diff, strides=schedule,
                           codes=codes)
    if d.device.type != "cuda":
        raise ValueError(f"relax runs on cuda or cpu, not {d.device}")
    # The kernel writes every voxel of ``out`` and only reads ``d``.
    out = torch.empty_like(d)
    with torch.cuda.device(d.device):
        stream = torch.cuda.current_stream().cuda_stream
        if strided:
            name = "esdf_relax_k2"
            arg = _schedule_arg(schedule, voxel_size)
            err = _lib().esdf_relax_k2(
                d.data_ptr(), obs.data_ptr(), upd.data_ptr(),
                codes[0].data_ptr(), codes[1].data_ptr(), active.data_ptr(),
                out.data_ptr(), d.shape[0], ctypes.byref(arg),
                float(max_distance), float(min_diff), stream)
        else:
            name = "esdf_relax_k1"
            s1, s2, s3 = step_constants(voxel_size)
            err = _lib().esdf_relax_k1(
                d.data_ptr(), obs.data_ptr(), upd.data_ptr(),
                active.data_ptr(), out.data_ptr(), d.shape[0],
                len(schedule), s1, s2, s3, float(max_distance),
                float(min_diff), stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    LAUNCHES += 1
    if strided:
        STRIDED_LAUNCHES += 1
    return out
