"""The block-walk-and-probe kernel of TSDF allocation (csrc/tsdf_alloc.cu)
and its wrapper.

One launch a round walks every valid ray's blocks, looks up each block
and its six face neighbours in the hash table and, for the ones with no
key, scatter-maxes their lane ids into the pending buffer and sets a
flag, all in one thread per ray. When the host finds the flag set, a
second launch recovers the winners' keys by re-walking their rays. Its
plain version is the chain ``ops/tsdf._allocate_chain`` runs on CPU
tensors (``raycast.cast_rays`` of the block-scaled segments -> the
[7, steps, rays] dilation -> ``core/layer.allocate_blocks``' lookup and
``pending_winners``); ``find_missing`` and ``pending_keys`` take CUDA
tensors only and raise on anything else. There is no fallback from one
to the other.

The per-ray inputs are the chain's own per-ray set-up:
``raycast.dda_start`` of ``raycast.block_segments``, their block step
counts and the lanes' validity. ``make_params`` packs them, checked, into
the kernel's argument structure; the CPU tests hand the same structure to
the kernel's source compiled for the CPU (csrc/tsdf_alloc_emulate.cpp),
whose entry points have the library's names.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import _nvcc

LAUNCHES = 0  # find passes launched through ``find_missing``
KEY_LAUNCHES = 0  # key recoveries launched through ``pending_keys``
BUILD_INFO: dict = {}
_LIB = None

# counts[k] of the source, in order.
COUNTERS = ("integrate.alloc_candidates", "integrate.alloc_probed",
            "integrate.alloc_missing", "hash.probes")

_POINTERS = ("start", "step", "t_next", "t_step", "num_steps", "valid",
             "keys_w0", "keys_w1", "slot", "max_psl", "win", "pend_w0",
             "pend_w1", "pend_ok", "counts")
_INTS = ("n_rays", "block_steps", "cap_mask", "pending_size")


class AllocParams(ctypes.Structure):
    """struct AllocParams of csrc/tsdf_alloc.cu, field for field."""
    _fields_ = ([(n, ctypes.c_void_p) for n in _POINTERS]
                + [(n, ctypes.c_int32) for n in _INTS])


class Found(NamedTuple):
    """One find pass: its arguments, the tensors they point into, the
    pending buffer and the flag."""
    params: AllocParams
    keep: dict
    win: torch.Tensor  # int64[pending_size]: largest missing lane id, or -1
    flag: torch.Tensor  # int64[]: 1 when a candidate was missing, else -1


def build():
    """Compile csrc/tsdf_alloc.cu into _build/; the command, seconds and
    ptxas report of a build that ran go to ``BUILD_INFO``."""
    return _nvcc.build("tsdf_alloc", info=BUILD_INFO)


def bind(lib):
    """Declare the entry points' types on a loaded library (the CUDA build
    or the CPU emulation) and check its structure's size against ours."""
    for name in ("tsdf_alloc_find", "tsdf_alloc_keys"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.POINTER(AllocParams), ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.tsdf_alloc_params_size.argtypes = []
    lib.tsdf_alloc_params_size.restype = ctypes.c_int
    size = lib.tsdf_alloc_params_size()
    if size != ctypes.sizeof(AllocParams):
        raise RuntimeError(f"tsdf_alloc: AllocParams is {size} bytes in the "
                           f"library, {ctypes.sizeof(AllocParams)} here")
    return lib


def _lib():
    global _LIB
    if _LIB is None:
        _LIB = bind(ctypes.CDLL(str(build())))
    return _LIB


def _checked(name, x, dtype, shape, device):
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name} must be a tensor")
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, the table on {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} must be {tuple(shape)}, got "
                         f"{tuple(x.shape)}")
    return x.contiguous()


def make_params(table, dda, num_steps, valid, block_steps: int,
                pending_size: int, counts=None):
    """The kernel's arguments for one round, checked: every tensor on the
    table's device with the dtype and shape the kernel reads. ``dda`` is
    ``raycast.dda_start`` of the block-scaled segments, ``num_steps``
    their block step counts; ``counts`` None or int64[4] that the kernel
    adds ``COUNTERS`` to. Returns (params, the tensors the params point
    into: the pending buffer ``win`` [pending_size + 1], filled with -1,
    and the key outputs ``pend_w0``, ``pend_w1``, ``pend_ok``)."""
    dev = table.keys_w0.device
    r = num_steps.shape[0]
    if r >= 2 ** 31:
        raise ValueError("tsdf_alloc takes fewer than 2^31 rays")
    if block_steps < 1:
        raise ValueError(f"block_steps must be positive, got {block_steps}")
    if pending_size < 1 or pending_size & (pending_size - 1) \
            or pending_size >= 2 ** 31:
        raise ValueError(f"pending_size must be a power of two below 2^31, "
                         f"got {pending_size}")
    f32, i32 = torch.float32, torch.int32
    cap = table.capacity
    t = dict(start=(dda.voxel, i32, (r, 3)), step=(dda.step, i32, (r, 3)),
             t_next=(dda.t_next, f32, (r, 3)),
             t_step=(dda.t_step, f32, (r, 3)),
             num_steps=(num_steps, i32, (r,)),
             valid=(valid, torch.bool, (r,)),
             keys_w0=(table.keys_w0, i32, (cap,)),
             keys_w1=(table.keys_w1, i32, (cap,)),
             slot=(table.slot, i32, (cap,)),
             max_psl=(table.max_psl, i32, ()))
    if counts is not None:
        t["counts"] = (counts, torch.int64, (len(COUNTERS),))
    keep = {k: _checked(k, *v, dev) for k, v in t.items()}
    keep.update(
        win=torch.full((pending_size + 1,), -1, dtype=torch.int64,
                       device=dev),
        pend_w0=torch.empty(pending_size, dtype=i32, device=dev),
        pend_w1=torch.empty(pending_size, dtype=i32, device=dev),
        pend_ok=torch.empty(pending_size, dtype=torch.bool, device=dev))
    p = AllocParams()
    for k, x in keep.items():
        setattr(p, k, x.data_ptr())
    p.n_rays, p.block_steps = r, block_steps
    p.cap_mask, p.pending_size = cap - 1, pending_size
    return p, keep


def _launch(name: str, p: AllocParams, dev: torch.device):
    if dev.type != "cuda":
        raise ValueError(f"tsdf_alloc runs on a CUDA device, not {dev}; its "
                         "plain version is ops/tsdf's chain")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(_lib(), name)(ctypes.byref(p), stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")


def find_missing(table, dda, num_steps, valid, block_steps: int,
                 pending_size: int, counts=None) -> Found:
    """One launch of the find pass over every lane: the pending buffer
    (as ``core/layer.pending_winners`` builds it from the dilated
    candidates) and the flag. Arguments as ``make_params`` takes them, all
    on the table's CUDA device."""
    global LAUNCHES
    p, keep = make_params(table, dda, num_steps, valid, block_steps,
                          pending_size, counts)
    _launch("tsdf_alloc_find", p, keep["win"].device)
    LAUNCHES += 1
    win = keep["win"]
    return Found(p, keep, win[:pending_size], win[pending_size])


def pending_keys(found: Found):
    """One launch: the key words of each pending cell's winner (w0, w1
    int32[pending_size], ok bool), as ``core/layer.allocate_blocks``
    gathers them; (0, empty) and not ok where a cell took no lane."""
    global KEY_LAUNCHES
    k = found.keep
    _launch("tsdf_alloc_keys", found.params, k["win"].device)
    KEY_LAUNCHES += 1
    return k["pend_w0"], k["pend_w1"], k["pend_ok"]
