"""The walk-and-accumulate kernel of the simple and merged TSDF
integrators (csrc/tsdf_walk.cu), its wrapper, and the count of the
(step, lane) slots it executes.

One launch a scan walks every valid ray's voxels, weighs each sample,
looks its block up in the hash table once per block entered and adds it
into pool-sized accumulators, all in one thread per ray. Its plain
version is the chain ``ops/tsdf.py`` runs on CPU tensors (``cast_rays``
-> ``_per_sample_contributions`` -> ``global_voxel_to_flat`` ->
``_accumulate_flat``); ``walk_and_accumulate`` takes CUDA tensors only and
raises on anything else. There is no fallback from one to the other.

The per-ray inputs are the plain version's own per-ray set-up:
``raycast.dda_start`` of the ray segments, ``points - origin`` and its
norm, the ray weights and colours, and for anti-grazing the endpoint
stamp table. ``make_params`` packs them, checked, into the kernel's
argument structure; the CPU tests hand the same structure to the kernel's
source compiled for the CPU (csrc/tsdf_walk_emulate.cpp).
"""

from __future__ import annotations

import ctypes

import torch

from ..core import grid
from . import _nvcc

LAUNCHES = 0  # kernel launches through ``walk_and_accumulate``
BUILD_INFO: dict = {}
WARP = 32  # lanes that run in lockstep on the card
FLAGS = ("-fmad=false",)  # no multiply-add the source does not write
_LIB = None

DROPOFF, SPARSITY, COLOR, ANTI_GRAZING = 1, 2, 4, 8  # WALK_* in the source

_POINTERS = ("start", "step", "t_next", "t_step", "num_steps", "valid",
             "origin", "v_po", "dist", "weight", "color", "stamp",
             "endpoint", "clearing", "keys_w0", "keys_w1", "slot", "max_psl",
             "d_w", "d_wd", "d_wcw", "d_wc", "dirty", "counts")
_INTS = ("n_rays", "max_steps", "cap_mask", "max_blocks", "vps_log2",
         "flags")
_FLOATS = ("voxel_size", "trunc", "neg_dropoff", "dropoff_den", "sparsity",
           "eps")


class WalkParams(ctypes.Structure):
    """struct WalkParams of csrc/tsdf_walk.cu, field for field."""
    _fields_ = ([(n, ctypes.c_void_p) for n in _POINTERS]
                + [(n, ctypes.c_int32) for n in _INTS]
                + [(n, ctypes.c_float) for n in _FLOATS])


def walk_lengths(num_steps, valid, max_steps: int):
    """Samples each lane's walk visits: ``min(num_steps, max_steps - 1) +
    1`` where valid, else 0 (int32[R])."""
    return torch.where(valid, torch.clamp(num_steps, max=max_steps - 1) + 1,
                       0)


def warp_slots(lengths):
    """The (step, lane) slots the kernel executes for walks of
    ``lengths``: one thread per lane, and a warp of ``WARP`` consecutive
    lanes steps as long as its longest walk (int64[], on the device)."""
    pad = -lengths.numel() % WARP
    per_warp = torch.nn.functional.pad(lengths, (0, pad)).view(-1, WARP)
    return per_warp.amax(1).sum(dtype=torch.int64) * WARP


def needed_bytes(acc, valid, colors: bool, table_cells: int) -> int:
    """The fewest bytes one launch that returned ``acc`` (as
    ``walk_and_accumulate`` returns it, from zeroed accumulators) has to
    move: each accumulator cell it added to (nonzero), written once; each
    dirty byte it set; every lane's valid flag; the per-ray inputs of the
    valid lanes (start, step, t_next, t_step, v_po, num_steps, dist,
    weight, and with ``colors`` the colour); and ``table_cells`` hash
    table cells (two key words and a slot), each read once. The endpoint
    stamp table of anti-grazing is left out. The zero fill of the
    accumulators is the wrapper's, a launch of its own."""
    d_w, d_wd, d_wc, d_wcw, dirty = acc
    cells = sum(int(torch.count_nonzero(x)) for x in (d_w, d_wd, d_wc, d_wcw))
    ray_bytes = 5 * 12 + 3 * 4 + (12 if colors else 0)
    return (4 * cells + int(torch.count_nonzero(dirty)) + valid.numel()
            + ray_bytes * int(valid.sum()) + 12 * table_cells)


def build():
    """Compile csrc/tsdf_walk.cu (``FLAGS``) into _build/; the command,
    seconds and ptxas report of a build that ran go to ``BUILD_INFO``."""
    return _nvcc.build("tsdf_walk", FLAGS, BUILD_INFO)


def _lib():
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        lib.tsdf_walk.argtypes = [ctypes.POINTER(WalkParams), ctypes.c_void_p]
        lib.tsdf_walk.restype = ctypes.c_int
        lib.tsdf_walk_params_size.argtypes = []
        lib.tsdf_walk_params_size.restype = ctypes.c_int
        size = lib.tsdf_walk_params_size()
        if size != ctypes.sizeof(WalkParams):
            raise RuntimeError(f"tsdf_walk: WalkParams is {size} bytes in "
                               f"the library, {ctypes.sizeof(WalkParams)} "
                               "here")
        _LIB = lib
    return _LIB


def _checked(name, x, dtype, shape, device):
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name} must be a tensor")
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, the layer on {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} must be {tuple(shape)}, got "
                         f"{tuple(x.shape)}")
    return x.contiguous()


def make_params(layer, max_steps: int, cfg, dda, num_steps, valid, origin,
                v_po, dist, weights, colors=None, grazing=None, counts=None):
    """The kernel's arguments for one scan, checked: every tensor on the
    layer's device with the dtype and shape the kernel reads. ``dda`` is
    ``raycast.dda_start`` of the segments; ``colors`` f32[R,3] or None
    (no colour accumulators); ``grazing`` None or (stamp bool[2^20],
    endpoint voxel int32[R,3], clearing bool[R]); ``counts`` None or
    int64[2] that the kernel adds its hash probes and block lookups to.
    Returns (params, the accumulators (d_w, d_wd, d_wc, d_wcw, dirty),
    zeroed, and the tensors the params point into)."""
    dev = layer.device
    r = num_steps.shape[0]
    if r >= 2 ** 31 or max_steps >= 2 ** 31:
        raise ValueError("tsdf_walk takes fewer than 2^31 rays and steps")
    f32, i32 = torch.float32, torch.int32
    t = dict(start=(dda.voxel, i32, (r, 3)), step=(dda.step, i32, (r, 3)),
             t_next=(dda.t_next, f32, (r, 3)),
             t_step=(dda.t_step, f32, (r, 3)),
             num_steps=(num_steps, i32, (r,)),
             valid=(valid, torch.bool, (r,)), origin=(origin, f32, (3,)),
             v_po=(v_po, f32, (r, 3)), dist=(dist, f32, (r,)),
             weight=(weights, f32, (r,)))
    flags = ((DROPOFF if cfg.use_weight_dropoff else 0)
             | (SPARSITY if cfg.use_sparsity_compensation_factor else 0))
    if colors is not None:
        t["color"] = (colors, f32, (r, 3))
        flags |= COLOR
    if grazing is not None:
        stamp, endpoint, clearing = grazing
        t.update(stamp=(stamp, torch.bool, (1 << 20,)),
                 endpoint=(endpoint, i32, (r, 3)),
                 clearing=(clearing, torch.bool, (r,)))
        flags |= ANTI_GRAZING
    table = layer.table
    cap = table.capacity
    t.update(keys_w0=(table.keys_w0, i32, (cap,)),
             keys_w1=(table.keys_w1, i32, (cap,)),
             slot=(table.slot, i32, (cap,)),
             max_psl=(table.max_psl, i32, ()))
    if counts is not None:
        t["counts"] = (counts, torch.int64, (2,))
    keep = {k: _checked(k, *v, dev) for k, v in t.items()}
    n_flat = layer.max_blocks * layer.voxels_per_block
    acc = torch.zeros(6 * n_flat, dtype=f32, device=dev)
    dirty = torch.zeros(layer.max_blocks, dtype=torch.bool, device=dev)
    out = (acc[:n_flat], acc[n_flat:2 * n_flat], acc[3 * n_flat:].view(
        n_flat, 3), acc[2 * n_flat:3 * n_flat], dirty)
    keep.update(d_w=out[0], d_wd=out[1], d_wcw=out[3], d_wc=out[2],
                dirty=dirty)
    p = WalkParams()
    for k, x in keep.items():
        setattr(p, k, x.data_ptr())
    vs = layer.voxel_size
    trunc = cfg.default_truncation_distance
    p.n_rays, p.max_steps, p.cap_mask = r, max_steps, cap - 1
    p.max_blocks, p.vps_log2, p.flags = (layer.max_blocks,
                                         layer.vps.bit_length() - 1, flags)
    # ctypes rounds each to f32 as PyTorch rounds a Python scalar.
    p.voxel_size, p.trunc, p.neg_dropoff = vs, trunc, -vs
    p.dropoff_den = trunc - vs
    p.sparsity = cfg.sparsity_compensation_factor
    p.eps = grid.FLOAT_EPS
    return p, out, keep


def walk_and_accumulate(layer, max_steps: int, cfg, **inputs):
    """One launch: the accumulators (d_w, d_wd, d_wc, d_wcw, dirty) of
    every sample of every valid ray, as ``ops/tsdf._accumulate_flat``
    returns them. ``inputs`` as ``make_params`` takes them, all on the
    layer's CUDA device."""
    global LAUNCHES
    dev = layer.device
    if dev.type != "cuda":
        raise ValueError(f"tsdf_walk runs on a CUDA device, not {dev}; "
                         "its plain version is ops/tsdf's chain")
    p, out, keep = make_params(layer, max_steps, cfg, **inputs)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().tsdf_walk(ctypes.byref(p), stream)
    if err != 0:
        raise RuntimeError(f"tsdf_walk launch failed: cudaError {err}")
    LAUNCHES += 1
    return out
