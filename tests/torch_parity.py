"""Helpers for the port's parity tests: carry state between the JAX
package (the reference) and voxblox_tpu_torch through numpy.

This is a test helper, not part of either package, so it may import
both. JAX stays on the CPU (tests/conftest.py) and the port runs with
``device="cpu"``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

# The suite runs under several xdist workers on a few cores; torch's
# default of one intra-op thread per core in every worker oversubscribes
# the machine (measured: 3-10x slower port tests at -n 6).
torch.set_num_threads(1)

@pytest.fixture
def cuda_device():
    """A CUDA device, or skip: K1 is a CUDA kernel with no CPU mode, so
    its kernel-against-plain tests run only on a card (``-m cuda``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


TABLE_FIELDS = ("keys_w0", "keys_w1", "slot", "max_psl", "count")


def jax_layer_to_numpy(layer) -> dict:
    """A JAX ``VoxelLayer`` -> the dict ``voxblox_tpu_torch.core.layer.
    layer_from_numpy`` takes."""
    d = {f"channel/{k}": np.asarray(v) for k, v in layer.channels.items()}
    d.update({f"table/{k}": np.asarray(getattr(layer.table, k))
              for k in TABLE_FIELDS})
    d["block_ijk"] = np.asarray(layer.block_ijk)
    d["block_flags"] = np.asarray(layer.block_flags)
    d["num_blocks"] = np.asarray(layer.num_blocks)
    d["voxel_size"] = layer.voxel_size
    d["vps"] = layer.vps
    d["layer_type"] = layer.layer_type
    return d


def torch_layer_to_numpy(layer) -> dict:
    from voxblox_tpu_torch.core import layer as tl

    return tl.layer_to_numpy(layer)


def config_to_dict(cfg) -> dict:
    return dataclasses.asdict(cfg)


def assert_layers_equal(ref: dict, got: dict, atol: float = 0.0,
                        channels=None, rtol: float = 0.0):
    """Same rows, block indices, flags and table; channel values within
    ``atol``/``rtol`` (exact when both are 0)."""
    np.testing.assert_array_equal(got["num_blocks"], ref["num_blocks"])
    np.testing.assert_array_equal(got["block_ijk"], ref["block_ijk"])
    np.testing.assert_array_equal(got["block_flags"], ref["block_flags"])
    for k in TABLE_FIELDS:
        np.testing.assert_array_equal(got[f"table/{k}"], ref[f"table/{k}"],
                                      err_msg=k)
    names = channels or [k.split("/", 1)[1] for k in ref
                         if k.startswith("channel/")]
    for name in names:
        a, b = ref[f"channel/{name}"], got[f"channel/{name}"]
        if atol == 0.0 and rtol == 0.0:
            np.testing.assert_array_equal(b, a, err_msg=name)
        else:
            np.testing.assert_allclose(b, a, atol=atol, rtol=rtol,
                                       err_msg=name)


# ---------------------------------------------------------------------------
# The CUDA relaxation kernels' source, run on the CPU
# ---------------------------------------------------------------------------

_EMULATION = {}


def relax_emulation():
    """The ctypes function ``esdf_relax_emulate`` of the port's
    csrc/esdf_relax_emulate.cpp (the kernels' device functions compiled as
    plain C++ and run thread by thread), built with g++ into a temporary
    directory once per process; skips where there is no g++."""
    import ctypes
    import shutil
    import subprocess
    import tempfile
    from pathlib import Path

    from voxblox_tpu_torch.ops import esdf_relax as trelax

    if "fn" not in _EMULATION:
        gxx = shutil.which("g++")
        if gxx is None:
            pytest.skip("needs g++ to compile the kernels' source for the CPU")
        src = Path(trelax.__file__).resolve().parents[1] / "csrc"
        out = Path(tempfile.mkdtemp(prefix="esdf_relax_emulate_")) / "lib.so"
        subprocess.run(
            [gxx, "-std=c++17", "-O1", "-ffp-contract=off", "-shared",
             "-fPIC", "-o", str(out), str(src / "esdf_relax_emulate.cpp")],
            check=True, capture_output=True, text=True)
        fn = ctypes.CDLL(str(out)).esdf_relax_emulate
        fn.argtypes = [ctypes.c_void_p] * 7 + [
            ctypes.c_int, ctypes.POINTER(trelax._Schedule), ctypes.c_int,
            ctypes.c_float, ctypes.c_float]
        fn.restype = ctypes.c_int
        _EMULATION["fn"] = fn
    return _EMULATION["fn"]


def relax_emulated(d, obs, upd, active, inner_sweeps, voxel_size,
                   max_distance, min_diff, strides=None, codes=None):
    """``relax`` through the emulated kernels: the arguments of
    ``voxblox_tpu_torch.ops.esdf_relax.relax`` (CPU tensors)."""
    from voxblox_tpu_torch.ops import esdf_relax as trelax

    fn = relax_emulation()
    schedule = trelax._schedule(inner_sweeps, strides)
    strided = any(k > 1 for k in schedule)
    if strided:
        arg = trelax._schedule_arg(schedule, voxel_size)
    else:  # what the K1 entry point builds: n sweeps with step[0]
        arg = trelax._Schedule()
        arg.n = len(schedule)
        for g, s in enumerate(trelax.step_constants(voxel_size)):
            arg.step[0][g] = s
    d = d.contiguous()
    out = torch.full_like(d, float("nan"))  # every voxel must be written
    u8 = [x.contiguous().view(torch.uint8) for x in (obs, upd, active)]
    cp, cn = (codes if strided else (None, None))
    import ctypes

    rc = fn(d.data_ptr(), u8[0].data_ptr(), u8[1].data_ptr(),
            cp.data_ptr() if strided else None,
            cn.data_ptr() if strided else None, u8[2].data_ptr(),
            out.data_ptr(), d.shape[0], ctypes.byref(arg), int(strided),
            float(max_distance), float(min_diff))
    assert rc == 0, rc
    return out
