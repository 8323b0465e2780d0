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
