"""Port parity, K1: the plain PyTorch relaxation (voxblox_tpu_torch.ops.
esdf_relax.relax_plain) against the Pallas kernel run in interpret mode,
at the tolerance tests/test_pallas_kernels.py holds the Pallas kernel to
(atol 1e-6). The CUDA kernel itself is held against the plain version on
the card (marked ``cuda``, skipped without one, and in chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voxblox_tpu.ops.pallas import esdf_relax as jrelax
from voxblox_tpu_torch.ops import esdf_relax as trelax

from torch_parity import cuda_device  # noqa: F401  (fixture)

P = 18


def _fields(rng, b, p_obs=0.8, p_upd=0.7):
    """Random distances of both signs (some beyond max_distance) with
    partial obs/upd masks; upd is 0 on the halo ring."""
    d = rng.uniform(-2.5, 2.5, (b, P, P, P)).astype(np.float32)
    obs = rng.uniform(size=(b, P, P, P)) < p_obs
    upd = np.zeros((b, P, P, P), bool)
    upd[:, 1:-1, 1:-1, 1:-1] = rng.uniform(size=(b, 16, 16, 16)) < p_upd
    return d, obs, upd


@pytest.mark.parametrize("inner_sweeps", [1, 4])
def test_relax_plain_matches_pallas_interpret(rng, inner_sweeps):
    b = 6
    d, obs, upd = _fields(rng, b)
    active = np.array([1, 0, 1, 1, 0, 1], bool)
    voxel, maxd, min_diff = 0.1, 2.0, 0.001
    # block_tile=1 makes the Pallas activity gate per block, as in K1.
    ref2 = jrelax.relax_2d(
        jrelax.to_2d(jnp.asarray(d), 1),
        jrelax.to_2d(jnp.asarray(obs, jnp.float32), 1),
        jrelax.to_2d(jnp.asarray(upd, jnp.float32), 1),
        inner_sweeps, voxel, maxd, min_diff, interpret=True, block_tile=1,
        active=jnp.asarray(active))
    ref = np.asarray(jrelax.from_2d(ref2, b))
    before = trelax.LAUNCHES
    got = trelax.relax(torch.as_tensor(d), torch.as_tensor(obs),
                       torch.as_tensor(upd), torch.as_tensor(active),
                       inner_sweeps, voxel, maxd, min_diff).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)
    # Inactive blocks and the halo ring are untouched.
    np.testing.assert_array_equal(got[~active], d[~active])
    ring = np.ones((P, P, P), bool)
    ring[1:-1, 1:-1, 1:-1] = False
    np.testing.assert_array_equal(got[:, ring], d[:, ring])
    assert trelax.LAUNCHES == before  # the CPU path never counts a launch


def test_relax_plain_matches_relax_padded_all_active(rng):
    d, obs, upd = _fields(rng, 8, p_obs=0.6, p_upd=0.9)
    ref = np.asarray(jrelax.relax_padded(
        jnp.asarray(d), jnp.asarray(obs, jnp.float32),
        jnp.asarray(upd, jnp.float32), 4, 0.05, 2.0, 0.001, interpret=True))
    got = trelax.relax_plain(
        torch.as_tensor(d), torch.as_tensor(obs), torch.as_tensor(upd),
        torch.ones(8, dtype=torch.bool), 4, 0.05, 2.0, 0.001).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)


def test_relax_wrapper_rejects_bad_requests(rng):
    d, obs, upd = _fields(rng, 2)
    args = (torch.as_tensor(d), torch.as_tensor(obs), torch.as_tensor(upd),
            torch.ones(2, dtype=torch.bool), 4, 0.1, 2.0, 0.001)
    with pytest.raises(ValueError, match="codes"):
        trelax.relax(*args, strides=(8, 4, 2, 1))
    with pytest.raises(TypeError):
        trelax.relax(args[0].double(), *args[1:])
    with pytest.raises(TypeError):
        trelax.relax(args[0], args[1].float(), *args[2:])
    with pytest.raises(ValueError):
        trelax.relax(args[0][:, :16], *args[1:])
    with pytest.raises(ValueError):
        trelax.relax(args[0].transpose(1, 3), *args[1:])
    with pytest.raises(ValueError):
        trelax.relax(args[0].to("meta"), *args[1:])


def test_step_constants_round_like_the_tpu_kernel():
    """np.float32(round(norm, 6) * voxel * k) in float64, then cast."""
    for voxel in (0.05, 0.1, 0.2, 0.02):
        got = trelax.step_constants(voxel)
        ref = [float(np.float32(x * voxel * 1))
               for x in (1.0, 1.414214, 1.732051)]
        assert got == ref


@pytest.mark.cuda
def test_cuda_kernel_matches_plain(rng, cuda_device):
    b = 64
    d, obs, upd = _fields(rng, b)
    active = rng.uniform(size=b) < 0.5
    ts = [torch.as_tensor(x, device=cuda_device)
          for x in (d, obs, upd, active)]
    before = trelax.LAUNCHES
    got = trelax.relax(*ts, 4, 0.05, 2.0, 0.001)
    torch.cuda.synchronize()
    assert trelax.LAUNCHES == before + 1
    ref = trelax.relax_plain(*ts, 4, 0.05, 2.0, 0.001)
    np.testing.assert_array_equal(got.cpu().numpy(), ref.cpu().numpy())
