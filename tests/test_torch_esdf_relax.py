"""Port parity, K1: the plain PyTorch relaxation (voxblox_tpu_torch.ops.
esdf_relax.relax_plain) against the Pallas kernel run in interpret mode,
at the tolerance tests/test_pallas_kernels.py holds the Pallas kernel to
(atol 1e-6). The CUDA kernel itself is held against the plain version on
the card (marked ``cuda``, skipped without one, and in chip_smoke.py); its
source, compiled for the CPU (csrc/esdf_relax_emulate.cpp, built with g++
by tests/torch_parity.py), is held to the plain version here, bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voxblox_tpu.ops.pallas import esdf_relax as jrelax
from voxblox_tpu_torch.ops import esdf_relax as trelax

import torch_parity
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


# ---------------------------------------------------------------------------
# The kernels' own source on the CPU (csrc/esdf_relax_emulate.cpp), and the
# cases a redesign of the kernels could break without random data noticing
# ---------------------------------------------------------------------------


def _tensors(*arrays):
    return [torch.as_tensor(x) for x in arrays]


@pytest.mark.parametrize("inner_sweeps", [1, 4, 7])
def test_emulated_kernel_matches_plain(rng, inner_sweeps):
    """The CUDA source compiled for the CPU, bit for bit (tolerance 0: the
    kernel reorders only mins and maxes, which are exact)."""
    b = 5
    d, obs, upd = _fields(rng, b)
    active = np.array([1, 1, 0, 1, 1], bool)
    ts = _tensors(d, obs, upd, active)
    for voxel, maxd in ((0.05, 2.0), (0.02, 1.0)):
        ref = trelax.relax_plain(*ts, inner_sweeps, voxel, maxd, 0.001)
        got = torch_parity.relax_emulated(*ts, inner_sweeps, voxel, maxd,
                                          0.001)
        assert not torch.isnan(got).any()  # every voxel of out is written
        np.testing.assert_array_equal(got.numpy(), ref.numpy())
    assert np.abs(ref.numpy() - d).max() > 0.1


@pytest.mark.parametrize("impl", ["wrapper", "emulated"])
@pytest.mark.parametrize("n_active", [0, 1])
def test_inactive_blocks_pass_through_and_input_is_not_aliased(
        rng, impl, n_active):
    """All-inactive and single-active launches: everything outside the
    active block's interior equals ``d``; the result is a new tensor and
    ``d`` is not written (the wrapper makes no copy of its own)."""
    b = 4
    d, obs, upd = _fields(rng, b)
    active = np.zeros(b, bool)
    active[2] = n_active == 1
    ts = _tensors(d.copy(), obs, upd, active)
    fn = trelax.relax if impl == "wrapper" else torch_parity.relax_emulated
    got = fn(*ts, 4, 0.05, 2.0, 0.001)
    assert got.data_ptr() != ts[0].data_ptr()
    np.testing.assert_array_equal(ts[0].numpy(), d)  # input untouched
    np.testing.assert_array_equal(got.numpy()[~active], d[~active])
    ring = np.ones((P, P, P), bool)
    ring[1:-1, 1:-1, 1:-1] = False
    np.testing.assert_array_equal(got.numpy()[:, ring], d[:, ring])
    changed = np.abs(got.numpy() - d).reshape(b, -1).max(1) > 0
    np.testing.assert_array_equal(changed, active)
    # Running on the result aliases nothing either.
    again = fn(got, *ts[1:], 4, 0.05, 2.0, 0.001)
    assert again.data_ptr() != got.data_ptr()


def _special_block(kind, rng):
    """One padded block that a packed-tile kernel could get wrong."""
    d = rng.uniform(-2.5, 2.5, (P, P, P)).astype(np.float32)
    obs = rng.uniform(size=(P, P, P)) < 0.8
    upd = np.zeros((P, P, P), bool)
    upd[1:-1, 1:-1, 1:-1] = rng.uniform(size=(16, 16, 16)) < 0.7
    inner = (slice(1, -1),) * 3
    if kind == "all_positive":
        d[inner] = np.abs(d[inner]) + 0.01
    elif kind == "all_negative":
        d[inner] = -np.abs(d[inner]) - 0.01
    elif kind == "one_sign_everywhere":
        d = np.abs(d) + 0.01
    elif kind == "unobserved_interior":
        obs[inner] = False
    elif kind == "unobserved_everywhere":
        obs[:] = False
    elif kind == "at_plus_max_distance":
        d[inner] = 2.0  # |d| < max_distance fails exactly at the bound
        obs[:] = True
    elif kind == "at_minus_max_distance":
        d[inner] = -2.0
        obs[:] = True
    elif kind == "zeros":
        d[inner] = 0.0  # a zero centre takes the negative side
    elif kind == "nothing_to_write":
        upd[:] = False
    elif kind == "fixpoint":
        t = _tensors(d[None], obs[None], upd[None], np.ones(1, bool))
        d = trelax.relax_plain(*t, 40, 0.05, 2.0, 0.001).numpy()[0]
    else:
        raise AssertionError(kind)
    return d, obs, upd


SPECIAL = ["all_positive", "all_negative", "one_sign_everywhere",
           "unobserved_interior", "unobserved_everywhere",
           "at_plus_max_distance", "at_minus_max_distance", "zeros",
           "nothing_to_write", "fixpoint"]


@pytest.mark.parametrize("kind", SPECIAL)
def test_emulated_kernel_matches_plain_on_special_blocks(rng, kind):
    blocks = [_special_block(kind, rng) for _ in range(2)]
    d, obs, upd = (np.stack(x) for x in zip(*blocks))
    ts = _tensors(d, obs, upd, np.ones(2, bool))
    ref = trelax.relax_plain(*ts, 4, 0.05, 2.0, 0.001)
    got = torch_parity.relax_emulated(*ts, 4, 0.05, 2.0, 0.001)
    assert not torch.isnan(got).any()
    np.testing.assert_array_equal(got.numpy(), ref.numpy())
    if kind in ("nothing_to_write", "fixpoint", "unobserved_everywhere"):
        np.testing.assert_array_equal(got.numpy(), d)


def test_relax_plain_matches_pallas_interpret_on_special_blocks(rng):
    """The same special blocks, one launch, against the TPU kernel in
    interpret mode at its own tolerance (atol 1e-6)."""
    blocks = [_special_block(kind, rng) for kind in SPECIAL]
    d, obs, upd = (np.stack(x) for x in zip(*blocks))
    b = len(blocks)
    ref2 = jrelax.relax_2d(
        jrelax.to_2d(jnp.asarray(d), 1),
        jrelax.to_2d(jnp.asarray(obs, jnp.float32), 1),
        jrelax.to_2d(jnp.asarray(upd, jnp.float32), 1),
        4, 0.05, 2.0, 0.001, interpret=True, block_tile=1,
        active=jnp.ones(b, bool))
    ref = np.asarray(jrelax.from_2d(ref2, b))
    got = trelax.relax(*_tensors(d, obs, upd, np.ones(b, bool)), 4, 0.05,
                       2.0, 0.001).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)


def test_emulated_kernel_stops_at_a_fixpoint_like_plain(rng):
    """Sweeps past the fixpoint change nothing: 40 sweeps equal 60, in
    the plain version and in the kernel (which skips them)."""
    d, obs, upd = _fields(rng, 2)
    ts = _tensors(d, obs, upd, np.ones(2, bool))
    a = torch_parity.relax_emulated(*ts, 40, 0.05, 2.0, 0.001)
    b = torch_parity.relax_emulated(*ts, 60, 0.05, 2.0, 0.001)
    ref = trelax.relax_plain(*ts, 60, 0.05, 2.0, 0.001)
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    np.testing.assert_array_equal(b.numpy(), ref.numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("fraction", [0.0, 0.03, 0.5, 1.0])
@pytest.mark.parametrize("n", [1, 2, 131, 133, 384, 6144])
def test_cuda_k1_matches_plain_at_grid_sizes(cuda_device, n, fraction):
    """K1 against the plain version, bit-equal, below, at and above one
    wave of CTAs (132 SMs x 2) and at the stress loop's pool."""
    g = np.random.default_rng(n * 7 + int(fraction * 100))
    d, obs, upd = _fields(g, n)
    active = g.uniform(size=n) < fraction
    ts = [torch.as_tensor(x, device=cuda_device)
          for x in (d, obs, upd, active)]
    keep = ts[0].clone()
    before = trelax.LAUNCHES
    got = trelax.relax(*ts, 4, 0.05, 2.0, 0.001)
    torch.cuda.synchronize()
    assert trelax.LAUNCHES == before + 1
    assert got.data_ptr() != ts[0].data_ptr()
    assert torch.equal(ts[0], keep)
    ref = trelax.relax_plain(*ts, 4, 0.05, 2.0, 0.001)
    assert torch.equal(got, ref)


def test_binding_raises_when_shared_memory_is_refused(monkeypatch):
    """The kernels need more dynamic shared memory than a kernel gets
    unasked; the library's init sets that once at load, and a refusal
    raises there instead of failing at the first launch."""
    class Fn:
        def __init__(self, rc):
            self.rc = rc

        def __call__(self, *args):
            return self.rc

    class Lib:
        def __init__(self, init_rc):
            self.esdf_relax_k1 = Fn(0)
            self.esdf_relax_k2 = Fn(0)
            self.esdf_relax_init = Fn(init_rc)
            self.esdf_relax_ctas_per_sm = Fn(2)

    monkeypatch.setattr(trelax, "_LIB", None)
    monkeypatch.setattr(trelax, "build", lambda: "libesdf_relax.so")
    monkeypatch.setattr(trelax.ctypes, "CDLL", lambda path: Lib(1))
    with pytest.raises(RuntimeError, match="shared memory"):
        trelax._lib()
    assert trelax._LIB is None  # nothing half-bound is kept
    monkeypatch.setattr(trelax.ctypes, "CDLL", lambda path: Lib(0))
    lib = trelax._lib()
    assert trelax._lib() is lib  # bound and initialised once
    assert trelax.ctas_per_sm(False) == 2
    # Pointers and the stream go as 64-bit values, d and out separately.
    assert lib.esdf_relax_k1.argtypes[:5] == [trelax.ctypes.c_void_p] * 5
    assert lib.esdf_relax_k2.argtypes[:7] == [trelax.ctypes.c_void_p] * 7
