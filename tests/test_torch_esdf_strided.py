"""Port parity, K2: the strided ESDF relaxation schedule.

The same numpy inputs, made from a seed, go through the JAX package (the
Pallas kernel interpreted on the CPU) and the port (``device="cpu"``, so
the kernel's plain version runs): the relaxation itself at atol 1e-6, the
jump-admissibility codes exactly, a strided batch rebuild at atol 1e-5 on
observed voxels with equal flags, and the gate statistics. The two
soundness regressions of tests/test_pallas_kernels.py (no tunnelling
through an unobserved gap; a carved map) run on the port alone, against
its own unit-stride XLA-path sweep at that file's atol 2e-3. The CUDA
kernel is held against the plain version on the card (``cuda`` marker,
here and in tests/test_torch_mesh.py, and chip_smoke.py), and its source
compiled for the CPU (csrc/esdf_relax_emulate.cpp) against the plain
version here, bit for bit.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voxblox_tpu.core import layer as jlayer
from voxblox_tpu.core.config import EsdfIntegratorConfig as JE
from voxblox_tpu.ops import esdf as jesdf
from voxblox_tpu.ops.pallas import esdf_relax as jrelax

from voxblox_tpu_torch.core import layer as tlayer
from voxblox_tpu_torch.core.config import EsdfIntegratorConfig as TE
from voxblox_tpu_torch.ops import esdf as tesdf
from voxblox_tpu_torch.ops import esdf_relax as trelax

import torch_parity

P = 18
VOXEL = 0.1
BASE = dict(max_distance_m=2.0, default_distance_m=2.0, min_distance_m=0.2)
STRIDED = dict(BASE, use_pallas_kernel=True, sweep_strides=(8, 4, 2, 1),
               max_outer_sweeps=64)


def _structured_fields(rng, b):
    """Padded blocks with large traversable regions (so jumps at every
    level fire): each block's sign follows a random plane, magnitudes are
    random (some beyond max_distance), a few small boxes are unobserved,
    and a band near the plane may not update. Block 0 is all positive
    and open, so even the radius-7 level has its 2^3 central voxels."""
    zz, yy, xx = np.meshgrid(*[np.arange(P)] * 3, indexing="ij")
    d = np.empty((b, P, P, P), np.float32)
    obs = np.ones((b, P, P, P), bool)
    upd = np.zeros((b, P, P, P), bool)
    for i in range(b):
        nrm = rng.normal(size=3)
        nrm /= np.linalg.norm(nrm)
        off = rng.uniform(3.0, 14.0)
        s = (xx * nrm[0] + yy * nrm[1] + zz * nrm[2]
             - off * nrm.sum())
        if i == 0:
            s = np.full((P, P, P), 5.0)
        mag = rng.uniform(0.0, 2.5, (P, P, P))
        d[i] = np.where(s > 0, mag, -mag)
        for _ in range(4 if i else 0):
            c = rng.integers(0, P - 2, 3)
            obs[i, c[0]:c[0] + 2, c[1]:c[1] + 2, c[2]:c[2] + 2] = False
        u = obs[i] & (np.abs(s) > 1.0)
        upd[i, 1:-1, 1:-1, 1:-1] = u[1:-1, 1:-1, 1:-1]
    return d, obs, upd


@pytest.mark.parametrize("strides", [(8, 4, 2, 1), (4, 2, 1, 1)])
def test_relax_plain_strided_matches_pallas_interpret(rng, strides):
    b = 8
    d, obs, upd = _structured_fields(rng, b)
    ref = np.asarray(jrelax.relax_padded(
        jnp.asarray(d), jnp.asarray(obs, jnp.float32),
        jnp.asarray(upd, jnp.float32), 4, VOXEL, 2.0, 0.001, interpret=True,
        strides=strides))
    td, tobs, tupd = (torch.as_tensor(x) for x in (d, obs, upd))
    # relax_padded's standalone codes: traversable = may update.
    codes = tesdf.stride_codes_standalone(td, tupd, strides)
    for lvl in range(1, len(trelax.stride_radii(strides)) + 1):
        n_open = int((torch.maximum(*codes) >= lvl).sum())
        assert n_open >= (8 if lvl == 3 else 50), (lvl, n_open)
    before = trelax.LAUNCHES, trelax.STRIDED_LAUNCHES
    got = trelax.relax(td, tobs, tupd, torch.ones(b, dtype=torch.bool), 4,
                       VOXEL, 2.0, 0.001, strides=strides,
                       codes=codes).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)
    assert np.abs(got - d).max() > 0.1  # the schedule did move values
    unit = trelax.relax_plain(td, tobs, tupd, torch.ones(b, dtype=torch.bool),
                              len(strides), VOXEL, 2.0, 0.001).numpy()
    assert np.abs(got - unit).max() > 1e-3  # and not as unit sweeps would
    # The CPU path never counts a launch.
    assert (trelax.LAUNCHES, trelax.STRIDED_LAUNCHES) == before


def test_unit_schedule_as_strides_equals_k1_path(rng):
    d, obs, upd = _structured_fields(rng, 4)
    args = (torch.as_tensor(d), torch.as_tensor(obs), torch.as_tensor(upd),
            torch.tensor([True, False, True, True]))
    a = trelax.relax(*args, 4, VOXEL, 2.0, 0.001)
    # inner_sweeps is ignored once a schedule is given.
    b = trelax.relax(*args, 9, VOXEL, 2.0, 0.001, strides=(1, 1, 1, 1))
    assert torch.equal(a, b)
    c = trelax.relax_plain(*args, 4, VOXEL, 2.0, 0.001, strides=(1, 1))
    assert torch.equal(c, trelax.relax_plain(*args, 2, VOXEL, 2.0, 0.001))


def test_strided_requests_are_checked(rng):
    d, obs, upd = _structured_fields(rng, 2)
    args = (torch.as_tensor(d), torch.as_tensor(obs), torch.as_tensor(upd),
            torch.ones(2, dtype=torch.bool), 4, VOXEL, 2.0, 0.001)
    with pytest.raises(ValueError, match="codes"):
        trelax.relax(*args, strides=(4, 1))
    with pytest.raises(ValueError, match="codes"):
        trelax.relax_plain(*args, strides=(4, 1))
    codes = tesdf.stride_codes_standalone(args[0], args[2], (4, 1))
    with pytest.raises(TypeError):
        trelax.relax(*args, strides=(4, 1),
                     codes=(codes[0].float(), codes[1]))
    with pytest.raises(TypeError):
        trelax.relax(*args, strides=(4, 1), codes=(codes[0][:1], codes[1]))
    assert trelax.stride_radii((8, 4, 2, 1, 1, 1, 1)) == (1, 3, 7)
    assert trelax.stride_radii((8, 4, 2, 1, 1, 1, 1)) == jrelax.stride_radii(
        (8, 4, 2, 1, 1, 1, 1))
    assert trelax._levels((8, 4, 2, 1)) == {2: 1, 4: 2, 8: 3}
    for k in (2, 4, 8):
        assert trelax.step_constants(0.05, k) == [
            float(np.float32(x * 0.05 * k))
            for x in (1.0, 1.414214, 1.732051)]
    with pytest.raises(ValueError):
        trelax._schedule_arg((2,) * 17, VOXEL)
    with pytest.raises(ValueError):
        trelax._schedule_arg((2, 3, 4, 5), VOXEL)
    arg = trelax._schedule_arg((8, 4, 2, 1, 1, 1, 1), 0.05)
    assert arg.n == 7 and list(arg.stride)[:7] == [8, 4, 2, 1, 1, 1, 1]
    assert list(arg.level)[:7] == [3, 2, 1, 0, 0, 0, 0]
    assert [float(x) for x in arg.step[0]] == trelax.step_constants(0.05, 8)


def _blocks_layer(blocks, tsdf_of_xyz, weight):
    """A JAX TSDF layer over ``blocks`` with tsdf = f(voxel centres) and
    the given per-voxel weights [n_blocks, vpb], and the port's copy."""
    from voxblox_tpu.core import grid as vgrid

    layer = jlayer.make_layer("tsdf", VOXEL, vps=16, max_blocks=16)
    layer, _ = jlayer.allocate_blocks(
        layer, jnp.asarray(blocks), jnp.ones(len(blocks), bool))
    local = vgrid.linear_to_local(jnp.arange(layer.voxels_per_block), 16)
    gvi = layer.block_ijk[:, None, :] * 16 + local[None]
    xyz = np.asarray(vgrid.grid_index_to_center_point(gvi, VOXEL))
    active = np.asarray(layer.active_mask())[:, None]
    w = np.zeros(xyz.shape[:2], np.float32)
    w[: len(blocks)] = weight
    ch = dict(layer.channels)
    ch["tsdf"] = jnp.asarray(np.where(
        active, tsdf_of_xyz(xyz), 0.0).astype(np.float32))
    ch["weight"] = jnp.asarray(np.where(active, w, 0.0).astype(np.float32))
    layer = dataclasses.replace(layer, channels=ch)
    return layer, tlayer.layer_from_numpy(
        torch_parity.jax_layer_to_numpy(layer), "cpu")


def _carved_layers(rng, p_pocket=0.0, n_boxes=0):
    """2x2x2 blocks around a plane at z = 0.35 with unobserved pockets
    (random voxels and/or small boxes crossing block borders)."""
    blocks = np.stack(np.meshgrid([0, 1], [0, 1], [0, 1], indexing="ij"),
                      -1).reshape(-1, 3).astype(np.int32)
    w = (rng.uniform(size=(8, 4096)) >= p_pocket).astype(np.float32)
    g = w.reshape(8, 16, 16, 16)
    for _ in range(n_boxes):
        bi = rng.integers(0, 8)
        c = rng.integers(0, 15, 3)
        g[bi, c[0]:c[0] + 2, c[1]:c[1] + 2, c[2]:c[2] + 2] = 0.0
    return _blocks_layer(
        blocks, lambda xyz: np.clip(xyz[..., 2] - 0.35, -0.4, 0.4), w)


def _torch_batch(tt, **cfg):
    te = tlayer.make_layer("esdf", VOXEL, vps=16, max_blocks=16,
                           device="cpu")
    return tesdf.update_from_tsdf_batch(te, tt, TE(**cfg))


def test_strided_batch_codes_and_gate_stats_match_jax(rng):
    jt, tt = _carved_layers(rng, n_boxes=12)
    je = jlayer.make_layer("esdf", VOXEL, vps=16, max_blocks=16)
    je, jo, it_j = jesdf.update_from_tsdf_batch(je, jt, JE(**STRIDED))
    te, to, it_t = _torch_batch(tt, **STRIDED)
    assert bool(jo) == bool(to) is False
    assert int(it_j) == int(it_t)
    ref = torch_parity.jax_layer_to_numpy(je)
    got = tlayer.layer_to_numpy(te)
    np.testing.assert_array_equal(got["channel/esdf_flags"],
                                  ref["channel/esdf_flags"])
    np.testing.assert_array_equal(got["block_flags"], ref["block_flags"])
    obs = (ref["channel/esdf_flags"] & 1) != 0
    assert obs.sum() > 20000
    np.testing.assert_allclose(got["channel/esdf"][obs],
                               ref["channel/esdf"][obs], atol=1e-5, rtol=0)
    # The strided fixpoint is the unit schedule's (trailing unit sweeps).
    tu, _, _ = _torch_batch(tt, **dict(STRIDED, sweep_strides=None))
    np.testing.assert_allclose(tu.channels["esdf"].numpy()[obs],
                               got["channel/esdf"][obs], atol=2e-3, rtol=0)

    # (f) gate statistics on the rebuilt field.
    js = jesdf.stride_gate_stats(je, JE(**STRIDED))
    ts = tesdf.stride_gate_stats(te, TE(**STRIDED))
    assert {k: (list(v) if isinstance(v, (list, tuple)) else v)
            for k, v in ts.items()} == {
        k: (list(v) if isinstance(v, (list, tuple)) else v)
        for k, v in js.items()}
    assert ts["admitted_voxels"][2] > 0  # radius-7 jumps fire on this map

    # (b) codes, exactly, ring included; every block of this map has
    # missing neighbours.
    mb, v = 16, 16
    nbr_j = jesdf.neighbor_slot_table(je)
    flags = jnp.where(je.active_mask()[:, None], je.channels["esdf_flags"],
                      np.uint8(0)).reshape(mb, v, v, v)
    pad2 = lambda x: jrelax.to_2d(jesdf._padded(  # noqa: E731
        je, x, nbr_j, jnp.float32(0.0)))
    d20 = pad2(jlayer.cube(je, "esdf"))
    o2 = pad2(((flags & 1) != 0).astype(jnp.float32))
    f2 = pad2(((flags & 2) != 0).astype(jnp.float32))
    cp, cn = jesdf._stride_codes_2d(d20, o2, f2, nbr_j, mb,
                                    STRIDED["sweep_strides"])
    nbr_t = tesdf.neighbor_slot_table(te).to(torch.int64)
    assert (np.asarray(nbr_j) == -1).any(1)[:8].all()
    np.testing.assert_array_equal(nbr_t.numpy(), np.asarray(nbr_j))
    tf = torch.where(te.active_mask()[:, None], te.channels["esdf_flags"],
                     0).to(torch.uint8)
    tp = lambda x: tesdf.halo_exchange(  # noqa: E731
        tesdf._pad(x, mb, v), nbr_t)
    tcp, tcn = tesdf.stride_codes(
        tp(te.channels["esdf"]), tp((tf & 1) != 0), tp((tf & 2) != 0), nbr_t,
        STRIDED["sweep_strides"])
    for got_c, ref_c in ((tcp, cp), (tcn, cn)):
        assert got_c.dtype == torch.uint8
        np.testing.assert_array_equal(
            got_c.numpy(), np.asarray(jrelax.from_2d(ref_c, mb)))
    assert int(tcp.max()) == 3


def test_strided_sweeps_do_not_tunnel_unobserved_gaps():
    """An unobserved wall at x in {6,7,8} separates the fixed band from
    the far side, which must keep sign*default: a stride-k jump must not
    cross unobserved voxels."""
    x = (np.arange(4096) % 16)[None, :]
    w = np.where((x >= 6) & (x <= 8), 0.0, 1.0).astype(np.float32)
    _, tt = _blocks_layer(
        np.array([[0, 0, 0]], np.int32),
        lambda xyz: np.clip(xyz[..., 0] - 0.25, -0.4, 0.4), w)
    # The surface plane lies near x index 2, as in the reference test.
    t0 = tt.channels["tsdf"][0].numpy()
    np.testing.assert_allclose(
        t0, np.clip((x[0] - 2.0) * VOXEL, -0.4, 0.4), atol=1e-6)
    xla, _, _ = _torch_batch(tt, **BASE)
    strided, _, it = _torch_batch(tt, **STRIDED)
    a = xla.channels["esdf"][0].numpy()
    b = strided.channels["esdf"][0].numpy()
    far = x[0] >= 9
    assert np.all(a[far] >= BASE["default_distance_m"] - 1e-5)
    np.testing.assert_allclose(
        b, a, atol=2e-3,
        err_msg="strided sweep tunneled through the unobserved gap")


def test_strided_sweeps_match_on_partially_observed_blocks(rng):
    """Carved map: ~15% unobserved pockets everywhere. Jumps fire only
    where the erosion codes prove the Chebyshev ball traversable, and the
    trailing unit sweeps finish the unit-schedule fixpoint."""
    _, tt = _carved_layers(rng, p_pocket=0.15)
    e1, _, _ = _torch_batch(tt, **BASE)
    e3, _, _ = _torch_batch(tt, **STRIDED)
    act = tt.active_mask().numpy()
    np.testing.assert_allclose(
        e3.channels["esdf"].numpy()[act], e1.channels["esdf"].numpy()[act],
        atol=2e-3,
        err_msg="per-voxel-gated strided sweep diverged on a carved map")


def test_xla_path_ignores_the_schedule(rng):
    """Without the kernel layout the sweep runs ``_relax_once`` and, like
    the reference, ignores ``sweep_strides``."""
    _, tt = _carved_layers(rng, n_boxes=10)
    a, _, ia = _torch_batch(tt, **BASE)
    b, _, ib = _torch_batch(tt, **dict(BASE, sweep_strides=(8, 4, 2, 1)))
    assert ia == ib and torch.equal(a.channels["esdf"], b.channels["esdf"])


# ---------------------------------------------------------------------------
# The kernels' own source on the CPU (csrc/esdf_relax_emulate.cpp)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("strides", [
    (8, 4, 2, 1, 1, 1, 1), (8, 4, 2, 1), (4, 2, 1, 1), (1, 4, 2, 1),
    (2, 2, 1), (2,), (1, 1, 8, 8, 1), (3, 1), (16, 6, 5, 1)])
def test_emulated_k2_matches_plain(rng, strides):
    """K2's CUDA source compiled for the CPU against the plain version, bit
    for bit (tolerance 0: the kernel folds the negative side into a sign
    and moves the window test to the group's minimum, both exact), with
    some blocks inactive and the codes of a standalone erosion."""
    b = 6
    d, obs, upd = _structured_fields(rng, b)
    active = np.array([1, 1, 0, 1, 1, 1], bool)
    td, tobs, tupd, tact = (torch.as_tensor(x)
                            for x in (d, obs, upd, active))
    codes = tesdf.stride_codes_standalone(td, tupd, strides)
    for voxel, maxd in ((VOXEL, 2.0), (0.05, 0.6)):  # 0.6: windows close
        ref = trelax.relax_plain(td, tobs, tupd, tact, 4, voxel, maxd, 0.001,
                                 strides=strides, codes=codes)
        got = torch_parity.relax_emulated(td, tobs, tupd, tact, 4, voxel,
                                          maxd, 0.001, strides=strides,
                                          codes=codes)
        assert not torch.isnan(got).any()  # every voxel of out is written
        np.testing.assert_array_equal(got.numpy(), ref.numpy())
        np.testing.assert_array_equal(got.numpy()[2], d[2])
    assert np.abs(ref.numpy() - d).max() > 0.05


def test_schedule_starting_with_a_unit_sweep_matches_pallas_interpret(rng):
    """A strided schedule whose first entry is a unit sweep (the kernel
    then packs for a unit sweep first and strides afterwards)."""
    strides = (1, 4, 2, 1)
    b = 4
    d, obs, upd = _structured_fields(rng, b)
    ref = np.asarray(jrelax.relax_padded(
        jnp.asarray(d), jnp.asarray(obs, jnp.float32),
        jnp.asarray(upd, jnp.float32), 4, VOXEL, 2.0, 0.001, interpret=True,
        strides=strides))
    td, tobs, tupd = (torch.as_tensor(x) for x in (d, obs, upd))
    codes = tesdf.stride_codes_standalone(td, tupd, strides)
    got = trelax.relax(td, tobs, tupd, torch.ones(b, dtype=torch.bool), 4,
                       VOXEL, 2.0, 0.001, strides=strides, codes=codes)
    assert got.data_ptr() != td.data_ptr()
    np.testing.assert_array_equal(td.numpy(), d)  # the input is not written
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-6, rtol=0)


@pytest.mark.parametrize("n_active", [0, 1])
def test_emulated_k2_inactive_blocks_pass_through(rng, n_active):
    strides = (4, 2, 1)
    b = 3
    d, obs, upd = _structured_fields(rng, b)
    active = np.zeros(b, bool)
    active[0] = n_active == 1
    td, tobs, tupd, tact = (torch.as_tensor(x)
                            for x in (d, obs, upd, active))
    codes = tesdf.stride_codes_standalone(td, tupd, strides)
    got = torch_parity.relax_emulated(td, tobs, tupd, tact, 4, VOXEL, 2.0,
                                      0.001, strides=strides, codes=codes)
    np.testing.assert_array_equal(td.numpy(), d)
    np.testing.assert_array_equal(got.numpy()[~active], d[~active])
    changed = np.abs(got.numpy() - d).reshape(b, -1).max(1) > 0
    np.testing.assert_array_equal(changed, active)


@pytest.mark.cuda
@pytest.mark.parametrize("fraction", [0.0, 0.03, 0.5, 1.0])
@pytest.mark.parametrize("n", [1, 2, 131, 133, 384, 6144])
def test_cuda_k2_matches_plain_at_grid_sizes(n, fraction):
    """K2 against the plain version, bit-equal, below, at and above one
    wave of CTAs (132 SMs x 2) and at the stress loop's pool."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    dev = torch.device("cuda")
    strides = (8, 4, 2, 1, 1, 1, 1)
    g = np.random.default_rng(n * 11 + int(fraction * 100))
    reps = -(-n // 16)
    d, obs, upd = (np.concatenate([x] * reps)[:n]
                   for x in _structured_fields(g, min(n, 16)))
    d = d * g.uniform(0.5, 1.0, (n, 1, 1, 1)).astype(np.float32)
    active = g.uniform(size=n) < fraction
    td, tobs, tupd, tact = (torch.as_tensor(x, device=dev)
                            for x in (d, obs, upd, active))
    codes = tesdf.stride_codes_standalone(td, tupd, strides)
    before = trelax.LAUNCHES, trelax.STRIDED_LAUNCHES
    got = trelax.relax(td, tobs, tupd, tact, 4, 0.05, 2.0, 0.001,
                       strides=strides, codes=codes)
    torch.cuda.synchronize()
    assert (trelax.LAUNCHES, trelax.STRIDED_LAUNCHES) == (
        before[0] + 1, before[1] + 1)
    ref = trelax.relax_plain(td, tobs, tupd, tact, 4, 0.05, 2.0, 0.001,
                             strides=strides, codes=codes)
    assert torch.equal(got, ref)
