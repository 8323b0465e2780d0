"""Port parity, ESDF (quasi-Euclidean, unit strides, kernel path).

A TSDF map built by the JAX package is carried to the port with
``layer_from_numpy``; both packages then run a batch ESDF build and two
capped incremental updates (``max_outer_sweeps_incremental=1``, so
SWEEP_DEBT carries) with ``use_pallas_kernel=True`` — the Pallas kernel
interpreted on the CPU on the JAX side, the kernel's plain version on
the port's. Both follow the same Jacobi order, so distances are held at
atol 1e-5 (in practice they agree bit for bit), with equal voxel flags,
block flags (SWEEP_DEBT included), rows and outer-iteration counts.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voxblox_tpu.core import layer as jlayer
from voxblox_tpu.core.config import EsdfIntegratorConfig as JE
from voxblox_tpu.core.config import TsdfIntegratorConfig as JT
from voxblox_tpu.ops import esdf as jesdf
from voxblox_tpu.ops import projective as jproj

from voxblox_tpu_torch.core import layer as tlayer
from voxblox_tpu_torch.core.config import EsdfIntegratorConfig as TE
from voxblox_tpu_torch.ops import esdf as tesdf

import torch_parity
from test_torch_projective import _scans

ESDF = dict(max_distance_m=2.0, default_distance_m=2.0, min_distance_m=0.4,
            max_active_blocks=128, use_pallas_kernel=True, inner_sweeps=4,
            max_outer_sweeps_incremental=1)


def _compare(je, te, it_j, it_t):
    ref = torch_parity.jax_layer_to_numpy(je)
    got = tlayer.layer_to_numpy(te)
    torch_parity.assert_layers_equal(ref, got, atol=1e-5,
                                     channels=["esdf"])
    np.testing.assert_array_equal(got["channel/esdf_flags"],
                                  ref["channel/esdf_flags"])
    np.testing.assert_array_equal(got["channel/parent"],
                                  ref["channel/parent"])
    assert int(it_j) == int(it_t)
    assert ((ref["channel/esdf_flags"] & 1) != 0).sum() > 1000
    return ref


def test_batch_then_capped_incremental_match():
    scans = _scans([0.0, 0.7, 1.4, 2.1], organized=True)
    intr = scans[0][4]
    tcfg = JT(default_truncation_distance=0.8, max_ray_length_m=10.0)
    jint = jax.jit(jproj.integrate_organized_projective,
                   static_argnames=("cfg", "intrinsics", "pool"))

    def integrate(layer, scan):
        R, t, pts, col, _ = scan
        layer, _, _ = jint(layer, (jnp.asarray(R), jnp.asarray(t)), pts, col,
                           tcfg, intrinsics=intr, pool=2)
        return layer

    jt = jlayer.make_layer("tsdf", 0.2, vps=16, max_blocks=256)
    for s in scans[:2]:
        jt = integrate(jt, s)
    je = jlayer.make_layer("esdf", 0.2, vps=16, max_blocks=256)
    te = tlayer.make_layer("esdf", 0.2, vps=16, max_blocks=256, device="cpu")
    tt = tlayer.layer_from_numpy(torch_parity.jax_layer_to_numpy(jt), "cpu")
    je, jo, it_j = jesdf.update_from_tsdf_batch(je, jt, JE(**ESDF))
    te, to, it_t = tesdf.update_from_tsdf_batch(te, tt, TE(**ESDF))
    assert bool(jo) == bool(to) is False
    _compare(je, te, it_j, it_t)
    debts = []
    for s in scans[2:]:
        jt = integrate(jt, s)
        tt = tlayer.layer_from_numpy(torch_parity.jax_layer_to_numpy(jt),
                                     "cpu")
        je, jt, jo, it_j = jesdf.update_from_tsdf_incremental(
            je, jt, JE(**ESDF))
        te, tt, to, it_t = tesdf.update_from_tsdf_incremental(
            te, tt, TE(**ESDF))
        assert int(it_t) == 1  # capped
        ref = _compare(je, te, it_j, it_t)
        # The TSDF kEsdf dirty bits are cleared alike.
        np.testing.assert_array_equal(tt.block_flags.numpy(),
                                      np.asarray(jt.block_flags))
        debts.append(((ref["block_flags"] & 16) != 0).sum())
    assert max(debts) > 0  # the cap left debt to carry


def test_halo_exchange_matches_jax_2d(rng):
    """The padded-cube halo exchange equals the JAX 2D-layout exchange
    (_halo_exchange_2d) on random fields with missing neighbours."""
    from voxblox_tpu.ops.pallas import esdf_relax as jrelax

    b = 8
    d = rng.uniform(-3, 3, (b, 18, 18, 18)).astype(np.float32)
    nbr = rng.integers(-1, b, (b, 27)).astype(np.int32)
    nbr[:, 13] = np.arange(b)
    ref = jax.jit(lambda x, n: jrelax.from_2d(
        jesdf._halo_exchange_2d(jrelax.to_2d(x), n, b), b))(
        jnp.asarray(d), jnp.asarray(nbr))
    got = tesdf.halo_exchange(torch.as_tensor(d), torch.as_tensor(nbr))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_bucket_ladder_matches():
    for n in (1, 64, 65, 96, 97, 300, 513, 1500, 5000):
        assert tesdf._bucket_for(n) == jesdf._bucket_for(n)


def test_deferred_batch_equals_retrying_batch():
    """update_from_tsdf_batch_deferred (flags left on the device) gives the
    retrying entry point's field when nothing overflows."""
    scans = _scans([0.0], organized=True)
    R, t, pts, col, intr = scans[0]
    from voxblox_tpu_torch.core.config import TsdfIntegratorConfig
    from voxblox_tpu_torch.ops import projective as tproj

    tt = tlayer.make_layer("tsdf", 0.2, vps=16, max_blocks=256, device="cpu")
    tt, _, _ = tproj.integrate_organized_projective(
        tt, (torch.as_tensor(R), torch.as_tensor(t)), torch.as_tensor(pts),
        torch.as_tensor(col), TsdfIntegratorConfig(
            default_truncation_distance=0.8, max_ray_length_m=10.0),
        intrinsics=intr, pool=2)
    cfg = TE(**ESDF)
    a, ao, ai = tesdf.update_from_tsdf_batch(
        tlayer.make_layer("esdf", 0.2, vps=16, max_blocks=256, device="cpu"),
        tt, cfg)
    b, bo, br, bi = tesdf.update_from_tsdf_batch_deferred(
        tlayer.make_layer("esdf", 0.2, vps=16, max_blocks=256, device="cpu"),
        tt, cfg)
    assert not bool(ao) and not bool(bo) and not bool(br) and ai == bi
    torch_parity.assert_layers_equal(tlayer.layer_to_numpy(a),
                                     tlayer.layer_to_numpy(b))


@pytest.mark.parametrize("vps,use_kernel", [(8, True), (16, False)])
def test_batch_xla_path_matches(vps, use_kernel):
    """The sweep without the kernel layout — vps != 16, or
    use_pallas_kernel=False — runs _relax_once in both packages (the JAX
    XLA path); held at the same tolerance."""
    scans = _scans([0.0, 0.7], organized=True)
    intr = scans[0][4]
    tcfg = JT(default_truncation_distance=0.8, max_ray_length_m=10.0)
    jt = jlayer.make_layer("tsdf", 0.2, vps=vps, max_blocks=512)
    for R, t, pts, col, _ in scans:
        jt, _, _ = jproj.integrate_organized_projective(
            jt, (jnp.asarray(R), jnp.asarray(t)), pts, col, tcfg,
            intrinsics=intr, pool=2)
    tt = tlayer.layer_from_numpy(torch_parity.jax_layer_to_numpy(jt), "cpu")
    cfg = dict(ESDF, use_pallas_kernel=use_kernel, max_active_blocks=256)
    je, jo, it_j = jesdf.update_from_tsdf_batch(
        jlayer.make_layer("esdf", 0.2, vps=vps, max_blocks=512), jt,
        JE(**cfg))
    te, to, it_t = tesdf.update_from_tsdf_batch(
        tlayer.make_layer("esdf", 0.2, vps=vps, max_blocks=512,
                          device="cpu"), tt, TE(**cfg))
    assert bool(jo) == bool(to) is False
    _compare(je, te, it_j, it_t)
