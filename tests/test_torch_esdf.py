"""Port parity, ESDF (quasi-Euclidean, unit strides, kernel path; and
the full-Euclidean path).

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


def _compare(je, te, it_j, it_t, min_observed=1000):
    ref = torch_parity.jax_layer_to_numpy(je)
    got = tlayer.layer_to_numpy(te)
    torch_parity.assert_layers_equal(ref, got, atol=1e-5,
                                     channels=["esdf"])
    np.testing.assert_array_equal(got["channel/esdf_flags"],
                                  ref["channel/esdf_flags"])
    np.testing.assert_array_equal(got["channel/parent"],
                                  ref["channel/parent"])
    assert int(it_j) == int(it_t)
    assert ((ref["channel/esdf_flags"] & 1) != 0).sum() > min_observed
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


def _point_source_tsdf():
    """tests/test_esdf.py:218's map: 8 blocks of 8^3 1 m voxels around the
    origin, all observed at +100, one zero-distance seed at voxel 0."""
    layer = jlayer.make_layer("tsdf", 1.0, vps=8, max_blocks=64)
    blocks = np.stack(np.meshgrid([-1, 0], [-1, 0], [-1, 0], indexing="ij"),
                      -1).reshape(-1, 3).astype(np.int32)
    layer, _ = jlayer.allocate_blocks(layer, jnp.asarray(blocks),
                                      jnp.ones(len(blocks), bool))
    d = torch_parity.jax_layer_to_numpy(layer)
    active = (d["block_flags"] & 128) != 0
    d["channel/weight"] = np.where(active[:, None], 1.0, 0.0).astype(
        np.float32) * np.ones_like(d["channel/weight"])
    d["channel/tsdf"] = np.full_like(d["channel/tsdf"], 100.0)
    row = int(np.asarray(jlayer.lookup_blocks(layer, jnp.zeros((1, 3),
                                                               jnp.int32)))[0])
    d["channel/tsdf"][row, 0] = 0.0
    return d


def test_full_euclidean_point_source():
    """Full-Euclidean distances from a point seed match sqrt distances at
    rtol 0.035 (tests/test_esdf.py:250), and the port equals the JAX
    package (distances 1e-5, parents exact)."""
    d = _point_source_tsdf()
    cfg = dict(max_distance_m=20.0, default_distance_m=20.0,
               min_distance_m=0.2, min_diff_m=1e-4,
               full_euclidean_distance=True)
    tt = tlayer.layer_from_numpy(d, "cpu")
    te, to, it_t = tesdf.update_from_tsdf_batch(
        tlayer.make_layer("esdf", 1.0, vps=8, max_blocks=64, device="cpu"),
        tt, TE(**cfg))
    jt = tlayer_to_jax(d)
    je, jo, it_j = jesdf.update_from_tsdf_batch(
        jlayer.make_layer("esdf", 1.0, vps=8, max_blocks=64), jt, JE(**cfg))
    assert not bool(to) and not bool(jo)
    _compare(je, te, it_j, it_t, min_observed=4000)
    q = np.array([[1, 0, 0], [1, 1, 0], [3, 2, 1], [-4, -4, -4], [5, 0, 0],
                  [4, 3, 0]], np.int32)
    got, found = tlayer.get_voxels(te, "esdf", torch.as_tensor(q))
    assert bool(found.all())
    np.testing.assert_allclose(got.numpy(),
                               np.linalg.norm(q.astype(np.float64), axis=1),
                               rtol=0.035)
    assert np.abs(te.channels["parent"].numpy()).max() > 0


def tlayer_to_jax(d):
    """A numpy layer dict -> a JAX VoxelLayer (same rows and table)."""
    import dataclasses

    layer = jlayer.make_layer(d["layer_type"], d["voxel_size"], vps=d["vps"],
                              max_blocks=d["block_ijk"].shape[0],
                              table_capacity=d["table/keys_w0"].shape[0])
    table = dataclasses.replace(layer.table, **{
        k: jnp.asarray(d[f"table/{k}"]) for k in torch_parity.TABLE_FIELDS})
    return dataclasses.replace(
        layer, table=table, block_ijk=jnp.asarray(d["block_ijk"]),
        block_flags=jnp.asarray(d["block_flags"]),
        num_blocks=jnp.asarray(d["num_blocks"]),
        channels={k.split("/", 1)[1]: jnp.asarray(v) for k, v in d.items()
                  if k.startswith("channel/")})


def test_full_euclidean_batch_matches():
    """A scanned map through update_from_tsdf_batch(full_euclidean_
    distance=True) in both packages (the plain sweep with parent carry, on
    a compact working set): distances 1e-5, flags and parents exact; and
    against the quasi-Euclidean field: never longer by more than
    min_diff_m, shorter on many voxels."""
    scans = _scans([0.0, 0.7], organized=True)
    intr = scans[0][4]
    tcfg = JT(default_truncation_distance=0.8, max_ray_length_m=10.0)
    jt = jlayer.make_layer("tsdf", 0.2, vps=8, max_blocks=512)
    for R, t, pts, col, _ in scans:
        jt, _, _ = jproj.integrate_organized_projective(
            jt, (jnp.asarray(R), jnp.asarray(t)), pts, col, tcfg,
            intrinsics=intr, pool=2)
    tt = tlayer.layer_from_numpy(torch_parity.jax_layer_to_numpy(jt), "cpu")
    cfg = dict(ESDF, max_active_blocks=256, full_euclidean_distance=True)
    je, jo, it_j = jesdf.update_from_tsdf_batch(
        jlayer.make_layer("esdf", 0.2, vps=8, max_blocks=512), jt, JE(**cfg))
    te, to, it_t = tesdf.update_from_tsdf_batch(
        tlayer.make_layer("esdf", 0.2, vps=8, max_blocks=512,
                          device="cpu"), tt, TE(**cfg))
    assert bool(jo) == bool(to) is False
    ref = _compare(je, te, it_j, it_t)
    assert (ref["channel/parent"] != 0).any()
    tq, _, _ = tesdf.update_from_tsdf_batch(
        tlayer.make_layer("esdf", 0.2, vps=8, max_blocks=512,
                          device="cpu"), tt,
        TE(**dict(cfg, full_euclidean_distance=False)))
    obs = (te.channels["esdf_flags"] & 1) != 0
    fixed = (te.channels["esdf_flags"] & 2) != 0
    m = obs & ~fixed
    # The chamfer overestimates; both sweeps drop changes below
    # min_diff_m, so either field may stop that far from its fixpoint.
    full, quasi = te.channels["esdf"][m].abs(), tq.channels["esdf"][m].abs()
    assert float((full - quasi).max()) <= TE(**cfg).min_diff_m
    assert int((full < quasi - TE(**cfg).min_diff_m).sum()) > 100
