"""Port parity, meshing: marching-cubes tables, the device mesh pool, the
host export paths and the online step with meshing end to end.

The same layers (a ground-truth sphere built by the JAX sim, carried over
with ``layer_from_numpy``, colours drawn per voxel from a numpy seed) go
through ``voxblox_tpu.ops.mesh`` and ``voxblox_tpu_torch.ops.mesh``
(``device="cpu"``). Everything integral — triangle counts, overflow rows,
block flags, triangle order, packed colour words — must agree exactly;
vertex floats at atol 1e-5 m (the reference's XLA CPU program may fuse the
``p0 + t * (p1 - p0)`` interpolation, the port computes it op by op).

The end-to-end test runs two scans through both ``EsdfServer``s with
``update_mesh`` after each, the JAX side in a subprocess (its fused-step
programs stay out of the pytest worker), and compares TSDF, ESDF and the
mesh pool. Two tests need a card (``cuda`` marker): K2 against its plain
version, and the mesh built on the card against the mesh built on the CPU.
"""

import os
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voxblox_tpu.core.config import MeshIntegratorConfig as JM
from voxblox_tpu.ops import marching_cubes as jmc
from voxblox_tpu.ops import mesh as jmesh
from voxblox_tpu.sim import world as jsw

from voxblox_tpu_torch.core import layer as tlayer
from voxblox_tpu_torch.core.config import (
    EsdfIntegratorConfig, MapConfig, MeshIntegratorConfig as TM,
    TsdfIntegratorConfig)
from voxblox_tpu_torch.ops import esdf as tesdf
from voxblox_tpu_torch.ops import esdf_relax as trelax
from voxblox_tpu_torch.ops import marching_cubes as tmc
from voxblox_tpu_torch.ops import mesh as tmesh
from voxblox_tpu_torch.server.mapper import EsdfServer, TsdfServer

import torch_parity
from torch_parity import cuda_device  # noqa: F401  (fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOXEL = 0.1


def _sphere_layers(layer_type="tsdf", seed=0):
    """The JAX sim's ground-truth sphere layer (vps 8) and the port's
    copy; TSDF colours are redrawn per voxel so that the nearest-corner
    rule decides every vertex colour."""
    w = jsw.SimulationWorld()
    w.add_sphere((0.0, 0.0, 0.0), 1.0, color=(200, 30, 40))
    bound = 1.0 + 6 * VOXEL
    jl = jsw.generate_gt_layer(
        w.freeze(), layer_type, VOXEL, (-bound,) * 3, (bound,) * 3,
        max_dist=4 * VOXEL, vps=8, max_blocks=512)
    if layer_type == "tsdf":
        import dataclasses
        col = np.random.default_rng(seed).integers(
            0, 256, jl.channels["color"].shape).astype(np.float32)
        ch = dict(jl.channels)
        ch["color"] = jnp.asarray(col)
        jl = dataclasses.replace(jl, channels=ch)
    tl = tlayer.layer_from_numpy(torch_parity.jax_layer_to_numpy(jl), "cpu")
    return jl, tl


def _pools(max_blocks, tri_cap):
    """Both packages start from one (empty) pool."""
    jp = jmesh.make_mesh_pool(max_blocks, tri_cap)
    tp = tmesh.mesh_pool_from_numpy(dict(
        tris=np.asarray(jp.tris), counts=np.asarray(jp.counts),
        overflow_rows=np.asarray(jp.overflow_rows), tri_cap=jp.tri_cap),
        "cpu")
    return jp, tp


def _assert_pools_equal(jp, tp):
    got = tmesh.mesh_pool_to_numpy(tp)
    assert got["tri_cap"] == jp.tri_cap
    np.testing.assert_array_equal(got["counts"], np.asarray(jp.counts))
    np.testing.assert_array_equal(got["overflow_rows"],
                                  np.asarray(jp.overflow_rows))
    ref = np.asarray(jp.tris).reshape(-1, jp.tri_cap, 12)
    tris = got["tris"].reshape(ref.shape)
    np.testing.assert_allclose(tris[..., :9], ref[..., :9], atol=1e-5,
                               rtol=0)
    np.testing.assert_array_equal(
        np.ascontiguousarray(tris[..., 9:]).view(np.uint32),
        np.ascontiguousarray(ref[..., 9:]).view(np.uint32))


def _assert_flags_equal(jl, tl):
    np.testing.assert_array_equal(tl.block_flags.numpy(),
                                  np.asarray(jl.block_flags))


def _assert_same_mesh(got, ref, exact_colors=True):
    assert set(got.blocks) == set(ref.blocks)
    assert len(ref.blocks) > 0
    for key, b in ref.blocks.items():
        a = got.blocks[key]
        assert a.vertices.shape == b.vertices.shape, key
        np.testing.assert_allclose(a.vertices, b.vertices, atol=1e-5)
        np.testing.assert_allclose(a.normals, b.normals, atol=2e-3)
        np.testing.assert_array_equal(a.indices, b.indices)
        if exact_colors:
            np.testing.assert_array_equal(a.colors, b.colors)


def _drain_both(jl, jp, tl, tp, jcfg, tcfg, bucket):
    """Run both update_mesh_pool loops in step until neither has more."""
    calls = 0
    while True:
        jl, jp, jmore = jmesh.update_mesh_pool(jl, jp, jcfg, bucket=bucket)
        tl, tp, tmore = tmesh.update_mesh_pool(tl, tp, tcfg, bucket=bucket)
        calls += 1
        assert bool(jmore) == bool(tmore)
        _assert_flags_equal(jl, tl)
        _assert_pools_equal(jp, tp)
        if not bool(tmore):
            return jl, jp, tl, tp, calls
        assert calls < 64


def test_tables_equal_the_jax_tables():
    np.testing.assert_array_equal(tmc.TRI_TABLE, jmc.TRI_TABLE)
    np.testing.assert_array_equal(tmc.TRI_COUNT, jmc.TRI_COUNT)
    np.testing.assert_array_equal(tmc.CORNERS, jmc.CORNERS)
    np.testing.assert_array_equal(tmc.EDGES, jmc.EDGES)
    assert tmc.MAX_TRIS == jmc.MAX_TRIS == 5


def test_mesh_cubes_on_random_cubes(rng):
    n = 300
    base = rng.uniform(-2, 2, (n, 1, 3)).astype(np.float32)
    pos = base + jmc.CORNERS[None].astype(np.float32) * 0.1
    sdf = rng.uniform(-1, 1, (n, 8)).astype(np.float32)
    sdf[:5] = np.abs(sdf[:5])  # some cubes without a surface
    sdf[5:8] = 0.0  # and degenerate ones
    valid = rng.uniform(size=n) < 0.8
    rv, rm = jmc.mesh_cubes(jnp.asarray(pos), jnp.asarray(sdf),
                            jnp.asarray(valid))
    tv, tm = tmc.mesh_cubes(torch.as_tensor(pos), torch.as_tensor(sdf),
                            torch.as_tensor(valid))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(rm))
    m = np.asarray(rm)
    assert m.sum() > 300
    np.testing.assert_allclose(tv.numpy()[m], np.asarray(rv)[m], atol=1e-6)
    rn = np.asarray(jmc.triangle_normals(rv))[m]
    tn = tmc.triangle_normals(tv).numpy()[m]
    big = np.linalg.norm(np.cross(
        np.asarray(rv)[m][:, 1] - np.asarray(rv)[m][:, 0],
        np.asarray(rv)[m][:, 2] - np.asarray(rv)[m][:, 0]), axis=-1) > 1e-4
    np.testing.assert_allclose(tn[big], rn[big], atol=1e-3)


def test_pool_tsdf_color_small_bucket_and_exports():
    """Bucket smaller than the dirty set: ``more`` is true until the last
    call; pools, flags and all three export paths agree."""
    jl, tl = _sphere_layers()
    jcfg, tcfg = JM(), TM()
    n_dirty = int((tl.block_flags & 2 != 0).sum())
    assert n_dirty > 48
    jp, tp = _pools(512, jcfg.device_tri_cap)
    jl, jp, tl, tp, calls = _drain_both(jl, jp, tl, tp, jcfg, tcfg, 48)
    assert calls == -(-n_dirty // 48) and calls >= 2
    assert int((tl.block_flags & 2 != 0).sum()) == 0  # mesh bit cleared
    assert int((tl.block_flags & 8 != 0).sum()) == n_dirty  # publish bit
    assert not bool(tp.overflow_rows.any())
    assert int(tp.counts.sum()) > 1000
    words = tp.tris.view(512, -1, 12)[..., 9:].contiguous().view(torch.int32)
    assert len(torch.unique(words)) > 100  # per-voxel colours reached it

    ref = jmesh.pool_to_mesh_layer(jl, jp, jmesh.MeshLayer(jl.block_size),
                                   jcfg)
    got = tmesh.pool_to_mesh_layer(tl, tp, tmesh.MeshLayer(tl.block_size),
                                   tcfg)
    _assert_same_mesh(got, ref)

    # The host path (march + compact + transfer per batch of rows).
    ref_h = jmesh.MeshLayer(jl.block_size)
    jmesh.generate_mesh(jl, ref_h, jcfg, only_updated=False,
                        clear_updated_flag=False)
    got_h = tmesh.MeshLayer(tl.block_size)
    tmesh.generate_mesh(tl, got_h, tcfg, only_updated=False,
                        clear_updated_flag=False)
    _assert_same_mesh(got_h, ref_h)
    _assert_same_mesh(got_h, got)

    # Welding.
    rv, rn, rc = ref.combined()
    gv, gn, gc = got.combined()
    # Weld at a tolerance above the two packages' float difference.
    ruv, run, ruc, rinv = jmesh.weld_vertices(rv, rn, rc, tol=1e-3)
    guv, gun, guc, ginv = tmesh.weld_vertices(gv, gn, gc, tol=1e-3)
    assert len(guv) < len(gv) / 3
    np.testing.assert_array_equal(ginv, rinv)
    np.testing.assert_allclose(guv, ruv, atol=1e-5)
    np.testing.assert_array_equal(guc, ruc)
    np.testing.assert_allclose(gun, run, atol=2e-3)

    # Without colour: same triangles, zero colour words.
    _, tl2 = _sphere_layers()
    tp2 = tmesh.make_mesh_pool(512, 512, "cpu")
    more = True
    while more:
        tl2, tp2, more = tmesh.update_mesh_pool(
            tl2, tp2, TM(use_color=False), bucket=64)
    a = tp.tris.view(512, -1, 12)
    b = tp2.tris.view(512, -1, 12)
    assert torch.equal(a[..., :9], b[..., :9])
    assert torch.equal(tp.counts, tp2.counts)
    assert not b[..., 9:].any()


@pytest.mark.parametrize("kw", [dict(device_tri_cap=16),
                                dict(march_cube_budget=512)],
                         ids=["tri_cap_overflow", "cube_budget_spill"])
def test_pool_overflow_rows_match_and_fall_back_to_dense(kw):
    jl, tl = _sphere_layers()
    jcfg, tcfg = JM(**kw), TM(**kw)
    jp, tp = _pools(512, jcfg.device_tri_cap)
    jl, jp, tl, tp, _ = _drain_both(jl, jp, tl, tp, jcfg, tcfg, 64)
    assert bool(tp.overflow_rows.any())
    assert not bool(tp.overflow_rows.all())
    ref = jmesh.pool_to_mesh_layer(jl, jp, jmesh.MeshLayer(jl.block_size),
                                   jcfg)
    got = tmesh.pool_to_mesh_layer(tl, tp, tmesh.MeshLayer(tl.block_size),
                                   tcfg)
    _assert_same_mesh(got, ref)
    # The dense fallback rebuilt the flagged rows: the export equals the
    # mesh of a pool that never overflowed.
    _, tl2 = _sphere_layers()
    tp2 = tmesh.make_mesh_pool(512, 512, "cpu")
    more = True
    while more:
        tl2, tp2, more = tmesh.update_mesh_pool(tl2, tp2, TM(), bucket=64)
    assert not bool(tp2.overflow_rows.any())
    full = tmesh.pool_to_mesh_layer(tl2, tp2, tmesh.MeshLayer(tl.block_size))
    _assert_same_mesh(got, full)


def test_pool_esdf_layer_without_color():
    """An ESDF layer: validity is the observed flag, there is no colour
    channel, and inactive rows drop out of the pool."""
    jl, tl = _sphere_layers("esdf")
    assert "color" not in tl.channels
    jcfg, tcfg = JM(), TM()
    jp, tp = _pools(512, jcfg.device_tri_cap)
    jl, jp, tl, tp, _ = _drain_both(jl, jp, tl, tp, jcfg, tcfg, 64)
    assert int(tp.counts.sum()) > 1000
    assert not tp.tris.view(512, -1, 12)[..., 9:].any()
    ref = jmesh.pool_to_mesh_layer(jl, jp, jmesh.MeshLayer(jl.block_size),
                                   jcfg)
    got = tmesh.pool_to_mesh_layer(tl, tp, tmesh.MeshLayer(tl.block_size),
                                   tcfg)
    _assert_same_mesh(got, ref)
    v, _, _ = got.combined()
    r = np.linalg.norm(v, axis=1)
    assert np.abs(r - 1.0).max() < VOXEL

    # A deactivated block's triangles leave the pool at the next update.
    row = int(torch.nonzero(tp.counts)[0])
    tl.block_flags[row] = 0
    n_before = len(got.blocks)
    tl, tp, _ = tmesh.update_mesh_pool(tl, tp, tcfg, bucket=8)
    assert int(tp.counts[row]) == 0
    got = tmesh.pool_to_mesh_layer(tl, tp, tmesh.MeshLayer(tl.block_size))
    assert len(got.blocks) == n_before - 1


# ---------------------------------------------------------------------------
# Online steps with meshing, end to end
# ---------------------------------------------------------------------------

SETUP = textwrap.dedent("""
    MAP = dict(voxel_size=0.2, max_blocks=512)
    TSDF = dict(default_truncation_distance=0.8, max_ray_length_m=10.0)
    ESDF = dict(max_distance_m=2.0, default_distance_m=2.0,
                min_distance_m=0.4, max_active_blocks=256,
                use_pallas_kernel=True, inner_sweeps=4,
                max_outer_sweeps_incremental=1)
    MESH = dict(update_bucket=8, device_tri_cap=256)
    SERVER = dict(projective_resolution=(64, 48), projective_pool=2,
                  projective_max_visible_blocks=128,
                  projective_max_mixed_slabs=1024,
                  projective_max_free_slabs=256,
                  overflow_check_interval=10_000)
""")
exec(SETUP)

_JAX_SIDE = SETUP + textwrap.dedent("""
    import sys
    import numpy as np
    import jax.numpy as jnp
    sys.path.insert(0, "tests")
    import torch_parity
    from voxblox_tpu.core.config import (
        EsdfIntegratorConfig, MapConfig, MeshIntegratorConfig,
        TsdfIntegratorConfig)
    from voxblox_tpu.server.mapper import EsdfServer

    out_dir = sys.argv[1]
    z = np.load(out_dir + "/scans.npz")
    srv = EsdfServer(
        map_config=MapConfig(**MAP),
        integrator_config=TsdfIntegratorConfig(**TSDF),
        esdf_config=EsdfIntegratorConfig(**ESDF),
        mesh_config=MeshIntegratorConfig(**MESH), method="projective",
        projective_fov_deg=float(z["fov"]),
        projective_intrinsics=tuple(float(v) for v in z["intr"]), **SERVER)
    res = {}
    for i in range(len(z["R"])):
        srv.insert_pointcloud_and_update_esdf(
            (jnp.asarray(z["R"][i]), jnp.asarray(z["t"][i])),
            z["pts"][i], z["col"][i])
        srv.update_mesh()
    srv.check_overflow()
    for k, v in torch_parity.jax_layer_to_numpy(srv.layer).items():
        res["tsdf/" + k] = np.asarray(v)
    for k, v in torch_parity.jax_layer_to_numpy(srv.esdf_layer).items():
        res["esdf/" + k] = np.asarray(v)
    for k in ("tris", "counts", "overflow_rows"):
        res["pool/" + k] = np.asarray(getattr(srv.mesh_pool, k))
    res["more"] = np.asarray(bool(srv._mesh_more))
    ml = srv.generate_mesh()
    v, n, c = ml.combined()
    res["mesh_v"], res["mesh_c"] = v, c
    res["mesh_keys"] = np.asarray(sorted(ml.blocks))
    np.savez(out_dir + "/jax.npz", **res)
""")


def test_online_steps_with_mesh_match_jax_end_to_end(tmp_path):
    from test_torch_server import FOV_DEG, _layer_dict, _orbit
    from voxblox_tpu_torch.sim import world as tsw

    w = tsw.SimulationWorld()
    w.add_cylinder((0.0, 0.0, 2.0), 2.0, 4.0, color=(0, 255, 0))
    w.add_ground_level(0.0)
    scans = _orbit(w.freeze("cpu"), [0.0, 2 * np.pi / 32], True)
    intr = scans[0][4]
    np.savez(tmp_path / "scans.npz",
             R=np.stack([s[0].numpy() for s in scans]),
             t=np.stack([s[1].numpy() for s in scans]),
             pts=np.stack([s[2].numpy() for s in scans]),
             col=np.stack([s[3].numpy() for s in scans]),
             fov=np.asarray(FOV_DEG), intr=np.asarray(intr))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, "-c", _JAX_SIDE, str(tmp_path)],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    z = np.load(tmp_path / "jax.npz")

    srv = EsdfServer(
        map_config=MapConfig(**MAP),
        integrator_config=TsdfIntegratorConfig(**TSDF),
        esdf_config=EsdfIntegratorConfig(**ESDF), mesh_config=TM(**MESH),
        method="projective", projective_fov_deg=FOV_DEG, projective_intrinsics=intr,
        device="cpu", **SERVER)
    assert srv.mesh_config.update_bucket == 8
    for R, t, pts, col, _ in scans:
        srv.insert_pointcloud_and_update_esdf((R, t), pts, col)
        srv.update_mesh()
    srv.check_overflow()
    torch_parity.assert_layers_equal(
        _layer_dict(z, "tsdf/"), tlayer.layer_to_numpy(srv.layer), atol=1e-4,
        channels=["tsdf", "weight"])
    ref_e = _layer_dict(z, "esdf/")
    got_e = tlayer.layer_to_numpy(srv.esdf_layer)
    torch_parity.assert_layers_equal(ref_e, got_e, atol=1e-4,
                                     channels=["esdf"])
    np.testing.assert_array_equal(got_e["channel/esdf_flags"],
                                  ref_e["channel/esdf_flags"])
    got = tmesh.mesh_pool_to_numpy(srv.mesh_pool)
    np.testing.assert_array_equal(got["counts"], z["pool/counts"])
    np.testing.assert_array_equal(got["overflow_rows"],
                                  z["pool/overflow_rows"])
    assert got["counts"].sum() > 50
    assert bool(srv._mesh_more) == bool(z["more"]) is True
    cap = MESH["device_tri_cap"]
    a = got["tris"].reshape(-1, cap, 12)
    b = z["pool/tris"].reshape(-1, cap, 12)
    # Vertices as the pool-level tests hold them (the TSDF values under
    # them agree far inside the layer check's 1e-4 here). The blended
    # voxel colours differ by a float ulp, which the truncation to 8 bits
    # can turn into one step: hold colour channels to 1.
    np.testing.assert_allclose(a[..., :9], b[..., :9], atol=1e-5)

    def channels(words):
        w = np.ascontiguousarray(words).view(np.uint32).astype(np.int64)
        return np.stack([w & 0xFF, (w >> 8) & 0xFF, (w >> 16) & 0xFF], -1)

    ca, cb = channels(a[..., 9:]), channels(b[..., 9:])
    assert np.abs(ca - cb).max() <= 1
    assert (ca != cb).mean() < 1e-3
    assert ca.max() == 255
    ml = srv.generate_mesh()
    assert sorted(ml.blocks) == [tuple(k) for k in z["mesh_keys"].tolist()]
    v, _, c = ml.combined()
    assert v.shape == z["mesh_v"].shape
    np.testing.assert_allclose(v, z["mesh_v"], atol=1e-5)
    assert np.abs(c.astype(np.int64) - z["mesh_c"]).max() <= 1
    assert int((srv.layer.block_flags & 2 != 0).sum()) == 0
    with pytest.raises(NotImplementedError):
        srv.generate_mesh("mesh.ply")
    srv.clear()
    assert int(srv.layer.num_blocks) == 0
    assert int(srv.mesh_pool.counts.sum()) == 0


def test_tsdf_server_meshes_without_esdf():
    """TsdfServer.update_mesh / generate_mesh on the port alone: the mesh
    of a flat-scan map lies on the scene's surfaces."""
    from test_torch_server import FOV_DEG, _orbit
    from voxblox_tpu_torch.sim import world as tsw

    w = tsw.SimulationWorld()
    w.add_cylinder((0.0, 0.0, 2.0), 2.0, 4.0, color=(0, 255, 0))
    w.add_ground_level(0.0)
    scans = _orbit(w.freeze("cpu"), [0.0, 0.7], False)
    srv = TsdfServer(
        map_config=MapConfig(voxel_size=0.2, max_blocks=256),
        integrator_config=TsdfIntegratorConfig(**TSDF),
        mesh_config=TM(update_bucket=16), method="projective",
        projective_resolution=(64, 48),
        projective_fov_deg=FOV_DEG, device="cpu")
    for R, t, pts, col, _ in scans:
        srv.insert_pointcloud((R, t), pts, col)
        srv.update_mesh()
    ml = srv.generate_mesh()
    assert srv._mesh_more is None
    v, n, c = ml.combined()
    assert len(v) > 300 and np.isfinite(v).all()
    err = np.minimum(np.abs(np.hypot(v[:, 0], v[:, 1]) - 2.0),
                     np.abs(v[:, 2]))
    assert np.median(err) < 0.05 and err.max() < 0.4
    assert not bool(srv.mesh_pool.overflow_rows.any())


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_cuda_k2_matches_plain(cuda_device):
    from test_torch_esdf_strided import _structured_fields

    strides = (8, 4, 2, 1, 1, 1, 1)
    d, obs, upd = _structured_fields(np.random.default_rng(5), 64)
    act = np.random.default_rng(6).uniform(size=64) < 0.6
    ts = [torch.as_tensor(x, device=cuda_device) for x in (d, obs, upd, act)]
    codes = tesdf.stride_codes_standalone(ts[0], ts[2], strides)
    before = trelax.LAUNCHES, trelax.STRIDED_LAUNCHES
    got = trelax.relax(*ts, 4, 0.05, 2.0, 0.001, strides=strides,
                       codes=codes)
    torch.cuda.synchronize()
    assert (trelax.LAUNCHES, trelax.STRIDED_LAUNCHES) == (
        before[0] + 1, before[1] + 1)
    ref = trelax.relax_plain(*ts, 4, 0.05, 2.0, 0.001, strides=strides,
                             codes=codes)
    assert torch.equal(got, ref)


@pytest.mark.cuda
def test_cuda_mesh_matches_cpu_mesh(cuda_device):
    _, tl = _sphere_layers()
    gl = tlayer.layer_from_numpy(tlayer.layer_to_numpy(tl), cuda_device)
    pools = []
    for layer, dev in ((tl, "cpu"), (gl, cuda_device)):
        pool = tmesh.make_mesh_pool(512, 512, dev)
        more = True
        while more:
            layer, pool, more = tmesh.update_mesh_pool(layer, pool, TM(),
                                                       bucket=48)
        pools.append(tmesh.mesh_pool_to_numpy(pool))
    np.testing.assert_array_equal(pools[1]["counts"], pools[0]["counts"])
    np.testing.assert_array_equal(pools[1]["overflow_rows"],
                                  pools[0]["overflow_rows"])
    a = pools[1]["tris"].reshape(512, -1, 12)
    b = pools[0]["tris"].reshape(512, -1, 12)
    np.testing.assert_allclose(a[..., :9], b[..., :9], atol=1e-5)
    np.testing.assert_array_equal(
        np.ascontiguousarray(a[..., 9:]).view(np.uint32),
        np.ascontiguousarray(b[..., 9:]).view(np.uint32))
