"""Port parity, occupancy and intensity: the occupancy config and the
log-odds helpers, ``occupancy.integrate_pointcloud``,
``esdf_from_occupancy_batch`` (plain sweep against the JAX XLA sweep;
the kernel path against the JAX Pallas kernel, interpreted),
``add_intensity_bearing_vectors`` and ``IntensityServer`` against the JAX
package on the CPU (tests/test_occupancy_intensity.py's scenes).

Tolerances: occupancy layers equal (rows, flags, log-odds within 1e-6);
ESDF flags equal and distances within 1e-5; intensity layers equal
(values within 1e-5, the last lane winning a voxel as in JAX).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voxblox_tpu.core import config as jcfg
from voxblox_tpu.core import grid as jgrid
from voxblox_tpu.core import layer as jlayer
from voxblox_tpu.ops import intensity as jintensity
from voxblox_tpu.ops import occupancy as jocc
from voxblox_tpu.server.mapper import IntensityServer as JIntensityServer
from voxblox_tpu.sim import world as jsw
from voxblox_tpu_torch.core import config as tcfg
from voxblox_tpu_torch.core import grid as tgrid
from voxblox_tpu_torch.core import layer as tlayer
from voxblox_tpu_torch.ops import intensity as tintensity
from voxblox_tpu_torch.ops import occupancy as tocc
from voxblox_tpu_torch.server.mapper import IntensityServer

import torch_parity

VIEWS = ([0.0, -4.0, 2.0], [0.0, 4.0, 2.0], [4.0, 0.0, 2.0])


def _t(x):
    return torch.as_tensor(np.array(x))


def _sphere_world():
    w = jsw.SimulationWorld()
    w.add_sphere((0.0, 0.0, 2.0), 1.0)
    return w.freeze()


def _scan(objs, origin):
    view = np.asarray([0.0, 0.0, 2.0]) - np.asarray(origin)
    view = view / np.linalg.norm(view)
    pts, _, valid = jsw.pointcloud_from_viewpoint(
        objs, origin, view, (48, 36), np.deg2rad(60.0), 8.0)
    R = jsw.rotation_from_two_vectors(jnp.asarray([0.0, 0.0, 1.0]),
                                      jnp.asarray(view, jnp.float32))
    pose = (R, jnp.asarray(origin, jnp.float32))
    return pose, jsw.world_points_to_sensor(pose, pts, valid)


def _np(layer):
    return torch_parity.jax_layer_to_numpy(layer)


def test_occupancy_config_and_log_odds_match():
    ref = dataclasses.asdict(jcfg.OccupancyIntegratorConfig())
    assert dataclasses.asdict(tcfg.OccupancyIntegratorConfig()) == ref
    rebuilt = tcfg.config_from_dict("OccupancyIntegratorConfig", ref)
    assert dataclasses.asdict(rebuilt) == ref
    p = np.random.default_rng(0).uniform(0.01, 0.99, 1000).astype(np.float32)
    lo = np.asarray(jgrid.log_odds_from_probability(jnp.asarray(p)))
    np.testing.assert_allclose(tgrid.log_odds_from_probability(_t(p)).numpy(),
                               lo, atol=1e-6)
    np.testing.assert_allclose(
        tgrid.probability_from_log_odds(_t(lo)).numpy(),
        np.asarray(jgrid.probability_from_log_odds(jnp.asarray(lo))),
        atol=1e-6)


_OCC = {}


def _occupancy_layers():
    """Three views of the sphere, each integrated twice, through both
    packages (cached: the ESDF test starts from these layers)."""
    if not _OCC:
        objs = _sphere_world()
        cfg = dict(max_ray_length_m=8.0)
        jl = jlayer.make_layer("occupancy", 0.1, vps=16, max_blocks=96)
        tl = tlayer.make_layer("occupancy", 0.1, vps=16, max_blocks=96,
                               device="cpu")
        for origin in VIEWS:
            pose, pts_C = _scan(objs, origin)
            for _ in range(2):
                jl, j_ovf = jocc.integrate_pointcloud(
                    jl, pose, pts_C, jcfg.OccupancyIntegratorConfig(**cfg))
                tl, t_ovf = tocc.integrate_pointcloud(
                    tl, tuple(_t(x) for x in pose), _t(pts_C),
                    tcfg.OccupancyIntegratorConfig(**cfg))
                assert not bool(j_ovf) and not bool(t_ovf)
        _OCC.update(jax=jl, torch=tl)
    return _OCC["jax"], _OCC["torch"]


def test_occupancy_integration_matches_jax():
    jl, tl = _occupancy_layers()
    ref, got = _np(jl), tlayer.layer_to_numpy(tl)
    torch_parity.assert_layers_equal(ref, got, atol=1e-6)
    obs = ref["channel/occ_observed"] != 0
    assert obs.sum() > 5_000
    lo = ref["channel/log_odds"]
    assert (lo[obs] > 0).sum() > 500 and (lo[obs] < 0).sum() > 5_000
    p = tocc.occupancy_probability(tl).numpy()
    np.testing.assert_allclose(
        p, np.asarray(jocc.occupancy_probability(jl)), atol=1e-6)


@pytest.mark.parametrize("kernel", [False, True], ids=["plain", "kernel"])
def test_esdf_from_occupancy_matches_jax(kernel):
    """The JAX XLA sweep against the port's plain sweep; with
    ``use_pallas_kernel`` the JAX kernel (interpreted) against the port's
    kernel path (its plain version on the CPU)."""
    jl, _ = _occupancy_layers()
    occ = _np(jl)
    ecfg = dict(max_distance_m=2.0, default_distance_m=2.0,
                use_pallas_kernel=kernel, inner_sweeps=4)
    je = jlayer.make_layer("esdf", 0.1, vps=16, max_blocks=96)
    je, j_ovf, j_it = jocc.esdf_from_occupancy_batch(
        je, jl, jcfg.EsdfIntegratorConfig(**ecfg))
    te = tlayer.make_layer("esdf", 0.1, vps=16, max_blocks=96, device="cpu")
    te, t_ovf, t_it = tocc.esdf_from_occupancy_batch(
        te, tlayer.layer_from_numpy(occ, "cpu"),
        tcfg.EsdfIntegratorConfig(**ecfg))
    assert not bool(j_ovf) and not bool(t_ovf)
    assert int(t_it) == int(j_it) > 1
    torch_parity.assert_layers_equal(_np(je), tlayer.layer_to_numpy(te),
                                     atol=1e-5)
    flags = tlayer.layer_to_numpy(te)["channel/esdf_flags"]
    assert ((flags & 2) != 0).sum() > 500  # occupied voxels seed fixed


def _gt_sphere():
    bound = 1.8
    return jsw.generate_gt_layer(
        _sphere_world(), "tsdf", 0.1, (-bound, -bound, 2 - bound),
        (bound, bound, 2 + bound), max_dist=0.4, vps=8, max_blocks=1024)


def test_intensity_splat_matches_jax():
    """Neighbouring rays share voxels: the splat sums and the
    neighbourhood fill's last lane must match JAX."""
    j_tsdf = _gt_sphere()
    t_tsdf = tlayer.layer_from_numpy(_np(j_tsdf), "cpu")
    n = 256
    ang = np.linspace(-0.3, 0.3, n)
    el = np.random.default_rng(1).uniform(-0.2, 0.2, n)
    bearings = (np.stack([np.sin(ang) * np.cos(el), np.cos(ang) * np.cos(el),
                          np.sin(el)], -1) * 2.0).astype(np.float32)
    temps = np.random.default_rng(2).uniform(20.0, 40.0, n).astype(np.float32)
    origin = np.asarray([0.0, -3.0, 2.0], np.float32)
    jl = jlayer.make_layer("intensity", 0.1, vps=8, max_blocks=1024)
    tl = tlayer.make_layer("intensity", 0.1, vps=8, max_blocks=1024,
                           device="cpu")
    for _ in range(2):  # the second pass updates observed voxels
        jl, j_hit = jintensity.add_intensity_bearing_vectors(
            jl, j_tsdf, jnp.asarray(origin), jnp.asarray(bearings),
            jnp.asarray(temps))
        tl, t_hit = tintensity.add_intensity_bearing_vectors(
            tl, t_tsdf, _t(origin), _t(bearings), _t(temps))
        np.testing.assert_array_equal(t_hit.numpy(), np.asarray(j_hit))
        temps = temps[::-1].copy()
    assert int(t_hit.sum()) > n // 2
    ref, got = _np(jl), tlayer.layer_to_numpy(tl)
    torch_parity.assert_layers_equal(ref, got, atol=1e-5)
    w = got["channel/intensity_weight"]
    assert (w == 1.0).sum() > 100 and (w > 1.0).sum() > 50


def test_intensity_server_image_matches_jax():
    j_tsdf = _gt_sphere()
    mc = dict(voxel_size=0.1, max_blocks=1024)
    R = np.asarray(jsw.rotation_from_two_vectors(
        jnp.asarray([0.0, 0.0, 1.0]), jnp.asarray([0.0, 1.0, 0.0])))
    pose = (R, np.array([0.0, -3.0, 2.0], np.float32))
    img = np.random.default_rng(3).uniform(30.0, 45.0, (24, 32)).astype(
        np.float32)
    intr = (30.0, 30.0, 16.0, 12.0)
    js = JIntensityServer(map_config=jcfg.MapConfig(**mc))
    js.layer = j_tsdf
    js.intensity_layer = jlayer.make_layer("intensity", 0.1, vps=8,
                                           max_blocks=1024)
    ref_hits = js.insert_intensity_image(pose, img, intr, subsample=2)
    ts = IntensityServer(map_config=tcfg.MapConfig(**mc), device="cpu")
    ts.layer = tlayer.layer_from_numpy(_np(j_tsdf), "cpu")
    ts.intensity_layer = tlayer.make_layer("intensity", 0.1, vps=8,
                                           max_blocks=1024, device="cpu")
    hits = ts.insert_intensity_image(pose, img, intr, subsample=2)
    assert hits == ref_hits > 10
    torch_parity.assert_layers_equal(_np(js.intensity_layer),
                                     tlayer.layer_to_numpy(ts.intensity_layer),
                                     atol=1e-5)


def test_pool_overflow_reports_not_raises():
    """A scan that needs more blocks than the pool holds: both packages
    report the overflow and update the blocks that fit; the keys past the
    pool read as missing (they once raised IndexError in the port)."""
    objs = _sphere_world()
    pose, pts_C = _scan(objs, VIEWS[0])
    cfg = dict(max_ray_length_m=8.0)
    jl = jlayer.make_layer("occupancy", 0.1, vps=16, max_blocks=4)
    jl, j_ovf = jocc.integrate_pointcloud(
        jl, pose, pts_C, jcfg.OccupancyIntegratorConfig(**cfg))
    tl = tlayer.make_layer("occupancy", 0.1, vps=16, max_blocks=4,
                           device="cpu")
    tl, t_ovf = tocc.integrate_pointcloud(
        tl, tuple(_t(x) for x in pose), _t(pts_C),
        tcfg.OccupancyIntegratorConfig(**cfg))
    assert bool(j_ovf) and bool(t_ovf)
    torch_parity.assert_layers_equal(_np(jl), tlayer.layer_to_numpy(tl),
                                     atol=1e-6)
    assert int(tlayer.layer_to_numpy(tl)["table/count"]) > 4
    past = _t(np.asarray([[0, -3, 1]], np.int32))  # on the ray, past row 3
    assert int(tlayer.lookup_blocks(tl, past)[0]) == -1
