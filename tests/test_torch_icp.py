"""Port parity, ICP and the planning prior: utils/lie, ops/icp (given the
JAX package's batch order), the server with ``enable_icp``,
``add_new_robot_position`` and the clear-sphere server.

Inputs come from the JAX sim (the scene of tests/test_icp.py) and go to
both packages through numpy; the port runs with ``device="cpu"``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voxblox_tpu.core import config as jcfg
from voxblox_tpu.ops import icp as jicp
from voxblox_tpu.server.mapper import EsdfServer as JEsdfServer
from voxblox_tpu.server.mapper import TsdfServer as JTsdfServer
from voxblox_tpu.sim import world as jsw
from voxblox_tpu.utils import lie as jlie
from voxblox_tpu.utils import planning as jplan
from voxblox_tpu_torch import _runtime
from voxblox_tpu_torch.core import config as tcfg
from voxblox_tpu_torch.core import layer as tlayer
from voxblox_tpu_torch.ops import icp as ticp
from voxblox_tpu_torch.server.mapper import EsdfServer, TsdfServer
from voxblox_tpu_torch.utils import lie as tlie
from voxblox_tpu_torch.utils import planning as tplan

import torch_parity
from torch_parity import cuda_device  # noqa: F401  (fixture)

R_TRUE = np.array([[0.0, 0.0, 1.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0]],
                  np.float32)
T_TRUE = np.array([-3.0, 0.5, 1.0], np.float32)


def _t(x):
    return torch.as_tensor(np.array(x))


def _jax_perm(n):
    return np.asarray(jax.random.permutation(jax.random.PRNGKey(0), n))


def _scene():
    """tests/test_icp.py's scene: a GT TSDF (0.08 m, vps 8) and a 64x48
    scan from the true pose, in sensor coordinates."""
    w = jsw.SimulationWorld()
    w.add_cube((0.0, 0.0, 1.0), (1.5, 2.5, 2.0))
    w.add_sphere((2.0, -1.0, 1.0), 0.8)
    w.add_ground_level(0.0)
    objs = w.freeze()
    layer = jsw.generate_gt_layer(objs, "tsdf", 0.08, (-4.0, -4.0, -0.4),
                                  (4.0, 4.0, 3.5), max_dist=0.5, vps=8,
                                  max_blocks=4096)
    pose = (jnp.asarray(R_TRUE), jnp.asarray(T_TRUE))
    pts_G, _, valid = jsw.pointcloud_from_transform(
        objs, pose, (64, 48), np.deg2rad(70.0), 8.0)
    pts_C = np.asarray(jsw.world_points_to_sensor(pose, pts_G, valid))
    return layer, pts_C


def _rot(axis, deg):
    a = np.deg2rad(deg)
    c, s = np.cos(a), np.sin(a)
    i, j = [(1, 2), (2, 0), (0, 1)][axis]
    m = np.eye(3)
    m[i, i], m[i, j], m[j, i], m[j, j] = c, -s, s, c
    return m.astype(np.float32)


def test_icp_config_matches():
    assert (dataclasses.asdict(tcfg.IcpConfig())
            == dataclasses.asdict(jcfg.IcpConfig()))
    for v in (0.05, 0.2):
        assert tcfg.derive_defaults(v) == tuple(
            tcfg.config_from_dict(type(c).__name__, dataclasses.asdict(c))
            for c in jcfg.derive_defaults(v))


def test_lie_matches_jax(rng):
    """exp, log, hat, compose and inverse on random inputs, the small-angle
    branches (theta < 1e-6) included: atol 1e-6."""
    for scale in (0.7, 1e-3, 1e-7, 0.0):
        for _ in range(10):
            xi = (rng.uniform(-1, 1, 6) * scale).astype(np.float32)
            R, t = jlie.se3_exp(jnp.asarray(xi))
            tR, tt = tlie.se3_exp(_t(xi))
            np.testing.assert_allclose(tR.numpy(), np.asarray(R), atol=1e-6)
            np.testing.assert_allclose(tt.numpy(), np.asarray(t), atol=1e-6)
            np.testing.assert_allclose(
                tlie.se3_log(_t(R), _t(t)).numpy(),
                np.asarray(jlie.se3_log(R, t)), atol=1e-6)
            np.testing.assert_allclose(
                tlie.so3_exp(_t(xi[3:])).numpy(),
                np.asarray(jlie.so3_exp(jnp.asarray(xi[3:]))), atol=1e-6)
            np.testing.assert_array_equal(
                tlie.hat(_t(xi[:3])).numpy(),
                np.asarray(jlie.hat(jnp.asarray(xi[:3]))))
            T2 = jlie.se3_exp(jnp.asarray(xi[::-1].copy()))
            ref = jlie.compose(jlie.inverse((R, t)), T2)
            got = tlie.compose(tlie.inverse((tR, tt)), (_t(T2[0]), _t(T2[1])))
            for a, b in zip(got, ref):
                np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                           atol=1e-6)


@pytest.mark.parametrize("roll_pitch", [False, True], ids=["yaw", "rp"])
def test_run_icp_matches_jax_with_its_order(roll_pitch):
    layer, pts_C = _scene()
    R_bad = (_rot(0, 2.0) if roll_pitch else _rot(2, 2.0)) @ R_TRUE
    t_bad = T_TRUE + np.array([0.05, -0.04, 0.03], np.float32)
    kw = dict(mini_batch_size=64, refine_roll_pitch=roll_pitch,
              inital_translation_weighting=10.0,
              inital_rotation_weighting=10.0)
    ref = jicp.run_icp(layer, jnp.asarray(pts_C),
                       (jnp.asarray(R_bad), jnp.asarray(t_bad)),
                       jcfg.IcpConfig(**kw))
    tl = tlayer.layer_from_numpy(torch_parity.jax_layer_to_numpy(layer), "cpu")
    syncs = _runtime.SYNCS
    got = ticp.run_icp(tl, _t(pts_C), (_t(R_bad), _t(t_bad)),
                       tcfg.IcpConfig(**kw), perm=_t(_jax_perm(len(pts_C))))
    assert _runtime.SYNCS - syncs == 1  # the probe bound, once
    assert int(got.num_updates) == int(ref.num_updates) > 5
    np.testing.assert_allclose(got.R.numpy(), np.asarray(ref.R), atol=1e-5)
    np.testing.assert_allclose(got.t.numpy(), np.asarray(ref.t), atol=1e-5)
    # The refinement itself (tests/test_icp.py's margins).
    r_before = np.linalg.norm(tlie.so3_log(_t(R_bad @ R_TRUE.T)).numpy())
    r_after = np.linalg.norm(tlie.so3_log(got.R @ _t(R_TRUE).T).numpy())
    assert r_after < 0.7 * r_before
    # The port's own order refines too (it is another order, not JAX's).
    own = ticp.run_icp(tl, _t(pts_C), (_t(R_bad), _t(t_bad)),
                       tcfg.IcpConfig(**kw))
    t_after = np.linalg.norm(own.t.numpy() - T_TRUE)
    assert t_after < 0.6 * np.linalg.norm(t_bad - T_TRUE)


def test_kabsch_matches_svd(rng):
    """The Jacobi 3x3 Kabsch against numpy's SVD rule, reflections and a
    rank-2 (planar) cross-covariance included."""
    for k in range(40):
        H = rng.standard_normal((3, 3))
        if k % 4 == 3:
            H[:, 2] = H[:, 0] * 0.3 - H[:, 1] * 1.7  # rank 2
        u, s, vt = np.linalg.svd(H)
        d = np.sign(np.linalg.det(vt.T @ u.T))
        ref = vt.T @ np.diag([1.0, 1.0, d]) @ u.T
        got = ticp._kabsch(torch.as_tensor(H)).numpy()
        np.testing.assert_allclose(got, ref, atol=1e-9)


def _orbit_scans(n, res=(64, 48)):
    """Flat scans of the cylinder + ground orbit (the JAX sim)."""
    w = jsw.SimulationWorld()
    w.add_cylinder((0.0, 0.0, 2.0), 2.0, 4.0, color=(0, 255, 0))
    w.add_ground_level(0.0)
    objs = w.freeze()
    out = []
    for i in range(n):
        a = 2 * np.pi * i / 16
        pos = np.array([4.0 * np.cos(a), 4.0 * np.sin(a), 2.0], np.float32)
        view = jnp.asarray([-np.cos(a), -np.sin(a), 0.0], jnp.float32)
        R = np.array(jsw.rotation_from_two_vectors(
            jnp.asarray([0.0, 0.0, 1.0]), view))
        pts, cols, _, _ = jsw.organized_pointcloud_from_transform(
            objs, (jnp.asarray(R), jnp.asarray(pos)), res, np.deg2rad(60.0),
            8.0)
        out.append((R, pos, np.array(pts).reshape(-1, 3),
                    np.array(cols).reshape(-1, 3)))
    return out


SERVER = dict(method="projective", projective_resolution=(64, 48),
              projective_fov_deg=60.0)


def _configs(pkg):
    return dict(map_config=pkg.MapConfig(voxel_size=0.2, max_blocks=512),
                integrator_config=pkg.TsdfIntegratorConfig(
                    default_truncation_distance=0.8, max_ray_length_m=10.0))


def test_server_icp_matches_jax(monkeypatch):
    """Three scans through both servers with ``enable_icp`` (the port
    given JAX's batch order), the last from a pose 2 deg and 5 cm off: the
    refined poses and the maps agree."""
    scans = _orbit_scans(3)
    monkeypatch.setattr(ticp, "default_perm",
                        lambda n, dev: _t(_jax_perm(n)).to(dev))
    icp = dict(mini_batch_size=64, min_match_ratio=0.15,
               inital_translation_weighting=10.0,
               inital_rotation_weighting=10.0)
    jsrv = JTsdfServer(enable_icp=True, icp_config=jcfg.IcpConfig(**icp),
                       **_configs(jcfg), **SERVER)
    tsrv = TsdfServer(enable_icp=True, icp_config=tcfg.IcpConfig(**icp),
                      device="cpu", **_configs(tcfg), **SERVER)
    for i, (R, pos, pts, cols) in enumerate(scans):
        if i == 2:
            R = _rot(2, 2.0) @ R
            pos = pos + np.array([0.05, -0.03, 0.0], np.float32)
        jT = jsrv.insert_pointcloud((jnp.asarray(R), jnp.asarray(pos)), pts,
                                    cols)
        tT = tsrv.insert_pointcloud((_t(R), _t(pos)), pts, cols)
        np.testing.assert_allclose(tT[0].numpy(), np.asarray(jT[0]),
                                   atol=1e-5)
        np.testing.assert_allclose(tT[1].numpy(), np.asarray(jT[1]),
                                   atol=1e-5)
    assert not np.allclose(tsrv.icp_corrected[1].numpy(), pos)
    torch_parity.assert_layers_equal(
        torch_parity.jax_layer_to_numpy(jsrv.layer),
        tlayer.layer_to_numpy(tsrv.layer), atol=1e-4)
    assert tsrv.stats()["timing"]["icp"]["calls"] == 2


def test_add_new_robot_position_exact():
    """The robot-position prior on an ESDF layer that has observed voxels
    (the JAX sim's ground-truth ESDF of a sphere): blocks, flags and
    distances exact."""
    w = jsw.SimulationWorld()
    w.add_sphere((0.0, 0.0, 0.0), 0.6)
    jl = jsw.generate_gt_layer(w.freeze(), "esdf", 0.1, (-1.0,) * 3,
                               (1.0,) * 3, max_dist=1.0, vps=8,
                               max_blocks=1024)
    tl = tlayer.layer_from_numpy(torch_parity.jax_layer_to_numpy(jl), "cpu")
    kw = dict(clear_sphere_radius=0.7, occupied_sphere_radius=1.6,
              default_distance_m=1.0, max_distance_m=1.0)
    for pos in ([0.9, 0.1, -0.2], [-1.3, 0.45, 0.8]):
        p = np.asarray(pos, np.float32)
        jl, jovf = jplan.add_new_robot_position(
            jl, jnp.asarray(p), jcfg.EsdfIntegratorConfig(**kw))
        tl, tovf = tplan.add_new_robot_position(
            tl, _t(p), tcfg.EsdfIntegratorConfig(**kw))
        assert bool(jovf) == bool(tovf) is False
        torch_parity.assert_layers_equal(torch_parity.jax_layer_to_numpy(jl),
                                         tlayer.layer_to_numpy(tl))
    hall = (tl.channels["esdf_flags"] & tlayer.ESDF_HALLUCINATED) != 0
    assert int(hall.sum()) > 1000
    # fill/clear spheres and the map bounds.
    for fn in ("fill_sphere", "clear_sphere"):
        jl, _ = getattr(jplan, fn)(jl, jnp.asarray([0.2, 0.2, 0.2]), 0.35, 1.0)
        tl, _ = getattr(tplan, fn)(tl, _t(np.float32([0.2, 0.2, 0.2])), 0.35,
                                   1.0)
        torch_parity.assert_layers_equal(torch_parity.jax_layer_to_numpy(jl),
                                         tlayer.layer_to_numpy(tl))
    for a, b in zip(tplan.map_bounds(tl), jplan.map_bounds(jl)):
        np.testing.assert_array_equal(a, b)


def test_clear_sphere_server_matches_jax():
    """EsdfServer(clear_sphere_for_planning=True): two scans through both
    servers; the ESDF layer holds the robot-position priors, exact."""
    scans = _orbit_scans(2)
    jsrv = JEsdfServer(clear_sphere_for_planning=True, **_configs(jcfg),
                       **SERVER)
    tsrv = EsdfServer(clear_sphere_for_planning=True, device="cpu",
                      **_configs(tcfg), **SERVER)
    for R, pos, pts, cols in scans:
        jsrv.insert_pointcloud((jnp.asarray(R), jnp.asarray(pos)), pts, cols)
        tsrv.insert_pointcloud((_t(R), _t(pos)), pts, cols)
    torch_parity.assert_layers_equal(
        torch_parity.jax_layer_to_numpy(jsrv.esdf_layer),
        tlayer.layer_to_numpy(tsrv.esdf_layer))
    assert int(tsrv.esdf_layer.num_blocks) > 0
    assert "esdf/clear_radius" in tsrv.stats()["timing"]


@pytest.mark.cuda
@pytest.mark.parametrize("roll_pitch", [False, True], ids=["yaw", "rp"])
def test_icp_steps_do_not_sync_on_the_card(cuda_device, roll_pitch):
    layer, pts_C = _scene()
    tl = tlayer.layer_from_numpy(torch_parity.jax_layer_to_numpy(layer),
                                 cuda_device)
    cfg = tcfg.IcpConfig(mini_batch_size=64, refine_roll_pitch=roll_pitch)
    pts = _t(pts_C).to(cuda_device)
    pose = (_t(R_TRUE).to(cuda_device), _t(T_TRUE).to(cuda_device))
    ref = ticp.run_icp(tl, pts, pose, cfg)  # warm the constants
    psl = int(tl.table.max_psl)
    ordered = pts[ticp.default_perm(len(pts_C), cuda_device)]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = ticp.icp_steps(tl, ordered, *pose, cfg, psl)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.equal(got.R, ref.R) and torch.equal(got.t, ref.t)
    cpu = ticp.run_icp(tlayer.layer_from_numpy(tlayer.layer_to_numpy(tl),
                                               "cpu"), _t(pts_C),
                       (_t(R_TRUE), _t(T_TRUE)), cfg)
    np.testing.assert_allclose(got.R.cpu().numpy(), cpu.R.numpy(), atol=1e-4)
    np.testing.assert_allclose(got.t.cpu().numpy(), cpu.t.numpy(), atol=1e-4)
