"""Port parity, the slice end to end: the online mapping step.

Three organized scans of the sim orbit, rendered by the port's own sim
(and checked against the JAX sim), go through the JAX
``EsdfServer.insert_pointcloud_and_update_esdf`` (Pallas kernel
interpreted, inner_sweeps=4, max_outer_sweeps_incremental=1) and the
port's ``EsdfServer(device="cpu")``. After ``check_overflow`` the block
set and rows, TSDF/weight (atol 1e-4), ESDF (atol 1e-4), projective
budgets and outer-iteration counts must agree. A grow-and-retry run with
an undersized mixed-slab budget must end at the same budget rungs and
the same map.

The JAX side runs in a subprocess that writes numpy arrays to
``tmp_path``: its programs (the fused step at every budget rung) stay
out of the pytest worker, whose JAX CPU backend has a bounded program
budget (tests/conftest.py).
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from voxblox_tpu_torch.core import layer as tlayer
from voxblox_tpu_torch.core.config import (
    EsdfIntegratorConfig, MapConfig, TsdfIntegratorConfig)
from voxblox_tpu_torch.server.mapper import EsdfServer, TsdfServer
from voxblox_tpu_torch.sim import world as tsw

import torch_parity

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FOV_DEG = 60.0
RES = (128, 96)  # organized raster; pool 2 -> 64x48 virtual image

# Shared by both sides (the subprocess re-creates the same dicts).
SETUP = textwrap.dedent("""
    MAP = dict(voxel_size=0.2, max_blocks=1024)
    TSDF = dict(default_truncation_distance=0.8, max_ray_length_m=10.0)
    ESDF = dict(max_distance_m=2.0, default_distance_m=2.0,
                min_distance_m=0.4, max_active_blocks=512,
                use_pallas_kernel=True, inner_sweeps=4,
                max_outer_sweeps_incremental=1)
    BUDGETS = dict(projective_max_visible_blocks=128,
                   projective_max_mixed_slabs=1024,
                   projective_max_free_slabs=256)
""")
exec(SETUP)

_JAX_SIDE = SETUP + textwrap.dedent("""
    import sys
    import numpy as np
    import jax.numpy as jnp
    sys.path.insert(0, "tests")
    import torch_parity
    from voxblox_tpu.core.config import (
        EsdfIntegratorConfig, MapConfig, TsdfIntegratorConfig)
    from voxblox_tpu.server.mapper import EsdfServer, TsdfServer
    from voxblox_tpu.sim import world as sw

    out_dir = sys.argv[1]
    z = np.load(out_dir + "/scans.npz")
    w = sw.SimulationWorld()
    w.add_cylinder((0.0, 0.0, 2.0), 2.0, 4.0, color=(0, 255, 0))
    w.add_ground_level(0.0)
    objs = w.freeze()
    res = {}
    for i in range(len(z["R"])):
        pts, col, _, intr = sw.organized_pointcloud_from_transform(
            objs, (jnp.asarray(z["R"][i]), jnp.asarray(z["t"][i])),
            tuple(z["res"]), np.deg2rad(float(z["fov"])), 10.0)
        res[f"sim_pts{i}"] = np.asarray(pts)
        res[f"sim_col{i}"] = np.asarray(col)
    res["intr"] = np.asarray(intr)

    srv = EsdfServer(
        map_config=MapConfig(**MAP),
        integrator_config=TsdfIntegratorConfig(**TSDF),
        esdf_config=EsdfIntegratorConfig(**ESDF), method="projective",
        projective_resolution=(64, 48), projective_fov_deg=float(z["fov"]),
        projective_intrinsics=tuple(float(v) for v in z["intr"]),
        projective_pool=2, overflow_check_interval=10_000, **BUDGETS)
    iters = []
    for i in range(len(z["R"])):
        iters.append(int(srv.insert_pointcloud_and_update_esdf(
            (jnp.asarray(z["R"][i]), jnp.asarray(z["t"][i])),
            z["pts"][i], z["col"][i])))
    srv.check_overflow()
    res["iters"] = np.asarray(iters)
    for k, v in torch_parity.jax_layer_to_numpy(srv.layer).items():
        res["tsdf/" + k] = np.asarray(v)
    for k, v in torch_parity.jax_layer_to_numpy(srv.esdf_layer).items():
        res["esdf/" + k] = np.asarray(v)

    # Grow-and-retry: undersized mixed-slab budget, deferred checks.
    tiny = TsdfServer(
        map_config=MapConfig(**MAP),
        integrator_config=TsdfIntegratorConfig(**TSDF), method="projective",
        projective_resolution=(64, 48), projective_fov_deg=float(z["fov"]),
        projective_max_mixed_slabs=8, overflow_check_interval=8)
    for i in range(len(z["fR"])):
        tiny.insert_pointcloud(
            (jnp.asarray(z["fR"][i]), jnp.asarray(z["ft"][i])),
            z["fpts"][i], z["fcol"][i])
    tiny.check_overflow()
    res["grow_mixed"] = np.asarray(
        -1 if tiny.projective_budgets["max_mixed_slabs"] is None
        else tiny.projective_budgets["max_mixed_slabs"])
    for k, v in torch_parity.jax_layer_to_numpy(tiny.layer).items():
        res["grow/" + k] = np.asarray(v)
    np.savez(out_dir + "/jax.npz", **res)
""")


def _orbit(objs, angles, organized):
    out = []
    for a in angles:
        view = torch.tensor([-np.cos(a), -np.sin(a), 0.0], dtype=torch.float32)
        R = tsw.rotation_from_two_vectors(torch.tensor([0.0, 0.0, 1.0]), view)
        t = torch.tensor([4 * np.cos(a), 4 * np.sin(a), 2.0],
                         dtype=torch.float32)
        if organized:
            pts, col, _, intr = tsw.organized_pointcloud_from_transform(
                objs, (R, t), RES, np.deg2rad(FOV_DEG), 10.0)
        else:
            pg, col, val = tsw.pointcloud_from_viewpoint(
                objs, t, view, (64, 48), np.deg2rad(FOV_DEG), 10.0)
            pts, intr = tsw.world_points_to_sensor((R, t), pg, val), None
        out.append((R, t, pts, col, intr))
    return out


def _layer_dict(z, prefix):
    d = {k[len(prefix):]: z[k] for k in z.files if k.startswith(prefix)}
    for k in ("voxel_size", "vps", "layer_type"):
        d[k] = d[k].item()
    return d


def test_online_step_matches_jax_end_to_end(tmp_path):
    w = tsw.SimulationWorld()
    w.add_cylinder((0.0, 0.0, 2.0), 2.0, 4.0, color=(0, 255, 0))
    w.add_ground_level(0.0)
    objs = w.freeze("cpu")
    scans = _orbit(objs, [2 * np.pi * i / 32 for i in range(3)], True)
    flat = _orbit(objs, [2 * np.pi * i / 4 for i in range(4)], False)
    intr = scans[0][4]
    np.savez(
        tmp_path / "scans.npz",
        R=np.stack([s[0].numpy() for s in scans]),
        t=np.stack([s[1].numpy() for s in scans]),
        pts=np.stack([s[2].numpy() for s in scans]),
        col=np.stack([s[3].numpy() for s in scans]),
        res=np.asarray(RES), fov=np.asarray(FOV_DEG), intr=np.asarray(intr),
        fR=np.stack([s[0].numpy() for s in flat]),
        ft=np.stack([s[1].numpy() for s in flat]),
        fpts=np.stack([s[2].numpy() for s in flat]),
        fcol=np.stack([s[3].numpy() for s in flat]),
    )
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, "-c", _JAX_SIDE, str(tmp_path)],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    z = np.load(tmp_path / "jax.npz")

    # The port's sim renders the JAX sim's scans.
    np.testing.assert_allclose(z["intr"], np.asarray(intr), rtol=1e-7)
    for i, s in enumerate(scans):
        np.testing.assert_allclose(s[2].numpy(), z[f"sim_pts{i}"], atol=1e-5)
        np.testing.assert_array_equal(s[3].numpy(), z[f"sim_col{i}"])

    srv = EsdfServer(
        map_config=MapConfig(**MAP),
        integrator_config=TsdfIntegratorConfig(**TSDF),
        esdf_config=EsdfIntegratorConfig(**ESDF), method="projective",
        projective_resolution=(64, 48), projective_fov_deg=FOV_DEG,
        projective_intrinsics=intr, projective_pool=2,
        overflow_check_interval=10_000, device="cpu", **BUDGETS)
    iters = [srv.insert_pointcloud_and_update_esdf((R, t), pts, col)
             for R, t, pts, col, _ in scans]
    srv.check_overflow()
    np.testing.assert_array_equal(np.asarray(iters), z["iters"])
    assert srv.projective_budgets == dict(
        max_visible_blocks=128, max_mixed_slabs=1024, max_free_slabs=256)

    ref_t = _layer_dict(z, "tsdf/")
    got_t = tlayer.layer_to_numpy(srv.layer)
    torch_parity.assert_layers_equal(ref_t, got_t, atol=1e-4,
                                     channels=["tsdf", "weight"])
    ref_e = _layer_dict(z, "esdf/")
    got_e = tlayer.layer_to_numpy(srv.esdf_layer)
    torch_parity.assert_layers_equal(ref_e, got_e, atol=1e-4,
                                     channels=["esdf"])
    np.testing.assert_array_equal(got_e["channel/esdf_flags"],
                                  ref_e["channel/esdf_flags"])
    assert int(ref_t["num_blocks"]) > 20
    assert ((ref_e["channel/esdf_flags"] & 1) != 0).sum() > 1000

    # Grow-and-retry ends at the same rungs and the same map.
    tiny = TsdfServer(
        map_config=MapConfig(**MAP),
        integrator_config=TsdfIntegratorConfig(**TSDF), method="projective",
        projective_resolution=(64, 48), projective_fov_deg=FOV_DEG,
        projective_max_mixed_slabs=8, overflow_check_interval=8,
        device="cpu")
    for R, t, pts, col, _ in flat:
        tiny.insert_pointcloud((R, t), pts, col)
    tiny.check_overflow()
    got_mixed = tiny.projective_budgets["max_mixed_slabs"]
    assert (-1 if got_mixed is None else got_mixed) == int(z["grow_mixed"])
    assert got_mixed != 8
    torch_parity.assert_layers_equal(
        _layer_dict(z, "grow/"), tlayer.layer_to_numpy(tiny.layer),
        atol=1e-4, channels=["tsdf", "weight"])


# The 2 cm stress configuration (benchmarks/stress_bench.py) at full scan
# resolution, a short arc of its orbit, a pool cut to the arc. The ESDF
# runs one cheap XLA-path sweep per scan: this test is about allocation.
SETUP_2CM = textwrap.dedent("""
    N_POSES_2CM = int(os.environ.get("VOXBLOX_TORCH_PARITY_POSES", "2"))
    MAP_2CM = dict(voxel_size=0.02, max_blocks=512 * (N_POSES_2CM + 1),
                   table_capacity=16384)
    TSDF_2CM = dict(default_truncation_distance=0.08, max_ray_length_m=8.0)
    ESDF_2CM = dict(max_distance_m=1.0, default_distance_m=1.0,
                    min_distance_m=0.04,
                    max_active_blocks=MAP_2CM["max_blocks"],
                    use_pallas_kernel=False, inner_sweeps=1,
                    max_outer_sweeps_incremental=1)
    BUDGETS_2CM = dict(projective_max_visible_blocks=512,
                       projective_max_mixed_slabs=4096,
                       projective_max_free_slabs=512)
    RES_2CM = (640, 480)
""")
exec(SETUP_2CM)

_JAX_SIDE_2CM = "import os\n" + SETUP_2CM + textwrap.dedent("""
    import sys
    import numpy as np
    import jax.numpy as jnp
    sys.path.insert(0, "tests")
    import torch_parity
    from voxblox_tpu.core.config import (
        EsdfIntegratorConfig, MapConfig, TsdfIntegratorConfig)
    from voxblox_tpu.server.mapper import EsdfServer

    out_dir = sys.argv[1]
    z = np.load(out_dir + "/scans.npz")
    srv = EsdfServer(
        map_config=MapConfig(**MAP_2CM),
        integrator_config=TsdfIntegratorConfig(**TSDF_2CM),
        esdf_config=EsdfIntegratorConfig(**ESDF_2CM), method="projective",
        projective_resolution=(RES_2CM[0] // 2, RES_2CM[1] // 2),
        projective_fov_deg=float(z["fov"]),
        projective_intrinsics=tuple(float(v) for v in z["intr"]),
        projective_pool=2, overflow_check_interval=8, **BUDGETS_2CM)
    for i in range(len(z["R"])):
        srv.insert_pointcloud_and_update_esdf(
            (jnp.asarray(z["R"][i]), jnp.asarray(z["t"][i])),
            z["pts"][i], z["col"][i])
    srv.check_overflow()
    res = {"budgets": np.asarray([-1 if v is None else v for v in (
        srv.projective_budgets[k] for k in (
            "max_visible_blocks", "max_mixed_slabs", "max_free_slabs"))])}
    for k, v in torch_parity.jax_layer_to_numpy(srv.layer).items():
        res["tsdf/" + k] = np.asarray(v)
    np.savez(out_dir + "/jax.npz", **res)
""")


def test_two_cm_allocation_and_budget_ladder_match_jax(tmp_path):
    """The stress loop's configuration (2 cm voxels, 640x480 scans pooled
    to 320x240, 8 m rays, budgets 512/4096/512 undersized on purpose,
    deferred overflow checks) over the first poses of its orbit, through
    both packages: the same blocks in the same pool rows, the same budgets
    after grow-and-retry, the same TSDF. ``VOXBLOX_TORCH_PARITY_POSES=8``
    runs a quarter of the orbit (a few minutes)."""
    w = tsw.SimulationWorld()
    w.add_cylinder((0.0, 0.0, 2.0), 2.0, 4.0, color=(0, 255, 0))
    w.add_ground_level(0.0)
    objs = w.freeze("cpu")
    scans = []
    for i in range(N_POSES_2CM):
        a = 2 * np.pi * i / 32
        view = torch.tensor([-np.cos(a), -np.sin(a), 0.0], dtype=torch.float32)
        R = tsw.rotation_from_two_vectors(torch.tensor([0.0, 0.0, 1.0]), view)
        t = torch.tensor([4 * np.cos(a), 4 * np.sin(a), 2.0],
                         dtype=torch.float32)
        pts, col, _, intr = tsw.organized_pointcloud_from_transform(
            objs, (R, t), RES_2CM, np.deg2rad(FOV_DEG), 8.0)
        scans.append((R, t, pts, col))
    np.savez(tmp_path / "scans.npz",
             R=np.stack([s[0].numpy() for s in scans]),
             t=np.stack([s[1].numpy() for s in scans]),
             pts=np.stack([s[2].numpy() for s in scans]),
             col=np.stack([s[3].numpy() for s in scans]),
             fov=np.asarray(FOV_DEG), intr=np.asarray(intr))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, "-c", _JAX_SIDE_2CM, str(tmp_path)],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    z = np.load(tmp_path / "jax.npz")

    srv = EsdfServer(
        map_config=MapConfig(**MAP_2CM),
        integrator_config=TsdfIntegratorConfig(**TSDF_2CM),
        esdf_config=EsdfIntegratorConfig(**ESDF_2CM), method="projective",
        projective_resolution=(RES_2CM[0] // 2, RES_2CM[1] // 2),
        projective_fov_deg=FOV_DEG, projective_intrinsics=intr,
        projective_pool=2, overflow_check_interval=8, device="cpu",
        **BUDGETS_2CM)
    for R, t, pts, col in scans:
        srv.insert_pointcloud_and_update_esdf((R, t), pts, col)
    srv.check_overflow()

    got_b = [-1 if v is None else v for v in (
        srv.projective_budgets[k] for k in (
            "max_visible_blocks", "max_mixed_slabs", "max_free_slabs"))]
    assert got_b == z["budgets"].tolist(), (got_b, z["budgets"])
    assert got_b != [512, 4096, 512], "the budgets never grew"
    ref = _layer_dict(z, "tsdf/")
    got = tlayer.layer_to_numpy(srv.layer)
    n = int(got["num_blocks"])
    assert n == int(ref["num_blocks"]), (n, int(ref["num_blocks"]))
    assert n > 500
    # The same blocks in the same rows.
    np.testing.assert_array_equal(got["block_ijk"][:n], ref["block_ijk"][:n])
    # The same TSDF, but for voxels whose centre projects onto a pixel
    # border or a depth edge, where the two packages' float rounding can
    # pick different pixels: fewer than one observed voxel in 100,000.
    gw, rw = got["channel/weight"][:n], ref["channel/weight"][:n]
    gt, rt = got["channel/tsdf"][:n], ref["channel/tsdf"][:n]
    off = (np.abs(gw - rw) > 1e-4) | (np.abs(gt - rt) > 1e-4)
    observed = int((rw > 0).sum())
    assert observed > 100_000
    assert off.sum() <= observed * 1e-5, (int(off.sum()), observed)
    assert ((gw > 0) != (rw > 0)).sum() <= observed * 1e-5


def test_unported_requests_raise():
    """ICP, clear spheres and map/PLY IO still raise; the ray-casting
    methods, the spherical kinds, full-Euclidean ESDF and distance
    pruning construct and run one tiny scan."""
    kw = dict(device="cpu")
    with pytest.raises(NotImplementedError):
        TsdfServer(enable_icp=True, **kw)
    with pytest.raises(NotImplementedError):
        EsdfServer(clear_sphere_for_planning=True, **kw)
    with pytest.raises(ValueError):
        TsdfServer(method="bogus", **kw)
    with pytest.raises(ValueError):
        EsdfServer(**kw).insert_pointcloud_and_update_esdf(
            (torch.eye(3), torch.zeros(3)), torch.ones((4, 3)))
    pts = torch.tensor([[0.0, 0.0, 2.0], [0.3, 0.1, 2.5], [-0.2, 0.4, 1.5],
                        [1.0, -0.5, 3.0]])
    # A ring at elevation 0 on the azimuth bin centres of a 4 x 1 lidar.
    az = torch.tensor([-0.75, -0.25, 0.25, 0.75]) * np.pi
    ring = torch.stack([2 * torch.cos(az), 2 * torch.sin(az),
                        torch.zeros(4)], -1)
    pose = (torch.eye(3), torch.zeros(3))
    small = dict(map_config=MapConfig(voxel_size=0.2, max_blocks=256),
                 integrator_config=TsdfIntegratorConfig(**TSDF), **kw)
    for extra in (dict(method="fast"), dict(method="simple"),
                  dict(method="merged"),
                  dict(method="projective", projective_kind="spherical",
                       projective_resolution=(4, 1)),
                  dict(method="projective",
                       projective_kind="spherical_organized",
                       projective_resolution=(4, 1)),
                  dict(method="fast", max_block_distance_from_body=3.0)):
        srv = TsdfServer(**small, **extra)
        srv.insert_pointcloud(pose, ring if "projective_kind" in extra
                              else pts)
        assert int(srv.layer.num_blocks) > 0, extra
        assert float(srv.layer.channels["weight"].sum()) > 0, extra
    esrv = EsdfServer(esdf_config=EsdfIntegratorConfig(
        full_euclidean_distance=True, max_distance_m=2.0,
        default_distance_m=2.0, min_distance_m=0.4, max_active_blocks=64,
        inner_sweeps=2, max_outer_sweeps=2), method="fast", **small)
    esrv.insert_pointcloud(pose, pts)
    assert esrv.update_esdf() >= 1
    assert int(((esrv.esdf_layer.channels["esdf_flags"] & 1) != 0).sum()) > 0
    # The strided schedule and meshing are ported: they construct and run.
    EsdfServer(esdf_config=EsdfIntegratorConfig(
        sweep_strides=(8, 4, 2, 1)), **kw)
    srv = TsdfServer(method="projective", **kw)
    srv.update_mesh()
    assert len(srv.generate_mesh().blocks) == 0
    with pytest.raises(NotImplementedError):
        srv.generate_mesh("mesh.ply")
    with pytest.raises(NotImplementedError):
        srv.save_map("map.vxblx")
    with pytest.raises(NotImplementedError):
        srv.load_map("map.vxblx")


def test_default_method_is_fast_as_in_jax():
    from voxblox_tpu.server.mapper import TsdfServer as JaxTsdfServer

    assert TsdfServer(device="cpu").method == "fast" == JaxTsdfServer().method


def test_two_dispatch_path_matches_fused_step():
    """insert_pointcloud + update_esdf (two calls, synchronous overflow
    checks) builds the same maps as the fused online step."""
    w = tsw.SimulationWorld()
    w.add_cylinder((0.0, 0.0, 2.0), 2.0, 4.0, color=(0, 255, 0))
    w.add_ground_level(0.0)
    scans = _orbit(w.freeze("cpu"), [0.0, 0.7], False)

    def make(interval):
        return EsdfServer(
            map_config=MapConfig(voxel_size=0.2, max_blocks=256),
            integrator_config=TsdfIntegratorConfig(**TSDF),
            esdf_config=EsdfIntegratorConfig(**dict(ESDF,
                                                    max_active_blocks=128)),
            method="projective", projective_resolution=(64, 48), projective_fov_deg=FOV_DEG,
            overflow_check_interval=interval, device="cpu")

    a, b = make(1), make(4)
    for R, t, pts, col, _ in scans:
        a.insert_pointcloud((R, t), pts, col)
        a.update_esdf()
        b.insert_pointcloud_and_update_esdf((R, t), pts, col)
    a.check_overflow()
    b.check_overflow()
    for la, lb in ((a.layer, b.layer), (a.esdf_layer, b.esdf_layer)):
        torch_parity.assert_layers_equal(tlayer.layer_to_numpy(la),
                                         tlayer.layer_to_numpy(lb))
    assert b.num_scans == 2
