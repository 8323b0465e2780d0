"""Port parity, projective TSDF integration: spherical range images and
the K-scan batch path.

Scans come from the port's own sim (checked against the JAX sim); the
same numpy scans and poses go through voxblox_tpu (JAX, CPU) and
voxblox_tpu_torch (device="cpu"). Tolerances:
- range images: ranges and parameters exact, colours exact;
- spherical single scans: ``atan2``/``asin`` may round one ulp apart
  between XLA and torch, and a voxel whose centre projects onto a pixel
  border then reads the neighbouring pixel, so at most 1e-3 of the
  observed voxels may differ by more than 1e-4 and every other voxel
  matches at 1e-5 (block set, rows and flags exact);
- batch paths: TSDF and weight atol = rtol = 1e-5, colours within one
  float16 ulp, block set, rows, flags and the overflow flag exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voxblox_tpu.core import layer as jlayer
from voxblox_tpu.core.config import TsdfIntegratorConfig as JCfg
from voxblox_tpu.ops import projective as jproj
from voxblox_tpu.sim import world as jsw

from voxblox_tpu_torch.core import layer as tlayer
from voxblox_tpu_torch.core.config import TsdfIntegratorConfig as TCfg
from voxblox_tpu_torch.ops import projective as tproj
from voxblox_tpu_torch.sim import world as tsw

import torch_parity
from test_torch_projective import _assert_maps_match, _f16_ulp, _scans

RESO = (256, 32)
FOV_UP, FOV_DOWN = 5.0, -30.0
LIDAR = dict(default_truncation_distance=0.8, max_ray_length_m=15.0,
             voxel_carving_enabled=False)


def _lidar_world(w):
    w.add_ground_level(0.0)
    w.add_plane((0.0, 4.0, 2.0), (0.0, -1.0, 0.0), color=(200, 100, 50))
    w.add_cylinder((3.0, 1.0, 1.0), 0.5, 2.0, color=(200, 50, 50))
    w.add_sphere((-3.0, -2.0, 1.0), 0.8, color=(10, 20, 30))
    w.add_cube((2.0, -3.0, 0.5), (1.0, 1.5, 1.0), color=(40, 50, 60))
    return w


def _lidar_scans(xs):
    objs = _lidar_world(tsw.SimulationWorld()).freeze("cpu")
    out = []
    for x in xs:
        pos = torch.tensor([x, 0.2 * x, 1.5])
        pts, col, _ = tsw.spherical_pointcloud_from_transform(
            objs, (torch.eye(3), pos), RESO, FOV_UP, FOV_DOWN, 15.0)
        out.append((np.eye(3, dtype=np.float32), pos.numpy(), pts.numpy(),
                    col.numpy()))
    return out


def test_sim_lidar_scan_and_builders_match():
    """The port's lidar renderer (spheres, cubes, planes, cylinders)
    renders the JAX sim's scan; both spherical builders give the JAX
    images, and the scatter builder's image equals the organized
    builder's (tests/test_projective.py:331)."""
    (R, t, pts, col), = _lidar_scans([0.5])
    objs = _lidar_world(jsw.SimulationWorld()).freeze()
    ref = jax.jit(lambda p: jsw.spherical_pointcloud_from_transform(
        objs, (jnp.eye(3), p), RESO, FOV_UP, FOV_DOWN, 15.0))(t)
    np.testing.assert_allclose(pts, np.asarray(ref[0]), atol=2e-5)
    np.testing.assert_array_equal(col, np.asarray(ref[1]))
    assert int(np.asarray(ref[2]).sum()) > 3000
    for build in ("build_spherical_range_image",
                  "build_spherical_range_image_organized"):
        r = jax.jit(lambda p, c: getattr(jproj, build)(
            p, c, RESO, FOV_UP, FOV_DOWN)[:3])(pts, col)
        g = getattr(tproj, build)(torch.as_tensor(pts), torch.as_tensor(col),
                                  RESO, FOV_UP, FOV_DOWN)
        np.testing.assert_array_equal(g.rng.numpy(), np.asarray(r[0]))
        np.testing.assert_array_equal(g.color.numpy(), np.asarray(r[1]))
        np.testing.assert_array_equal(g.params.numpy(), np.asarray(r[2]))
        assert g.kind == "spherical"
    a = tproj.build_spherical_range_image(
        torch.as_tensor(pts), torch.as_tensor(col), RESO, FOV_UP, FOV_DOWN)
    b = tproj.build_spherical_range_image_organized(
        torch.as_tensor(pts), torch.as_tensor(col), RESO, FOV_UP, FOV_DOWN)
    np.testing.assert_array_equal(a.rng.numpy(), b.rng.numpy())
    np.testing.assert_array_equal(a.color.numpy(), b.color.numpy())


def _assert_mostly_equal(jl, tl, share=1e-3):
    """Blocks, rows and flags exact; at most ``share`` of the observed
    voxels off by more than 1e-4, the rest within 1e-5."""
    ref = torch_parity.jax_layer_to_numpy(jl)
    got = tlayer.layer_to_numpy(tl)
    for k in ("num_blocks", "block_ijk", "block_flags", "table/slot"):
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    rw, gw = ref["channel/weight"], got["channel/weight"]
    rt, gt = ref["channel/tsdf"], got["channel/tsdf"]
    off = (np.abs(gw - rw) > 1e-4 + 1e-5 * np.abs(rw)) | (
        np.abs(gt - rt) > 1e-4)
    observed = int((rw > 0).sum())
    assert observed > 2000, observed
    assert off.sum() <= share * observed, (int(off.sum()), observed)
    close = ~off
    np.testing.assert_allclose(gt[close], rt[close], atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(gw[close], rw[close], atol=1e-5, rtol=1e-5)
    print("voxels off by more than 1e-4:", int(off.sum()), "of", observed)
    return int(off.sum()), observed


@pytest.mark.parametrize("kind", ["spherical", "spherical_organized"])
def test_spherical_single_scans_match(kind):
    scans = _lidar_scans([0.0, 1.0])
    jl = jlayer.make_layer("tsdf", 0.2, vps=16, max_blocks=1024)
    tl = tlayer.make_layer("tsdf", 0.2, vps=16, max_blocks=1024, device="cpu")
    for R, t, pts, col in scans:
        jl, jp, jb = jproj.integrate_pointcloud_projective(
            jl, (jnp.asarray(R), jnp.asarray(t)), pts, col, JCfg(**LIDAR),
            resolution=RESO, kind=kind, fov_up_deg=FOV_UP,
            fov_down_deg=FOV_DOWN)
        tl, tp, tb = tproj.integrate_pointcloud_projective(
            tl, (torch.as_tensor(R), torch.as_tensor(t)),
            torch.as_tensor(pts), torch.as_tensor(col), TCfg(**LIDAR),
            resolution=RESO, kind=kind, fov_up_deg=FOV_UP,
            fov_down_deg=FOV_DOWN)
        assert (bool(tp), bool(tb)) == (bool(jp), bool(jb)) == (False, False)
    _assert_mostly_equal(jl, tl)


def _stack(scans):
    return [np.stack([s[i] for s in scans]) for i in range(4)]


def test_batch_pinhole_and_organized_match():
    """integrate_pointcloud_projective_batch (flat pinhole scans) and
    integrate_organized_projective_batch against the JAX batch functions,
    the second at undersized budgets so that the overflow flag is set and
    the batch still folds (the batch path is not transactional)."""
    cfg = dict(default_truncation_distance=0.8, max_ray_length_m=10.0)
    fov = float(np.deg2rad(60.0))
    flat = _scans([0.0, 0.7, 1.4], organized=False)
    Rs, ts, pts, cols = _stack([s[:4] for s in flat])
    jl, jo = jproj.integrate_pointcloud_projective_batch(
        jlayer.make_layer("tsdf", 0.2, vps=16, max_blocks=1024),
        jnp.asarray(Rs), jnp.asarray(ts), pts, cols, JCfg(**cfg),
        resolution=(64, 48), fov_h_rad=fov)
    tl, to = tproj.integrate_pointcloud_projective_batch(
        tlayer.make_layer("tsdf", 0.2, vps=16, max_blocks=1024,
                          device="cpu"),
        Rs, ts, torch.as_tensor(pts), torch.as_tensor(cols), TCfg(**cfg),
        resolution=(64, 48), fov_h_rad=fov)
    assert bool(jo) == bool(to) is False
    _assert_maps_match(jl, tl)

    org = _scans([0.3, 1.9], organized=True)
    intr = org[0][4]
    Rs, ts, pts, cols = _stack([s[:4] for s in org])
    budgets = dict(max_visible_blocks=128, max_mixed_slabs=96,
                   max_free_slabs=8)
    jl, jo = jproj.integrate_organized_projective_batch(
        jl, jnp.asarray(Rs), jnp.asarray(ts), pts, cols, JCfg(**cfg),
        intrinsics=intr, pool=2, **budgets)
    tl, to = tproj.integrate_organized_projective_batch(
        tl, Rs, ts, torch.as_tensor(pts), torch.as_tensor(cols),
        TCfg(**cfg), intrinsics=intr, pool=2, **budgets)
    assert bool(jo) == bool(to) is True
    _assert_maps_match(jl, tl)


@pytest.mark.parametrize("max_blocks", [1024, 8192])
def test_batch_spherical_organized_matches(max_blocks):
    """The velodyne path (bench.py:400) at a small size; max_blocks 8192
    takes the direct pool-domain accumulator (vps 8 keeps that pool
    small)."""
    scans = _lidar_scans([0.0, 1.0, 2.0])
    Rs, ts, pts, cols = _stack(scans)
    vps = 16 if max_blocks < 8192 else 8
    kw = dict(resolution=RESO, kind="spherical_organized",
              fov_up_deg=FOV_UP, fov_down_deg=FOV_DOWN, use_color=False,
              max_visible_blocks=256 if vps == 16 else 2048)
    jl, jo = jproj.integrate_pointcloud_projective_batch(
        jlayer.make_layer("tsdf", 0.2, vps=vps, max_blocks=max_blocks),
        jnp.asarray(Rs), jnp.asarray(ts), pts, cols, JCfg(**LIDAR), **kw)
    tl, to = tproj.integrate_pointcloud_projective_batch(
        tlayer.make_layer("tsdf", 0.2, vps=vps, max_blocks=max_blocks,
                          device="cpu"),
        Rs, ts, torch.as_tensor(pts), torch.as_tensor(cols), TCfg(**LIDAR),
        **kw)
    assert bool(jo) == bool(to) is False
    _assert_mostly_equal(jl, tl)
