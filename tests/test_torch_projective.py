"""Port parity, projective TSDF integration (single-scan pinhole path).

Scans come from the port's own sim (torch, no JAX programs); the same
numpy scans and poses go through voxblox_tpu (JAX, CPU) and
voxblox_tpu_torch (device="cpu"). Tolerances: ranges exact; TSDF and
weight atol = rtol = 1e-5 (f32 sums whose rounding may differ where XLA
fuses a multiply-add); colours within one float16 ulp of the reference
(both round through f16 and renormalize in f32); block set, rows, flags
and overflow flags exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from voxblox_tpu.core import layer as jlayer
from voxblox_tpu.core.config import TsdfIntegratorConfig as JCfg
from voxblox_tpu.ops import projective as jproj

from voxblox_tpu_torch.core import layer as tlayer
from voxblox_tpu_torch.core.config import TsdfIntegratorConfig as TCfg
from voxblox_tpu_torch.ops import projective as tproj
from voxblox_tpu_torch.sim import world as tsw

import torch_parity

FOV = float(np.deg2rad(60.0))
CFG = dict(default_truncation_distance=0.8, max_ray_length_m=10.0)


def _scans(angles, organized: bool):
    w = tsw.SimulationWorld()
    w.add_cylinder((0.0, 0.0, 2.0), 2.0, 4.0, color=(0, 255, 0))
    w.add_ground_level(0.0)
    objs = w.freeze("cpu")
    out = []
    for a in angles:
        view = torch.tensor([-np.cos(a), -np.sin(a), 0.0], dtype=torch.float32)
        R = tsw.rotation_from_two_vectors(torch.tensor([0.0, 0.0, 1.0]), view)
        pos = torch.tensor([4 * np.cos(a), 4 * np.sin(a), 2.0],
                           dtype=torch.float32)
        if organized:
            pts, col, _, intr = tsw.organized_pointcloud_from_transform(
                objs, (R, pos), (128, 96), FOV, 10.0)
        else:
            pg, col, val = tsw.pointcloud_from_viewpoint(
                objs, pos, view, (64, 48), FOV, 10.0)
            pts, intr = tsw.world_points_to_sensor((R, pos), pg, val), None
        out.append(tuple(x.numpy() for x in (R, pos, pts, col)) + (intr,))
    return out


def _f16_ulp(x):
    return np.spacing(np.abs(x).astype(np.float16)).astype(np.float32)


def _assert_maps_match(jl, tl):
    ref = torch_parity.jax_layer_to_numpy(jl)
    got = tlayer.layer_to_numpy(tl)
    torch_parity.assert_layers_equal(ref, got, atol=1e-5, rtol=1e-5,
                                     channels=["tsdf", "weight"])
    c_ref, c_got = ref["channel/color"], got["channel/color"]
    assert np.all(np.abs(c_got - c_ref) <= _f16_ulp(c_ref))
    assert ref["block_flags"].astype(bool).sum() > 10
    return ref


def test_range_images_match(rng):
    (R, t, pts, col, _), = _scans([0.3], organized=False)
    ref = jax.jit(lambda p, c: jproj.build_pinhole_range_image(
        p, c, (64, 48), FOV)[:3])(pts, col)
    got = tproj.build_pinhole_range_image(torch.as_tensor(pts),
                                          torch.as_tensor(col), (64, 48), FOV)
    np.testing.assert_array_equal(got.rng.numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(got.params.numpy(), np.asarray(ref[2]))
    assert np.all(np.abs(got.color.numpy() - np.asarray(ref[1]))
                  <= _f16_ulp(np.asarray(ref[1])))
    (R, t, pts, col, intr), = _scans([1.1], organized=True)
    ref = jax.jit(lambda p, c: jproj.build_pinhole_range_image_organized(
        p, c, 2, intr)[:3])(pts, col)
    got = tproj.build_pinhole_range_image_organized(
        torch.as_tensor(pts), torch.as_tensor(col), 2, intr)
    np.testing.assert_array_equal(got.rng.numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(got.params.numpy(), np.asarray(ref[2]))
    assert np.all(np.abs(got.color.numpy() - np.asarray(ref[1]))
                  <= _f16_ulp(np.asarray(ref[1])))


def test_hiz_query_matches_jax_and_bruteforce():
    """Same (lo, lo_band, hi) as the JAX pyramid, and conservative against
    the brute-force box extrema (tests/test_projective.py:292), on a
    square and a 16:1 skewed image."""
    rs = np.random.RandomState(7)
    for (h, w) in ((48, 64), (8, 128)):
        img = rs.uniform(1.0, 9.0, (h, w)).astype(np.float32)
        img[rs.uniform(size=(h, w)) < 0.3] = np.inf
        ri = tproj.RangeImage(rng=torch.as_tensor(img),
                              color=torch.zeros((h, w, 3)),
                              params=torch.zeros(4), kind="pinhole")
        eff = tproj._pix_eff(ri, TCfg(default_truncation_distance=0.4,
                                      max_ray_length_m=8.0))
        hiz = tproj._hiz_tables(eff)
        b = np.array([(u0, rs.randint(u0, w), v0, rs.randint(v0, h))
                      for u0, v0 in zip(rs.randint(0, w, 200),
                                        rs.randint(0, h, 200))], np.int32)
        got = [x.numpy() for x in tproj._hiz_query(
            hiz, *(torch.as_tensor(b[:, i]) for i in range(4)))]
        ref = jax.jit(lambda e, q: jproj._hiz_query(
            jproj._hiz_tables(e), q[:, 0], q[:, 1], q[:, 2], q[:, 3]))(
            jnp.asarray(eff.numpy()), jnp.asarray(b))
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g, np.asarray(r))
        e = eff.numpy()
        band = np.where(np.isfinite(e), e, np.inf)
        for i, (u0, u1, v0, v1) in enumerate(b):
            assert got[0][i] <= e[v0:v1 + 1, u0:u1 + 1].min() + 1e-6
            assert got[1][i] <= band[v0:v1 + 1, u0:u1 + 1].min() + 1e-6
            assert got[2][i] >= e[v0:v1 + 1, u0:u1 + 1].max() - 1e-6


def test_flat_scans_one_and_two_match():
    scans = _scans([0.0, 0.7], organized=False)
    jl = jlayer.make_layer("tsdf", 0.2, vps=16, max_blocks=1024)
    tl = tlayer.make_layer("tsdf", 0.2, vps=16, max_blocks=1024, device="cpu")
    jint = jax.jit(jproj.integrate_pointcloud_projective,
                   static_argnames=("cfg", "resolution", "fov_h_rad"))
    for R, t, pts, col, _ in scans:
        jl, jp, jb = jint(jl, (jnp.asarray(R), jnp.asarray(t)), pts, col,
                          JCfg(**CFG), resolution=(64, 48), fov_h_rad=FOV)
        tl, tp, tb = tproj.integrate_pointcloud_projective(
            tl, (torch.as_tensor(R), torch.as_tensor(t)),
            torch.as_tensor(pts), torch.as_tensor(col), TCfg(**CFG),
            resolution=(64, 48), fov_h_rad=FOV)
        assert (bool(tp), bool(tb)) == (bool(jp), bool(jb)) == (False, False)
        _assert_maps_match(jl, tl)


def test_organized_scans_budgets_and_overflow_match():
    """Organized binning at bench-style budgets, then an undersized
    max_mixed_slabs=8: both flag budget overflow (not pool overflow) and
    apply nothing (transactional)."""
    scans = _scans([0.0, 2.0], organized=True)
    intr = scans[0][4]
    jl = jlayer.make_layer("tsdf", 0.2, vps=16, max_blocks=1024)
    tl = tlayer.make_layer("tsdf", 0.2, vps=16, max_blocks=1024, device="cpu")
    budgets = dict(max_visible_blocks=128, max_mixed_slabs=1024,
                   max_free_slabs=256)
    R, t, pts, col, _ = scans[0]
    jl, jp, jb = jproj.integrate_organized_projective(
        jl, (jnp.asarray(R), jnp.asarray(t)), pts, col, JCfg(**CFG),
        intrinsics=intr, pool=2, **budgets)
    tl, tp, tb = tproj.integrate_organized_projective(
        tl, (torch.as_tensor(R), torch.as_tensor(t)), torch.as_tensor(pts),
        torch.as_tensor(col), TCfg(**CFG), intrinsics=intr, pool=2,
        **budgets)
    assert (bool(tp), bool(tb)) == (bool(jp), bool(jb)) == (False, False)
    before = _assert_maps_match(jl, tl)
    R, t, pts, col, _ = scans[1]
    tiny = dict(budgets, max_mixed_slabs=8)
    jl, jp, jb = jproj.integrate_organized_projective(
        jl, (jnp.asarray(R), jnp.asarray(t)), pts, col, JCfg(**CFG),
        intrinsics=intr, pool=2, **tiny)
    tl, tp, tb = tproj.integrate_organized_projective(
        tl, (torch.as_tensor(R), torch.as_tensor(t)), torch.as_tensor(pts),
        torch.as_tensor(col), TCfg(**CFG), intrinsics=intr, pool=2, **tiny)
    assert (bool(tp), bool(tb)) == (bool(jp), bool(jb)) == (False, True)
    after = _assert_maps_match(jl, tl)
    # Allocation happened, values did not move.
    n = int(before["num_blocks"])
    np.testing.assert_array_equal(after["channel/weight"][:n],
                                  before["channel/weight"][:n])


def test_reference_row0_visibility_fault_is_reproduced():
    """The JAX ``_scan_terms`` builds its visible-row mask with a scatter
    that also aims every non-visible candidate lane at row 0 (value
    False); the last writer wins, so pool row 0 is dropped from the
    visible set whenever a later lane is invalid. The port reproduces the
    rule for parity (ROADMAP Queue 3): row 0 here is a visible candidate
    inside the truncation band, yet it takes no update in either
    package."""
    (R, t, pts, col, intr), = _scans([0.0], organized=True)
    cfg = TCfg(**CFG)
    tl = tlayer.make_layer("tsdf", 0.2, vps=16, max_blocks=1024, device="cpu")
    img = tproj.build_pinhole_range_image_organized(
        torch.as_tensor(pts), torch.as_tensor(col), 2, intr)
    hiz = tproj._hiz_tables(tproj._pix_eff(img, cfg))
    tl, cand, c_ok, _, _ = tproj._discover_and_allocate(
        tl, img, torch.as_tensor(R), torch.as_tensor(t), cfg, hiz, 512, True)
    sel = torch.where(c_ok, tlayer.lookup_blocks(tl, cand), -1)
    assert bool((sel == 0).any()) and int(sel[-1]) < 0
    jl = jlayer.make_layer("tsdf", 0.2, vps=16, max_blocks=1024)
    jl, _, _ = jproj.integrate_organized_projective(
        jl, (jnp.asarray(R), jnp.asarray(t)), pts, col, JCfg(**CFG),
        intrinsics=intr, pool=2)
    tl2 = tlayer.make_layer("tsdf", 0.2, vps=16, max_blocks=1024,
                            device="cpu")
    tl2, _, _ = tproj.integrate_organized_projective(
        tl2, (torch.as_tensor(R), torch.as_tensor(t)), torch.as_tensor(pts),
        torch.as_tensor(col), cfg, intrinsics=intr, pool=2)
    jw = np.asarray(jl.channels["weight"]).sum(1)
    tw = tl2.channels["weight"].sum(1).numpy()
    assert jw[0] == 0.0 and tw[0] == 0.0
    assert (jw[1:] > 0).sum() == (tw[1:] > 0).sum() > 0
