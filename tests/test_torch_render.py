"""Port parity, the renderer: ``surface_distance_along_rays``,
``render_depth`` (packed and general march, with and without colour, both
survivor branches), ``fit_dense_grid_dim`` and ``render_depth_image``
against the JAX package on the CPU, and the gradients against JAX's and
against central finite differences.

The layer is tests/test_render.py's GT sphere (JAX ``generate_gt_layer``)
carried to the port through numpy. Tolerances: depth within 1e-4 m and the
same hit on at least 99% of rays (the JAX CPU program contracts
multiply-adds the port cannot all see; measured: every ray), gradients
within 1e-5 of JAX's, finite differences at tests/test_render.py's bars
(0.08 depth, 0.05 colour, 0.15 colour through the SDF, 0.1 packed).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voxblox_tpu.ops import render as jrender
from voxblox_tpu.sim import world as jsw
from voxblox_tpu_torch import _runtime
from voxblox_tpu_torch.core import layer as tlayer
from voxblox_tpu_torch.ops import render as trender

import torch_parity

DEPTH_ATOL = 1e-4
SHARE = 0.99


def _sphere(voxel):
    w = jsw.SimulationWorld()
    w.add_sphere((0.0, 0.0, 0.0), 1.0, color=(250, 10, 10))
    bound = 1.0 + 10 * voxel
    return jsw.generate_gt_layer(w.freeze(), "tsdf", voxel,
                                 -bound * np.ones(3), bound * np.ones(3),
                                 max_dist=6 * voxel, vps=8, max_blocks=2048)


_LAYERS = {}


def _layers(voxel=0.1):
    if voxel not in _LAYERS:
        j = _sphere(voxel)
        _LAYERS[voxel] = (j, tlayer.layer_from_numpy(
            torch_parity.jax_layer_to_numpy(j), "cpu"))
    return _LAYERS[voxel]


def _fan(n, seed, origin=(0.0, -3.0, 0.0), spread=0.5):
    rng = np.random.RandomState(seed)
    ang = rng.uniform(-spread, spread, n)
    elev = rng.uniform(-0.3, 0.3, n)
    dirs = np.stack([np.sin(ang) * np.cos(elev), np.cos(ang) * np.cos(elev),
                     np.sin(elev)], -1).astype(np.float32)
    origins = np.broadcast_to(np.asarray(origin, np.float32), dirs.shape)
    return np.ascontiguousarray(origins), dirs


def _t(x):
    return torch.as_tensor(np.array(x))


def _assert_depth_parity(ref_d, ref_h, got_d, got_h):
    ref_d, ref_h = np.asarray(ref_d), np.asarray(ref_h)
    got_d, got_h = got_d.detach().numpy(), got_h.numpy()
    same_hit = ref_h == got_h
    close = np.abs(ref_d - got_d) <= DEPTH_ATOL
    assert same_hit.mean() >= SHARE, same_hit.mean()
    assert (close & same_hit).mean() >= SHARE, (close & same_hit).mean()
    assert ref_h.sum() > len(ref_h) // 4  # the fan hits the sphere
    return close & same_hit


def test_surface_distance_matches_jax():
    j, t = _layers()
    origins, dirs = _fan(512, 0, spread=0.6)
    dirs = dirs * 1.7  # bearings need not be unit
    ref_t, ref_h = jrender.surface_distance_along_rays(
        j, jnp.asarray(origins), jnp.asarray(dirs), 10.0)
    syncs = _runtime.SYNCS
    got_t, got_h = trender.surface_distance_along_rays(t, _t(origins),
                                                       _t(dirs), 10.0)
    # The probe bound once, then a done check every 16 of the 113 steps.
    assert _runtime.SYNCS - syncs <= 1 + 113 // 16
    np.testing.assert_array_equal(got_h.numpy(), np.asarray(ref_h))
    close = np.abs(got_t.numpy() - np.asarray(ref_t)) <= 1e-5
    assert close.mean() >= SHARE, close.mean()
    assert np.asarray(ref_h).sum() > 100
    # A ray past the sphere misses (tests/test_render.py:40-45).
    _, miss = trender.surface_distance_along_rays(
        t, _t([[-3.0, 0.0, 0.0]]), _t([[0.0, 0.0, 1.0]]), 4.0)
    assert not bool(miss[0])


@pytest.mark.parametrize("with_color", [False, True], ids=["depth", "color"])
@pytest.mark.parametrize("dim", [16, 64], ids=["packed", "general"])
def test_render_depth_matches_jax(dim, with_color):
    j, t = _layers()
    origins, dirs = _fan(1024, 3)
    ref = jrender.render_depth(j, jnp.asarray(origins), jnp.asarray(dirs),
                               8.0, dense_grid_dim=dim, with_color=with_color)
    got = trender.render_depth(t, _t(origins), _t(dirs), 8.0,
                               dense_grid_dim=dim, with_color=with_color)
    assert trender.LAST_MARCH["packed"] == (dim <= 32)
    ok = _assert_depth_parity(ref[0], ref[-1], got[0], got[-1])
    if with_color:
        np.testing.assert_allclose(got[1].numpy()[ok], np.asarray(ref[1])[ok],
                                   atol=1e-3)
        hit = got[-1].numpy()
        assert np.abs(got[1].numpy()[hit][:, 0] - 250).max() < 20


def _fan_and_grazers():
    """960 fan rays that hit within 16 steps, and 64 that graze the sphere
    0.15 m off its surface, creeping along it for longer."""
    origins, dirs = _fan(960, 3)
    z = np.linspace(-0.05, 0.05, 64, dtype=np.float32)
    g_o = np.stack([np.full_like(z, -2.0), np.full_like(z, -1.15), z], -1)
    g_d = np.tile(np.asarray([[1.0, 0.0, 0.0]], np.float32), (64, 1))
    return np.concatenate([origins, g_o]), np.concatenate([dirs, g_d])


@pytest.mark.parametrize("phase1_iters,branch", [(1, "overflow"),
                                                 (2, "compact")])
def test_survivor_branches_match_jax_and_chunks(phase1_iters, branch):
    """Phase 2's two branches: survivors over the n/8 buffer finish at
    full width, fewer are compacted. Both match JAX, and the same rays in
    chunks of 128 (no compaction) to 1e-4 (tests/test_render.py:210)."""
    j, t = _layers()
    origins, dirs = _fan_and_grazers()
    ref_d, ref_h = jrender.render_depth(
        j, jnp.asarray(origins), jnp.asarray(dirs), 8.0,
        phase1_iters=phase1_iters)
    got_d, got_h = trender.render_depth(t, _t(origins), _t(dirs), 8.0,
                                        phase1_iters=phase1_iters)
    stats = dict(trender.LAST_MARCH)
    assert stats["phase1_steps"] == 8 * phase1_iters
    if branch == "overflow":
        assert stats["survivors"] > 128 and not stats["compacted"], stats
    else:
        assert 0 < stats["survivors"] <= 128 and stats["compacted"], stats
    assert stats["phase2_steps"] > 0
    _assert_depth_parity(ref_d, ref_h, got_d, got_h)
    for s0 in range(0, 1024, 128):
        d_c, h_c = trender.render_depth(t, _t(origins[s0:s0 + 128]),
                                        _t(dirs[s0:s0 + 128]), 8.0,
                                        phase1_iters=phase1_iters)
        assert not trender.LAST_MARCH["compacted"]
        np.testing.assert_allclose(got_d[s0:s0 + 128].numpy(), d_c.numpy(),
                                   atol=1e-4)
        np.testing.assert_array_equal(got_h[s0:s0 + 128].numpy(), h_c.numpy())


def _with(layer, **channels):
    return dataclasses.replace(layer, channels={**layer.channels, **channels})


def _fd_check(loss, base, grad, idxs, eps, bar):
    """Central differences of ``loss`` (summed in float64 by the caller:
    a float32 sum of hundreds of depths rounds at ~1e-4, which eps = 1e-3
    would turn into an error of ~0.1)."""
    checked = 0
    for idx in idxs:
        idx = tuple(int(i) for i in idx)
        hi, lo = base.clone(), base.clone()
        hi[idx] += eps
        lo[idx] -= eps
        fd = (float(loss(hi)) - float(loss(lo))) / (2 * eps)
        assert abs(fd - float(grad[idx])) < bar * max(1.0, abs(fd)), (
            idx, fd, float(grad[idx]))
        checked += 1
    return checked


def _grad_case(dim):
    """tests/test_render.py's gradient cases: the general path's two rays
    at 0.125 m (:121-150), the packed path's 512 rays at 0.1 m
    (:293-350); (voxel, origins, dirs, loss of (depth, hit), |g| floor,
    FD bar)."""
    if dim > 32:
        o = np.asarray([[-3.0, 0.0, 0.0], [-3.0, 0.11, 0.07]], np.float32)
        d = np.asarray([[1.0, 0.0, 0.0], [1.0, 0.0, 0.0]], np.float32)
        return 0.125, o, d, (lambda dep, hit, xp: xp.sum(dep)), 1e-3, 0.08
    rng = np.random.RandomState(11)
    n = 512
    o = np.stack([rng.uniform(-3.5, -2.5, n), rng.uniform(-0.3, 0.3, n),
                  rng.uniform(-0.3, 0.3, n)], -1).astype(np.float32)
    d = np.array([[1.0, 0.0, 0.0]] * n, np.float32) + rng.uniform(
        -0.2, 0.2, (n, 3)).astype(np.float32)
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return 0.1, o, d, (lambda dep, hit, xp: xp.sum(xp.where(hit, dep, 0.0))), \
        1e-2, 0.1


@pytest.mark.parametrize("dim", [16, 64], ids=["packed", "general"])
def test_depth_gradients_match_jax_and_fd(dim):
    """d(loss of depth)/d(tsdf): equal to JAX's, and to central
    differences at tests/test_render.py's bars."""
    voxel, origins, dirs, loss, floor, bar = _grad_case(dim)
    j, t = _layers(voxel)

    def jloss(tsdf):
        ch = dict(j.channels, tsdf=tsdf)
        d, h = jrender.render_depth(dataclasses.replace(j, channels=ch),
                                    jnp.asarray(origins), jnp.asarray(dirs),
                                    8.0, dense_grid_dim=dim)
        return loss(d, h, jnp)

    ref_g = np.asarray(jax.grad(jloss)(j.channels["tsdf"]))

    def tloss(tsdf, dtype=torch.float64):
        d, h = trender.render_depth(_with(t, tsdf=tsdf), _t(origins),
                                    _t(dirs), 8.0, dense_grid_dim=dim)
        return loss(d.to(dtype), h, torch)

    base = t.channels["tsdf"].clone().requires_grad_(True)
    tloss(base, torch.float32).backward()
    g = base.grad
    np.testing.assert_allclose(g.numpy(), ref_g, atol=1e-5)
    nz = np.argwhere(np.abs(g.numpy()) > floor)
    assert len(nz) >= 8, "expected gradients on the corner voxels"
    with torch.no_grad():
        assert _fd_check(tloss, base.detach(), g,
                         nz[::max(1, len(nz) // 6)][:6], 1e-3, bar) >= 3


def test_color_gradients_match_jax_and_fd():
    """Pixel colour against the colour channel and, through the moving
    hit point, the TSDF (tests/test_render.py:215-290)."""
    j, t = _layers(0.125)
    # A red channel that varies along the ray axis: r = 100 + 40 x.
    d_np = torch_parity.jax_layer_to_numpy(j)
    v = j.vps
    lin = np.arange(v ** 3)
    local = np.stack([lin % v, (lin // v) % v, lin // (v * v)], -1)
    x = ((d_np["block_ijk"][:, None, :] * v + local) + 0.5)[..., 0] \
        * j.voxel_size
    col = np.stack([100.0 + 40.0 * x, np.full_like(x, 10.0),
                    np.full_like(x, 10.0)], -1).astype(np.float32)
    col = col.reshape(d_np["channel/color"].shape)
    origins = np.asarray([[-3.0, 0.1, 0.05], [-3.0, -0.23, 0.11]], np.float32)
    dirs = np.asarray([[1.0, 0.0, 0.0], [1.0, 0.0, 0.0]], np.float32)

    def jloss(c, tsdf):
        ch = dict(j.channels, color=c, tsdf=tsdf)
        _, rgb, _ = jrender.render_depth(
            dataclasses.replace(j, channels=ch), jnp.asarray(origins),
            jnp.asarray(dirs), 8.0, with_color=True)
        return jnp.sum(rgb[:, 0]) + 0.1 * jnp.sum(rgb[:, 1])

    ref_gc, ref_gt = (np.asarray(g) for g in jax.grad(jloss, argnums=(0, 1))(
        jnp.asarray(col), j.channels["tsdf"]))

    def tloss(c, tsdf):
        _, rgb, _ = trender.render_depth(_with(t, color=c, tsdf=tsdf),
                                         _t(origins), _t(dirs), 8.0,
                                         with_color=True)
        rgb = rgb.double()
        return rgb[:, 0].sum() + 0.1 * rgb[:, 1].sum()

    c0 = _t(col).requires_grad_(True)
    t0 = t.channels["tsdf"].clone().requires_grad_(True)
    tloss(c0, t0).backward()
    np.testing.assert_allclose(c0.grad.numpy(), ref_gc, atol=1e-5)
    np.testing.assert_allclose(t0.grad.numpy(), ref_gt, atol=1e-4)
    cb, tb = c0.detach(), t0.detach()
    with torch.no_grad():
        nz = np.argwhere(np.abs(c0.grad.numpy()) > 1e-3)
        assert len(nz) >= 8
        assert _fd_check(lambda c: tloss(c, tb), cb, c0.grad,
                         nz[::max(1, len(nz) // 5)][:5], 1e-2, 0.05) >= 3
        nzt = np.argwhere(np.abs(t0.grad.numpy()) > 1e-2)
        assert len(nzt) >= 4
        assert _fd_check(lambda s: tloss(cb, s), tb, t0.grad,
                         nzt[::max(1, len(nzt) // 4)][:4], 2e-3, 0.15) >= 2


def test_fit_dense_grid_dim_and_depth_image_match_jax():
    j, t = _layers()
    assert trender.fit_dense_grid_dim(t) == jrender.fit_dense_grid_dim(j)
    Rm = np.asarray([[0.0, 0.0, 1.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0]],
                    np.float32)
    tr = np.asarray([-3.0, 0.0, 0.0], np.float32)
    intr = (40.0, 40.0, 16.0, 12.0)
    ref_d, ref_h = jrender.render_depth_image(
        j, (jnp.asarray(Rm), jnp.asarray(tr)), intr, (32, 24), 8.0)
    got_d, got_h = trender.render_depth_image(t, (_t(Rm), _t(tr)), intr,
                                              (32, 24), 8.0)
    assert got_d.shape == (24, 32) and got_h.shape == (24, 32)
    assert trender.LAST_MARCH["packed"]
    _assert_depth_parity(np.asarray(ref_d).ravel(), np.asarray(ref_h).ravel(),
                         got_d.reshape(-1), got_h.reshape(-1))
    assert bool(got_h[12, 16]) and 1.8 < float(got_d[12, 16]) < 2.2
    # Outside the active bounding box: immediate misses at max_distance.
    d, h = trender.render_depth(t, _t([[8.0, 0.0, 0.0], [0.0, 9.0, 0.0]]),
                                _t([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]]), 5.0)
    assert not h.any() and torch.all(d == 5.0)
