"""Port parity, DDA ray casting (voxblox_tpu/ops/raycast.py).

The same ray segments go through the JAX ``cast_rays`` /
``bresenham_hierarchical`` and the port's: voxels and masks exact, with
ties between axes, axis-aligned rays, zero-length rays, invalid rays and
rays longer than the step budget among them. ``compute_ray_segments``
agrees to one float32 ulp (the endpoints' multiply-adds are fused in the
JAX program and emulated in the port) and exactly for carving rays that
start at the origin.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voxblox_tpu.ops import raycast as jr

from voxblox_tpu_torch.ops import raycast as tr


def _rays(rng, n=400):
    o = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    p = o + rng.normal(0, 2.5, (n, 3)).astype(np.float32)
    # Axis-aligned, grid-aligned (ties between axes) and zero-length rays.
    p[:20, 1:] = o[:20, 1:]
    o[20:40] = np.round(o[20:40] * 10) / 10
    p[20:40] = o[20:40] + np.float32(0.7)
    p[40:45] = o[40:45]
    clearing = rng.uniform(size=n) < 0.2
    valid = rng.uniform(size=n) < 0.9
    return o, p, clearing, valid


@pytest.mark.parametrize("carving,from_origin", [(True, True), (False, True),
                                                 (True, False)])
def test_segments_and_dda_match(rng, carving, from_origin):
    o, p, clearing, valid = _rays(rng)
    args = (0.1, 0.3, 4.0, carving)
    js = jax.jit(lambda o, p, c: jr.compute_ray_segments(
        o, p, c, *args, cast_from_origin=from_origin))(o, p, clearing)
    ts = tr.compute_ray_segments(torch.as_tensor(o), torch.as_tensor(p),
                                 torch.as_tensor(clearing), *args,
                                 cast_from_origin=from_origin)
    for a, b in zip(js[:2], ts[:2]):
        a = np.asarray(a)
        assert np.all(np.abs(b.numpy() - a) <= np.spacing(np.abs(a)))
    if carving and from_origin:
        np.testing.assert_array_equal(ts.start_scaled.numpy(),
                                      np.asarray(js.start_scaled))
    # The DDA on the same segments: exact, including rays cut off by the
    # step budget (the last one is shorter than most rays here).
    setup = [np.array(x) for x in js]
    for steps in (jr.max_steps_hint(4.0, 0.3, 0.1, carving), 12):
        jv, jm = jax.jit(jr.cast_rays, static_argnums=1)(
            jr.RaySetup(*setup), steps, valid)
        tv, tm = tr.cast_rays(tr.RaySetup(*map(torch.as_tensor, setup)),
                              steps, torch.as_tensor(valid))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    assert bool(np.asarray(jm).any())
    jv, jm = jax.jit(jr.bresenham_hierarchical, static_argnums=(1, 2))(
        jr.RaySetup(*setup), 8, 10, valid)
    tv, tm = tr.bresenham_hierarchical(
        tr.RaySetup(*map(torch.as_tensor, setup)), 8, 10,
        torch.as_tensor(valid))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))


def test_dda_visits_a_connected_path_and_step_hint():
    """Each step moves one voxel along one axis, towards the end voxel,
    and the ray ends there; the step hint equals the JAX one."""
    o = np.array([[0.05, 0.05, 0.05], [0.33, -0.71, 0.12]], np.float32)
    p = np.array([[0.95, 0.05, 0.05], [-0.52, 0.48, 1.31]], np.float32)
    s = tr.compute_ray_segments(torch.as_tensor(o), torch.as_tensor(p),
                                torch.zeros(2, dtype=torch.bool), 0.1, 0.0,
                                5.0, False)
    vox, mask = tr.cast_rays(s, 64)
    for r in range(2):
        path = vox[:, r][mask[:, r]].numpy()
        assert len(path) == int(s.num_steps[r]) + 1
        assert (np.abs(np.diff(path, axis=0)).sum(1) == 1).all()
        np.testing.assert_array_equal(
            path[-1], np.floor(p[r] / 0.1 + 1e-6).astype(np.int32))
    for args in ((5.0, 0.2, 0.05, True), (50.0, 0.8, 0.2, False)):
        assert tr.max_steps_hint(*args) == jr.max_steps_hint(*args)
