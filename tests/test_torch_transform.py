"""Port parity, layer transforms and camera frustums: ``merge_layers`` (the
four layer types), ``transform_layer`` (TSDF and ESDF, with a resample),
``naive_transform_layer`` (duplicate targets: the last lane wins, as in
JAX), ``evaluate_layer_rmse_at_poses`` and ``utils/camera`` against the
JAX package on the CPU.

Tolerances: merged layers within 1e-6; transformed layers with the same
blocks in the same rows, values within 1e-5 and colour (0-255) within
1e-3 (trilinear sums of the same corners, associated differently: up to
5e-4 apart); frustum masks equal, planes within 1e-6.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voxblox_tpu.core import layer as jlayer
from voxblox_tpu.ops import transform as jtransform
from voxblox_tpu.sim import world as jsw
from voxblox_tpu.utils import camera as jcamera
from voxblox_tpu.utils import evaluation as jeval
from voxblox_tpu_torch.core import layer as tlayer
from voxblox_tpu_torch.ops import transform as ttransform
from voxblox_tpu_torch.utils import camera as tcamera
from voxblox_tpu_torch.utils import evaluation as teval

import torch_parity


def _t(x):
    return torch.as_tensor(np.array(x))


def _yaw(deg, shift=(0.0, 0.0, 0.0)):
    a = np.deg2rad(deg)
    R = np.array([[np.cos(a), -np.sin(a), 0.0], [np.sin(a), np.cos(a), 0.0],
                  [0.0, 0.0, 1.0]], np.float32)
    return R, np.asarray(shift, np.float32)


_GT = {}


def _gt(kind, center=(0.0, 0.0, 0.0)):
    key = (kind, center)
    if key not in _GT:
        w = jsw.SimulationWorld()
        w.add_sphere(center, 0.8, color=(200, 40, 10))
        c = np.asarray(center)
        _GT[key] = jsw.generate_gt_layer(
            w.freeze(), kind, 0.1, c - 1.3, c + 1.3, max_dist=0.4, vps=8,
            max_blocks=512)
    return _GT[key]


def _np(layer):
    return torch_parity.jax_layer_to_numpy(layer)


def _to_torch(layer):
    return tlayer.layer_from_numpy(_np(layer), "cpu")


def _as_type(d, kind):
    """A GT TSDF's numpy dict recast as an occupancy or intensity layer."""
    d = dict(d)
    w = d.pop("channel/weight")
    tsdf = d.pop("channel/tsdf")
    d.pop("channel/color")
    if kind == "occupancy":
        d["channel/log_odds"] = -tsdf * 5.0
        d["channel/occ_observed"] = (w > 0).astype(np.uint8)
    else:
        d["channel/intensity"] = 20.0 + 10.0 * tsdf
        d["channel/intensity_weight"] = w * 2.0
    d["layer_type"] = kind
    return d


def _jax_layer(d):
    lt = d["layer_type"]
    base = jlayer.make_layer(lt, d["voxel_size"], vps=d["vps"],
                             max_blocks=len(d["block_ijk"]))
    table = type(base.table)(**{k: jnp.asarray(d[f"table/{k}"])
                                for k in torch_parity.TABLE_FIELDS})
    return dataclasses.replace(
        base, table=table, block_ijk=jnp.asarray(d["block_ijk"]),
        block_flags=jnp.asarray(d["block_flags"]),
        num_blocks=jnp.asarray(d["num_blocks"]),
        channels={k.split("/", 1)[1]: jnp.asarray(v) for k, v in d.items()
                  if k.startswith("channel/")})


@pytest.mark.parametrize("kind", ["tsdf", "esdf", "occupancy", "intensity"])
def test_merge_layers_matches_jax(kind):
    """Two overlapping spheres' layers merged voxel by voxel."""
    src_kind = kind if kind in ("tsdf", "esdf") else "tsdf"
    a, b = _np(_gt(src_kind)), _np(_gt(src_kind, (1.0, 0.4, 0.0)))
    if src_kind != kind:
        a, b = _as_type(a, kind), _as_type(b, kind)
    ja, jb = _jax_layer(a), _jax_layer(b)
    ref, j_ovf = jtransform.merge_layers(ja, jb)
    got, t_ovf = ttransform.merge_layers(tlayer.layer_from_numpy(a, "cpu"),
                                         tlayer.layer_from_numpy(b, "cpu"))
    assert not bool(j_ovf) and not bool(t_ovf)
    torch_parity.assert_layers_equal(_np(ref), tlayer.layer_to_numpy(got),
                                     atol=1e-6)
    assert int(got.num_blocks) > int(a["num_blocks"])


@pytest.mark.parametrize("kind,resample", [("tsdf", None), ("esdf", None),
                                           ("tsdf", (0.2, 4))],
                         ids=["tsdf", "esdf", "tsdf-resample"])
def test_transform_layer_matches_jax(kind, resample):
    src = _gt(kind)
    T = _yaw(10.0, (0.1, -0.05, 0.02))
    kw = {}
    if resample:
        kw = dict(out_voxel_size=resample[0], out_vps=resample[1])
    ref, j_ovf = jtransform.transform_layer(
        src, (jnp.asarray(T[0]), jnp.asarray(T[1])), **kw)
    got, t_ovf = ttransform.transform_layer(_to_torch(src), (_t(T[0]),
                                                             _t(T[1])), **kw)
    assert not bool(j_ovf) and not bool(t_ovf)
    r, g = _np(ref), tlayer.layer_to_numpy(got)
    names = [k.split("/", 1)[1] for k in r if k.startswith("channel/")]
    torch_parity.assert_layers_equal(
        r, g, atol=1e-5, channels=[n for n in names if n != "color"])
    if "color" in names:
        np.testing.assert_allclose(g["channel/color"], r["channel/color"],
                                   atol=1e-3)
    assert teval.count_observed(got) > (1_000 if resample else 10_000)


def test_naive_transform_and_rmse_at_poses_match_jax():
    src = _gt("tsdf")
    T = _yaw(7.0, (0.13, 0.0, 0.0))
    ref, _ = jtransform.naive_transform_layer(
        src, (jnp.asarray(T[0]), jnp.asarray(T[1])))
    got, _ = ttransform.naive_transform_layer(_to_torch(src),
                                              (_t(T[0]), _t(T[1])))
    torch_parity.assert_layers_equal(_np(ref), tlayer.layer_to_numpy(got))
    # A 7 degree yaw aliases: some targets take several source voxels.
    assert teval.count_observed(got) < teval.count_observed(_to_torch(src))
    # The pose sweep: the identity aligns exactly, a shift does not.
    poses = [_yaw(0.0), _yaw(0.0, (0.2, 0.0, 0.0))]
    ref_d = jeval.evaluate_layer_rmse_at_poses(
        src, src, [(jnp.asarray(R), jnp.asarray(t)) for R, t in poses])
    got_d = teval.evaluate_layer_rmse_at_poses(
        _to_torch(src), _to_torch(src), [(_t(R), _t(t)) for R, t in poses])
    for r, g in zip(ref_d, got_d):
        assert g.num_evaluated_voxels == r.num_evaluated_voxels > 1000
        assert abs(g.rmse - r.rmse) <= 1e-6 and abs(
            g.max_error - r.max_error) <= 1e-5
    assert got_d[0].rmse < 1e-5 < 0.05 < got_d[1].rmse


def test_frustum_matches_jax():
    R = np.asarray(jsw.rotation_from_two_vectors(
        jnp.asarray([0.0, 0.0, 1.0]), jnp.asarray([0.6, 0.8, 0.0])))
    t = np.asarray([0.5, -1.0, 1.2], np.float32)
    ref = jcamera.frustum_from_fov((R, t), np.deg2rad(70.0), np.deg2rad(50.0),
                                   0.3, 6.0)
    got = tcamera.frustum_from_fov((_t(R), _t(t)), np.deg2rad(70.0),
                                   np.deg2rad(50.0), 0.3, 6.0, device="cpu")
    for f in ("normals", "offsets", "aabb_min", "aabb_max"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(ref, f)), atol=1e-6)
    pts = np.random.default_rng(0).uniform(-6, 6, (20_000, 3)).astype(
        np.float32)
    inside = tcamera.points_in_frustum(got, _t(pts)).numpy()
    np.testing.assert_array_equal(
        inside, np.asarray(jcamera.points_in_frustum(ref, jnp.asarray(pts))))
    assert 100 < inside.sum() < 10_000
    blocks = np.random.default_rng(1).integers(-8, 8, (5_000, 3)).astype(
        np.int32)
    got_b = tcamera.blocks_in_frustum(got, _t(blocks), 0.8).numpy()
    np.testing.assert_array_equal(got_b, np.asarray(
        jcamera.blocks_in_frustum(ref, jnp.asarray(blocks), 0.8)))
    assert got_b.sum() > 50
