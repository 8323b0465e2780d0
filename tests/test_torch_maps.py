"""Port parity, the query layer (voxblox_tpu/ops/interp.py and
voxblox_tpu/models/maps.py).

A TSDF map of two organized scans is built by the JAX package, its ESDF
by a batch rebuild, and both are carried to the port with
``layer_from_numpy``; an occupancy layer gets seeded random log-odds.
Every query function then runs in both packages on the same seeded
random positions in the maps' bounds (and on a plane slice): values,
gradients and colours atol 1e-5, validity masks exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voxblox_tpu.core import layer as jlayer
from voxblox_tpu.core.config import EsdfIntegratorConfig as JE
from voxblox_tpu.core.config import MapConfig as JM
from voxblox_tpu.core.config import TsdfIntegratorConfig as JT
from voxblox_tpu.models import maps as jmaps
from voxblox_tpu.ops import esdf as jesdf
from voxblox_tpu.ops import interp as jinterp
from voxblox_tpu.ops import projective as jproj

from voxblox_tpu_torch.core import layer as tlayer
from voxblox_tpu_torch.core.config import MapConfig as TM
from voxblox_tpu_torch.models import maps as tmaps
from voxblox_tpu_torch.ops import interp as tinterp

import torch_parity
from test_torch_projective import _scans


@pytest.fixture(scope="module")
def layers():
    scans = _scans([0.0, 1.5], organized=True)
    intr = scans[0][4]
    jt = jlayer.make_layer("tsdf", 0.2, vps=8, max_blocks=512)
    for R, t, pts, col, _ in scans:
        jt, _, _ = jproj.integrate_organized_projective(
            jt, (jnp.asarray(R), jnp.asarray(t)), pts, col,
            JT(default_truncation_distance=0.8, max_ray_length_m=10.0),
            intrinsics=intr, pool=2)
    je, _, _ = jesdf.update_from_tsdf_batch(
        jlayer.make_layer("esdf", 0.2, vps=8, max_blocks=512), jt,
        JE(max_distance_m=2.0, default_distance_m=2.0, min_distance_m=0.4,
           max_active_blocks=256))
    rs = np.random.default_rng(5)
    jo = jlayer.make_layer("occupancy", 0.2, vps=8, max_blocks=64)
    blocks = np.stack(np.meshgrid(*[np.arange(-1, 2)] * 3, indexing="ij"),
                      -1).reshape(-1, 3).astype(np.int32)
    jo, _ = jlayer.allocate_blocks(jo, jnp.asarray(blocks),
                                   jnp.ones(len(blocks), bool))
    o = torch_parity.jax_layer_to_numpy(jo)
    o["channel/log_odds"] = rs.normal(0, 2, o["channel/log_odds"].shape
                                      ).astype(np.float32)
    o["channel/occ_observed"] = (rs.uniform(
        size=o["channel/occ_observed"].shape) < 0.9).astype(np.uint8)
    out = {}
    for name, d in (("tsdf", torch_parity.jax_layer_to_numpy(jt)),
                    ("esdf", torch_parity.jax_layer_to_numpy(je)),
                    ("occupancy", o)):
        out[name] = (_to_jax(d), tlayer.layer_from_numpy(d, "cpu"))
    return out


def _to_jax(d):
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


def _points(layer, n=3000, seed=0):
    """Seeded positions in the bounds of the layer's active blocks."""
    d = tlayer.layer_to_numpy(layer)
    act = (d["block_flags"] & 128) != 0
    lo = d["block_ijk"][act].min(0) * layer.block_size
    hi = (d["block_ijk"][act].max(0) + 1) * layer.block_size
    return np.random.default_rng(seed).uniform(lo, hi, (n, 3)).astype(
        np.float32)


def _same(ref, got, what):
    ref = [np.asarray(r) for r in ref]
    got = [g.numpy() for g in got]
    for r, g in zip(ref, got):
        if r.dtype == bool:
            np.testing.assert_array_equal(g, r, err_msg=what)
            assert r.any() and not r.all(), what  # both cases occur
        else:
            np.testing.assert_allclose(g, r, atol=1e-5, err_msg=what)


@pytest.mark.parametrize("fn", ["interpolate", "nearest",
                                "interpolate_with_gradient",
                                "gradient_central",
                                "adaptive_distance_and_gradient"])
@pytest.mark.parametrize("kind", ["tsdf", "esdf", "occupancy"])
def test_interp_functions_match_jax(layers, fn, kind):
    jl, tl = layers[kind]
    pts = _points(tl)
    ref = jax.jit(lambda p: getattr(jinterp, fn)(jl, p))(pts)
    got = getattr(tinterp, fn)(tl, torch.as_tensor(pts))
    _same(ref, got, f"{fn} on {kind}")


def test_trilinear_color_matches_jax(layers):
    jl, tl = layers["tsdf"]
    pts = _points(tl)
    ref = jax.jit(lambda p: jinterp.interpolate_trilinear_color(jl, p))(pts)
    _same(ref, tinterp.interpolate_trilinear_color(tl, torch.as_tensor(pts)),
          "colour")


def test_map_classes_match_jax(layers):
    jt, tt = layers["tsdf"]
    je, te = layers["esdf"]
    jo, to = layers["occupancy"]
    jm, tm = JM(voxel_size=0.2, voxels_per_side=8), TM(voxel_size=0.2,
                                                        voxels_per_side=8)
    maps = [(jmaps.TsdfMap(jt, jm), tmaps.TsdfMap(tt, tm)),
            (jmaps.EsdfMap(je, jm), tmaps.EsdfMap(te, tm)),
            (jmaps.OccupancyMap(jo, jm), tmaps.OccupancyMap(to, tm))]
    pts = _points(te)
    tp = torch.as_tensor(pts)
    (jtm, ttm), (jem, tem), (jom, tom) = maps
    for interp_ in (True, False):
        _same(jtm.get_distance_at_position(pts, interp_),
              ttm.get_distance_at_position(tp, interp_), "tsdf distance")
        _same(jtm.get_weight_at_position(pts, interp_),
              ttm.get_weight_at_position(tp, interp_), "tsdf weight")
        _same(jem.get_distance_at_position(pts, interp_),
              tem.get_distance_at_position(tp, interp_), "esdf distance")
        _same(jem.get_distance_and_gradient_at_position(pts, interp_),
              tem.get_distance_and_gradient_at_position(tp, interp_),
              "esdf gradient")
    _same(jem.get_distance_and_gradient_at_position(pts, adaptive=True),
          tem.get_distance_and_gradient_at_position(tp, adaptive=True),
          "esdf adaptive")
    _same([jem.is_observed(pts)], [tem.is_observed(tp)], "observed")
    po = _points(to) * 1.5  # reaching past the allocated blocks
    _same(jom.occupancy_probability(po),
          tom.occupancy_probability(torch.as_tensor(po)), "occupancy")
    for axis in range(3):
        _same(jtm.coord_plane_slice(axis, 1.0, extent=4.0),
              ttm.coord_plane_slice(axis, 1.0, extent=4.0), "tsdf slice")
        _same(jem.coord_plane_slice(axis, 1.0, extent=4.0, step=0.15),
              tem.coord_plane_slice(axis, 1.0, extent=4.0, step=0.15),
              "esdf slice")
    rp, rd = jem.traversable_points(0.5)
    gp, gd = tem.traversable_points(0.5)
    assert len(rp) > 200
    np.testing.assert_array_equal(gp, rp)
    np.testing.assert_array_equal(gd, rd)
    assert tmaps.EsdfMap.create(tm, device="cpu").layer.layer_type == "esdf"
