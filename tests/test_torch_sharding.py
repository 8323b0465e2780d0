"""Port parity, multi-device sharding (voxblox_tpu/parallel/sharding.py on
torch.distributed): the ray-sharded simple integrate, the scan-sharded
projective batch, the ray-sharded render gradient, the mesh shapes and
the block placement. The block-sharded sweep is in
test_torch_sharding_sweep.py.

tests/test_parallel.py's scene (sphere + ground, a 32x24 scan, 0.1 m
voxels; K=8 organized 32x24 orbit scans; 64 rays over +-0.2 rad) at a
pool of 256 blocks. The JAX side runs the JAX sharded functions in this
process on a 1x1 mesh; the port runs W = 1, 2 and 4 gloo CPU ranks
(tests/torch_dist.py), each world size spawned once for the module.
Bounds:
- ray-sharded integrate: W=1 bit-equal to the port's unsharded
  ``integrate_pointcloud(method="simple")``; W=2 (rays=2) and W=4 ((2,2)
  mesh) against W=1 at test_parallel's bounds (rmse < 1e-4, max |dtsdf|
  < 1e-4 where weight > 1e-3); each W against JAX at the 5% share that
  test_torch_tsdf.py holds the simple integrator to;
- scan-sharded batch: W=1 bit-equal to ``integrate_organized_projective_
  batch`` (the same scans summed in the same order); W=2/4 against W=1
  with identical blocks, rmse < 1e-5, max weight difference < 1e-3
  (test_parallel); each W against JAX at atol = rtol = 1e-5;
- render gradient: loss within rel 1e-3 and gradient within 1e-4 of the
  single-process port (test_parallel), gradient within 1e-5 of JAX's;
- every rank ends with the same map, bit for bit.
"""

import dataclasses
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voxblox_tpu.core import layer as jlayer
from voxblox_tpu.core.config import TsdfIntegratorConfig as JCfg
from voxblox_tpu.parallel import sharding as jsharding
from voxblox_tpu.sim import world as jsw

from voxblox_tpu_torch.core import layer as tlayer
from voxblox_tpu_torch.ops import projective as tproj
from voxblox_tpu_torch.ops import render as trender
from voxblox_tpu_torch.ops import tsdf as ttsdf
from voxblox_tpu_torch.utils import evaluation as teval

import torch_dist
import torch_parity
from test_torch_esdf import tlayer_to_jax
from test_torch_projective import _assert_maps_match
from test_torch_tsdf import _close_but_for_a_share

WORLDS = (1, 2, 4)
MAX_BLOCKS = 256
CFG = dict(default_truncation_distance=0.4, max_ray_length_m=8.0)


def scene_inputs(seed: int = 0) -> dict:
    """test_parallel's scene through the JAX sim, as numpy: one flat scan
    from (0, -4, 2), K=8 organized orbit scans, and 64 render rays whose
    target depths carry seeded noise."""
    w = jsw.SimulationWorld()
    w.add_sphere((0.0, 0.0, 2.0), 1.5, color=(255, 0, 0))
    w.add_ground_level(0.0)
    objs = w.freeze()
    view = jnp.asarray([0.0, 1.0, 0.0])
    R = jsw.rotation_from_two_vectors(jnp.asarray([0.0, 0.0, 1.0]), view)
    t = jnp.asarray([0.0, -4.0, 2.0])
    pts_G, colors, valid = jsw.pointcloud_from_viewpoint(
        objs, t, view, (32, 24), np.deg2rad(60.0), 8.0)
    pts_C = jsw.world_points_to_sensor((R, t), pts_G, valid)
    K, res = 8, (32, 24)
    scans = []
    for i in range(K):
        a = 2 * np.pi * i / K
        pos = jnp.asarray([3.0 * np.cos(a), 3.0 * np.sin(a), 2.0],
                          jnp.float32)
        v = jnp.asarray([-np.cos(a), -np.sin(a), 0.0], jnp.float32)
        Ri = jsw.rotation_from_two_vectors(jnp.asarray([0.0, 0.0, 1.0]), v)
        p, c, _, intr = jsw.organized_pointcloud_from_transform(
            objs, (Ri, pos), res, np.deg2rad(60.0), 8.0)
        scans.append((Ri, pos, p, c))
    n = 64
    ang = np.linspace(-0.2, 0.2, n).astype(np.float32)
    rng = np.random.default_rng(seed)
    return dict(
        R=np.array(R), t=np.array(t), pts_C=np.array(pts_C),
        colors=np.array(colors),
        **{k: np.stack([np.array(s[i]) for s in scans])
           for i, k in enumerate(("Rs", "ts", "pts_K", "cols_K"))},
        intr=tuple(float(x) for x in intr),
        origins=np.tile([0.0, -4.0, 2.0], (n, 1)).astype(np.float32),
        dirs=np.stack([np.sin(ang), np.cos(ang), np.zeros(n)],
                      -1).astype(np.float32),
        target=(2.5 + rng.normal(0.0, 0.1, n)).astype(np.float32))


def port_map(inp):
    """The port's unsharded simple integrate of the flat scan."""
    from voxblox_tpu_torch.core.config import TsdfIntegratorConfig

    layer = tlayer.make_layer("tsdf", 0.1, vps=16, max_blocks=MAX_BLOCKS,
                              device="cpu")
    layer, _, ovf = ttsdf.integrate_pointcloud(
        layer, (torch.as_tensor(inp["R"]), torch.as_tensor(inp["t"])),
        torch.as_tensor(inp["pts_C"]), torch.as_tensor(inp["colors"]),
        TsdfIntegratorConfig(**CFG), method="simple")
    assert not bool(ovf)
    return layer


def _render_loss(layer, inp):
    tsdf = layer.channels["tsdf"].clone().requires_grad_(True)
    lyr = dataclasses.replace(
        layer, channels={**layer.channels, "tsdf": tsdf})
    depth, hit = trender.render_depth(lyr, torch.as_tensor(inp["origins"]),
                                      torch.as_tensor(inp["dirs"]), 8.0)
    err = torch.where(hit, depth - torch.as_tensor(inp["target"]), 0.0)
    loss = (err * err).sum()
    loss.backward()
    return float(loss.detach()), tsdf.grad.numpy()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every world size's ranks (started first, run in the background),
    the JAX references on a 1x1 mesh and the port's unsharded paths."""
    from voxblox_tpu_torch.core.config import TsdfIntegratorConfig

    tmp = tmp_path_factory.mktemp("sharding")
    inp = scene_inputs()
    tmap = port_map(inp)
    inp["tsdf_map"] = tlayer.layer_to_numpy(tmap)
    with open(tmp / "inputs.pkl", "wb") as f:
        pickle.dump(inp, f)
    jobs = {w: torch_dist.Job("sharding", w, tmp) for w in WORLDS}

    ref = {"map": tmap}
    mesh1 = jsharding.make_mesh(1, rays=1)
    jcfg = JCfg(**CFG)
    jl, jo = jsharding.integrate_pointcloud_sharded(
        mesh1, jlayer.make_layer("tsdf", 0.1, vps=16, max_blocks=MAX_BLOCKS),
        (jnp.asarray(inp["R"]), jnp.asarray(inp["t"])),
        jnp.asarray(inp["pts_C"]), jnp.asarray(inp["colors"]), jcfg)
    assert not bool(jo)
    ref["jax_integrate"] = torch_parity.jax_layer_to_numpy(jl)
    batch = dict(kind="pinhole_organized", intrinsics=inp["intr"], pool=2,
                 max_visible_blocks=256)
    jl, jo = jsharding.integrate_projective_batch_sharded(
        mesh1, jlayer.make_layer("tsdf", 0.1, vps=16, max_blocks=MAX_BLOCKS),
        jnp.asarray(inp["Rs"]), jnp.asarray(inp["ts"]),
        jnp.asarray(inp["pts_K"]), jnp.asarray(inp["cols_K"]), jcfg, **batch)
    assert not bool(jo)
    ref["jax_projective"] = jl
    jloss, jgrad = jsharding.render_loss_grad_sharded(
        mesh1, tlayer_to_jax(inp["tsdf_map"]), jnp.asarray(inp["origins"]),
        jnp.asarray(inp["dirs"]), jnp.asarray(inp["target"]), 8.0)
    ref["jax_render"] = (float(jloss), np.asarray(jgrad))

    tl, to = tproj.integrate_organized_projective_batch(
        tlayer.make_layer("tsdf", 0.1, vps=16, max_blocks=MAX_BLOCKS,
                          device="cpu"),
        inp["Rs"], inp["ts"], torch.as_tensor(inp["pts_K"]),
        torch.as_tensor(inp["cols_K"]), TsdfIntegratorConfig(**CFG),
        intrinsics=inp["intr"], pool=2, max_visible_blocks=256)
    assert not bool(to)
    ref["projective"] = tlayer.layer_to_numpy(tl)
    ref["render"] = _render_loss(tmap, inp)
    ref["ranks"] = {w: job.wait() for w, job in jobs.items()}
    print({w: f"{job.seconds:.1f} s" for w, job in jobs.items()})
    return ref


def _rank0(runs, w, key):
    return runs["ranks"][w][0][key]


def _map_close(ref_np, got_np, rmse_bar, tsdf_bar=None):
    """test_parallel's comparison of two maps of the same scene."""
    a = tlayer.layer_from_numpy(ref_np, "cpu")
    b = tlayer.layer_from_numpy(got_np, "cpu")
    det = teval.evaluate_layers_rmse(a, b)
    assert det.num_evaluated_voxels > 1000, det
    assert det.rmse < rmse_bar, det
    if tsdf_bar is not None:
        np.testing.assert_array_equal(got_np["block_ijk"],
                                      ref_np["block_ijk"])
        w = ref_np["channel/weight"]
        diff = np.abs(got_np["channel/tsdf"] - ref_np["channel/tsdf"])
        assert diff[w > 1e-3].max() < tsdf_bar, diff[w > 1e-3].max()
    return det


@pytest.mark.parametrize("w", WORLDS)
def test_every_rank_holds_the_same_result(runs, w):
    ranks = runs["ranks"][w]
    for r in ranks[1:]:
        for key in ("integrate", "projective"):
            torch_parity.assert_layers_equal(ranks[0][key][0], r[key][0])
            assert r[key][1] == ranks[0][key][1]
        assert r["render"][0] == ranks[0]["render"][0]
        np.testing.assert_array_equal(r["render"][1], ranks[0]["render"][1])


def test_mesh_shapes(runs):
    assert _rank0(runs, 1, "mesh_shapes") == {"rays": (1, 1),
                                              "blocks": (1, 1)}
    assert _rank0(runs, 2, "mesh_shapes") == {"rays": (2, 1),
                                              "blocks": (1, 2)}
    assert _rank0(runs, 4, "mesh_shapes") == {
        "rays": (2, 2), "blocks": (2, 2), "default": (2, 2), "rays4": (4, 1)}


@pytest.mark.parametrize("w", WORLDS)
def test_ray_sharded_integrate(runs, w):
    got, ovf = _rank0(runs, w, "integrate")
    assert not ovf
    if w == 1:
        torch_parity.assert_layers_equal(
            tlayer.layer_to_numpy(runs["map"]), got)
    else:
        _map_close(_rank0(runs, 1, "integrate")[0], got, 1e-4, 1e-4)


@pytest.mark.parametrize("w", WORLDS)
def test_ray_sharded_integrate_matches_jax(runs, w):
    off, observed = _close_but_for_a_share(
        runs["jax_integrate"], _rank0(runs, w, "integrate")[0], 0.05)
    print(f"W={w}: {off} of {observed} observed voxels off by > 1e-5")


@pytest.mark.parametrize("w", WORLDS)
def test_scan_sharded_projective_batch(runs, w):
    got, ovf = _rank0(runs, w, "projective")
    assert not ovf
    if w == 1:
        torch_parity.assert_layers_equal(runs["projective"], got)
    else:
        ref = _rank0(runs, 1, "projective")[0]
        _map_close(ref, got, 1e-5)
        np.testing.assert_array_equal(got["block_ijk"], ref["block_ijk"])
        wd = np.abs(got["channel/weight"] - ref["channel/weight"]).max()
        assert wd < 1e-3, wd


@pytest.mark.parametrize("w", WORLDS)
def test_scan_sharded_projective_batch_matches_jax(runs, w):
    got = tlayer.layer_from_numpy(_rank0(runs, w, "projective")[0], "cpu")
    _assert_maps_match(runs["jax_projective"], got)


@pytest.mark.parametrize("w", WORLDS)
def test_render_loss_grad_sharded(runs, w):
    loss, grad = _rank0(runs, w, "render")
    ref_loss, ref_grad = runs["render"]
    assert ref_loss > 0.0 and np.abs(ref_grad).max() > 0.0
    assert abs(loss - ref_loss) < 1e-3 * max(1.0, abs(ref_loss))
    assert np.abs(grad - ref_grad).max() < 1e-4
    jloss, jgrad = runs["jax_render"]
    assert abs(loss - jloss) < 1e-3 * max(1.0, abs(jloss))
    np.testing.assert_allclose(grad, jgrad, atol=1e-5)


@pytest.mark.parametrize("w", [2, 4])
def test_shard_layer_blocks(runs, w):
    """Each rank's channel rows are its torch.chunk share along 'blocks'
    (replicated along 'rays'); full_tensor() reassembles the input."""
    size = (1, 2) if w == 2 else (2, 2)
    for r in runs["ranks"][w]:
        p = r["placement"]
        share = torch.arange(MAX_BLOCKS).chunk(size[1])[p["coordinate"][1]]
        for name, shape in p["local_rows"].items():
            assert shape[0] == share.numel(), (name, shape)
        assert p["full_equal"] and p["replicated_equal"]
    coords = sorted(r["placement"]["coordinate"] for r in runs["ranks"][w])
    assert coords == sorted({(i, j) for i in range(size[0])
                             for j in range(size[1])})


def test_axes_group_follows_a_new_world(tmp_path):
    """The group of several axes is cached per world: after
    ``destroy_process_group`` and a new world (as chip_smoke.py's phase 22
    does), a mesh of the same shape gets a subgroup of the new world, not
    of the destroyed one."""
    import torch.distributed as dist

    from voxblox_tpu_torch.parallel import sharding

    for i in range(2):
        dist.init_process_group("gloo",
                                init_method=f"file://{tmp_path}/store{i}",
                                world_size=1, rank=0)
        try:
            mesh = sharding.make_mesh(1, device_type="cpu")
            group, index, count = sharding._axes_group(mesh,
                                                       ("rays", "blocks"))
            # A group of a destroyed world is unknown to the new one.
            assert dist.get_process_group_ranks(group) == [0]
            x = torch.ones(3)
            dist.all_reduce(x, group=group)
            assert (index, count) == (0, 1)
            assert torch.equal(x, torch.ones(3))
        finally:
            dist.destroy_process_group()
