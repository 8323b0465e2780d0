"""Port parity, ray-casting TSDF integrators (voxblox_tpu/ops/tsdf.py):
simple, merged (with and without anti-grazing) and fast over three scans,
the integrator flags of tests/test_integrator_flags.py, and the servers'
ray-casting methods (with distance pruning) against the JAX servers.

The JAX program computes the rays' endpoints and the voxel-origin dot
products with fused multiply-adds; the port emulates them
(``ops/raycast.fma``), but the JAX compiler fuses other multiply-adds
across the whole program too, so a ray's endpoint can still land one ulp
away and its DDA path one voxel over. Tolerances, per map:
- blocks, rows, flags and hash table exact; the fast integrator's stamp
  set the same but for 0.1% of its cells;
- observed voxels (weight > 0) the same but for 0.1% of them;
- at most 1% (fast) or 5% (simple, merged) of the observed voxels off by
  more than 1e-5 in TSDF (atol) or weight (atol and rtol); the colours of
  all others within 1e-3.
The flag cases (one or two rays) hold TSDF and weight at 1e-5 everywhere.

The same holds where simple and merged scatter through the walk kernel
(csrc/tsdf_walk.cu): on the CPU its source compiled with g++ in the place
of the chain's scatter, and on a card (tests marked ``cuda``) the kernel
itself, with the port's layer there.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voxblox_tpu.core import grid as jgrid
from voxblox_tpu.core import layer as jlayer
from voxblox_tpu.core.config import TsdfIntegratorConfig as JCfg
from voxblox_tpu.ops import tsdf as jt

from voxblox_tpu_torch.core import layer as tlayer
from voxblox_tpu_torch.core.config import TsdfIntegratorConfig as TCfg
from voxblox_tpu_torch.ops import tsdf as tt
from voxblox_tpu_torch.ops import tsdf_walk
from voxblox_tpu_torch.sim import world as tsw

import torch_parity
from test_torch_tsdf_walk import _emulate, emulation  # noqa: F401 (fixture)
from torch_parity import cuda_device  # noqa: F401  (fixture)

VOXEL = 0.1
CFG = dict(default_truncation_distance=0.4, max_ray_length_m=10.0)


def _scans(n=3, res=(40, 30)):
    """Flat sensor-frame scans of the cylinder + ground scene from a
    circle of poses (tests/test_tsdf_integration.py's camera frames)."""
    w = tsw.SimulationWorld()
    w.add_cylinder((0.0, 0.0, 2.0), 2.0, 4.0, color=(0, 255, 0))
    w.add_ground_level(0.0)
    objs = w.freeze("cpu")
    out = []
    for i in range(n):
        a = 2 * np.pi * i / 8
        pos = torch.tensor([4 * np.cos(a), 4 * np.sin(a), 2.0],
                           dtype=torch.float32)
        z = torch.tensor([-np.cos(a), -np.sin(a), 0.0], dtype=torch.float32)
        x = torch.linalg.cross(z, torch.tensor([0.0, 0.0, 1.0]))
        x = x / torch.linalg.norm(x)
        R = torch.stack([x, torch.linalg.cross(z, x), z], 1)
        pg, col, val = tsw.pointcloud_from_transform(
            objs, (R, pos), res, np.deg2rad(60.0), 10.0)
        pts = tsw.world_points_to_sensor((R, pos), pg, val)
        out.append(tuple(v.numpy() for v in (R, pos, pts, col)))
    return out


def _close_but_for_a_share(ref, got, share):
    for k in ("num_blocks", "block_ijk", "block_flags", "table/slot"):
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    rw, gw = ref["channel/weight"], got["channel/weight"]
    rt, gt = ref["channel/tsdf"], got["channel/tsdf"]
    observed = int((rw > 0).sum())
    assert observed > 5000, observed
    assert ((rw > 0) != (gw > 0)).sum() <= 1e-3 * observed
    off = (np.abs(gw - rw) > 1e-5 + 1e-5 * rw) | (np.abs(gt - rt) > 1e-5)
    assert off.sum() <= share * observed, (int(off.sum()), observed)
    ok = ~off
    rc = ref["channel/color"].reshape(rw.shape + (3,))
    gc = got["channel/color"].reshape(rw.shape + (3,))
    np.testing.assert_allclose(gc[ok], rc[ok], atol=1e-3)
    return int(off.sum()), observed


def _integrators_match_jax(method, anti_grazing, device="cpu"):
    """Three scans through both packages' integrators, the port's layer on
    ``device``; the maps held to each other as the module docstring says.
    Returns the number of scans."""
    cfg = dict(CFG, enable_anti_grazing=anti_grazing)
    jl = jlayer.make_layer("tsdf", VOXEL, vps=8, max_blocks=4096)
    tl = tlayer.make_layer("tsdf", VOXEL, vps=8, max_blocks=4096,
                           device=device)
    js = jt.make_fast_state() if method == "fast" else None
    ts = tt.make_fast_state(device=device) if method == "fast" else None
    scans = _scans()
    for R, t, pts, col in scans:
        jl, js, jo = jt.integrate_pointcloud(
            jl, (jnp.asarray(R), jnp.asarray(t)), jnp.asarray(pts),
            jnp.asarray(col), JCfg(**cfg), method=method, state=js)
        tl, ts, to = tt.integrate_pointcloud(
            tl, tuple(torch.as_tensor(x, device=device) for x in (R, t)),
            torch.as_tensor(pts, device=device),
            torch.as_tensor(col, device=device), TCfg(**cfg),
            method=method, state=ts)
        assert bool(jo) == bool(to) is False
    ref = torch_parity.jax_layer_to_numpy(jl)
    got = tlayer.layer_to_numpy(tl)
    off, observed = _close_but_for_a_share(
        ref, got, 0.01 if method == "fast" else 0.05)
    print(f"{method} anti_grazing={anti_grazing} on {device}: {off} of "
          f"{observed} observed voxels off by more than 1e-5")
    if method == "fast":
        _stamps_close(js, ts)
        assert int(ts.frame) == int(js.frame) == 4
    return len(scans)


@pytest.mark.parametrize("method,anti_grazing", [
    ("simple", False), ("merged", False), ("merged", True), ("fast", False)])
def test_integrators_match_jax(method, anti_grazing):
    _integrators_match_jax(method, anti_grazing)


_KERNEL_CASES = [("simple", False), ("merged", False), ("merged", True)]


@pytest.mark.parametrize("method,anti_grazing", _KERNEL_CASES)
def test_emulated_kernel_integrators_match_jax(emulation, monkeypatch,
                                               method, anti_grazing):
    """The walk kernel's source (csrc/tsdf_walk.cu, compiled for the CPU
    by tests/test_torch_tsdf_walk.py's fixture) in the place of the chain's
    scatter: every scan's accumulators are what the kernel's per-ray
    function adds on the chain's rays and table, and the map is held to
    the JAX integrators at the CPU port's tolerances."""
    chain = tt._chain_samples
    seen = {}
    scattered = []

    def spy(layer, rays, max_steps, cfg, state=None):
        seen.update(layer=layer, rays=rays, max_steps=max_steps, cfg=cfg)
        return chain(layer, rays, max_steps, cfg, state)

    def kernel_sums(*args):
        scattered.append(1)
        return _emulate(emulation, seen)[2]

    monkeypatch.setattr(tt, "_chain_samples", spy)
    monkeypatch.setattr(tt, "_accumulate_flat", kernel_sums)
    assert _integrators_match_jax(method, anti_grazing) == len(scattered)


@pytest.mark.cuda
@pytest.mark.parametrize("method,anti_grazing", _KERNEL_CASES)
def test_cuda_kernel_integrators_match_jax(cuda_device, method,
                                           anti_grazing):
    """The port's layer on the card, where simple and merged walk, weigh,
    look up and scatter in the walk kernel (one launch a scan), held to
    the JAX integrators at the CPU port's tolerances."""
    before = tsdf_walk.LAUNCHES
    scans = _integrators_match_jax(method, anti_grazing, cuda_device)
    assert tsdf_walk.LAUNCHES - before == scans


def _stamps_close(js, ts):
    """The fast integrator's stamp sets: the same but for 0.1% of the
    stamped cells (a ray moved by a voxel stamps another cell)."""
    r = np.asarray(js.observed_stamp).astype(np.int64)
    g = ts.observed_stamp.numpy()
    assert (r != g).sum() <= 1e-3 * (r > 0).sum(), ((r != g).sum(),
                                                     (r > 0).sum())


def _one_ray(cfg, points, method="simple", device="cpu"):
    """Both packages integrate ``points`` (sensor = world frame) into an
    8-voxel-block layer, the port's on ``device``; returns the port's
    layer."""
    pts = np.asarray(points, np.float32)
    cols = np.zeros_like(pts)
    jl = jlayer.make_layer("tsdf", VOXEL, vps=8, max_blocks=256)
    tl = tlayer.make_layer("tsdf", VOXEL, vps=8, max_blocks=256,
                           device=device)
    js = jt.make_fast_state() if method == "fast" else None
    ts = tt.make_fast_state(device=device) if method == "fast" else None
    jl, _, _ = jt.integrate_pointcloud(
        jl, (jnp.eye(3), jnp.zeros(3)), jnp.asarray(pts), jnp.asarray(cols),
        JCfg(**cfg), method=method, state=js)
    tl, _, _ = tt.integrate_pointcloud(
        tl, (torch.eye(3, device=device), torch.zeros(3, device=device)),
        torch.as_tensor(pts, device=device),
        torch.as_tensor(cols, device=device), TCfg(**cfg), method=method,
        state=ts)
    torch_parity.assert_layers_equal(
        torch_parity.jax_layer_to_numpy(jl), tlayer.layer_to_numpy(tl),
        atol=1e-5, rtol=1e-5, channels=["tsdf", "weight"])
    return tl


def _voxel(layer, xyz, channel="weight"):
    gvi = torch.floor(torch.tensor([xyz], dtype=torch.float32) / VOXEL
                      + jgrid.EPS).to(torch.int32).to(layer.device)
    v, found = tlayer.get_voxels(layer, channel, gvi)
    return float(v[0]), bool(found[0])


_BASE = dict(default_truncation_distance=0.2, max_ray_length_m=5.0)
_FLAGS = {
    # name: (cfg, points, method, check(layer))
    "carving_on": (_BASE, [(0, 0, 1.0)], "simple",
                   lambda l: _voxel(l, (0, 0, 0.25))[0] > 0),
    "carving_off": (dict(_BASE, voxel_carving_enabled=False),
                    [(0, 0, 1.0)], "simple",
                    lambda l: _voxel(l, (0, 0, 0.25))[0] == 0.0
                    and _voxel(l, (0, 0, 0.95))[0] > 0),
    "const_weight": (dict(_BASE, use_const_weight=True,
                          use_weight_dropoff=False), [(0, 0, 2.0)], "simple",
                     lambda l: abs(_voxel(l, (0, 0, 1.95))[0] - 1.0) < 1e-5),
    "inverse_square_weight": (dict(_BASE, use_weight_dropoff=False),
                              [(0, 0, 2.0)], "simple",
                              lambda l: abs(_voxel(l, (0, 0, 1.95))[0]
                                            - 0.25) < 1e-2),
    "weight_dropoff": (dict(_BASE, default_truncation_distance=0.3,
                            use_const_weight=True), [(0, 0, 1.0)], "simple",
                       lambda l: _voxel(l, (0, 0, 1.25))[0]
                       < 0.6 * _voxel(l, (0, 0, 0.85))[0]),
    "sparsity_compensation": (
        dict(_BASE, use_const_weight=True, use_weight_dropoff=False,
             use_sparsity_compensation_factor=True,
             sparsity_compensation_factor=10.0), [(0, 0, 1.0)], "simple",
        lambda l: _voxel(l, (0, 0, 0.95))[0] > 5 * _voxel(l, (0, 0, 0.35))[0]),
    "allow_clear": (dict(_BASE, max_ray_length_m=1.5, allow_clear=True,
                         use_const_weight=True), [(0, 0, 3.0)], "simple",
                    lambda l: _voxel(l, (0, 0, 0.55))[0] > 0),
    "no_clear": (dict(_BASE, max_ray_length_m=1.5, allow_clear=False,
                      use_const_weight=True), [(0, 0, 3.0)], "simple",
                 lambda l: _voxel(l, (0, 0, 0.55))[0] == 0.0),
    "anti_grazing": (dict(_BASE, use_const_weight=True,
                          enable_anti_grazing=True),
                     [(0, 0, 1.0), (0, 0, 2.0)], "merged",
                     lambda l: _voxel(l, (0, 0, 1.05))[0] <= 1.0 + 1e-4),
    "grazing": (dict(_BASE, use_const_weight=True),
                [(0, 0, 1.0), (0, 0, 2.0)], "merged",
                lambda l: _voxel(l, (0, 0, 1.05))[0] > 1.5),
    "fast_one_ray": (_BASE, [(0, 0, 1.0), (0.001, 0, 1.0)], "fast",
                     lambda l: _voxel(l, (0, 0, 0.95))[0] > 0),
}


@pytest.mark.parametrize("name", sorted(_FLAGS))
def test_integrator_flags_match_jax(name):
    """The configuration knobs (tsdf_integrator.h:56-89) on one or two
    rays along +z: both packages give the same layer, and the behaviour
    tests/test_integrator_flags.py asserts holds on the port."""
    cfg, points, method, check = _FLAGS[name]
    assert check(_one_ray(cfg, points, method))


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(
    n for n, case in _FLAGS.items() if case[2] != "fast"))
def test_cuda_kernel_integrator_flags_match_jax(cuda_device, name):
    """The flag cases of simple and merged with the port's layer on the
    card, through the walk kernel (one launch): the same layer as the JAX
    package's at 1e-5, and the same behaviour."""
    cfg, points, method, check = _FLAGS[name]
    before = tsdf_walk.LAUNCHES
    assert check(_one_ray(cfg, points, method, cuda_device))
    assert tsdf_walk.LAUNCHES == before + 1


@pytest.mark.parametrize("method,prune", [("simple", 0.0), ("merged", 0.0),
                                          ("fast", 0.0), ("fast", 4.5)])
def test_ray_casting_servers_match_jax(method, prune):
    """TsdfServer(method=m) in both packages over three flat scans of the
    orbit (and, for fast, with max_block_distance_from_body): the same
    blocks, rows and flags, and the TSDF as tests/test_torch_tsdf.py holds
    the integrators (a small share of voxels may differ where the JAX
    program's fused multiply-adds move a ray by a voxel)."""
    from voxblox_tpu.core.config import MapConfig as JM
    from voxblox_tpu.server.mapper import TsdfServer as JaxTsdfServer
    from voxblox_tpu_torch.core.config import MapConfig
    from voxblox_tpu_torch.server.mapper import TsdfServer
    from test_torch_server import _orbit

    w = tsw.SimulationWorld()
    w.add_cylinder((0.0, 0.0, 2.0), 2.0, 4.0, color=(0, 255, 0))
    w.add_ground_level(0.0)
    scans = _orbit(w.freeze("cpu"), [0.0, 0.7, 1.4], False)
    mcfg = dict(voxel_size=0.1, voxels_per_side=8, max_blocks=4096)
    tcfg = dict(default_truncation_distance=0.4, max_ray_length_m=10.0)
    ref = JaxTsdfServer(map_config=JM(**mcfg), integrator_config=JCfg(**tcfg),
                        method=method, max_block_distance_from_body=prune)
    got = TsdfServer(map_config=MapConfig(**mcfg),
                     integrator_config=TCfg(**tcfg),
                     method=method, max_block_distance_from_body=prune,
                     device="cpu")
    for R, t, pts, col, _ in scans:
        ref.insert_pointcloud((jnp.asarray(R.numpy()),
                               jnp.asarray(t.numpy())), pts.numpy(),
                              col.numpy())
        got.insert_pointcloud((R, t), pts, col)
    r = torch_parity.jax_layer_to_numpy(ref.layer)
    g = tlayer.layer_to_numpy(got.layer)
    _close_but_for_a_share(r, g, 0.05)
    if prune:
        active = (g["block_flags"] & 128) != 0
        assert (~active[:int(g["num_blocks"])]).sum() > 0  # some pruned
    if method == "fast":
        _stamps_close(ref.fast_state, got.fast_state)
