"""The block-walk-and-probe kernel of allocation (csrc/tsdf_alloc.cu,
ops/tsdf_alloc.py) against its plain version, the chain of ops/tsdf.py
(``cast_rays`` of the block-scaled segments -> the [7, steps, rays]
dilation -> ``core/layer.allocate_blocks``).

On the CPU the kernel's own source, compiled with g++
(csrc/tsdf_alloc_emulate.cpp), stands in for the CUDA library behind the
wrapper. A find pass gives the chain's pending buffer bit for bit, its
flag, the winners' keys and counters that a plain count over the chain's
candidates gives; whole allocations, round after round, leave the
chain's pool rows, block flags, high-water mark, table and overflow.

Tests marked ``cuda`` run the kernel on a card: against the chain there
on the benchmark's tiny scene, a rolling map with removal and row reuse
and a pool that overflows; one launch and one sync a round; the counters
on rays checked by hand.
"""

import ctypes
import importlib.util
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

from voxblox_tpu_torch import _runtime
from voxblox_tpu_torch.core import grid
from voxblox_tpu_torch.core import hash as vhash
from voxblox_tpu_torch.core import layer as tlayer
from voxblox_tpu_torch.core.config import MapConfig, TsdfIntegratorConfig
from voxblox_tpu_torch.ops import raycast
from voxblox_tpu_torch.ops import tsdf as tt
from voxblox_tpu_torch.ops import tsdf_alloc
from voxblox_tpu_torch.server.mapper import TsdfServer
from voxblox_tpu_torch.utils import timing

from torch_parity import cuda_device  # noqa: F401  (fixture)

VOXEL = 0.1
CPU = torch.device("cpu")

# scripts/tsdf_alloc_kernel.py: the state copy, the comparison of two
# allocations and the exact probe count, shared with the measurement.
_spec = importlib.util.spec_from_file_location(
    "tsdf_alloc_kernel",
    Path(__file__).resolve().parents[1] / "scripts" / "tsdf_alloc_kernel.py")
alloc_tool = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(alloc_tool)


@pytest.fixture(scope="module")
def emulation_lib():
    """csrc/tsdf_alloc_emulate.cpp built with g++ once per module."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the kernel's source for the CPU")
    src = Path(tsdf_alloc.__file__).resolve().parents[1] / "csrc"
    out = Path(tempfile.mkdtemp(prefix="tsdf_alloc_emulate_")) / "lib.so"
    subprocess.run([gxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-o",
                    str(out), str(src / "tsdf_alloc_emulate.cpp")],
                   check=True, capture_output=True, text=True)
    return tsdf_alloc.bind(ctypes.CDLL(str(out)))


@pytest.fixture
def emulated(emulation_lib, monkeypatch):
    """The wrapper launching the emulation on CPU tensors."""
    def launch(name, p, dev):
        assert dev.type == "cpu"
        assert getattr(emulation_lib, name)(ctypes.byref(p), None) == 0

    monkeypatch.setattr(tsdf_alloc, "_launch", launch)
    return emulation_lib


def _cloud(n=1500, seed=0, shift=0.0):
    """Walls, a floor and a box in front of the sensor, a few points beyond
    max_ray_length (clearing rays), a few too close, one NaN."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform([-1.6, -1.1, 1.6], [1.6, 1.1, 3.4], (n, 3))
    pts[: n // 4, 1] = 1.1
    pts[n // 4: n // 2, 2] = 3.4
    pts[n // 2: n // 2 + 200] = rng.uniform([-0.4, -0.3, 2.0],
                                            [0.2, 0.3, 2.3], (200, 3))
    pts[-40:] *= 3.0
    pts[:8] *= 0.01
    pts[9] = np.nan
    pts[:, 0] += shift
    cols = rng.uniform(0.0, 255.0, (n, 3))
    return (torch.as_tensor(pts, dtype=torch.float32),
            torch.as_tensor(cols, dtype=torch.float32))


def _pose(k, dev=CPU):
    """Pose k of a short sweep: the sensor moves along x and turns."""
    a = 0.25 * k
    R = torch.tensor([[np.cos(a), 0.0, np.sin(a)], [0.0, 1.0, 0.0],
                      [-np.sin(a), 0.0, np.cos(a)]], dtype=torch.float32)
    t = torch.tensor([0.37 + 0.4 * k, -0.21, 1.13], dtype=torch.float32)
    return R.to(dev), t.to(dev)


def _cfg(**kw):
    return TsdfIntegratorConfig(default_truncation_distance=0.3,
                                max_ray_length_m=6.0, **kw)


def _assert_same_allocation(a, b):
    diff = alloc_tool.allocation_diff(a, b)
    assert not diff, diff


def _both_ways(monkeypatch):
    """Make every ``allocate_for_rays`` run the kernel's path on a copy of
    the allocation state and then the chain on the layer, and hold the two
    results equal. Returns the list of per-call records: find passes, key
    launches, syncs of each path, blocks after."""
    calls = []

    def spy(layer, setup, valid, max_steps):
        block_steps = max(4, max_steps // layer.vps + 3)
        blocks = raycast.block_segments(setup, layer.vps)
        finds, keys = tsdf_alloc.LAUNCHES, tsdf_alloc.KEY_LAUNCHES
        s0 = _runtime.SYNCS
        a, ovf_a = tt._allocate_kernel(alloc_tool.alloc_state(layer), blocks,
                                       valid, block_steps)
        s1 = _runtime.SYNCS
        b, ovf_b = tt._allocate_chain(layer, blocks, valid, block_steps)
        s2 = _runtime.SYNCS
        _assert_same_allocation(a, b)
        assert bool(ovf_a) == bool(ovf_b)
        calls.append(dict(finds=tsdf_alloc.LAUNCHES - finds,
                          keys=tsdf_alloc.KEY_LAUNCHES - keys,
                          kernel_syncs=s1 - s0, chain_syncs=s2 - s1,
                          blocks=int(b.num_blocks), overflowed=bool(ovf_b)))
        return b, ovf_b

    monkeypatch.setattr(tt, "allocate_for_rays", spy)
    return calls


def _check_rounds(calls):
    """One find pass and one sync a round, one key recovery a round that
    found a missing candidate; the chain reads twice a round."""
    for c in calls:
        assert 1 <= c["finds"] <= 8
        assert (c["keys"] == c["finds"] - 1
                or c["keys"] == c["finds"] == 8)
        assert c["chain_syncs"] - c["kernel_syncs"] == c["finds"]


# ---------------------------------------------------------------------------
# One find pass against the chain's candidates (CPU, the emulation)
# ---------------------------------------------------------------------------

# name -> (layer options, integrator options, pending_size, what to do to
# the map before the pass)
CASES = {
    "vps8": (dict(vps=8), dict(), 8192, None),
    "vps16": (dict(vps=16), dict(), 8192, None),
    "empty_table": (dict(vps=8), dict(), 8192, "empty"),
    "tiny_pending": (dict(vps=8), dict(), 16, None),
    "rays_past_block_steps": (dict(vps=8), dict(max_steps=14), 8192, None),
    "tombstones": (dict(vps=8), dict(), 8192, "remove"),
    "slots_past_the_pool": (dict(vps=8, max_blocks=40), dict(), 8192, None),
    "no_carving": (dict(vps=16), dict(voxel_carving_enabled=False), 64,
                   None),
    "ties": (dict(vps=8), dict(), 8192, "ties"),
}


def _tied(pts):
    """The sensor at a voxel centre, a third of the rays on a diagonal
    (x = y, y = z or x = y = z): equal t to the next block boundary on two
    or three axes, where the walk's tie rule decides."""
    pts = pts.clone()
    k = pts.shape[0] // 9
    pts[:k, 1] = pts[:k, 0]
    pts[k:2 * k, 2] = pts[k:2 * k, 1] + 1.5
    pts[k:2 * k, 1] = pts[k:2 * k, 2]
    pts[2 * k:3 * k, :] = pts[2 * k:3 * k, :1].abs() + 1.0
    return (torch.eye(3), torch.tensor([0.05, 0.05, 0.05])), pts


def _case(name):
    """A map of one scan (through the chain) and the rays of a second scan
    from another pose: (layer, block segments, valid, block_steps,
    pending_size)."""
    layer_kw, cfg_kw, pending, before = CASES[name]
    cfg = _cfg(**cfg_kw)
    layer = tlayer.make_layer("tsdf", VOXEL, device="cpu",
                              **dict(dict(max_blocks=1024), **layer_kw))
    if before != "empty":
        pts, cols = _cloud(seed=0)
        layer, _, _ = tt.integrate_pointcloud(layer, _pose(0), pts, cols,
                                              cfg, method="merged")
    if before == "remove":
        layer = tlayer.remove_distant_blocks(layer, _pose(0)[1], 2.0)
        assert bool((layer.table.keys_w1 == grid.TOMBSTONE_W1).any())
    pts, _ = _cloud(seed=1)
    (R, t), pts = _tied(pts) if before == "ties" else (_pose(1), pts)
    points_G = pts @ R.T + t
    valid, clearing = tt.point_validity(pts, cfg)
    max_steps = cfg.max_steps or raycast.max_steps_hint(
        cfg.max_ray_length_m, cfg.default_truncation_distance, VOXEL,
        cfg.voxel_carving_enabled)
    setup = raycast.compute_ray_segments(
        t.expand(points_G.shape), points_G, clearing, VOXEL,
        cfg.default_truncation_distance, cfg.max_ray_length_m,
        cfg.voxel_carving_enabled)
    block_steps = max(4, max_steps // layer.vps + 3)
    return (layer, raycast.block_segments(setup, layer.vps), valid,
            block_steps, pending)


def _dilate_index(d):
    """Index in tsdf._DILATE of each offset d [..., 3], or -1."""
    j = torch.full(d.shape[:-1], -1, dtype=torch.int64)
    for k, off in enumerate(tt._DILATE):
        j = torch.where((d == torch.tensor(off)).all(-1), k, j)
    return j


@pytest.mark.parametrize("case", sorted(CASES))
def test_emulated_find_pass_matches_chain(emulated, case):
    layer, blocks, valid, steps, pending = _case(case)
    table, r = layer.table, valid.shape[0]
    # The chain's candidates, their lookups and its pending buffer.
    bvox, bmask = raycast.cast_rays(blocks, steps, valid)
    offs = torch.tensor(tt._DILATE, dtype=torch.int32)
    cand = bvox[None] + offs[:, None, None, :]
    w0, w1 = grid.pack_block_index(cand.reshape(-1, 3))
    present = (vhash.lookup(table, w0, w1) >= 0).reshape(7, steps, r)
    mask = bmask[None].expand(7, steps, r)
    missing = mask & ~present
    win = tlayer.pending_winners(w0, w1, missing.reshape(-1), pending)

    counts = torch.zeros(4, dtype=torch.int64)
    found = tsdf_alloc.find_missing(table, raycast.dda_start(blocks),
                                    blocks.num_steps, valid, steps, pending,
                                    counts)
    assert torch.equal(found.win, win)
    assert int(found.flag) == (1 if bool(missing.any()) else -1)
    pw0, pw1, ok = tsdf_alloc.pending_keys(found)
    new = win >= 0
    src = torch.where(new, win, 0)
    assert torch.equal(ok, new)
    assert torch.equal(pw0, torch.where(new, w0[src], 0))
    assert torch.equal(pw1, torch.where(new, w1[src], grid.EMPTY_W1))

    # Counters: a candidate is looked up unless it was one of the previous
    # block's present candidates.
    j = _dilate_index(cand[:, 1:] - bvox[None, :-1])
    prev = torch.gather(present[:, :-1], 0, j.clamp(min=0))
    skipped = torch.cat([torch.zeros(7, 1, r, dtype=torch.bool),
                         (j >= 0) & prev], 1)
    probed = mask & ~skipped
    flat = probed.reshape(-1)
    assert counts.tolist() == [
        int(mask.sum()), int(probed.sum()), int(missing.sum()),
        int(alloc_tool.probes_each(table, w0[flat], w1[flat]).sum())]

    # Each case exercises what it is named for.
    n_steps = blocks.num_steps
    assert bool((~valid).any()) and int(missing.sum()) > 0
    if case == "empty_table":
        assert int(present.sum()) == 0 and int(skipped.sum()) == 0
    else:
        assert 0 < int(skipped.sum()) < int(probed.sum())
    if case == "tiny_pending":
        assert int(new.sum()) < int(torch.unique(
            torch.stack([w0, w1], 1)[missing.reshape(-1)], dim=0).shape[0])
    if case == "rays_past_block_steps":
        assert bool((valid & (n_steps >= steps)).any())
    if case == "ties":
        t_next = raycast.dda_start(blocks).t_next[valid]
        assert int((t_next[:, 0] == t_next[:, 1]).sum()) > 50
        assert int(((t_next[:, 0] == t_next[:, 1])
                    & (t_next[:, 1] == t_next[:, 2])).sum()) > 10
    if case == "slots_past_the_pool":
        past = table.slot >= layer.max_blocks
        assert bool(past.any())
        keys = torch.stack([table.keys_w0[past], table.keys_w1[past]], 1)
        cands = torch.stack([w0, w1], 1)[mask.reshape(-1)]
        seen = (cands[:, None, :] == keys[None]).all(-1).any(1)
        assert bool(seen.any())  # candidates the pass found present


def test_params_refuse_what_the_kernel_does_not_take():
    layer, blocks, valid, steps, pending = _case("vps8")
    dda = raycast.dda_start(blocks)
    args = (layer.table, dda, blocks.num_steps, valid, steps)
    tsdf_alloc.make_params(*args, pending)
    with pytest.raises(TypeError, match="num_steps"):
        tsdf_alloc.make_params(layer.table, dda, blocks.num_steps.long(),
                               valid, steps, pending)
    with pytest.raises(ValueError, match="valid"):
        tsdf_alloc.make_params(layer.table, dda, blocks.num_steps,
                               valid[:-1], steps, pending)
    with pytest.raises(ValueError, match="power of two"):
        tsdf_alloc.make_params(*args, 1000)
    with pytest.raises(ValueError, match="block_steps"):
        tsdf_alloc.make_params(layer.table, dda, blocks.num_steps, valid, 0,
                               pending)
    with pytest.raises(ValueError, match="CUDA"):
        tsdf_alloc.find_missing(*args, pending)


# ---------------------------------------------------------------------------
# Whole allocations, round after round (CPU, the emulation)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("scene", ["sweep_vps8_merged", "sweep_vps16_simple",
                                   "overflow"])
def test_emulated_allocation_matches_chain(emulated, monkeypatch, scene):
    vps = 16 if "vps16" in scene else 8
    max_blocks = 48 if scene == "overflow" else 1024
    method = "simple" if "simple" in scene else "merged"
    layer = tlayer.make_layer("tsdf", VOXEL, vps=vps, max_blocks=max_blocks,
                              device="cpu")
    calls = _both_ways(monkeypatch)
    for k in range(4):
        pts, cols = _cloud(seed=k, shift=0.3 * k)
        layer, _, _ = tt.integrate_pointcloud(layer, _pose(k), pts, cols,
                                              _cfg(), method=method)
    _check_rounds(calls)
    assert len(calls) == 4
    if scene == "overflow":
        assert any(c["overflowed"] for c in calls)
    else:
        assert not any(c["overflowed"] for c in calls)
        assert calls[-1]["blocks"] > calls[0]["blocks"]


def test_emulated_rolling_allocation_matches_chain(emulated, monkeypatch):
    """tests/test_torch_rolling_pool.py's street, pool and reach: blocks
    removed every scan, freed rows handed out again, tombstones and a
    rebuild of the table."""
    from test_torch_rolling_pool import ORDER, POOL, SENSOR, TRAFFIC, _server

    from mapbench import scene

    _, scans = scene.make_traffic_data(TRAFFIC, SENSOR, 2 ** 31 + 17, CPU)
    srv = _server(POOL)
    calls = _both_ways(monkeypatch)
    timing.start_recording()
    try:
        for i in ORDER:
            s = scans[i]
            srv.insert_pointcloud((s[0], s[1]), s[2].reshape(-1, 3),
                                  s[3].reshape(-1, 3))
    finally:
        c = timing.stop_recording()["counters"]
    _check_rounds(calls)
    assert c["layer.rows_reused"] > 0 and c["hash.rebuilds"] > 0
    assert int(srv.layer.num_blocks) == POOL


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


def _tiny_cow(dev):
    """mapbench/tests/tiny.py's cut of the 5 cm cell: its config, traffic
    and 8 scans."""
    import json

    from mapbench import harness, scene

    root = Path(__file__).resolve().parents[1]
    with open(root / "mapbench/configs/cow_and_lady.5cm.merged.json") as f:
        cfg = json.load(f)
    cfg["sensor"].update(width=64, height=48)
    cfg["map"].update(voxel_size=0.2, max_blocks=256)
    cfg["tsdf"]["default_truncation_distance"] = 0.8
    traffic = harness.read_json(harness.traffic_file(str(root), "tsdf_only"))
    traffic["orbit"]["poses"] = 8
    _, scans = scene.make_traffic_data(traffic, cfg["sensor"], 2 ** 31 + 11,
                                       dev)
    srv = harness.build_server(cfg, dev)
    return harness.make_step(srv, traffic), scans


@pytest.mark.cuda
@pytest.mark.parametrize("scene", ["tiny_cow", "rolling", "overflow"])
def test_cuda_allocation_matches_chain(cuda_device, monkeypatch, scene):
    """Every allocation of a run, through the kernel on a copy of the
    allocation state and through the chain on the layer, both on the
    card: the same pool rows, block flags, high-water mark, table and
    overflow, one find pass and one sync a round."""
    dev = cuda_device
    calls = _both_ways(monkeypatch)
    if scene == "tiny_cow":
        step, scans = _tiny_cow(dev)
        for s in scans:
            step(s)
    elif scene == "rolling":
        from test_torch_rolling_pool import (ORDER, POOL, REACH, SENSOR,
                                             TRAFFIC, TSDF)

        from mapbench import scene as mscene

        _, scans = mscene.make_traffic_data(TRAFFIC, SENSOR, 2 ** 31 + 17,
                                            dev)
        srv = TsdfServer(map_config=MapConfig(voxel_size=0.2,
                                              max_blocks=POOL),
                         integrator_config=TsdfIntegratorConfig(**TSDF),
                         method="merged", max_block_distance_from_body=REACH,
                         device=dev)
        timing.start_recording()
        try:
            for i in ORDER:
                s = scans[i]
                srv.insert_pointcloud((s[0], s[1]), s[2].reshape(-1, 3),
                                      s[3].reshape(-1, 3))
        finally:
            c = timing.stop_recording()["counters"]
        assert c["layer.rows_reused"] > 0 and c["hash.rebuilds"] > 0
    else:
        layer = tlayer.make_layer("tsdf", VOXEL, vps=8, max_blocks=48,
                                  device=dev)
        for k in range(4):
            pts, cols = _cloud(20000, seed=k, shift=0.3 * k)
            layer, _, _ = tt.integrate_pointcloud(
                layer, _pose(k, dev), pts.to(dev), cols.to(dev), _cfg(),
                method="merged")
        assert any(c["overflowed"] for c in calls)
    assert len(calls) >= 4 and calls[-1]["blocks"] > 0
    _check_rounds(calls)


@pytest.mark.cuda
def test_cuda_one_find_a_round_and_one_sync_fewer(cuda_device, monkeypatch):
    """The same scan again (nothing missing): one find pass, no key
    recovery, and one host read fewer a scan than the chain's two."""
    dev = cuda_device
    srv = TsdfServer(MapConfig(voxel_size=VOXEL, voxels_per_side=8,
                               max_blocks=2048), _cfg(), method="merged",
                     device=dev)
    pts, cols = _cloud(20000, seed=5)
    scan = (_pose(0, dev), pts.to(dev), cols.to(dev))
    srv.insert_pointcloud(*scan)

    def syncs_a_scan():
        finds, keys = tsdf_alloc.LAUNCHES, tsdf_alloc.KEY_LAUNCHES
        s0 = _runtime.SYNCS
        for _ in range(3):
            srv.insert_pointcloud(*scan)
        return ((_runtime.SYNCS - s0) / 3, tsdf_alloc.LAUNCHES - finds,
                tsdf_alloc.KEY_LAUNCHES - keys)

    kernel_syncs, finds, keys = syncs_a_scan()
    assert (finds, keys) == (3, 0)
    chain = tt._allocate_chain
    monkeypatch.setattr(tt, "_allocate_kernel", chain)
    chain_syncs, finds, keys = syncs_a_scan()
    assert (finds, keys) == (0, 0)
    assert chain_syncs - kernel_syncs == 1


def _hand_checked_rays(dev):
    """Three rays straight down the sensor's z axis from a voxel centre,
    8-voxel blocks of 0.1 m, carving, truncation 3 voxels: their walks end
    in voxels 23, 13 and 8, so their block walks visit blocks 0-2, 0-1 and
    0-1 (7 blocks, 49 candidates). They sit in lanes 0, 1 and 33 of 40
    (the rest NaN). Returns (config, layer, pose, points)."""
    cfg = _cfg()
    layer = tlayer.make_layer("tsdf", VOXEL, vps=8, max_blocks=256,
                              device=dev)
    pts = np.full((40, 3), np.nan, np.float32)
    pts[0], pts[1], pts[33] = (0, 0, 2.0), (0, 0, 1.0), (0, 0, 0.5)
    pose = (torch.eye(3, device=dev),
            torch.tensor([0.05, 0.05, 0.05], device=dev))
    return cfg, layer, pose, torch.as_tensor(pts, device=dev)


def _hand_checked_candidates():
    """The probed candidates of ``_hand_checked_rays`` on a map that holds
    them all: every candidate of a ray's first block, and of each later
    block the five that the previous block's seven do not hold."""
    out = []
    for last in (2, 1, 1):
        for b in range(last + 1):
            for k, off in enumerate(tt._DILATE):
                if b > 0 and off in ((0, 0, 0), (0, 0, -1)):
                    continue  # the block itself and the one behind it
                out.append((off[0], off[1], b + off[2]))
    return torch.tensor(out, dtype=torch.int32)


@pytest.mark.cuda
def test_cuda_counters_on_hand_checked_rays(cuda_device):
    """After a first scan allocated every candidate, a second scan's pass
    finds 49 candidates in the walks' masks, looks up 7 + 5 + 5 + 7 + 5 +
    7 + 5 = 41 of them and misses none; its probes are a plain count over
    those 41 lookups."""
    dev = cuda_device
    cfg, layer, pose, pts = _hand_checked_rays(dev)
    tt.integrate_pointcloud(layer, pose, pts, torch.zeros_like(pts), cfg,
                            method="simple")
    finds = tsdf_alloc.LAUNCHES
    timing.start_recording()
    tt.integrate_pointcloud(layer, pose, pts, torch.zeros_like(pts), cfg,
                            method="simple")
    c = timing.stop_recording()["counters"]
    assert tsdf_alloc.LAUNCHES - finds == 1
    assert c["integrate.alloc_candidates"] == 49
    assert c["integrate.alloc_probed"] == 41
    assert c["integrate.alloc_missing"] == 0
    cand = _hand_checked_candidates()
    assert cand.shape[0] == 41
    cpu_table = vhash.HashTable(*(getattr(layer.table, k).cpu() for k in (
        "keys_w0", "keys_w1", "slot", "max_psl", "count")))
    w0, w1 = grid.pack_block_index(cand)
    assert bool((vhash.lookup(cpu_table, w0, w1) >= 0).all())
    alloc_probes = int(alloc_tool.probes_each(cpu_table, w0, w1).sum())
    # The walk kernel adds its own 7 block lookups and their probes.
    walk_blocks = torch.tensor([[0, 0, z] for z in (0, 1, 2, 0, 1, 0, 1)],
                               dtype=torch.int32)
    v0, v1 = grid.pack_block_index(walk_blocks)
    assert c["hash.lookup_lanes"] == 41 + 7
    assert c["hash.probes"] == alloc_probes + int(
        alloc_tool.probes_each(cpu_table, v0, v1).sum())
