"""A rolling map in a pool sized for its live blocks: rows freed by
``remove_distant_blocks`` are handed out again, the hash table is rebuilt
once its tombstones pile up, and a reused row starts empty in the voxel
pool and in the mesh pool.

The street and the plain reference are the benchmark's own
(``mapbench.scene``, ``mapbench.reference``); the comparison is the one
that decides the benchmark's ``correct``: a voxel observed on either side
is off when its distance differs by more than 1e-4 m or its weight by
more than 1e-4 of it. On the CPU the program reads 0 off."""

import dataclasses

import pytest
import torch

from mapbench import scene
from mapbench.reference import merged as rmerged
from mapbench.reference import tsdf as rtsdf
from mapbench.reference.store import remove_distant_blocks
from voxblox_tpu_torch.core import grid
from voxblox_tpu_torch.core import hash as vhash
from voxblox_tpu_torch.core import layer as vlayer
from voxblox_tpu_torch.core.config import MapConfig, TsdfIntegratorConfig
from voxblox_tpu_torch.server.mapper import TsdfServer
from voxblox_tpu_torch.utils import timing

CPU = torch.device("cpu")
VOXEL = 0.2
REACH = 6.0
TSDF = dict(default_truncation_distance=0.8, max_ray_length_m=8.0)
# A 128x16 spinning LiDAR on a vehicle round a small street: each scan
# makes ~110 blocks and keeps ~26 within reach, so the loop makes ~1,800
# blocks and a scan holds at most ~140 before its removal.
SENSOR = {"model": "spherical", "width": 128, "height": 16,
          "vfov_deg": [-24.8, 2.0], "max_range_m": 20.0}
TRAFFIC = {
    "layout_seed": 20261,
    "scene": {"cylinder_radius": 0, "cylinder_height": 0,
              "road": {"radius_m": 10.0, "half_width_m": 3.0},
              "buildings": {"frontage_m": [4, 8], "depth_m": [2, 4],
                            "height_m": [3, 8], "setback_m": [1, 2],
                            "gap_m": [1, 4]},
              "cars": {"count": 6, "size_m": [4.5, 1.8, 1.5]},
              "poles": {"count": 6, "radius_m": [0.15, 0.3],
                        "height_m": [4, 8], "offset_m": [0.3, 1.0]}},
    "orbit": {"mount": "vehicle", "poses": 16, "radius_m": 10.0,
              "height_m": 1.73, "jitter_m": 0.05}}
POOL = 256  # above the live peak, far below the ~1,800 blocks made
ORDER = list(range(16)) + list(range(4))  # the loop and four scans more


def _server(max_blocks, reach=REACH, vps=16):
    return TsdfServer(map_config=MapConfig(voxel_size=VOXEL,
                                           voxels_per_side=vps,
                                           max_blocks=max_blocks),
                      integrator_config=TsdfIntegratorConfig(**TSDF),
                      method="merged", max_block_distance_from_body=reach,
                      device="cpu")


def _insert(srv, s):
    srv.insert_pointcloud((s[0], s[1]), s[2].reshape(-1, 3),
                          s[3].reshape(-1, 3))


@pytest.fixture(scope="module")
def scans():
    _, out = scene.make_traffic_data(TRAFFIC, SENSOR, 2 ** 31 + 17, CPU)
    return out


@pytest.fixture(scope="module")
def rolled(scans):
    """The program over ``ORDER`` in a pool of ``POOL`` rows, recorded,
    and the reference's replay of the same scans."""
    srv = _server(POOL)
    timing.start_recording()
    try:
        for i in ORDER:
            _insert(srv, scans[i])
    finally:
        summary = timing.stop_recording()
    cfg = dict(dataclasses.asdict(srv.cfg), voxel_size=VOXEL)
    ref = rtsdf.new_store(VOXEL, 16, 4096, CPU, torch.float32)
    for i in ORDER:
        s = scans[i]
        rtsdf.fold(ref, *rmerged.samples(ref, s[0], s[1], s[2].reshape(-1, 3),
                                         cfg, torch.float32), cfg)
        remove_distant_blocks(ref, s[1], REACH)
    return srv, summary, ref


def test_rolling_pool_matches_the_reference(rolled):
    srv, summary, ref = rolled
    L = srv.layer
    rows = vlayer.lookup_blocks(L, ref.ijk[:ref.n].to(torch.int32))
    assert ref.n > 0 and bool((rows >= 0).all())
    w_p = L.channels["weight"][rows.long()]
    d_p = L.channels["tsdf"][rows.long()]
    w_r, d_r = ref.ch["weight"][:ref.n], ref.ch["tsdf"][:ref.n]
    off = ((d_p - d_r).abs() > 1e-4) | (
        (w_p - w_r).abs() > 1e-4 * torch.maximum(w_p, w_r))
    assert int(((w_p > 0) | (w_r > 0)).sum()) > 5000
    assert int(off.sum()) == 0
    # The program's other live blocks were allocated and never observed.
    other = L.active_mask().clone()
    other[rows.long()] = False
    assert float(L.channels["weight"][other].abs().sum()) == 0.0
    # The pool is full to its last row, the loop made many times more
    # blocks than it holds, and those rows were handed out again.
    c = summary["counters"]
    made = c["layer.blocks_removed"] + int(L.active_mask().sum())
    assert int(L.num_blocks) == POOL and made > 4 * POOL
    assert c["layer.rows_reused"] == made - POOL
    assert c["hash.rebuilds"] > 0


def test_rolling_spans_and_counters(rolled):
    srv, summary, _ = rolled
    spans, c = summary["spans"], summary["counters"]
    n = len(ORDER)
    for tag in ("rolling.remove", "rolling.remove.select",
                "rolling.remove.hash", "rolling.remove.clear"):
        assert spans[tag]["calls"] >= n, tag
    assert spans["rolling.remove"]["calls"] == n
    assert c["hash.table_cells"] == n * srv.layer.table.capacity
    assert 0 < c["hash.tombstone_cells"] < c["hash.table_cells"]
    # The rebuild is decided by the overflow check's one read a scan, and
    # the removal reads the host once a scan (the probe bound), but for
    # the rebuilds' own probe rounds.
    assert spans["server.check_overflow"]["syncs"] == n
    syncs = sum(v["syncs"] for k, v in spans.items()
                if k.startswith("rolling.remove"))
    assert n <= syncs <= n + 2 * vhash.MAX_INSERT_ROUNDS * c["hash.rebuilds"]


def _high_water_only(layer, k):
    return (layer.num_blocks
            + torch.arange(k, dtype=torch.int32, device=layer.device))


def test_same_pool_without_reuse_overflows(scans, monkeypatch):
    monkeypatch.setattr(vlayer, "free_rows", _high_water_only)
    srv = _server(POOL)
    with pytest.raises(MemoryError, match="block pool overflow"):
        for i in ORDER:
            _insert(srv, scans[i])


def test_pool_below_the_live_peak_raises(scans):
    srv = _server(96)
    with pytest.raises(MemoryError, match="block pool overflow"):
        for i in ORDER:
            _insert(srv, scans[i])


def test_free_rows_order():
    layer = vlayer.make_layer("tsdf", 1.0, vps=4, max_blocks=8, device=CPU)
    assert vlayer.free_rows(layer, 10).tolist() == list(range(10))
    ijk = torch.tensor([[i, 0, 0] for i in range(5)], dtype=torch.int32)
    layer, ovf = vlayer.allocate_blocks(layer, ijk, torch.ones(5, dtype=bool))
    assert not bool(ovf) and int(layer.num_blocks) == 5
    # Fresh rows from the high-water mark, then freed rows lowest first,
    # then ids past the pool.
    gone = torch.tensor([3, 1], dtype=torch.int32)
    layer = vlayer.remove_blocks(layer, gone, torch.ones(2, dtype=bool))
    assert vlayer.free_rows(layer, 7).tolist() == [5, 6, 7, 1, 3, 8, 9]
    new = torch.tensor([[i, 1, 0] for i in range(5)], dtype=torch.int32)
    layer, ovf = vlayer.allocate_blocks(layer, new, torch.ones(5, dtype=bool))
    assert not bool(ovf) and int(layer.num_blocks) == 8
    assert sorted(vlayer.lookup_blocks(layer, new).tolist()) == [1, 3, 5, 6, 7]
    assert bool(layer.active_mask().all())
    one = torch.tensor([[9, 9, 9]], dtype=torch.int32)
    layer, ovf = vlayer.allocate_blocks(layer, one, torch.ones(1, dtype=bool))
    assert bool(ovf)


def test_rebuild_clears_tombstones_and_keeps_rows():
    g = torch.Generator().manual_seed(7)
    layer = vlayer.make_layer("tsdf", 1.0, vps=4, max_blocks=256, device=CPU)
    for _ in range(12):
        ijk = torch.randint(-30, 30, (120, 3), generator=g, dtype=torch.int32)
        layer, ovf = vlayer.allocate_blocks(layer, ijk,
                                            torch.ones(120, dtype=bool))
        assert not bool(ovf)
        rows = torch.arange(256, dtype=torch.int32)
        doomed = layer.active_mask() & (torch.rand(256, generator=g) < 0.6)
        layer = vlayer.remove_blocks(layer, rows, doomed)
    assert int(layer.num_blocks) == 256
    table = layer.table
    assert int((table.keys_w1 == grid.TOMBSTONE_W1).sum()) > 0
    active = layer.active_mask()
    live = torch.nonzero(active).flatten()
    count, psl = int(table.count), int(table.max_psl)
    layer = vlayer.rebuild_table(layer)
    assert int((layer.table.keys_w1 == grid.TOMBSTONE_W1).sum()) == 0
    assert int(layer.table.count) == count
    assert int(layer.table.max_psl) <= psl
    got = vlayer.lookup_blocks(layer, layer.block_ijk[live])
    assert torch.equal(got, live.to(torch.int32))
    w0, w1 = grid.pack_block_index(layer.block_ijk)
    fresh, _, _ = vhash.insert(vhash.make_table(table.capacity, CPU),
                               w0, w1, active)
    assert int(layer.table.max_psl) <= int(fresh.max_psl)
    assert int((layer.table.keys_w1 >= 0).sum()) == len(live)


def _wall(n=24):
    """A flat 2 m x 2 m wall 2 m ahead of the sensor (x forward)."""
    u = torch.linspace(-1.0, 1.0, n)
    y, z = torch.meshgrid(u, u, indexing="ij")
    return torch.stack([torch.full_like(y, 2.0), y, z], -1).reshape(-1, 3)


def test_remade_block_starts_empty_in_voxels_and_mesh():
    eye = torch.eye(3)
    home, away = torch.zeros(3), torch.tensor([40.0, 0.0, 0.0])
    pts = _wall()
    probe = _server(4096, reach=10.0, vps=8)
    probe.insert_pointcloud((eye, home), pts)
    n = int(probe.layer.num_blocks)
    srv = _server(n + 3, reach=10.0, vps=8)
    srv.insert_pointcloud((eye, home), pts)
    srv.update_mesh()
    assert int(srv.mesh_pool.counts.sum()) > 0
    # A scan far away with no return drops every block near home.
    srv.insert_pointcloud((eye, away), torch.zeros_like(pts))
    assert not bool(srv.layer.active_mask().any())
    assert float(srv.layer.channels["weight"].abs().sum()) == 0.0
    assert int(srv.mesh_pool.counts.sum()) == 0
    assert not bool(srv.mesh_pool.overflow_rows.any())
    # Home again: the blocks are made again, in the 3 fresh rows and then
    # in freed ones, and hold what one scan into an empty map gives.
    timing.start_recording()
    try:
        srv.insert_pointcloud((eye, home), pts)
    finally:
        reused = timing.stop_recording()["counters"]["layer.rows_reused"]
    assert reused == n - 3
    assert int(srv.mesh_pool.counts.sum()) == 0
    act = probe.layer.active_mask()
    rows = vlayer.lookup_blocks(srv.layer, probe.layer.block_ijk[act])
    assert bool((rows >= 0).all())
    for name in ("tsdf", "weight"):
        assert torch.equal(srv.layer.channels[name][rows.long()],
                           probe.layer.channels[name][act]), name
