"""The walk-and-accumulate kernel (csrc/tsdf_walk.cu, ops/tsdf_walk.py)
against its plain version, the chain of ops/tsdf.py (``cast_rays`` ->
``_per_sample_contributions`` -> ``global_voxel_to_flat`` ->
``_accumulate_flat``).

On the CPU the kernel's own source, compiled with g++
(csrc/tsdf_walk_emulate.cpp), runs every lane of a scan the chain has just
integrated, on the same per-ray inputs and the same table: every sample it
adds (lane, step, flat offset, pool row; w, w * sdf, cw, cw * rgb) is the
chain's, bit for bit, but where ``ops/raycast.fma``'s double rounding (one
product in ~2^29) rounds another way than the kernel's fused multiply-add;
such a case is named. Its accumulators match the chain's within the
reordering bound of float32 sums; its dirty rows are the chain's.

Tests marked ``cuda`` run the kernel on a card: against the chain on the
card, a map of the benchmark's tiny scene against the benchmark's
reference, one launch a scan, the wrapper's refusals and its counters.
"""

import ctypes
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

from voxblox_tpu_torch.core import hash as vhash
from voxblox_tpu_torch.core import layer as tlayer
from voxblox_tpu_torch.core.config import TsdfIntegratorConfig
from voxblox_tpu_torch.ops import raycast
from voxblox_tpu_torch.ops import tsdf as tt
from voxblox_tpu_torch.ops import tsdf_walk
from voxblox_tpu_torch.utils import timing

from torch_parity import cuda_device  # noqa: F401  (fixture)

VOXEL = 0.1
VPS = 8
ROT = np.array([[0.0, 0.0, 1.0], [-1.0, 0.0, 0.0], [0.0, -1.0, 0.0]],
               np.float32)  # camera z along world x
POSE = (ROT, np.array([0.37, -0.21, 1.13], np.float32))


@pytest.fixture(scope="module")
def emulation():
    """csrc/tsdf_walk_emulate.cpp built with g++ once per module."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the kernel's source for the CPU")
    src = Path(tsdf_walk.__file__).resolve().parents[1] / "csrc"
    out = Path(tempfile.mkdtemp(prefix="tsdf_walk_emulate_")) / "lib.so"
    subprocess.run([gxx, "-std=c++17", "-O1", "-ffp-contract=off",
                    "-shared", "-fPIC", "-o", str(out),
                    str(src / "tsdf_walk_emulate.cpp")],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(out))
    lib.tsdf_walk_emulate.argtypes = [
        ctypes.POINTER(tsdf_walk.WalkParams), ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_ulonglong * 2)]
    lib.tsdf_walk_emulate.restype = ctypes.c_int64
    lib.tsdf_walk_fmaf.argtypes = [ctypes.c_float] * 3
    lib.tsdf_walk_fmaf.restype = ctypes.c_float
    lib.tsdf_walk_params_size.restype = ctypes.c_int
    assert lib.tsdf_walk_params_size() == ctypes.sizeof(tsdf_walk.WalkParams)
    return lib


def _cloud(n=1500, seed=0):
    """A wall, a floor and two boxes in front of the sensor, a few points
    beyond max_ray_length (clearing rays), a few too close, one NaN; with
    colours in [0, 255]."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform([-1.6, -1.1, 1.6], [1.6, 1.1, 3.4], (n, 3))
    pts[: n // 4, 1] = 1.1  # floor
    pts[n // 4: n // 2, 2] = 3.4  # back wall
    pts[n // 2: n // 2 + 200] = rng.uniform([-0.4, -0.3, 2.0],
                                            [0.2, 0.3, 2.3], (200, 3))
    pts[-40:] *= 3.0  # beyond max_ray_length_m: clearing
    pts[:8] *= 0.01  # closer than min_ray_length_m: invalid
    pts[9] = np.nan
    cols = rng.uniform(0.0, 255.0, (n, 3))
    return pts.astype(np.float32), cols.astype(np.float32)


# name -> (integrator config, layer options, other options)
CASES = {
    "carving": (dict(), dict(), dict()),
    "no_carving": (dict(voxel_carving_enabled=False), dict(), dict()),
    "cut_at_max_steps": (dict(max_steps=14), dict(), dict()),
    "no_colour": (dict(), dict(), dict(use_color=False)),
    "sparsity_and_dropoff": (dict(use_sparsity_compensation_factor=True,
                                  sparsity_compensation_factor=0.7),
                             dict(), dict()),
    "no_dropoff_const_weight": (dict(use_weight_dropoff=False,
                                     use_const_weight=True), dict(), dict()),
    "unallocated_blocks": (dict(), dict(), dict(allocate_every=8)),
    "full_pool": (dict(), dict(max_blocks=40), dict()),
    "crowded_table": (dict(), dict(max_blocks=512, table_capacity=512),
                      dict()),
    "anti_grazing": (dict(enable_anti_grazing=True), dict(), dict()),
    "ties": (dict(), dict(), dict(ties=True)),
}


def _tied(pts):
    """The sensor at a voxel centre, a third of the rays on a diagonal
    (x = y, y = z or x = y = z): equal t to the next boundary on two or
    three axes at every step, where the walk's tie rule decides."""
    k = pts.shape[0] // 9
    pts[:k, 1] = pts[:k, 0]
    pts[k:2 * k, 2] = pts[k:2 * k, 1] + 1.5
    pts[k:2 * k, 1] = pts[k:2 * k, 2]
    pts[2 * k:3 * k, :] = np.abs(pts[2 * k:3 * k, :1]) + 1.0
    return (np.eye(3, dtype=np.float32),
            np.array([0.05, 0.05, 0.05], np.float32)), pts


def _integrate(case, method, monkeypatch):
    """One scan on a map that already holds one (from another pose),
    through the chain on the CPU; returns what the chain's walk took and
    gave: the layer it looked up in, the rays, max_steps, the config and
    (voxels, sdf, w, flat, ok)."""
    cfg_kw, layer_kw, opts = CASES[case]
    cfg = TsdfIntegratorConfig(default_truncation_distance=0.3,
                               max_ray_length_m=6.0, **cfg_kw)
    layer = tlayer.make_layer("tsdf", VOXEL, vps=VPS, device="cpu",
                              **dict(dict(max_blocks=1024), **layer_kw))
    use_color = opts.get("use_color", True)
    pts, cols = _cloud()
    R0 = np.eye(3, dtype=np.float32)
    layer, _, _ = tt.integrate_pointcloud(
        layer, (torch.as_tensor(R0), torch.zeros(3)), torch.as_tensor(pts),
        torch.as_tensor(cols), cfg, method=method, use_color=use_color)
    seen = {}
    chain = tt._chain_samples
    allocate = tt.allocate_for_rays

    def spy(layer, rays, max_steps, cfg, state=None):
        out = chain(layer, rays, max_steps, cfg, state)
        seen.update(layer=layer, rays=rays, max_steps=max_steps, cfg=cfg,
                    samples=out[:5])
        return out

    def allocate_some(layer, setup, valid, max_steps):
        lane = torch.arange(valid.shape[0])
        every = opts["allocate_every"]
        return allocate(layer, setup, valid & (lane % every == 0), max_steps)

    monkeypatch.setattr(tt, "_chain_samples", spy)
    if "allocate_every" in opts:
        monkeypatch.setattr(tt, "allocate_for_rays", allocate_some)
    pts, cols = _cloud(seed=1)
    pose = POSE
    if opts.get("ties"):
        pose, pts = _tied(pts)
    tt.integrate_pointcloud(
        layer, tuple(torch.as_tensor(x) for x in pose), torch.as_tensor(pts),
        torch.as_tensor(cols), cfg, method=method, use_color=use_color)
    return seen


def _emulate(lib, seen, grazing=True):
    """The kernel's source on the CPU over every lane: (records' ints
    [n, 4], floats [n, 6], accumulators, (probes, lookups))."""
    rays = seen["rays"]
    inputs = tt._kernel_inputs(rays)
    if not grazing:
        inputs["grazing"] = None
    p, acc, _keep = tsdf_walk.make_params(seen["layer"], seen["max_steps"],
                                          seen["cfg"], **inputs)
    cap = int(tsdf_walk.walk_lengths(rays.setup.num_steps, rays.valid,
                                     seen["max_steps"]).sum())
    ints = torch.empty((cap, 4), dtype=torch.int64)
    floats = torch.empty((cap, 6), dtype=torch.float32)
    counts = (ctypes.c_ulonglong * 2)()
    n = lib.tsdf_walk_emulate(ctypes.byref(p), ints.data_ptr(),
                              floats.data_ptr(), cap, ctypes.byref(counts))
    assert 0 <= n <= cap
    return ints[:n].numpy(), floats[:n].numpy(), acc, tuple(counts)


def _chain_records(seen):
    """The chain's samples that ``_accumulate_flat`` adds, as records."""
    voxels, sdf, w, flat, ok = seen["samples"]
    rays, cfg = seen["rays"], seen["cfg"]
    trunc = cfg.default_truncation_distance
    step, lane = torch.nonzero(ok, as_tuple=True)
    vpb = seen["layer"].voxels_per_block
    wd = (w * torch.clamp(sdf, -trunc, trunc))[ok]
    if rays.colors is not None:
        cw = torch.where(sdf.abs() < trunc, w, 0.0)[ok]
        wc = cw[:, None] * rays.colors[lane]
    else:
        cw = torch.zeros_like(wd)
        wc = torch.zeros((wd.shape[0], 3))
    ints = torch.stack([lane, step, flat[ok], flat[ok] // vpb], 1)
    floats = torch.cat([torch.stack([w[ok], wd, cw], 1), wc], 1)
    return ints.numpy(), floats.numpy()


def _sorted(ints, floats):
    order = np.lexsort((ints[:, 1], ints[:, 0]))
    return ints[order], floats[order]


def _double_rounded(lib, seen, lane, step):
    """Whether one of the sample's five fused multiply-adds rounds
    otherwise in ``raycast.fma`` (float64, then float32) than in fmaf."""
    rays = seen["rays"]
    vox = seen["samples"][0][step, lane].to(torch.float32) + 0.5
    neg_o = -rays.origin
    b = rays.points[lane] - rays.origin
    a = [lib.tsdf_walk_fmaf(float(vox[k]), VOXEL, float(neg_o[k]))
         for k in range(3)]
    pairs = [(float(vox[k]), np.float32(VOXEL), float(neg_o[k]))
             for k in range(3)]
    p01 = float(np.float32(a[0]) * np.float32(b[0]))
    pairs.append((a[1], float(b[1]), p01))
    pairs.append((a[2], float(b[2]), lib.tsdf_walk_fmaf(a[1], float(b[1]),
                                                        p01)))
    return any(float(raycast.fma(*x)) != lib.tsdf_walk_fmaf(*map(float, x))
               for x in pairs)


def _records_equal(lib, seen, emu, ref):
    """Bit-equal records, or mismatches that double rounding explains
    (named on stdout)."""
    ei, ef = _sorted(*emu)
    ri, rf = _sorted(*ref)
    assert ei.shape == ri.shape, (ei.shape, ri.shape)
    np.testing.assert_array_equal(ei, ri)
    off = np.nonzero((ef.view(np.int32) != rf.view(np.int32)).any(1))[0]
    for k in off:
        lane, step = int(ei[k, 0]), int(ei[k, 1])
        assert _double_rounded(lib, seen, lane, step), (
            f"lane {lane} step {step}: kernel {ef[k]} chain {rf[k]}")
        print(f"double rounding: lane {lane} step {step}")
    return len(ei)


def _sum_bound(ints, floats, n_flat, col):
    """Per cell, 2 (n - 1) 2^-24 sum|x| over its n addends: two float32
    sums of the same addends in any two orders differ by at most this."""
    flat = ints[:, 2]
    n = np.bincount(flat, minlength=n_flat)
    mag = np.bincount(flat, weights=np.abs(floats[:, col].astype(np.float64)),
                      minlength=n_flat)
    return 2.0 * np.maximum(n - 1, 0) * 2.0 ** -24 * mag


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("method", ["simple", "merged"])
def test_emulated_kernel_matches_chain(emulation, monkeypatch, method, case):
    if case == "anti_grazing" and method == "simple":
        pytest.skip("anti-grazing is the merged integrator's")
    seen = _integrate(case, method, monkeypatch)
    layer, rays, max_steps = seen["layer"], seen["rays"], seen["max_steps"]
    ints, floats, acc, (probes, lookups) = _emulate(emulation, seen)
    ref_ints, ref_floats = _chain_records(seen)
    n = _records_equal(emulation, seen, (ints, floats),
                       (ref_ints, ref_floats))
    assert n > 200

    # Accumulators and dirty rows, against the chain's own scatter: the
    # record columns that d_w, d_wd, d_wc (three) and d_wcw sum.
    voxels, sdf, w, flat, ok = seen["samples"]
    ref = tt._accumulate_flat(layer, flat, ok, sdf, w, rays.colors,
                              seen["cfg"], rays.colors is not None)
    n_flat = layer.max_blocks * layer.voxels_per_block
    for i, cols in ((0, [0]), (1, [1]), (2, [3, 4, 5]), (3, [2])):
        got = acc[i].numpy().reshape(n_flat, -1)
        want = ref[i].numpy().reshape(n_flat, -1)
        for c, col in enumerate(cols):
            bound = _sum_bound(ints, floats, n_flat, col)
            assert (np.abs(got[:, c] - want[:, c]) <= bound).all(), (i, c)
    np.testing.assert_array_equal(acc[4].numpy(), ref[4].numpy())

    # The counters: one lookup per block a walk enters (of its samples in
    # the walk's mask and not grazing), each probing until its key or an
    # empty cell.
    useful = int(tsdf_walk.walk_lengths(rays.setup.num_steps, rays.valid,
                                        max_steps).sum())
    assert 0 < lookups < useful
    _, mask = raycast.cast_rays(rays.setup, max_steps, rays.valid)
    if case != "anti_grazing":
        blocks = voxels >> (VPS.bit_length() - 1)
        enter = mask.clone()
        enter[1:] &= (blocks[1:] != blocks[:-1]).any(-1)
        assert lookups == int(enter.sum())
        assert probes == _probes(layer.table, blocks[enter])
    else:
        plain = _emulate(emulation, seen, grazing=False)
        assert len(plain[0]) > n  # grazing samples were dropped

    # Each case exercises what it is named for; every case has clearing
    # rays.
    table, mb = layer.table, layer.max_blocks
    if case == "cut_at_max_steps":
        assert bool((rays.valid & (rays.setup.num_steps >= max_steps)).any())
    if case in ("unallocated_blocks", "full_pool"):
        assert int((mask & ~ok).sum()) > 50
    if case == "full_pool":
        assert bool((table.slot >= mb).any())
    if case == "crowded_table":
        assert int(table.max_psl) >= 2
    if case == "ties":
        t = raycast.dda_start(rays.setup).t_next[rays.valid]
        assert int((t[:, 0] == t[:, 1]).sum()) > 50
        assert int(((t[:, 0] == t[:, 1]) & (t[:, 1] == t[:, 2])).sum()) > 10
    far = torch.linalg.vector_norm(rays.points - rays.origin, dim=-1) > 6.0
    assert bool((far & rays.valid).any())


def _probes(table, block_ijk):
    """Probes of looking each block up, by a plain loop over the table."""
    from voxblox_tpu_torch.core import grid
    w0, w1 = grid.pack_block_index(block_ijk)
    h = vhash.hash_words(w0, w1)
    mask = table.capacity - 1
    total = 0
    for k in range(w0.shape[0]):
        for q in range(int(table.max_psl) + 1):
            idx = int((h[k] + q) & mask)
            total += 1
            k1 = int(table.keys_w1[idx])
            if k1 == int(w1[k]) and int(table.keys_w0[idx]) == int(w0[k]):
                break
            if k1 == -1:
                break
    return total


def test_params_refuse_a_wrong_dtype_or_shape(monkeypatch):
    seen = _integrate("carving", "merged", monkeypatch)
    good = tt._kernel_inputs(seen["rays"])
    args = (seen["layer"], seen["max_steps"], seen["cfg"])
    tsdf_walk.make_params(*args, **good)
    with pytest.raises(TypeError, match="weight"):
        tsdf_walk.make_params(*args, **dict(good, weights=good[
            "weights"].double()))
    with pytest.raises(ValueError, match="dist"):
        tsdf_walk.make_params(*args, **dict(good, dist=good["dist"][:-1]))
    with pytest.raises(ValueError, match="CUDA"):
        tsdf_walk.walk_and_accumulate(*args, **good)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


def _card_scan(dev, n=60000, seed=3):
    pts, cols = _cloud(n, seed)
    return (tuple(torch.as_tensor(x, device=dev) for x in POSE),
            torch.as_tensor(pts, device=dev),
            torch.as_tensor(cols, device=dev))


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["simple", "merged"])
def test_cuda_kernel_matches_chain_on_the_card(cuda_device, monkeypatch,
                                               method):
    """The kernel and the chain on the same rays and table on the card.
    Accumulators within 2 (n - 1) 2^-24 sum|x| per cell plus 2^-21 of
    the cell's sum|x|: the atomics add in any order, and the chain's
    dropoff ramp on the card multiplies by the reciprocal (one rounding
    more than the kernel's IEEE division). Dirty rows equal."""
    dev = cuda_device
    cfg = TsdfIntegratorConfig(default_truncation_distance=0.3,
                               max_ray_length_m=6.0)
    layer = tlayer.make_layer("tsdf", VOXEL, vps=VPS, max_blocks=4096,
                              device=dev)
    seen = {}
    kernel = tt._walk_kernel

    def spy(layer, rays, max_steps, cfg):
        seen.update(layer=layer, rays=rays, max_steps=max_steps, cfg=cfg)
        return kernel(layer, rays, max_steps, cfg)

    monkeypatch.setattr(tt, "_walk_kernel", spy)
    tt.integrate_pointcloud(layer, *_card_scan(dev), cfg, method=method)
    layer, rays, max_steps = seen["layer"], seen["rays"], seen["max_steps"]
    got = kernel(layer, rays, max_steps, cfg)
    _, sdf, w, flat, ok, _ = tt._chain_samples(layer, rays, max_steps, cfg)
    want = tt._accumulate_flat(layer, flat, ok, sdf, w, rays.colors, cfg,
                               True)
    trunc = cfg.default_truncation_distance
    cw = torch.where(sdf.abs() < trunc, w, 0.0)
    addends = [w, w * torch.clamp(sdf, -trunc, trunc),
               cw[..., None] * rays.colors, cw]
    f = flat[ok]
    n_flat = got[0].shape[0]
    n = torch.bincount(f, minlength=n_flat).double()
    for i, x in enumerate(addends):
        x = x[ok].reshape(f.shape[0], -1).abs().double()
        mag = torch.zeros((n_flat, x.shape[1]), dtype=torch.float64,
                          device=dev).index_add_(0, f, x)
        bound = ((2.0 * (n - 1).clamp(min=0) * 2.0 ** -24
                  + 2.0 ** -21)[:, None] * mag)
        err = (got[i].double() - want[i].double()).reshape(bound.shape).abs()
        assert bool((err <= bound).all()), (i, float((err - bound).max()))
    assert torch.equal(got[4], want[4])
    assert int(ok.sum()) > 100000


@pytest.mark.cuda
def test_cuda_tiny_scene_map_is_correct(cuda_device):
    """Eight scans of the benchmark's tiny scene (mapbench/tests/tiny.py's
    configuration) on the card, judged against the benchmark's reference
    at the 5 cm cell's limit."""
    import json

    from mapbench import checks, harness, scene

    root = Path(__file__).resolve().parents[1]
    with open(root / "mapbench/configs/cow_and_lady.5cm.merged.json") as f:
        cfg = json.load(f)
    cfg["sensor"].update(width=64, height=48)
    cfg["map"].update(voxel_size=0.2, max_blocks=256)
    cfg["tsdf"]["default_truncation_distance"] = 0.8
    traffic = harness.read_json(harness.traffic_file(str(root), "tsdf_only"))
    traffic["orbit"]["poses"] = 8
    limits = harness.read_json(harness.limits_file(
        str(root), "cow_and_lady.5cm.merged.tsdf_only"))
    dev = cuda_device
    _, scans = scene.make_traffic_data(traffic, cfg["sensor"], 2 ** 31 + 11,
                                       dev)
    srv = harness.build_server(cfg, dev)
    step = harness.make_step(srv, traffic)
    before = tsdf_walk.LAUNCHES
    for s in scans:
        step(s)
    srv.check_overflow()
    assert tsdf_walk.LAUNCHES - before == len(scans) == 8
    prog = checks.program_store(harness.map_rows(srv), cfg)
    numbers = checks.judge(cfg, traffic, scans, list(range(8)), prog, limits,
                           dev)
    assert checks.verdict(numbers, 0), numbers


@pytest.mark.cuda
def test_cuda_one_launch_a_scan_and_refusals(cuda_device):
    from voxblox_tpu_torch.core.config import MapConfig
    from voxblox_tpu_torch.server.mapper import TsdfServer

    dev = cuda_device
    srv = TsdfServer(MapConfig(voxel_size=VOXEL, voxels_per_side=VPS,
                               max_blocks=2048),
                     TsdfIntegratorConfig(default_truncation_distance=0.3,
                                          max_ray_length_m=6.0),
                     method="merged", device=dev)
    before = tsdf_walk.LAUNCHES
    for seed in range(3):
        pose, pts, cols = _card_scan(dev, n=20000, seed=seed)
        srv.insert_pointcloud(pose, pts, cols)
    assert tsdf_walk.LAUNCHES - before == 3

    seen = {}
    kernel = tt._walk_kernel

    def spy(layer, rays, max_steps, cfg):
        seen.update(layer=layer, rays=rays, max_steps=max_steps, cfg=cfg)
        return kernel(layer, rays, max_steps, cfg)

    tt._walk_kernel = spy
    try:
        srv.insert_pointcloud(*_card_scan(dev, n=20000, seed=9))
    finally:
        tt._walk_kernel = kernel
    good = tt._kernel_inputs(seen["rays"])
    args = (seen["layer"], seen["max_steps"], seen["cfg"])
    with pytest.raises(ValueError, match="weight is on cpu"):
        tsdf_walk.walk_and_accumulate(*args, **dict(
            good, weights=good["weights"].cpu()))
    with pytest.raises(TypeError, match="v_po"):
        tsdf_walk.walk_and_accumulate(*args, **dict(
            good, v_po=good["v_po"].half()))
    before = tsdf_walk.LAUNCHES
    tsdf_walk.walk_and_accumulate(*args, **good)
    assert tsdf_walk.LAUNCHES == before + 1


@pytest.mark.cuda
def test_cuda_counters_on_hand_checked_rays(cuda_device, monkeypatch):
    """Three rays straight down the sensor's z axis from a voxel centre,
    8-voxel blocks, carving, truncation 3 voxels: a point 2.0 m away ends
    its walk in voxel 23 (24 samples: blocks 0-7, 8-15, 16-23, 3 lookups),
    one 1.0 m away in voxel 13 (14 samples, 2 lookups), one 0.5 m away in
    voxel 8 (9 samples, 2 lookups). They sit in lanes 0, 1 and 33 of 40
    (the rest NaN), so the kernel executes 32 x 24 + 32 x 9 = 1,056 slots,
    47 of them useful."""
    dev = cuda_device
    cfg = TsdfIntegratorConfig(default_truncation_distance=0.3,
                               max_ray_length_m=6.0)
    layer = tlayer.make_layer("tsdf", VOXEL, vps=VPS, max_blocks=256,
                              device=dev)
    pts = np.full((40, 3), np.nan, np.float32)
    pts[0], pts[1], pts[33] = (0, 0, 2.0), (0, 0, 1.0), (0, 0, 0.5)
    pose = (torch.eye(3, device=dev),
            torch.tensor([0.05, 0.05, 0.05], device=dev))
    pts = torch.as_tensor(pts, device=dev)
    tt.integrate_pointcloud(layer, pose, pts, torch.zeros_like(pts), cfg,
                            method="simple")  # allocates the blocks
    probes, lanes = [], []
    lookup = vhash.lookup

    def spy(table, w0, w1, max_psl=None):  # the allocation's lookups
        bound = int(table.max_psl) if max_psl is None else max_psl
        probes.append(w0.numel() * (bound + 1))
        lanes.append(w0.numel())
        return lookup(table, w0, w1, max_psl)

    monkeypatch.setattr(vhash, "lookup", spy)
    timing.start_recording()
    layer, _, _ = tt.integrate_pointcloud(layer, pose, pts,
                                          torch.zeros_like(pts), cfg,
                                          method="simple")
    c = timing.stop_recording()["counters"]
    assert c["integrate.walk_samples"] == 1056
    assert c["integrate.walk_samples_useful"] == 47
    assert c["integrate.block_lookups"] == 7
    assert c["hash.lookup_lanes"] - sum(lanes) == 7
    blocks = torch.tensor([[0, 0, z] for z in (0, 1, 2, 0, 1, 0, 1)],
                          dtype=torch.int32)
    cpu_table = vhash.HashTable(*(getattr(layer.table, k).cpu() for k in (
        "keys_w0", "keys_w1", "slot", "max_psl", "count")))
    assert c["hash.probes"] - sum(probes) == _probes(cpu_table, blocks)
