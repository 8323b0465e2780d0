"""GPU smoke run of the PyTorch/CUDA port: builds the hand-written kernels,
holds each to its plain version, and drives the port's paths on one CUDA
card at the full size of the JAX package's own benchmarks: the online
mapping step at 5 cm (bench.py's online loop), the batch ESDF rebuild
with the unit and the strided schedule (bench.py's ESDF section), the
2 cm stress loop with a mesh update every scan (benchmarks/
stress_bench.py), the batched TSDF throughput path (bench.py section 1),
the velodyne street map (bench.py's velodyne section), the three
ray-casting integrators, the full-Euclidean ESDF and the map queries.

    python3 chip_smoke.py             # the check (one card, a few minutes)
    python3 chip_smoke.py --profile   # + torch.profiler windows

Phases (any failure exits non-zero; nothing falls back to the CPU):
  1 device   nvidia-smi name/power limit, refuse without a GPU
  2 build    nvcc the kernels from voxblox_tpu_torch/csrc/
  3 main     warm a 32-pose orbit, then time 12 online steps with the
             kernel counters zeroed just before and read just after
  4 kernel   K1 against its plain version at the shape and constants of
             each path that launches it: the online loop's bucket, the
             unit batch rebuild's bucket where it differs (both 5 cm,
             max distance 2 m), and the stress loop's whole pool (6144
             blocks, 2 cm, max distance 1 m; on random inputs here and on
             the 2 cm map's own padded sweep inputs in phase 8); expect
             bit-equal, timed with CUDA events
  5 replay   the same scans with the plain relaxation (relax_impl="plain"):
             TSDF identical, ESDF equal on observed voxels
  6 batch    batch ESDF rebuild of the phase-3 map, unit and strided
             schedule (counters zeroed before each, read after), the two
             fixpoints compared, both rebuilds replayed with the plain
             relaxation, the stride-gate statistics
  7 kernel   K2 against its plain version at the batch rebuild's bucket
  8 euclid   full-Euclidean batch ESDF rebuild of the phase-3 map (never
             longer than the quasi-Euclidean field by more than
             min_diff_m); a point source in 8 blocks of 16^3 against sqrt
             distances (rtol 0.035) and against the port on the CPU
  9 queries  TsdfMap/EsdfMap queries (distance, distance + gradient,
             adaptive) at 1,000,000 points in the phase-3 maps' bounds,
             against the same queries on CPU copies of the layers
 10 stress   2 cm, 6144-block pool: warm circle with undersized budgets,
             8 steps with mesh updates, 16 timed steps of integrate +
             incremental ESDF + mesh update; the exported mesh against
             the analytic surface; a batch ESDF rebuild of the 2 cm map
             over the whole pool, kernel against plain relaxation; K1
             timed on the inputs of that rebuild's first sweep
 11 batch    bench.py section 1: the 32 orbit scans in one K=32 dispatch
             of integrate_organized_projective_batch (budgets 192/1920/
             256), a warm-up epoch and timed rounds; against 32
             sequential single-scan calls
 12 velodyne bench.py's velodyne section: 2048x64 spinning-lidar scans of
             a street, 0.2 m voxels, 50 m rays, K=16 batches; against 16
             sequential single-scan calls and the scatter image builder
 13 raycast  TsdfServer(method=fast/merged/simple) on the orbit's flat
             640x480 clouds against the analytic scene; at 160x120 the
             card's maps against the port's on the CPU
Prints a {"kernels": [...]} line, the nvidia-smi line, and last
{"ok": true, "device": {...}}. Details go to chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

if not torch.cuda.is_available():
    print("chip_smoke: no CUDA device; this check runs only on a GPU",
          file=sys.stderr)
    sys.exit(1)

from voxblox_tpu_torch import _runtime  # noqa: E402
from voxblox_tpu_torch.core import layer as vlayer  # noqa: E402
from voxblox_tpu_torch.core.config import (  # noqa: E402
    EsdfIntegratorConfig, MapConfig, MeshIntegratorConfig,
    TsdfIntegratorConfig)
from voxblox_tpu_torch.ops import mesh as mesh_ops  # noqa: E402
from voxblox_tpu_torch.ops import esdf as esdf_ops  # noqa: E402
from voxblox_tpu_torch.ops import esdf_relax  # noqa: E402
from voxblox_tpu_torch.ops import projective as projective_ops  # noqa: E402
from voxblox_tpu_torch.models import maps  # noqa: E402
from voxblox_tpu_torch.server.mapper import (  # noqa: E402
    EsdfServer, TsdfServer)
from voxblox_tpu_torch.sim import world as sw  # noqa: E402

# H100 SXM peaks: HBM bytes/s (NVIDIA data sheet) and the f32 instruction
# rate outside the tensor cores. The relaxation is min, max, compare,
# select and add, each one instruction a lane a clock: 132 SMs x 128 lanes
# x 1.98 GHz boost clock. (The data sheet's 67 TFLOP/s is the same rate
# with an FMA counted as two operations; no FMA occurs here.)
PEAK_BYTES = 3.35e12
PEAK_OPS = 132 * 128 * 1.98e9

# bench.py online-loop configuration (bench.py:56-76, :461-487).
RES = (640, 480)
VIRT = (320, 240)
VOXEL = 0.05
FOV_DEG = 60.0
N_POSES = 32
MAX_BLOCKS = 4096
MIN_OBSERVED = 100_000  # observed ESDF voxels a full-size map must have
TIMED = 12  # online steps in the timed window
# bench.py's batch-ESDF schedule (bench.py:269-274).
STRIDES = (8, 4, 2, 1, 1, 1, 1)
# benchmarks/stress_bench.py (:29-87).
STRESS_VOXEL = 0.02
STRESS_BLOCKS = 6144
STRESS_TIMED = 16
# Undersized on purpose: the grow-and-retry ladder must adapt.
STRESS_BUDGETS = dict(projective_max_visible_blocks=512,
                      projective_max_mixed_slabs=4096,
                      projective_max_free_slabs=512)
STRESS_MIN_BLOCKS = 4000
STRESS_MIN_VERTS = 100_000
MIN_DIFF = EsdfIntegratorConfig().min_diff_m  # what every path passes

# Operations the relaxation needs (the count behind the kernels' bounds;
# derivation in the note of voxblox_tpu_torch/csrc/esdf_relax.cu), by the
# best arrangement known. A unit sweep of one block: packing each padded
# voxel once as a source; per padded plane and packed field the in-plane
# partial extrema shared by the three centres around the plane (left/right
# pairs on 18 rows x 16 columns, up/down pairs, in-plane faces and
# diagonals on 16 x 16); per interior voxel and field five extrema to
# recombine three planes into the three step groups; the per-voxel group
# finish. A strided sweep beyond the packing: per interior voxel the gate
# test, per gated voxel and in-block neighbour one side's window test and
# minimum, per gated voxel the finish.
P = esdf_relax.P
OPS_PACK = 10
FIELDS = 4
OPS_PLANE = FIELDS * (P * (P - 2) + 3 * (P - 2) ** 2)
OPS_RECOMBINE = FIELDS * 5
OPS_FINISH = 49
OPS_PER_BLOCK_SWEEP = (P ** 3 * OPS_PACK + P * OPS_PLANE
                       + (P - 2) ** 3 * (OPS_RECOMBINE + OPS_FINISH))
OPS_GATE = 3
OPS_STRIDED_NEIGHBOUR = 4
OPS_STRIDED_FINISH = 11


def log(*a):
    print(*a, flush=True)


def _cuda_ms(fn, inputs):
    """Median device time of fn(x) over varied inputs (CUDA events). A
    short device-side spin goes first, so that the host enqueues the call
    while the card is busy and the events bracket device time only."""
    times = []
    for x in inputs:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)  # ~1 ms
        a.record()
        fn(x)
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times), times


def make_scans(dev):
    w = sw.SimulationWorld()
    w.add_cylinder((0.0, 0.0, 2.0), 2.0, 4.0, color=(0, 255, 0))
    w.add_ground_level(0.0)
    objs = w.freeze(dev)
    scans = []
    for i in range(N_POSES):
        a = 2 * np.pi * i / N_POSES
        pos = torch.tensor([4.0 * np.cos(a), 4.0 * np.sin(a), 2.0],
                           dtype=torch.float32, device=dev)
        view = torch.tensor([-np.cos(a), -np.sin(a), 0.0],
                            dtype=torch.float32, device=dev)
        R = sw.rotation_from_two_vectors(
            torch.tensor([0.0, 0.0, 1.0], device=dev), view)
        pts, cols, _, intr = sw.organized_pointcloud_from_transform(
            objs, (R, pos), RES, np.deg2rad(FOV_DEG), 8.0)
        scans.append((R, pos, pts, cols))
    return scans, intr


def make_server(dev, intr, relax_impl):
    ecfg = EsdfIntegratorConfig(
        max_distance_m=2.0, default_distance_m=2.0, min_distance_m=2 * VOXEL,
        max_active_blocks=1024, use_pallas_kernel=True, inner_sweeps=4,
        max_outer_sweeps_incremental=1)
    # Each server replays the same bucket history from scratch.
    esdf_ops._BUCKET_CACHE.clear()
    return EsdfServer(
        map_config=MapConfig(voxel_size=VOXEL, max_blocks=MAX_BLOCKS),
        integrator_config=TsdfIntegratorConfig(
            default_truncation_distance=4 * VOXEL, max_ray_length_m=5.0),
        esdf_config=ecfg, method="projective", projective_resolution=VIRT,
        projective_fov_deg=FOV_DEG, projective_intrinsics=intr,
        projective_pool=RES[0] // VIRT[0],
        projective_max_visible_blocks=256, projective_max_mixed_slabs=2048,
        projective_max_free_slabs=512, overflow_check_interval=10_000,
        device=dev, relax_impl=relax_impl)


def run_loop(srv, scans, on_window_start=None):
    """bench.py _bench_online's sequence: warm a full circle, check
    overflow, presize the bucket to the map, 4 steady steps, then TIMED
    steps with one sync at the end. Returns window stats; K1 launches and
    host syncs are read right after that sync, before the closing
    overflow check (whose rebuild could launch K1 again)."""
    for i in range(len(scans)):
        srv.insert_pointcloud_and_update_esdf(scans[i][:2], *scans[i][2:])
    srv.check_overflow()
    n_blocks = int(srv.layer.num_blocks)
    esdf_ops.presize_bucket(srv.esdf_cfg, srv.esdf_layer, n_blocks + 8)
    for i in range(4):
        srv.insert_pointcloud_and_update_esdf(scans[i][:2], *scans[i][2:])
    torch.cuda.synchronize()
    if on_window_start:
        on_window_start()
    syncs0 = _runtime.SYNCS
    t0 = time.perf_counter()
    iters = []
    for i in range(TIMED):
        s = scans[(4 + i) % len(scans)]
        iters.append(srv.insert_pointcloud_and_update_esdf(s[:2], *s[2:]))
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / TIMED * 1e3
    syncs = _runtime.SYNCS - syncs0
    launches = esdf_relax.LAUNCHES
    srv.check_overflow()
    return dict(ms_per_scan=ms, outer_iters=iters, relax_launches=launches,
                host_syncs_per_scan=syncs / TIMED, blocks=n_blocks)


def profile_window(srv, step, path, n=4, stack=True, keep=True):
    """torch.profiler over ``n`` calls of ``step(i)`` (a server's deferred
    overflow checks, if ``srv``, resolved after); per-call device busy
    time, the busy share of the traced window, kernel time inside the
    projective_integrate / esdf_incremental / mesh_update spans, K1's
    time, kernel launches and stream synchronizations (from the exported
    trace, written to ``path``)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 with_stack=stack) as prof:
        for i in range(n):
            step(i)
        torch.cuda.synchronize()
    if srv is not None:
        srv.check_overflow()
    os.makedirs("chiprun_out", exist_ok=True)
    prof.export_chrome_trace(path)
    with open(path) as f:
        ev = json.load(f)["traceEvents"]
    if not keep:  # chiprun_out/ has a size limit; the summary is enough
        os.remove(path)
    kern = [e for e in ev if e.get("cat") == "kernel"]
    t0 = min(e["ts"] for e in kern)
    t1 = max(e["ts"] + e["dur"] for e in kern)
    busy = sum(e["dur"] for e in kern)
    spans = {}
    for a in (e for e in ev if e.get("cat") == "gpu_user_annotation"):
        inside = sum(e["dur"] for e in kern if a["ts"] <= e["ts"]
                     and e["ts"] + e["dur"] <= a["ts"] + a["dur"] + 1)
        spans[a["name"]] = spans.get(a["name"], 0.0) + inside
    host = {}
    for a in (e for e in ev if e.get("cat") == "user_annotation"):
        host[a["name"]] = host.get(a["name"], 0.0) + a["dur"]
    runtime = [e["name"] for e in ev if e.get("cat") == "cuda_runtime"]
    # Where the stream syncs come from: the innermost port function
    # (file:line name) around each cudaStreamSynchronize.
    pyf = [e for e in ev if e.get("cat") == "python_function"
           and "voxblox_tpu_torch" in e["name"]]
    sites = {}
    for sy in (e for e in ev if e.get("name") == "cudaStreamSynchronize"):
        around = [p for p in pyf if p["ts"] <= sy["ts"]
                  and p["ts"] + p["dur"] >= sy["ts"] + sy["dur"]]
        key = min(around, key=lambda p: p["dur"])["name"] if around else "?"
        key = key.split("voxblox_tpu_torch/")[-1]
        sites[key] = sites.get(key, 0) + 1
    k1 = sum(e["dur"] for e in kern if "esdf_relax_k1" in e["name"])
    by_name = {}  # kernel time by (shortened) name
    for e in kern:
        by_name[e["name"][:60]] = by_name.get(e["name"][:60], 0.0) + e["dur"]
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return dict(
        scans=n, device_busy_ms_per_scan=busy / n / 1e3,
        traced_span_ms_per_scan=(t1 - t0) / n / 1e3,
        device_busy_share=busy / (t1 - t0),
        span_kernel_ms_per_scan={k: v / n / 1e3 for k, v in spans.items()},
        span_host_ms_per_scan={k: v / n / 1e3 for k, v in host.items()},
        k1_ms_per_scan=k1 / n / 1e3,
        kernel_launches_per_scan=len(kern) / n,
        stream_syncs_per_scan=runtime.count("cudaStreamSynchronize") / n,
        sync_sites_per_scan={k: v / n for k, v in sorted(
            sites.items(), key=lambda kv: -kv[1])},
        memcpy_per_scan=sum(1 for e in ev if e.get("cat") == "gpu_memcpy")
        / n,
        top_kernels_ms_per_scan={k: v / n / 1e3 for k, v in top})


def structured_relax_inputs(n, seed, dev, strides):
    """K2 inputs: values as ``random_relax_inputs`` makes them, but with
    traversable regions large enough for jumps at every level. Four blocks
    in ten are open and of one sign; the rest follow a random plane (a
    band around it may not update) and have four unobserved 2^3 boxes.
    Codes come from the port's own erosion (standalone: zero ring)."""
    g = torch.Generator(device="cpu").manual_seed(1000 + seed)
    mag = torch.rand((n, 18, 18, 18), generator=g) * 2.5
    ax = torch.arange(18, dtype=torch.float32)
    zz, yy, xx = torch.meshgrid(ax, ax, ax, indexing="ij")
    nrm = torch.nn.functional.normalize(
        torch.randn((n, 3), generator=g), dim=1)
    off = torch.rand(n, generator=g) * 11.0 + 3.0
    s = (xx[None] * nrm[:, 0, None, None, None]
         + yy[None] * nrm[:, 1, None, None, None]
         + zz[None] * nrm[:, 2, None, None, None]
         - (off * nrm.sum(1))[:, None, None, None])
    open_blk = (torch.rand(n, generator=g) < 0.4)[:, None, None, None]
    side = torch.where(torch.rand(n, generator=g) < 0.5, 5.0, -5.0)
    s = torch.where(open_blk, side[:, None, None, None], s)
    d = torch.where(s > 0, mag, -mag)
    corner = torch.randint(0, 16, (n, 4, 3), generator=g)
    inside = torch.ones((n, 4, 18, 18, 18), dtype=torch.bool)
    for a, grid in enumerate((zz, yy, xx)):
        c = corner[:, :, a, None, None, None].float()
        inside &= (grid[None, None] >= c) & (grid[None, None] < c + 2)
    obs = ~(inside.any(1) & ~open_blk)
    upd = torch.zeros(d.shape, dtype=torch.bool)
    u = obs & (s.abs() > 1.0)
    upd[:, 1:-1, 1:-1, 1:-1] = u[:, 1:-1, 1:-1, 1:-1]
    act = torch.rand(n, generator=g) < 0.5
    d, obs, upd, act = (x.to(dev).contiguous() for x in (d, obs, upd, act))
    codes = esdf_ops.stride_codes_standalone(d, upd, strides)
    return d, obs, upd, act, codes


def entries_needed(x, schedule, voxel, max_distance, codes=None):
    """Which entries of ``schedule`` each block needs, bool [entries, n]:
    none for a block that is inactive or has no voxel that may be written;
    an entry that repeats the previous one's stride only where that one
    changed a voxel of the block (the same sweep on an unchanged state
    changes nothing). Found by running the entries one launch each."""
    d, obs, upd, act = x[:4]
    levels = esdf_relax._levels(schedule)
    work = act & upd.flatten(1).any(1)
    need, cur, prev = [], d, None
    for k in schedule:
        run = need[-1] & changed if k == prev else work
        own = None
        if k > 1:  # this stride's gate as a one-level code
            own = tuple((c >= levels[k]).to(torch.uint8) for c in codes)
        new = esdf_relax.relax(cur, obs, upd, run, 1, voxel, max_distance,
                               MIN_DIFF, strides=(k,), codes=own)
        changed = (new != cur).flatten(1).any(1)
        need.append(run)
        cur, prev = new, k
    return torch.stack(need)


def relax_work(x, schedule, voxel, max_distance, codes=None):
    """(operations, bytes) ``relax`` needs for these inputs and this
    schedule (a tuple of strides). Operations: a unit sweep costs
    ``OPS_PER_BLOCK_SWEEP`` per block that needs it (``entries_needed``);
    a strided sweep costs the packing, one gate test per interior voxel
    and, for voxels that may update and whose own sign's gate is open, the
    window test and minimum per neighbour that lies inside the padded cube
    plus the finish. Bytes: d read and the output written for every block,
    the active flags, upd read for active blocks, obs (and both code
    cubes) for blocks that have a voxel to write."""
    d, obs, upd, active = x[:4]
    levels = esdf_relax._levels(schedule)
    need = entries_needed(x, schedule, voxel, max_distance, codes)
    n = d.shape[0]
    v = P - 2
    ops = 0
    ax = torch.arange(1, v + 1, device=upd.device)
    for k, run in zip(schedule, need):
        n_run = int(run.sum())
        if k == 1:
            ops += n_run * OPS_PER_BLOCK_SWEEP
            continue
        own = torch.where(d > 0.0, codes[0], codes[1])
        gated = (upd & (own >= levels[k])
                 & run.view(-1, 1, 1, 1))[:, 1:-1, 1:-1, 1:-1]
        per_cell = torch.zeros((v, v, v), dtype=torch.int64,
                               device=upd.device)
        for dx, dy, dz in esdf_relax._OFFSETS:
            ok = [((ax + k * o >= 0) & (ax + k * o <= P - 1))
                  for o in (dz, dy, dx)]
            per_cell += (ok[0][:, None, None] & ok[1][None, :, None]
                         & ok[2][None, None, :])
        nbrs = int((gated * per_cell[None]).sum())
        ops += (n_run * (P ** 3 * OPS_PACK + v ** 3 * OPS_GATE)
                + nbrs * OPS_STRIDED_NEIGHBOUR
                + int(gated.sum()) * OPS_STRIDED_FINISH)
    working = int(need[0].sum())
    nbytes = (n * P ** 3 * (4 + 4) + n + int(active.sum()) * P ** 3
              + working * P ** 3 * (3 if levels else 1))
    return ops, nbytes


def kernel_phase(name, inputs, run_kernel, run_plain, work_of, extra):
    """One kernel against its plain version on ``inputs`` (expect
    bit-equal), both timed with CUDA events, and its bound from the
    operations and bytes these inputs need (``work_of``)."""
    max_err = 0.0
    for x in inputs:
        got = run_kernel(x)
        ref = run_plain(x)
        torch.cuda.synchronize()
        max_err = max(max_err, float((got - ref).abs().max()))
        assert torch.isfinite(got).all()
    assert max_err == 0.0, f"{name} differs from its plain version: {max_err}"
    ms, k_times = _cuda_ms(run_kernel, inputs)
    plain_ms, p_times = _cuda_ms(run_plain, inputs)
    work = [work_of(x) for x in inputs]
    ops = statistics.median(w[0] for w in work)
    nbytes = statistics.median(w[1] for w in work)
    bound_ms = max(nbytes / PEAK_BYTES, ops / PEAK_OPS) * 1e3
    bound_by = "operations" if ops / PEAK_OPS > nbytes / PEAK_BYTES else (
        "bytes")
    kern = dict(extra, tolerance="exact (bit-equal)", ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                share_of_bound=bound_ms / ms, ops=ops, bytes=nbytes,
                kernel_times_ms=k_times,
                plain_times_ms=p_times, max_abs_err=max_err)
    log(f"{name}: " + json.dumps(kern))
    return kern


def k1_phase(n, dev, voxel, max_distance, path, inputs=None):
    """K1 at ``n`` padded blocks, 4 unit sweeps, with the voxel size and
    max distance of ``path`` (the step constants and the source window
    follow from them), on ``inputs`` or else on random inputs spanning
    1.25 x the window."""
    if inputs is None:
        inputs = [random_relax_inputs(n, seed, dev, max_distance / 2.0)
                  for seed in range(7)]
    act = statistics.median(int(x[3].sum()) for x in inputs)
    return kernel_phase(
        f"kernel K1 ({path})", inputs,
        lambda x: esdf_relax.relax(*x, 4, voxel, max_distance, MIN_DIFF),
        lambda x: esdf_relax.relax_plain(*x, 4, voxel, max_distance,
                                         MIN_DIFF),
        lambda x: relax_work(x, (1,) * 4, voxel, max_distance),
        dict(path=path, n_blocks=n, active_blocks=act, inner_sweeps=4,
             voxel_size=voxel, max_distance=max_distance))


def k2_phase(n, dev):
    """K2 at ``n`` padded blocks with the batch rebuild's schedule."""
    inputs = [structured_relax_inputs(n, seed, dev, STRIDES)
              for seed in range(7)]
    act = statistics.median(int(x[3].sum()) for x in inputs)
    code = torch.maximum(*inputs[0][4])
    admitted = [int((code >= lvl).sum()) for lvl in (1, 2, 3)]
    assert all(a > 0 for a in admitted), admitted

    def kernel(x):
        before = esdf_relax.STRIDED_LAUNCHES
        out = esdf_relax.relax(*x[:4], 4, VOXEL, 2.0, MIN_DIFF,
                               strides=STRIDES, codes=x[4])
        assert esdf_relax.STRIDED_LAUNCHES == before + 1
        return out

    def plain(x):
        return esdf_relax.relax_plain(*x[:4], 4, VOXEL, 2.0, MIN_DIFF,
                                      strides=STRIDES, codes=x[4])

    return kernel_phase(
        "kernel K2", inputs, kernel, plain,
        lambda x: relax_work(x, STRIDES, VOXEL, 2.0, x[4]),
        dict(n_blocks=n, active_blocks=act, strides=list(STRIDES),
             admitted_voxels_per_level=admitted))


def random_relax_inputs(n, seed, dev, scale=1.0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    d = (torch.rand((n, 18, 18, 18), generator=g) * 5.0 - 2.5) * scale
    obs = torch.rand(d.shape, generator=g) < 0.8
    upd = torch.zeros(d.shape, dtype=torch.bool)
    upd[:, 1:-1, 1:-1, 1:-1] = torch.rand((n, 16, 16, 16), generator=g) < 0.7
    act = torch.rand(n, generator=g) < 0.5
    return tuple(x.to(dev).contiguous() for x in (d, obs, upd, act))


def reset_counts():
    esdf_relax.LAUNCHES = 0
    esdf_relax.STRIDED_LAUNCHES = 0


def batch_phase(tsdf_layer, dev):
    """bench.py's batch-ESDF section on the map the online loop built:
    ``update_from_tsdf_batch_deferred`` with the unit and the strided
    schedule, perturbed TSDF inputs per call, groups of 4 chained calls
    with one sync, median of 3 groups."""
    import dataclasses

    base = dict(max_distance_m=2.0, default_distance_m=2.0,
                min_distance_m=2 * VOXEL, max_active_blocks=1024,
                use_pallas_kernel=True, inner_sweeps=4)
    cfg_unit = EsdfIntegratorConfig(**base)
    cfg_strided = EsdfIntegratorConfig(**base, sweep_strides=STRIDES)

    def perturbed(i):
        ch = dict(tsdf_layer.channels)
        ch["tsdf"] = ch["tsdf"] + np.float32(1e-6 * i)
        return dataclasses.replace(tsdf_layer, channels=ch)

    layers = [perturbed(i) for i in range(8)]
    # The online server shares the bucket cache's key: put its entry back.
    saved_buckets = dict(esdf_ops._BUCKET_CACHE)
    G, N = 4, 3
    last = layers[1 + (G * (N - 1) + G - 1) % (len(layers) - 1)]

    def fresh():
        return vlayer.make_layer("esdf", VOXEL, vps=16,
                                 max_blocks=MAX_BLOCKS, device=dev)

    def run(cfg):
        esdf_ops._BUCKET_CACHE.clear()
        e2, _, _, _ = esdf_ops.update_from_tsdf_batch_deferred(
            fresh(), layers[0], cfg)
        torch.cuda.synchronize()
        reset_counts()
        syncs0 = _runtime.SYNCS
        times, flags, iters = [], [], []
        for i in range(N):
            t0 = time.perf_counter()
            for g in range(G):
                e2, ovf, r_ovf, it = (
                    esdf_ops.update_from_tsdf_batch_deferred(
                        e2, layers[1 + (G * i + g) % (len(layers) - 1)],
                        cfg))
                flags += [ovf, r_ovf]
                iters.append(it)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3 / G)
        launches = esdf_relax.LAUNCHES
        strided = esdf_relax.STRIDED_LAUNCHES
        syncs = (_runtime.SYNCS - syncs0) / (G * N)
        assert not any(_runtime.host_bools(flags)), "batch ESDF overflowed"
        return e2, dict(ms=statistics.median(times), group_ms=times,
                        outer_iters=iters[-1], launches=launches,
                        strided_launches=strided,
                        launches_per_rebuild=launches / (G * N),
                        host_syncs_per_rebuild=syncs,
                        bucket=esdf_ops._BUCKET_CACHE.get((MAX_BLOCKS, 16, 1024),
                                                       MAX_BLOCKS))

    e_unit, unit = run(cfg_unit)
    e_str, strided = run(cfg_strided)
    assert unit["launches"] > 0 and unit["strided_launches"] == 0, unit
    assert strided["strided_launches"] > 0, "the strided rebuild never " \
        "launched K2"
    assert strided["strided_launches"] == strided["launches"], strided

    # The two schedules' fixpoints, at the tolerance the JAX suite accepts
    # between its own schedules (rmse < 5e-3 over observed voxels).
    fl_u = e_unit.channels["esdf_flags"]
    fl_s = e_str.channels["esdf_flags"]
    assert torch.equal(fl_u, fl_s)
    obs = (fl_s & 1) != 0
    n_obs = int(obs.sum())
    assert n_obs > MIN_OBSERVED, n_obs
    diff = (e_str.channels["esdf"] - e_unit.channels["esdf"])[obs]
    rmse = float(diff.pow(2).mean().sqrt())
    assert torch.isfinite(e_str.channels["esdf"]).all()
    assert rmse < 5e-3, rmse

    # Both rebuilds again with the plain relaxation, asked by name.
    def plain_replay(cfg, e_kern, iters):
        before = esdf_relax.LAUNCHES
        e_plain, ovf, r_ovf, it_p = esdf_ops.update_from_tsdf_batch_deferred(
            fresh(), last, cfg, relax_impl="plain")
        assert esdf_relax.LAUNCHES == before, "plain replay launched a kernel"
        assert not any(_runtime.host_bools([ovf, r_ovf]))
        assert it_p == iters, (it_p, iters)
        assert torch.equal(e_plain.channels["esdf_flags"],
                           e_kern.channels["esdf_flags"])
        assert torch.equal(e_plain.block_flags, e_kern.block_flags)
        err = float((e_plain.channels["esdf"]
                     - e_kern.channels["esdf"])[obs].abs().max())
        assert err <= 1e-5, err
        return err

    replay_err = plain_replay(cfg_strided, e_str, strided["outer_iters"])
    unit_replay_err = plain_replay(cfg_unit, e_unit, unit["outer_iters"])
    gate = esdf_ops.stride_gate_stats(e_str, cfg_strided)
    esdf_ops._BUCKET_CACHE.clear()
    esdf_ops._BUCKET_CACHE.update(saved_buckets)
    res = dict(unit=unit, strided=strided, observed_voxels=n_obs,
               strided_vs_unit_rmse=rmse,
               strided_vs_unit_max_abs=float(diff.abs().max()),
               plain_replay_max_abs_err=replay_err,
               unit_plain_replay_max_abs_err=unit_replay_err,
               stride_gate=gate)
    log("batch esdf: " + json.dumps(res))
    return res


def make_stress_server(dev, intr):
    """benchmarks/stress_bench.py's server (:61-87): 2 cm, projective
    budgets undersized on purpose so the grow-and-retry ladder adapts."""
    ecfg = EsdfIntegratorConfig(
        max_distance_m=1.0, default_distance_m=1.0,
        min_distance_m=2 * STRESS_VOXEL, max_active_blocks=STRESS_BLOCKS,
        use_pallas_kernel=True, inner_sweeps=4,
        max_outer_sweeps_incremental=1)
    esdf_ops._BUCKET_CACHE.clear()
    return EsdfServer(
        map_config=MapConfig(voxel_size=STRESS_VOXEL,
                             max_blocks=STRESS_BLOCKS, table_capacity=32768),
        integrator_config=TsdfIntegratorConfig(
            default_truncation_distance=4 * STRESS_VOXEL,
            max_ray_length_m=8.0),
        esdf_config=ecfg,
        mesh_config=MeshIntegratorConfig(march_cube_budget=16384,
                                         update_bucket=192),
        method="projective", projective_resolution=VIRT, projective_fov_deg=FOV_DEG,
        projective_intrinsics=intr, projective_pool=RES[0] // VIRT[0],
        overflow_check_interval=8, device=dev, **STRESS_BUDGETS)


def surface_error(v):
    """Distance of points [N,3] to the scene's surface: the capped
    cylinder (radius 2 m, z in [0, 4]) or the ground plane z = 0."""
    dr = np.hypot(v[:, 0], v[:, 1]) - 2.0
    dz = np.abs(v[:, 2] - 2.0) - 2.0
    cyl = (np.hypot(np.maximum(dr, 0), np.maximum(dz, 0))
           + np.minimum(np.maximum(dr, dz), 0))
    return np.minimum(np.abs(cyl), np.abs(v[:, 2]))


def stress_step(srv, scan):
    srv.insert_pointcloud_and_update_esdf(scan[:2], *scan[2:])
    srv.update_mesh()


def stress_phase(scans, intr, dev, profile):
    """benchmarks/stress_bench.py's loop (:89-117) and a check of the mesh
    it leaves."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    srv = make_stress_server(dev, intr)
    budgets0 = dict(srv.projective_budgets)
    t0 = time.perf_counter()
    blocks_at = {}
    for i, s in enumerate(scans):
        srv.insert_pointcloud_and_update_esdf(s[:2], *s[2:])
        if i + 1 in (8, 16):  # just after a deferred overflow check
            blocks_at[i + 1] = int(srv.layer.num_blocks)
    srv.check_overflow()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    esdf_ops.presize_bucket(srv.esdf_cfg, srv.esdf_layer,
                            int(srv.layer.num_blocks) + 64)
    for s in scans[:8]:
        stress_step(srv, s)
    srv.check_overflow()
    torch.cuda.synchronize()
    n_blocks = int(srv.layer.num_blocks)
    assert n_blocks >= STRESS_MIN_BLOCKS, n_blocks
    assert srv.projective_budgets != budgets0, "the budgets never grew"

    reset_counts()
    syncs0 = _runtime.SYNCS
    t0 = time.perf_counter()
    for i in range(STRESS_TIMED):
        stress_step(srv, scans[i % len(scans)])
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / STRESS_TIMED * 1e3
    syncs = (_runtime.SYNCS - syncs0) / STRESS_TIMED
    launches = esdf_relax.LAUNCHES
    assert launches > 0 and esdf_relax.STRIDED_LAUNCHES == 0
    srv.check_overflow()
    res = dict(ms_per_scan=ms, blocks=n_blocks, warm_circle_s=warm_s,
               blocks_after_scans=blocks_at,
               relax_launches=launches,
               relax_launches_per_scan=launches / STRESS_TIMED,
               host_syncs_per_scan=syncs,
               budgets_start=budgets0, budgets=dict(srv.projective_budgets),
               max_memory_allocated=torch.cuda.max_memory_allocated(),
               voxel_bytes=(srv.layer.memory_bytes()
                            + srv.esdf_layer.memory_bytes()),
               mesh_pool_bytes=srv.mesh_pool.tris.numel() * 4)
    if profile:
        res["profile"] = profile_window(
            srv, lambda i: stress_step(srv, scans[(16 + i) % len(scans)]),
            "chiprun_out/stress_trace.json")
        res["profile"]["device_busy_share_of_step"] = (
            res["profile"]["device_busy_ms_per_scan"] / ms)

    # The mesh: full re-mesh through the pool (overflow rows rebuilt by the
    # dense fallback on export) against the host path, then the surface.
    t0 = time.perf_counter()
    ml = srv.generate_mesh()
    gen_s = time.perf_counter() - t0
    n_ovf = int((srv.mesh_pool.overflow_rows & srv.layer.active_mask()).sum())
    v, nrm, _ = ml.combined()
    assert len(v) > STRESS_MIN_VERTS and len(v) % 3 == 0, len(v)
    assert np.isfinite(v).all() and np.isfinite(nrm).all()
    host = mesh_ops.MeshLayer(srv.layer.block_size)
    mesh_ops.generate_mesh(srv.layer, host, srv.mesh_config,
                           only_updated=False, clear_updated_flag=False)
    # No overflow row is left out: block for block, the pool's export has
    # the triangles of the uncapped host march.
    assert set(ml.blocks) == set(host.blocks)
    for key, blk in host.blocks.items():
        assert len(ml.blocks[key].vertices) == len(blk.vertices), key
    err = surface_error(v)
    res.update(mesh_triangles=len(v) // 3, mesh_blocks=len(ml.blocks),
               mesh_overflow_rows_rebuilt=n_ovf, generate_mesh_s=gen_s,
               surface_err_max=float(err.max()),
               surface_err_p999=float(np.quantile(err, 0.999)),
               surface_err_mean=float(err.mean()))
    log("stress loop: " + json.dumps(res))
    assert err.max() <= STRESS_VOXEL, (
        f"mesh vertex {err.max():.4f} m off the surface")
    esdf = srv.esdf_layer.channels["esdf"]
    assert torch.isfinite(esdf).all()
    assert float(esdf.abs().max()) <= 1.0 + 1e-6
    res["esdf_rebuild"] = stress_rebuild_check(srv, dev)
    return res


def stress_rebuild_check(srv, dev):
    """K1 on the stress map's own data: a batch ESDF rebuild of the 2 cm
    TSDF map with the stress configuration (the sweep runs over the whole
    6144-row pool, as the loop's incremental update does), once through
    the kernel and once through the plain relaxation; flags identical,
    ESDF equal on observed voxels."""
    first = []  # the arguments of the kernel rebuild's first relaxation
    relax = esdf_relax.relax

    def capturing(*args, **kwargs):
        if not first:
            first.append((args, kwargs))
        return relax(*args, **kwargs)

    def rebuild(impl):
        fresh = vlayer.make_layer("esdf", STRESS_VOXEL, vps=16,
                                  max_blocks=STRESS_BLOCKS, device=dev)
        before = esdf_relax.LAUNCHES
        t0 = time.perf_counter()
        e, ovf, r_ovf, it = esdf_ops.update_from_tsdf_batch_deferred(
            fresh, srv.layer, srv.esdf_cfg, relax_impl=impl)
        assert not any(_runtime.host_bools([ovf, r_ovf]))
        return (e, it, esdf_relax.LAUNCHES - before,
                time.perf_counter() - t0)

    esdf_relax.relax = capturing
    try:
        e_k, it_k, launches, s_k = rebuild("kernel")
    finally:
        esdf_relax.relax = relax
    e_p, it_p, plain_launches, s_p = rebuild("plain")
    assert launches > 0 and plain_launches == 0, (launches, plain_launches)
    assert it_k == it_p, (it_k, it_p)
    assert torch.equal(e_k.channels["esdf_flags"], e_p.channels["esdf_flags"])
    obs = (e_k.channels["esdf_flags"] & 1) != 0
    err = float((e_k.channels["esdf"] - e_p.channels["esdf"])[obs].abs().max())
    res = dict(outer_iters=it_k, relax_launches=launches, kernel_s=s_k,
               plain_s=s_p, observed_voxels=int(obs.sum()),
               kernel_vs_plain_max_abs_err=err)
    log("stress esdf rebuild: " + json.dumps(res))
    assert err <= 1e-5, err
    # K1 on those first-sweep inputs: the padded 2 cm map with its halo,
    # every block of the pool active, as in the loop's single outer
    # iteration.
    (d_pad, obs_pad, upd_pad, act, sweeps, voxel, maxd, min_diff), kw = (
        first[0])
    assert (sweeps, voxel, maxd, min_diff) == (4, STRESS_VOXEL, 1.0,
                                               MIN_DIFF), first[0][0][4:]
    assert not kw.get("strides") and d_pad.shape[0] == STRESS_BLOCKS
    x = (d_pad, obs_pad, upd_pad, act)
    k1 = k1_phase(STRESS_BLOCKS, dev, STRESS_VOXEL, 1.0, "stress, map data",
                  inputs=[x] * 7)
    k1["blocks_with_voxels_to_write"] = int(
        (act & upd_pad.flatten(1).any(1)).sum())
    res["k1_on_map_data"] = k1
    return res


# ---------------------------------------------------------------------------
# Phases 8-13: full-Euclidean ESDF, queries, batched and spherical TSDF,
# ray casting
# ---------------------------------------------------------------------------


def tsdf_observed(layer):
    """bool [max_blocks, vpb]: weight > 1e-6 on active rows (the observed
    test of voxblox_tpu/utils/evaluation.py)."""
    return (layer.channels["weight"] > 1e-6) & layer.active_mask()[:, None]


def layers_rmse(gt, test):
    """(rmse, voxels) of test's TSDF against gt's over co-located voxels
    observed in both (evaluate_layers_rmse)."""
    slot = vlayer.lookup_blocks(test, gt.block_ijk)
    pair = gt.active_mask() & (slot >= 0)
    safe = torch.where(pair, slot, 0).to(torch.int64)
    both = (tsdf_observed(gt) & (test.channels["weight"][safe] > 1e-6)
            & pair[:, None])
    err = (test.channels["tsdf"][safe] - gt.channels["tsdf"])[both]
    return float(err.pow(2).mean().sqrt()), int(both.sum())


def batch_vs_sequential(bat, seq, what):
    """The JAX suite's batch-against-sequential contract
    (tests/test_projective.py:210-242): rmse < 2e-3 over voxels observed
    in both, observed counts within 1%."""
    rmse, n = layers_rmse(seq, bat)
    n_s, n_b = int(tsdf_observed(seq).sum()), int(tsdf_observed(bat).sum())
    res = dict(rmse=rmse, compared_voxels=n, observed_sequential=n_s,
               observed_batch=n_b)
    assert n > MIN_OBSERVED // 10, (what, res)
    assert rmse < 2e-3, (what, res)
    assert abs(n_s - n_b) <= 0.01 * n_s, (what, res)
    return res


def cpu_copy(layer):
    return vlayer.layer_from_numpy(vlayer.layer_to_numpy(layer), "cpu")


def full_euclid_phase(tsdf_layer, dev):
    """A batch ESDF rebuild with full_euclidean_distance=True of the
    phase-3 map (the plain sweep with parent vectors: the JAX package
    never takes its kernel there), against the quasi-Euclidean rebuild,
    and a point source against sqrt distances and the port on the CPU."""
    base = dict(max_distance_m=2.0, default_distance_m=2.0,
                min_distance_m=2 * VOXEL, max_active_blocks=1024,
                use_pallas_kernel=True, inner_sweeps=4)
    cfg_full = EsdfIntegratorConfig(**base, full_euclidean_distance=True)
    cfg_quasi = EsdfIntegratorConfig(**base)
    saved_buckets = dict(esdf_ops._BUCKET_CACHE)

    def rebuild(cfg):
        esdf_ops._BUCKET_CACHE.clear()
        fresh = vlayer.make_layer("esdf", VOXEL, vps=16,
                                  max_blocks=MAX_BLOCKS, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        e, ovf, r_ovf, it = esdf_ops.update_from_tsdf_batch_deferred(
            fresh, tsdf_layer, cfg)
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) * 1e3
        assert not any(_runtime.host_bools([ovf, r_ovf]))
        return e, it, dt

    reset_counts()
    times = []
    for _ in range(3):
        e_full, it_full, dt = rebuild(cfg_full)
        times.append(dt)
    assert esdf_relax.LAUNCHES == 0, "the full-Euclidean sweep launched K1"
    e_quasi, _, _ = rebuild(cfg_quasi)
    esdf_ops._BUCKET_CACHE.clear()
    esdf_ops._BUCKET_CACHE.update(saved_buckets)
    f = e_full.channels["esdf_flags"]
    assert torch.equal(f, e_quasi.channels["esdf_flags"])
    m = ((f & 1) != 0) & ((f & 2) == 0)
    full = e_full.channels["esdf"][m].abs()
    quasi = e_quasi.channels["esdf"][m].abs()
    assert torch.isfinite(full).all()
    # The chamfer overestimates; both sweeps drop changes below min_diff_m,
    # so either field may stop that far from its fixpoint.
    excess = float((full - quasi).max())
    shorter = int((full < quasi - cfg_full.min_diff_m).sum())
    assert excess <= cfg_full.min_diff_m, excess
    assert shorter > 0.01 * int(m.sum()), (shorter, int(m.sum()))
    n_parent = int((e_full.channels["parent"] != 0).any(1).sum())
    assert n_parent > 0

    # Point source: 8 blocks of 16^3 1 m voxels, one zero seed.
    t = vlayer.make_layer("tsdf", 1.0, vps=16, max_blocks=64, device=dev)
    blocks = torch.tensor(np.stack(np.meshgrid([-1, 0], [-1, 0], [-1, 0],
                                               indexing="ij"), -1)
                          .reshape(-1, 3), dtype=torch.int32, device=dev)
    t, _ = vlayer.allocate_blocks(t, blocks, torch.ones(8, dtype=torch.bool,
                                                        device=dev))
    t.channels["weight"].copy_(torch.where(
        t.active_mask()[:, None], 1.0, 0.0).expand_as(t.channels["weight"]))
    t.channels["tsdf"].fill_(100.0)
    vlayer.set_voxels(t, "tsdf", torch.zeros((1, 3), dtype=torch.int32,
                                             device=dev),
                      torch.zeros(1, device=dev))
    pcfg = EsdfIntegratorConfig(max_distance_m=20.0, default_distance_m=20.0,
                                min_distance_m=0.2, min_diff_m=1e-4,
                                full_euclidean_distance=True)
    point = {}
    for where, layer in (("cuda", t), ("cpu", cpu_copy(t))):
        e, ovf, _ = esdf_ops.update_from_tsdf_batch(
            vlayer.make_layer("esdf", 1.0, vps=16, max_blocks=64,
                              device=layer.device), layer, pcfg)
        assert not _runtime.host_bool(ovf)
        point[where] = e
    q = np.array([[1, 0, 0], [1, 1, 0], [3, 2, 1], [-4, -4, -4], [5, 0, 0],
                  [4, 3, 0], [-15, 7, -9], [12, -3, 5]], np.int32)
    got, found = vlayer.get_voxels(point["cuda"], "esdf",
                                   torch.as_tensor(q, device=dev))
    assert bool(found.all())
    want = np.linalg.norm(q.astype(np.float64), axis=1)
    rel = np.abs(got.cpu().numpy() - want) / want
    assert rel.max() <= 0.035, rel
    err_cpu = float((point["cuda"].channels["esdf"].cpu()
                     - point["cpu"].channels["esdf"]).abs().max())
    assert err_cpu <= 1e-5, err_cpu
    assert torch.equal(point["cuda"].channels["parent"].cpu(),
                       point["cpu"].channels["parent"])
    res = dict(ms_per_rebuild=statistics.median(times), rebuild_ms=times,
               outer_iters=it_full, observed_non_fixed=int(m.sum()),
               shorter_than_quasi=shorter, max_excess_over_quasi=excess,
               blocks_with_parents=n_parent,
               point_source_max_rel_err=float(rel.max()),
               point_source_card_vs_cpu_max_abs=err_cpu)
    log("full-Euclidean esdf: " + json.dumps(res))
    return res


QUERIES = 1_000_000
QUERIES_CPU = 200_000  # the prefix also run on CPU copies of the layers


def queries_phase(tsdf_layer, esdf_layer, dev):
    """TsdfMap / EsdfMap queries at a million seeded points in the maps'
    bounds, timed on the card, and against CPU copies of the layers."""
    mc = MapConfig(voxel_size=VOXEL, max_blocks=MAX_BLOCKS)
    act = esdf_layer.active_mask()
    bijk = esdf_layer.block_ijk[act].to(torch.float32)
    lo = bijk.amin(0) * esdf_layer.block_size
    hi = (bijk.amax(0) + 1) * esdf_layer.block_size
    g = torch.Generator(device="cpu").manual_seed(7)
    pts = (torch.rand((QUERIES, 3), generator=g).to(dev) * (hi - lo) + lo)
    maps_on = {"cuda": (maps.TsdfMap(tsdf_layer, mc),
                        maps.EsdfMap(esdf_layer, mc))}
    maps_on["cpu"] = (maps.TsdfMap(cpu_copy(tsdf_layer), mc),
                      maps.EsdfMap(cpu_copy(esdf_layer), mc))
    calls = {
        "tsdf_distance": lambda m, p: m[0].get_distance_at_position(p),
        "esdf_distance": lambda m, p: m[1].get_distance_at_position(p),
        "esdf_distance_and_gradient":
            lambda m, p: m[1].get_distance_and_gradient_at_position(p),
        "esdf_adaptive_distance_and_gradient":
            lambda m, p: m[1].get_distance_and_gradient_at_position(
                p, adaptive=True),
    }
    res = {}
    for name, fn in calls.items():
        times = []
        for i in range(3):
            p = pts + 1e-6 * i  # varied inputs
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(maps_on["cuda"], p)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        ref = fn(maps_on["cpu"], pts[:QUERIES_CPU].cpu())
        got = fn(maps_on["cuda"], pts[:QUERIES_CPU])
        valid = got[-1]
        assert torch.equal(valid.cpu(), ref[-1]), name
        err = 0.0
        for a, b in zip(got[:-1], ref[:-1]):
            a = a.cpu()
            ok = valid.cpu()
            assert torch.isfinite(a[ok]).all(), name
            err = max(err, float((a - b)[ok].abs().max()))
        assert err <= 1e-5, (name, err)
        share = float(out[-1].float().mean())
        assert share > 0.01, (name, share)
        res[name] = dict(ms_per_million=statistics.median(times)
                         * 1e6 / QUERIES, times_ms=times, valid_share=share,
                         card_vs_cpu_max_abs=err)
    log("queries: " + json.dumps(res))
    return res


def tsdf_batch_phase(scans, intr, dev, profile=False):
    """bench.py section 1 (:102-156): K=32 organized scans per dispatch,
    budgets 192/1920/256, a warm-up epoch then timed rounds; the first
    batch against 32 sequential single-scan calls."""
    cfg = TsdfIntegratorConfig(default_truncation_distance=4 * VOXEL,
                               max_ray_length_m=5.0)
    Rs = torch.stack([s[0] for s in scans])
    ts = torch.stack([s[1] for s in scans])
    pts = torch.stack([s[2] for s in scans])
    cols = torch.stack([s[3] for s in scans])
    budgets = dict(max_visible_blocks=192, max_mixed_slabs=1920,
                   max_free_slabs=256)

    def epoch(layer):
        return projective_ops.integrate_organized_projective_batch(
            layer, Rs, ts, pts, cols, cfg, intrinsics=intr,
            pool=RES[0] // VIRT[0], **budgets)

    def fresh():
        return vlayer.make_layer("tsdf", VOXEL, vps=16, max_blocks=MAX_BLOCKS,
                                 device=dev)

    layer, ovf = epoch(fresh())
    first = vlayer.clone_layer(layer)
    flags = [ovf]
    rounds = 3
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(rounds):
        layer, ovf = epoch(layer)
        flags.append(ovf)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    overflow = any(_runtime.host_bools(flags))
    n_scans = rounds * len(scans)
    seq = fresh()
    seq_flags = []
    for R, t, p, c in scans:
        seq, p_o, b_o = projective_ops.integrate_organized_projective(
            seq, (R, t), p, c, cfg, intrinsics=intr, pool=RES[0] // VIRT[0])
        seq_flags += [p_o, b_o]
    assert not any(_runtime.host_bools(seq_flags))
    if profile:
        holder = [layer]

        def step(i):
            holder[0], _ = epoch(holder[0])

        prof = profile_window(None, step, "chiprun_out/tsdf_batch_trace.json",
                              n=1, stack=False, keep=False)
        prof["device_busy_ms_per_scan"] = (prof["device_busy_ms_per_scan"]
                                           / len(scans))
        log("tsdf batch profile (one K=32 call): " + json.dumps(prof))
    res = dict(ms_per_scan=dt / n_scans * 1e3,
               points_per_s=n_scans * RES[0] * RES[1] / dt,
               scans_timed=n_scans, K=len(scans),
               blocks=_runtime.host_int(layer.num_blocks), overflow=overflow,
               vs_sequential=batch_vs_sequential(first, seq, "tsdf batch"))
    log(f"tsdf batch: {res['ms_per_scan']:.3f} ms/scan, "
        f"{res['points_per_s'] / 1e6:.1f} M points/s, blocks "
        f"{res['blocks']}, overflow={overflow}")
    log("tsdf batch: " + json.dumps(res))
    assert not overflow, "the batch overflowed its budgets"
    return res


def velodyne_phase(dev, profile=False):
    """bench.py's velodyne section (:347-426): a street (two walls, ground,
    12 cylinders from RandomState(0)), 2048x64 spinning-lidar scans, 0.2 m
    voxels, 50 m rays, carving off, a 16384-block pool (the direct
    accumulator), K=16 per call, four timed groups, the first dropped."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    w = sw.SimulationWorld()
    w.add_ground_level(0.0)
    w.add_plane((0.0, 12.0, 5.0), (0.0, -1.0, 0.0), color=(180, 160, 140))
    w.add_plane((0.0, -12.0, 5.0), (0.0, 1.0, 0.0), color=(140, 160, 180))
    rng = np.random.RandomState(0)
    for _ in range(12):
        x = rng.uniform(-40, 40)
        y = rng.uniform(-9, 9)
        w.add_cylinder((x, y, 2.5), rng.uniform(0.2, 1.0), 5.0,
                       color=(30, 200, 30))
    objs = w.freeze(dev)
    reso, voxel, K = (2048, 64), 0.2, 16
    cfg = TsdfIntegratorConfig(default_truncation_distance=4 * voxel,
                               max_ray_length_m=50.0,
                               voxel_carving_enabled=False)
    eye = torch.eye(3, device=dev)
    ts = torch.tensor([[-20.0 + 2.5 * i, 0.0, 2.0] for i in range(K)],
                      device=dev)
    scans = [sw.spherical_pointcloud_from_transform(
        objs, (eye, ts[i]), reso, 3.0, -25.0, 50.0) for i in range(K)]
    pts = torch.stack([s[0] for s in scans])
    cols = torch.stack([s[1] for s in scans])
    Rs = eye.expand(K, 3, 3)
    lidar = dict(resolution=reso, fov_up_deg=3.0, fov_down_deg=-25.0)

    def run(layer, i):
        return projective_ops.integrate_pointcloud_projective_batch(
            layer, Rs, ts + i * 1e-5, pts, cols, cfg,
            kind="spherical_organized", max_visible_blocks=2944,
            max_mixed_slabs=15360, max_free_slabs=384, **lidar)

    def fresh():
        return vlayer.make_layer("tsdf", voxel, vps=16, max_blocks=16384,
                                 device=dev)

    layer, ovf = run(fresh(), 0)
    first = vlayer.clone_layer(layer)
    flags, times = [ovf], []
    for g in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        layer, ovf = run(layer, g + 1)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) / K * 1e3)
        flags.append(ovf)
    overflow = any(_runtime.host_bools(flags))
    peak = torch.cuda.max_memory_allocated()
    if profile:
        holder = [layer]

        def step(i):
            holder[0], _ = run(holder[0], 10 + i)

        prof = profile_window(None, step, "chiprun_out/velodyne_trace.json",
                              n=1, stack=False, keep=False)
        log("velodyne profile (one K=16 call): " + json.dumps(prof))
    seq = fresh()
    seq_flags = []
    for i in range(K):
        seq, p_o, b_o = projective_ops.integrate_pointcloud_projective(
            seq, (eye, ts[i]), pts[i], cols[i], cfg,
            kind="spherical_organized", max_visible_blocks=2944, **lidar)
        seq_flags += [p_o, b_o]
    assert not any(_runtime.host_bools(seq_flags))
    a = projective_ops.build_spherical_range_image(pts[0], cols[0], reso,
                                                   3.0, -25.0)
    b = projective_ops.build_spherical_range_image_organized(
        pts[0], cols[0], reso, 3.0, -25.0)
    fin = torch.isfinite(b.rng)
    assert torch.equal(torch.isfinite(a.rng), fin)
    img_err = float(((a.rng - b.rng)[fin]).abs().max())
    assert img_err <= 1e-6 * 50.0, img_err
    assert torch.equal(a.color, b.color) and torch.equal(a.params, b.params)
    warm = sorted(times[1:])
    res = dict(ms_per_scan=warm[len(warm) // 2], group_ms_per_scan=times,
               blocks=_runtime.host_int(layer.num_blocks), overflow=overflow,
               max_memory_allocated=peak, returns_per_scan=int(
                   (pts[0].norm(dim=-1) > 1e-3).sum()),
               scatter_vs_organized_image_max_abs=img_err,
               vs_sequential=batch_vs_sequential(first, seq, "velodyne"))
    log(f"velodyne: {res['ms_per_scan']:.2f} ms/scan, blocks "
        f"{res['blocks']}, overflow={overflow}, peak {peak / 2**30:.2f} GiB")
    log("velodyne: " + json.dumps(res))
    assert not overflow, "the velodyne batch overflowed its budgets"
    return res


RAYCAST_SCANS = {"fast": (2, 12), "merged": (1, 4), "simple": (1, 4)}


def raycast_phase(scans, dev, profile=False):
    """TsdfServer(method=...) on the orbit's flat 640x480 clouds (307,200
    points, 5 m rays): ms/scan after warm-up scans, the map against the
    analytic scene (tests/test_tsdf_integration.py:90-91 on every observed
    voxel within truncation), then 2 scans at 160x120 on the card against
    the same run of the port on the CPU."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    trunc = 4 * VOXEL
    tcfg = TsdfIntegratorConfig(default_truncation_distance=trunc,
                                max_ray_length_m=5.0)
    w = sw.SimulationWorld()
    w.add_cylinder((0.0, 0.0, 2.0), 2.0, 4.0, color=(0, 255, 0))
    w.add_ground_level(0.0)
    objs = w.freeze(dev)
    flat = [(s[0], s[1], s[2].reshape(-1, 3), s[3].reshape(-1, 3))
            for s in scans]

    def server(method, device):
        return TsdfServer(map_config=MapConfig(voxel_size=VOXEL,
                                               max_blocks=MAX_BLOCKS),
                          integrator_config=tcfg, method=method,
                          device=device)

    res = {}
    for method, (n_warm, n_timed) in RAYCAST_SCANS.items():
        srv = server(method, dev)
        for s in flat[:n_warm]:
            srv.insert_pointcloud(s[:2], *s[2:])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for s in flat[n_warm:n_warm + n_timed]:
            srv.insert_pointcloud(s[:2], *s[2:])
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / n_timed * 1e3
        srv.check_overflow()
        if profile and method == "fast":
            nxt = n_warm + n_timed
            prof = profile_window(
                srv, lambda i: srv.insert_pointcloud(
                    flat[nxt + i][:2], *flat[nxt + i][2:]),
                "chiprun_out/raycast_fast_trace.json", n=2, stack=False,
                keep=False)
            log("raycast fast profile: " + json.dumps(prof))
        layer = srv.layer
        obs = tsdf_observed(layer)
        rows, vox = torch.nonzero(obs, as_tuple=True)
        lin = vox.to(torch.int32)
        v = layer.vps
        local = torch.stack([lin % v, (lin // v) % v, lin // (v * v)], -1)
        centres = ((layer.block_ijk[rows] * v + local).to(torch.float32)
                   + 0.5) * VOXEL
        gt, _ = sw.distance_to_point(objs, centres, trunc)
        gt = torch.clamp(gt, min=-trunc)
        d = layer.channels["tsdf"][rows, vox]
        keep = d >= -trunc + 1e-6  # kIgnoreErrorBehindTestSurface
        err = (d - gt)[keep]
        rmse = float(err.pow(2).mean().sqrt())
        max_err = float(err.abs().max())
        res[method] = dict(ms_per_scan=ms, scans_timed=n_timed,
                           blocks=_runtime.host_int(layer.num_blocks),
                           observed_voxels=int(obs.sum()),
                           evaluated_voxels=int(keep.sum()), rmse=rmse,
                           max_err=max_err)
        log(f"raycast {method}: {ms:.1f} ms/scan, rmse {rmse:.4f} m, "
            f"max {max_err:.3f} m over {int(keep.sum())} voxels")
        assert int(keep.sum()) > MIN_OBSERVED // 4, (method, res[method])
        assert rmse < 2 * VOXEL and max_err < 4 * trunc + 1e-6, res[method]
        del srv
    res["max_memory_allocated"] = torch.cuda.max_memory_allocated()

    # The card against the port on the CPU, 2 scans at 160x120.
    small = []
    for R, t, _, _ in scans[:2]:
        p, c, _, _ = sw.organized_pointcloud_from_transform(
            objs, (R, t), (160, 120), np.deg2rad(FOV_DEG), 8.0)
        small.append((R, t, p.reshape(-1, 3), c.reshape(-1, 3)))
    for method in RAYCAST_SCANS:
        out = []
        for device in (dev, torch.device("cpu")):
            srv = server(method, device)
            for R, t, p, c in small:
                srv.insert_pointcloud((R.to(device), t.to(device)),
                                      p.to(device), c.to(device))
            srv.check_overflow()
            out.append(vlayer.layer_to_numpy(srv.layer))
        a, b = out
        for k in ("num_blocks", "block_ijk", "block_flags"):
            assert np.array_equal(a[k], b[k]), (method, k)
        wa, wb = a["channel/weight"], b["channel/weight"]
        da, db = a["channel/tsdf"], b["channel/tsdf"]
        observed = int((wb > 0).sum())
        equal = int(((wa == wb) & (da == db) & (wb > 0)).sum())
        off = int(((np.abs(wa - wb) > 1e-5 + 1e-5 * wb)
                   | (np.abs(da - db) > 1e-5)).sum())
        cmp = dict(observed_voxels=observed, bit_equal_voxels=equal,
                   voxels_off_by_more_than_1e5=off)
        res[method]["card_vs_cpu_160x120"] = cmp
        log(f"raycast {method} card vs cpu: " + json.dumps(cmp))
        assert observed > MIN_OBSERVED // 10, cmp
        assert off <= 2e-3 * observed, cmp
    log("raycast: " + json.dumps(res))
    return res


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args()
    dev = torch.device("cuda")
    out = {"phase_seconds": {}}
    clock = [time.perf_counter()]

    def done(phase):
        torch.cuda.synchronize()
        now = time.perf_counter()
        out["phase_seconds"][phase] = now - clock[0]
        log(f"[{phase}: {now - clock[0]:.1f} s]")
        clock[0] = now

    # 1. Device.
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    log(f"device: {name} | nvidia-smi: {smi} | torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    out["device"] = dict(name=name, nvidia_smi=smi)

    # 2. Build (one source file holds both kernels: one nvcc run).
    t0 = time.perf_counter()
    esdf_relax.build()
    esdf_relax._lib()
    out["build_s"] = time.perf_counter() - t0
    out["build_ptxas"] = esdf_relax.BUILD_INFO.get("ptxas", "(cached)")
    ctas = dict(k1=esdf_relax.ctas_per_sm(False),
                k2=esdf_relax.ctas_per_sm(True))
    out["ctas_per_sm"] = ctas
    log(f"build: {out['build_s']:.1f} s, CTAs per SM {ctas} "
        f"{out['build_ptxas']}")
    assert min(ctas.values()) >= 1, ctas
    done("build")

    # 3. Main path at full size, kernel relaxation.
    t0 = time.perf_counter()
    scans, intr = make_scans(dev)
    torch.cuda.synchronize()
    log(f"scans: {len(scans)} x {RES} in {time.perf_counter() - t0:.1f} s")
    srv = make_server(dev, intr, "kernel")
    torch.cuda.reset_peak_memory_stats()
    win = run_loop(srv, scans, on_window_start=reset_counts)
    launches = win["relax_launches"]
    bucket = esdf_ops._BUCKET_CACHE[(MAX_BLOCKS, 16, 1024)]
    win.update(bucket=bucket,
               max_memory_allocated=torch.cuda.max_memory_allocated())
    log("main path: " + json.dumps(win))
    assert launches > 0, "the online loop never launched the kernel"
    assert all(i >= 1 for i in win["outer_iters"])
    esdf = srv.esdf_layer.channels["esdf"]
    obs = (srv.esdf_layer.channels["esdf_flags"] & 1) != 0
    tsdf = srv.layer.channels["tsdf"]
    assert torch.isfinite(esdf).all() and torch.isfinite(tsdf).all()
    assert int(obs.sum()) > MIN_OBSERVED, int(obs.sum())
    assert float(esdf[obs].abs().max()) <= 2.0 + 1e-6
    assert float(tsdf.abs().max()) <= 4 * VOXEL + 1e-6
    out["main"] = win
    done("main")

    # 4. K1 against its plain version at the online loop's shape and at
    # the stress loop's (the unit batch rebuild's follows its phase).
    k1 = k1_phase(bucket, dev, VOXEL, 2.0, "online loop")
    out["kernel"] = k1
    k1_other = [k1_phase(STRESS_BLOCKS, dev, STRESS_VOXEL, 1.0,
                         "stress loop")]
    done("kernel K1")

    # 5. Replay with the plain relaxation, selected explicitly.
    ref_srv = make_server(dev, intr, "plain")
    before = esdf_relax.LAUNCHES
    run_loop(ref_srv, scans)
    assert esdf_relax.LAUNCHES == before, "plain replay launched the kernel"
    for k in ("tsdf", "weight", "color"):
        assert torch.equal(srv.layer.channels[k], ref_srv.layer.channels[k]), k
    assert torch.equal(srv.layer.block_ijk, ref_srv.layer.block_ijk)
    e_ref = ref_srv.esdf_layer.channels["esdf"]
    replay_err = float((esdf - e_ref)[obs].abs().max())
    assert replay_err <= 1e-5, replay_err
    assert torch.equal(srv.esdf_layer.channels["esdf_flags"],
                       ref_srv.esdf_layer.channels["esdf_flags"])
    log(f"replay: TSDF identical, ESDF max |kernel - plain| on observed "
        f"voxels = {replay_err}")
    out["replay_max_abs_err"] = replay_err
    del ref_srv
    done("replay")

    # 6. Batch ESDF rebuild of that map, unit and strided.
    out["batch"] = batch_phase(srv.layer, dev)
    done("batch esdf")
    batch_bucket = out["batch"]["unit"]["bucket"]
    if batch_bucket != bucket:
        k1_other.append(k1_phase(batch_bucket, dev, VOXEL, 2.0,
                                 "unit batch rebuild"))
        done("kernel K1 at the batch bucket")

    # 7. K2 against its plain version at the batch rebuild's bucket.
    k2 = k2_phase(out["batch"]["strided"]["bucket"], dev)
    out["kernel_k2"] = k2
    done("kernel K2")

    if args.profile:
        # After the replay and batch checks: these scans change the map.
        def online_step(i):
            s = scans[(16 + i) % len(scans)]
            srv.insert_pointcloud_and_update_esdf(s[:2], *s[2:])

        out["profile"] = profile_window(srv, online_step,
                                        "chiprun_out/online_trace.json")
        # Busy share against the unprofiled step time (the profiler itself
        # slows the host side of the traced window).
        out["profile"]["device_busy_share_of_step"] = (
            out["profile"]["device_busy_ms_per_scan"] / win["ms_per_scan"])
        log("profile: " + json.dumps(out["profile"]))
        done("profile online")

    # 8. Full-Euclidean batch ESDF of the phase-3 map.
    out["full_euclid"] = full_euclid_phase(srv.layer, dev)
    done("full-Euclidean esdf")

    # 9. Map queries on the phase-3 maps.
    out["queries"] = queries_phase(srv.layer, srv.esdf_layer, dev)
    done("queries")
    del srv
    torch.cuda.empty_cache()

    # 10. The 2 cm stress loop, with a mesh update every scan.
    out["stress"] = stress_phase(scans, intr, dev, args.profile)
    done("stress")
    k1_other.append(out["stress"]["esdf_rebuild"]["k1_on_map_data"])
    out["kernel_other_shapes"] = k1_other
    torch.cuda.empty_cache()

    # 11-13. Batched TSDF, the velodyne street map, ray casting.
    out["tsdf_batch"] = tsdf_batch_phase(scans, intr, dev, args.profile)
    done("tsdf batch")
    torch.cuda.empty_cache()
    out["velodyne"] = velodyne_phase(dev, args.profile)
    done("velodyne")
    torch.cuda.empty_cache()
    out["raycast"] = raycast_phase(scans, dev, args.profile)
    done("raycast")

    os.makedirs("chiprun_out", exist_ok=True)
    with open("chiprun_out/chip_smoke.json", "w") as f:
        json.dump(out, f, indent=1)
    src = "voxblox_tpu_torch/csrc/esdf_relax.cu"
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")
    shape_keys = ("path", "n_blocks", "active_blocks", "voxel_size",
                  "max_distance") + keys
    # ``launches`` is the count from the path that is the kernel's own (K1:
    # the online loop's timed window; K2: the strided batch rebuilds); the
    # other paths' counts, and K1 at their shapes, stand beside it.
    line = {"kernels": [
        dict(name="esdf_relax_k1", route="cuda", source=src,
             replaces="voxblox_tpu/ops/pallas/esdf_relax.py:52",
             launches=launches, **{k: k1[k] for k in keys},
             library_ms=None, ctas_per_sm=ctas["k1"],
             launches_by_path=dict(
                 online_loop=launches,
                 batch_unit=out["batch"]["unit"]["launches"],
                 stress_loop=out["stress"]["relax_launches"]),
             other_shapes=[{k: o[k] for k in shape_keys}
                           for o in k1_other]),
        dict(name="esdf_relax_k2", route="cuda", source=src,
             replaces="voxblox_tpu/ops/pallas/esdf_relax.py:208",
             launches=out["batch"]["strided"]["strided_launches"],
             **{k: k2[k] for k in keys}, library_ms=None,
             ctas_per_sm=ctas["k2"],
             launches_by_path=dict(
                 batch_strided=out["batch"]["strided"]["strided_launches"])),
    ]}
    print(json.dumps(line))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
