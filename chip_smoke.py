"""GPU smoke run of the PyTorch/CUDA port: builds the hand-written kernels,
holds each to its plain version, and drives the port's paths on one CUDA
card at the full size of the JAX package's own benchmarks: the online
mapping step at 5 cm (bench.py's online loop), the batch ESDF rebuild
with the unit and the strided schedule (bench.py's ESDF section), the
2 cm stress loop with a mesh update every scan (benchmarks/
stress_bench.py), the batched TSDF throughput path (bench.py section 1),
the velodyne street map (bench.py's velodyne section), the three
ray-casting integrators, the full-Euclidean ESDF, the map queries, map
files, mesh messages, ICP, the command line's bag replay, the renderer
(bench.py's render section), `cli sim-bench` with occupancy, intensity,
layer transforms and multi-GPU sharding (one rank over NCCL, two ranks
sharing the card over gloo).

    python3 chip_smoke.py             # the check (one card, a few minutes)
    python3 chip_smoke.py --profile   # + torch.profiler windows

Phases (any failure exits non-zero; nothing falls back to the CPU):
  1 device   nvidia-smi name/power limit, refuse without a GPU
  2 build    nvcc the kernels from voxblox_tpu_torch/csrc/ (K1 and K2,
             the walk kernel)
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
             640x480 clouds against the analytic scene, the walk kernel's
             launches counted over the timed scans (one a scan for simple
             and merged, none for fast); the kernel held to the plain
             chain on the rays of 3 more scans of each, and timed against
             it and its byte bound there; at 160x120 the card's maps
             against the port's on the CPU
 14 io       (after 9) EsdfServer.save_map of the phase-3 maps to .vxblx
             (TSDF + ESDF appended) and .npz, loaded back into fresh
             servers on the card: the same blocks, floats bit for bit,
             ESDF flags and parents equal, colour after its uint8
             rounding; the command line in process on the .vxblx file
             (info, mesh, tsdf-to-esdf against update_esdf_batch of the
             loaded TSDF, traversable); after 15 the same save and load
             of the 2 cm stress map (seconds and MB of each)
 15 meshmsg  (after 10) 8 more stress steps, publish_mesh_msg() after
             each into a subscriber MeshLayer, which must then hold
             export_mesh_layer()'s blocks and triangle counts, vertices
             within the quantization step; bytes and ms per publish
 16 icp      TsdfServer(method="fast", enable_icp=True) at 5 cm on the flat
             640x480 orbit clouds: 8 scans at their true poses, then scans
             2 deg of yaw and 5 cm off, refined by tests/test_icp.py's
             margins; ms and host syncs (at most 2) per ICP call; the first
             call again on a CPU copy of the layer, R and t within 1e-4
 17 replay   the 32 orbit scans written as a ROS bag (640x480 PointCloud2
             + TransformStamped), replayed by `cli replay --method fast
             --esdf` into a map and a mesh; the map against the analytic
             scene; then tests/data/cow_fixture.bag replayed on the card
             and on the CPU (same blocks, at most 0.2% of voxels off)
 18 render   (after 11) bench.py's render section on the tsdf-batch map:
             65,536 rays from (0, -4, 2), 8 m, the packed march; forward
             and loss + gradient rays/s (median of 3 groups of 4 calls),
             launches, syncs, march steps and survivors per call; against
             a CPU copy (depth, hit, gradient), the general path, the
             analytic cylinder, central differences, the colour path; a
             640x480 depth image of the 2 cm stress map from orbit pose 0
 19 simbench (last) `cli sim-bench --device cuda` in process at its
             defaults, plain and --occupancy, against tests/test_server.py's
             bounds; 3 viewpoints against a CPU copy (TSDF and occupancy,
             at most 0.2% of voxels off); the occupancy ESDF through K1
             against the plain relaxation (bit-equal), K1 at its shape
 20 intensity (after 14) IntensityServer over the phase-3 TSDF: a 640x480
             image at subsample 4, ms and syncs a call, against a CPU copy
 21 transform transform_layer of the phase-3 TSDF (10 deg yaw, 0.1 m) and
             back, merge_layers, evaluate_layer_rmse_at_poses; against a
             CPU copy
 22 shard    (after 11) parallel/sharding.py: (a) one rank over NCCL in
             this process, at full width: the ray-sharded simple integrate
             of orbit scan 0 (307,200 points, 5 m rays, 4096 blocks), the
             32 orbit scans scan-sharded (budgets 192/1920/256), the
             block-sharded sweep of the phase-3 map (unit and strided
             schedule) and of the 2 cm map over its 6144-block pool, the
             ray-sharded render loss + gradient of 65,536 rays on the
             tsdf-batch map; each against its unsharded call on the card
             (sweeps bit-equal, integrates at tests/test_parallel.py's
             bounds, loss rel 1e-3, gradient 1e-4); K1/K2 counted on the
             sharded sweeps; K1 at the rows rank 0 of two relaxes.
             (b) two spawned ranks sharing the card over gloo, the 5 cm
             calls, the same checks, every rank's results the same bits.
             Seconds, and count, bytes and seconds of each collective,
             per call
Prints a {"kernels": [...]} line, the nvidia-smi line, and last
{"ok": true, "device": {...}}. Details go to chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
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
    EsdfIntegratorConfig, IcpConfig, MapConfig, MeshIntegratorConfig,
    TsdfIntegratorConfig)
from voxblox_tpu_torch.ops import mesh as mesh_ops  # noqa: E402
from voxblox_tpu_torch.ops import esdf as esdf_ops  # noqa: E402
from voxblox_tpu_torch.ops import esdf_relax  # noqa: E402
from voxblox_tpu_torch.ops import projective as projective_ops  # noqa: E402
from voxblox_tpu_torch.ops import tsdf as tsdf_ops  # noqa: E402
from voxblox_tpu_torch.ops import tsdf_walk  # noqa: E402
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


def k2_phase(n, dev, path="strided batch rebuild", inputs=None):
    """K2 at ``n`` padded blocks with the batch rebuild's schedule, on
    ``inputs`` = (d, obs, upd, act, codes) tuples taken from ``path`` or
    else on structured random inputs."""
    synthetic = inputs is None
    if synthetic:
        inputs = [structured_relax_inputs(n, seed, dev, STRIDES)
                  for seed in range(7)]
    act = statistics.median(int(x[3].sum()) for x in inputs)
    code = torch.maximum(*inputs[0][4])
    admitted = [int((code >= lvl).sum()) for lvl in (1, 2, 3)]
    # Random inputs must reach every level; a path's own data at least the
    # first (some voxel takes a jump, so the strided reads run).
    assert all(a > 0 for a in admitted[:3 if synthetic else 1]), admitted

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
        f"kernel K2 ({path})", inputs, kernel, plain,
        lambda x: relax_work(x, STRIDES, VOXEL, 2.0, x[4]),
        dict(path=path, n_blocks=n, active_blocks=act,
             strides=list(STRIDES), voxel_size=VOXEL, max_distance=2.0,
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
    return res, srv


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
    return res, layer


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


def orbit_objects(dev):
    w = sw.SimulationWorld()
    w.add_cylinder((0.0, 0.0, 2.0), 2.0, 4.0, color=(0, 255, 0))
    w.add_ground_level(0.0)
    return w.freeze(dev)


def analytic_errors(layer, objs, trunc):
    """A TSDF map against the analytic scene (tests/test_tsdf_integration.
    py:90-91): every observed voxel not behind the surface, its distance
    against the scene's, clamped to the truncation."""
    obs = tsdf_observed(layer)
    rows, vox = torch.nonzero(obs, as_tuple=True)
    lin = vox.to(torch.int32)
    v = layer.vps
    local = torch.stack([lin % v, (lin // v) % v, lin // (v * v)], -1)
    centres = ((layer.block_ijk[rows] * v + local).to(torch.float32)
               + 0.5) * layer.voxel_size
    gt, _ = sw.distance_to_point(objs, centres, trunc)
    gt = torch.clamp(gt, min=-trunc)
    d = layer.channels["tsdf"][rows, vox]
    keep = d >= -trunc + 1e-6  # kIgnoreErrorBehindTestSurface
    err = (d - gt)[keep]
    return dict(observed_voxels=int(obs.sum()),
                evaluated_voxels=int(keep.sum()),
                rmse=float(err.pow(2).mean().sqrt()),
                max_err=float(err.abs().max()))


def check_analytic(acc, trunc, what):
    """The ray-casting contract: rmse under 2 voxels, max error under 4
    truncations, enough voxels evaluated."""
    assert acc["evaluated_voxels"] > MIN_OBSERVED // 4, what
    assert acc["rmse"] < 2 * VOXEL and acc["max_err"] < 4 * trunc + 1e-6, what


WALK_SCANS = 3  # scans whose rays the walk kernel is held and timed on


def walk_vs_chain(layer, rays, max_steps, cfg):
    """The walk kernel (through its wrapper) and the plain chain
    (``_chain_samples`` + ``_accumulate_flat``) on the same rays and table.
    Each accumulator cell within 2 (n - 1) 2^-24 sum|x| + 2^-21 sum|x| of
    the chain's over its n addends x (tests/test_torch_tsdf_walk.py's bound
    on the card: the atomics add in any order, and the chain's dropoff
    ramp multiplies by the reciprocal); dirty rows equal. Returns the
    kernel's accumulators, the largest |kernel - chain| and the largest
    error over its bound."""
    got = tsdf_ops._walk_kernel(layer, rays, max_steps, cfg)
    _, sdf, w, flat, ok, _ = tsdf_ops._chain_samples(layer, rays, max_steps,
                                                     cfg)
    use_color = rays.colors is not None
    want = tsdf_ops._accumulate_flat(layer, flat, ok, sdf, w, rays.colors,
                                     cfg, use_color)
    trunc = cfg.default_truncation_distance
    cw = torch.where(sdf.abs() < trunc, w, 0.0)
    addends = [w, w * torch.clamp(sdf, -trunc, trunc)]
    if use_color:
        addends += [cw[..., None] * rays.colors, cw]
    f = flat[ok]
    n_flat = got[0].shape[0]
    n = torch.bincount(f, minlength=n_flat).double()
    max_err, max_ratio = 0.0, 0.0
    for i, x in enumerate(addends):
        x = x[ok].reshape(f.shape[0], -1).abs().double()
        mag = torch.zeros((n_flat, x.shape[1]), dtype=torch.float64,
                          device=x.device).index_add_(0, f, x)
        bound = ((2.0 * (n - 1).clamp(min=0) * 2.0 ** -24
                  + 2.0 ** -21)[:, None] * mag)
        err = (got[i].double() - want[i].double()).reshape(bound.shape).abs()
        max_err = max(max_err, float(err.max()))
        max_ratio = max(max_ratio, float((err / bound.clamp(
            min=1e-30)).max()))
        assert bool((err <= bound).all()), (i, float((err - bound).max()))
    assert torch.equal(got[4], want[4]), "dirty rows differ"
    return got, max_err, max_ratio


def walk_phase(srv, scans):
    """The walk kernel on the rays ``srv`` (simple or merged) hands it for
    ``scans``: held to the plain chain (``walk_vs_chain``), its device time
    (the bare launch on prepared arguments, CUDA events) against the
    chain's (event to event, its launch gaps and probe-bound read
    included), and its bound: ``tsdf_walk.needed_bytes`` over the HBM
    rate."""
    caught = []
    kernel = tsdf_ops._walk_kernel

    def spy(layer, rays, max_steps, cfg):
        caught.append((layer, rays, max_steps, cfg))
        return kernel(layer, rays, max_steps, cfg)

    tsdf_ops._walk_kernel = spy
    try:
        for s in scans:
            srv.insert_pointcloud(s[:2], *s[2:])
    finally:
        tsdf_ops._walk_kernel = kernel
    assert len(caught) == len(scans), len(caught)
    errs, ratios, needed, samples = [], [], [], []
    for layer, rays, max_steps, cfg in caught:
        counts = torch.zeros(2, dtype=torch.int64, device=layer.device)
        acc = tsdf_walk.walk_and_accumulate(
            layer, max_steps, cfg, **tsdf_ops._kernel_inputs(rays, counts))
        probes = int(counts[0])
        needed.append(tsdf_walk.needed_bytes(
            acc, rays.valid, rays.colors is not None,
            min(probes, layer.table.capacity)))
        del acc
        _, err, ratio = walk_vs_chain(layer, rays, max_steps, cfg)
        errs.append(err)
        ratios.append(ratio)
        samples.append(int(tsdf_walk.walk_lengths(
            rays.setup.num_steps, rays.valid, max_steps).sum()))
    lib = tsdf_walk._lib()
    stream = torch.cuda.current_stream().cuda_stream
    prepared = [tsdf_walk.make_params(layer, max_steps, cfg,
                                      **tsdf_ops._kernel_inputs(rays))
                for layer, rays, max_steps, cfg in caught]
    ms, _ = _cuda_ms(lambda p: lib.tsdf_walk(ctypes.byref(p[0]), stream),
                     prepared * 3)
    del prepared

    def chain(c):
        layer, rays, max_steps, cfg = c
        _, sdf, w, flat, ok, _ = tsdf_ops._chain_samples(layer, rays,
                                                         max_steps, cfg)
        tsdf_ops._accumulate_flat(layer, flat, ok, sdf, w, rays.colors, cfg,
                                  rays.colors is not None)

    plain_ms, _ = _cuda_ms(chain, caught)
    bound_ms = 1e3 * statistics.median(needed) / PEAK_BYTES
    return dict(scans=len(caught), max_abs_err=max(errs),
                max_err_over_bound=max(ratios), ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by="bytes",
                needed_bytes=needed, useful_samples=samples,
                share_of_bound=bound_ms / ms)


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
    objs = orbit_objects(dev)
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
        tsdf_walk.LAUNCHES = 0
        t0 = time.perf_counter()
        for s in flat[n_warm:n_warm + n_timed]:
            srv.insert_pointcloud(s[:2], *s[2:])
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / n_timed * 1e3
        walk_launches = tsdf_walk.LAUNCHES
        # One launch a scan for simple and merged; fast keeps the chain.
        assert walk_launches == (0 if method == "fast" else n_timed), (
            method, walk_launches)
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
        acc = analytic_errors(layer, objs, trunc)
        res[method] = dict(ms_per_scan=ms, scans_timed=n_timed,
                           walk_launches=walk_launches,
                           blocks=_runtime.host_int(layer.num_blocks), **acc)
        log(f"raycast {method}: {ms:.1f} ms/scan, rmse {acc['rmse']:.4f} m, "
            f"max {acc['max_err']:.3f} m over {acc['evaluated_voxels']} "
            "voxels")
        check_analytic(acc, trunc, (method, res[method]))
        if method != "fast":
            nxt = n_warm + n_timed
            res[method]["walk_kernel"] = walk_phase(
                srv, flat[nxt:nxt + WALK_SCANS])
            log(f"raycast {method} walk kernel: "
                + json.dumps(res[method]["walk_kernel"]))
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



# ---------------------------------------------------------------------------
# Phases 14-17: map files, mesh messages, ICP, bag replay
# ---------------------------------------------------------------------------


def _bits(x):
    return x.contiguous().view(torch.int32) if x.dtype == torch.float32 else x


def assert_same_blocks(a, b, what, wire=True):
    """Two layers hold the same blocks (by index, in any rows) with the
    same voxels: floats bit for bit, the ESDF flags and the parent equal;
    after the .vxblx wire (``wire``) only the four wire flags, and colour
    after its uint8 rounding. Returns the number of blocks."""
    rows = torch.nonzero(a.active_mask())[:, 0]
    n = _runtime.host_int(b.active_mask().sum())
    assert n == len(rows), (what, n, len(rows))
    slots = vlayer.lookup_blocks(b, a.block_ijk[rows]).long()
    assert bool((slots >= 0).all()), what
    for name, ca in a.channels.items():
        x, y = ca[rows], b.channels[name][slots]
        if wire and name == "color":
            x = torch.clamp(torch.round(x), 0, 255)
        elif wire and name == "esdf_flags":
            x = x & 15
        assert torch.equal(_bits(x), _bits(y)), (what, name)
    return len(rows)


def _file_mb(path):
    size = os.path.getsize(path)
    if os.path.exists(path + ".esdf.npz"):
        size += os.path.getsize(path + ".esdf.npz")
    return size / 1e6


def io_phase(srv, dev, tmp, tag, with_cli):
    """EsdfServer.save_map to .vxblx (TSDF + ESDF appended) and to .npz,
    each loaded back into a fresh server on the card and compared block
    by block; with ``with_cli`` the command line in process on the .vxblx
    file: info, mesh, tsdf-to-esdf (its ESDF against update_esdf_batch of
    the loaded TSDF) and traversable."""
    from voxblox_tpu_torch.io import layer_io, ply
    from voxblox_tpu_torch.server import cli

    res = {}
    for ext in ("vxblx", "npz"):
        path = os.path.join(tmp, f"{tag}.{ext}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        srv.save_map(path)
        save_s = time.perf_counter() - t0
        fresh = EsdfServer(map_config=srv.map_config,
                           integrator_config=srv.cfg,
                           esdf_config=srv.esdf_cfg, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fresh.load_map(path)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        wire = ext == "vxblx"
        blocks = assert_same_blocks(srv.layer, fresh.layer, (tag, ext, "tsdf"),
                                    wire)
        assert_same_blocks(srv.esdf_layer, fresh.esdf_layer,
                           (tag, ext, "esdf"), wire)
        if ext == "npz":  # a checkpoint comes back row for row
            for k in vlayer._TABLE_FIELDS:
                assert torch.equal(getattr(srv.layer.table, k),
                                   getattr(fresh.layer.table, k)), k
        res[ext] = dict(save_s=save_s, load_s=load_s, mb=_file_mb(path),
                        blocks=blocks)
        del fresh
    if with_cli:
        path = os.path.join(tmp, f"{tag}.vxblx")
        card = ["--device", str(dev), "--max-blocks", str(MAX_BLOCKS)]
        t0 = time.perf_counter()
        assert cli.main(["info", path, "--device", str(dev)]) == 0
        heads = [(h.type, n) for h, n in layer_io.read_headers(path)]
        assert heads == [("tsdf", res["vxblx"]["blocks"]),
                         ("esdf", res["vxblx"]["blocks"])], heads
        mesh_path = os.path.join(tmp, f"{tag}_mesh.ply")
        assert cli.main(["mesh", path, mesh_path] + card) == 0
        verts = ply.read_ply(mesh_path)["vertices"]
        assert len(verts) > 1000 and np.isfinite(verts).all()
        out = os.path.join(tmp, f"{tag}_esdf.vxblx")
        assert cli.main(["tsdf-to-esdf", path, out] + card) == 0
        tsdf = layer_io.load_layer(path, "tsdf", max_blocks=MAX_BLOCKS,
                                   device=dev)
        ref, ovf, _ = esdf_ops.update_from_tsdf_batch(
            vlayer.make_layer("esdf", tsdf.voxel_size, vps=tsdf.vps,
                              max_blocks=tsdf.max_blocks, device=dev),
            tsdf, EsdfIntegratorConfig(max_distance_m=2.0,
                                       default_distance_m=2.0))
        assert not _runtime.host_bool(ovf)
        got = layer_io.load_layer(out, "esdf", max_blocks=MAX_BLOCKS,
                                  device=dev)
        assert_same_blocks(ref, got, (tag, "tsdf-to-esdf"))
        trav = os.path.join(tmp, f"{tag}_trav.ply")
        assert cli.main(["traversable", path, trav, "--radius", "0.3"]
                        + card) == 0
        n_trav = len(ply.read_ply(trav)["vertices"])
        want, _ = maps.EsdfMap(srv.esdf_layer, srv.map_config).\
            traversable_points(0.3)
        assert n_trav == len(want) > 0, (n_trav, len(want))
        res["cli"] = dict(seconds=time.perf_counter() - t0,
                          mesh_vertices=len(verts),
                          traversable_points=n_trav)
    log(f"io {tag}: " + json.dumps(res))
    return res


def mesh_msg_phase(srv, scans):
    """Eight more stress steps, each followed by publish_mesh_msg() into a
    subscriber MeshLayer (after one publish of everything pending); the
    subscriber then holds export_mesh_layer()'s blocks and triangle
    counts, every vertex within the wire's quantization step."""
    from voxblox_tpu_torch.io import mesh_msg

    sub = mesh_ops.MeshLayer(srv.layer.block_size)
    first = srv.publish_mesh_msg()
    mesh_msg.apply_mesh_msg(sub, mesh_msg.deserialize_mesh_msg(first))
    ms, sizes, blocks, syncs = [], [], [], []
    for i in range(8):
        stress_step(srv, scans[(STRESS_TIMED + i) % len(scans)])
        torch.cuda.synchronize()
        s0 = _runtime.SYNCS
        t0 = time.perf_counter()
        data = srv.publish_mesh_msg()
        ms.append((time.perf_counter() - t0) * 1e3)
        syncs.append(_runtime.SYNCS - s0)
        msg = mesh_msg.deserialize_mesh_msg(data)
        sizes.append(len(data))
        blocks.append(len(msg.blocks))
        mesh_msg.apply_mesh_msg(sub, msg)
    # A deferred overflow check may replay scans: publish what it changed.
    srv.check_overflow()
    last = srv.publish_mesh_msg()
    mesh_msg.apply_mesh_msg(sub, mesh_msg.deserialize_mesh_msg(last))
    ml = srv.export_mesh_layer()
    assert set(sub.blocks) == set(ml.blocks)
    # Rows that overflowed the pool's triangle cap are marched densely
    # when they are published and again on export, from the neighbours'
    # voxels of that moment: a neighbour updated in between moves their
    # border vertices. Their vertices are recorded, not held.
    ovf = _runtime.to_host(srv.mesh_pool.overflow_rows
                           & srv.layer.active_mask())
    ijk = _runtime.to_host(srv.layer.block_ijk)
    dense = {tuple(int(v) for v in ijk[r]) for r in np.flatnonzero(ovf)}
    step = srv.layer.block_size / 65535.0 + 1e-6
    worst = worst_dense = 0.0
    for key, blk in ml.blocks.items():
        got = sub.blocks[key].vertices
        assert got.shape == blk.vertices.shape, key
        err = float(np.abs(got - blk.vertices).max())
        if key in dense:
            worst_dense = max(worst_dense, err)
        else:
            worst = max(worst, err)
    assert worst <= step, (worst, step)
    res = dict(first_publish_bytes=len(first), last_publish_bytes=len(last),
               bytes_per_publish=sizes,
               blocks_per_publish=blocks, ms_per_publish=ms,
               host_syncs_per_publish=syncs, subscriber_blocks=len(sub.blocks),
               max_vertex_err=worst, quantization_step=step,
               dense_rows=len(dense), max_vertex_err_dense_rows=worst_dense)
    log("mesh messages: " + json.dumps(res))
    return res


ICP_TRUE_SCANS = 8
# tests/test_icp.py's configuration (:56-58).
ICP_CONFIG = IcpConfig(mini_batch_size=64, inital_translation_weighting=10.0,
                       inital_rotation_weighting=10.0)
ICP_SLOW_S = 20.0  # past this a call, the phase refines one scan only


def _yaw(deg):
    a = np.deg2rad(deg)
    return torch.tensor([[np.cos(a), -np.sin(a), 0.0],
                         [np.sin(a), np.cos(a), 0.0], [0.0, 0.0, 1.0]],
                        dtype=torch.float32)


def icp_phase(scans, dev):
    """TsdfServer(method="fast", enable_icp=True) at the online cell's
    5 cm settings on the orbit's flat 640x480 clouds: 8 scans around the
    orbit at their true poses (ICP off), then scans between them whose
    given pose is 2 deg of yaw and 5 cm off. Each call's time and host
    reads are recorded with its errors before and after (the orbit's
    cylinder is symmetric about the yaw axis, so those errors are not
    held to a margin), and the first call is repeated on a CPU copy of
    the layer (the same batch order). The margins of tests/test_icp.py
    are held on that test's own scene and pose (``icp_margins``)."""
    from voxblox_tpu_torch.ops import icp as icp_ops
    from voxblox_tpu_torch.server import mapper
    from voxblox_tpu_torch.utils import lie

    calls = []
    run = icp_ops.run_icp

    def timed(layer, points, T, cfg):
        torch.cuda.synchronize()
        s0 = _runtime.SYNCS
        t0 = time.perf_counter()
        out = run(layer, points, T, cfg)
        torch.cuda.synchronize()
        calls.append(dict(s=time.perf_counter() - t0,
                          syncs=_runtime.SYNCS - s0,
                          args=(cpu_copy(layer), points.cpu(),
                                (T[0].cpu(), T[1].cpu()), cfg) if not calls
                          else None, out=out))
        return out

    trunc = 4 * VOXEL
    srv = TsdfServer(
        map_config=MapConfig(voxel_size=VOXEL, max_blocks=MAX_BLOCKS),
        integrator_config=TsdfIntegratorConfig(
            default_truncation_distance=trunc, max_ray_length_m=5.0),
        method="fast", enable_icp=True, icp_config=ICP_CONFIG, device=dev)
    flat = [(s[0], s[1], s[2].reshape(-1, 3), s[3].reshape(-1, 3))
            for s in scans]
    step = len(flat) // ICP_TRUE_SCANS
    srv.enable_icp = False
    for R, t, p, c in flat[::step]:
        srv.insert_pointcloud((R, t), p, c)
    srv.enable_icp = True
    off = torch.tensor([0.03, -0.04, 0.0], device=dev)
    errs = []
    mapper.icp_ops.run_icp = timed
    try:
        for R, t, p, c in flat[step // 2::2 * step][:3]:
            R_bad, t_bad = _yaw(2.0).to(dev) @ R, t + off
            R_ref, t_ref = srv.insert_pointcloud((R_bad, t_bad), p, c)
            errs.append(dict(
                t_before=float((t_bad - t).norm()),
                t_after=float((t_ref - t).norm()),
                r_before=float(lie.so3_log(R_bad @ R.T).norm()),
                r_after=float(lie.so3_log(R_ref @ R.T).norm())))
            if calls[-1]["s"] > ICP_SLOW_S:
                break
    finally:
        mapper.icp_ops.run_icp = run
    srv.check_overflow()
    # The first call again on the CPU, in the same batch order.
    args, out = calls[0]["args"], calls[0]["out"]
    t0 = time.perf_counter()
    cpu = run(*args)
    cpu_s = time.perf_counter() - t0
    dR = float((out.R.cpu() - cpu.R).abs().max())
    dt = float((out.t.cpu() - cpu.t).abs().max())
    # tests/test_icp.py's case, at its size and at full size.
    margins = {"64x48": icp_margins(dev, (64, 48)),
               "640x480": icp_margins(dev, RES)}
    res = dict(points=int(flat[0][2].shape[0]),
               steps=max(1, int(flat[0][2].shape[0]
                                * srv.icp_config.subsample_keep_ratio)
                         // srv.icp_config.mini_batch_size),
               ms_per_call=[c["s"] * 1e3 for c in calls],
               host_syncs_per_call=[c["syncs"] for c in calls],
               num_updates=[_runtime.host_int(c["out"].num_updates)
                            for c in calls],
               errors=errs, cpu_s=cpu_s, card_vs_cpu_R=dR, card_vs_cpu_t=dt,
               margins=margins)
    log("icp: " + json.dumps(res))
    assert all(c["syncs"] <= 2 for c in calls), res
    assert dR <= 1e-4 and dt <= 1e-4, res
    assert all(np.isfinite(list(e.values())).all() for e in errs), errs
    check_icp_margins(margins["64x48"])
    # At full size the rotation meets the margins; the translation error
    # shrinks, but not to the test's 0.6 of what it was (PERF.md).
    check_icp_margins(margins["640x480"], translation=False)
    assert margins["640x480"]["t_after"] < margins["640x480"]["t_before"]
    return res


def gt_tsdf_layer(objs, voxel, lo, hi, max_dist, vps, dev):
    """A ground-truth TSDF over [lo, hi] (voxblox_tpu/sim/world.py
    generate_gt_layer): every voxel centre of the covering blocks gets the
    scene's distance, floored at -max_dist, weight 1 inside the bounds."""
    bs = voxel * vps
    b0 = np.floor((np.asarray(lo) - bs / 2) / bs).astype(np.int64)
    b1 = np.floor((np.asarray(hi) + bs / 2) / bs).astype(np.int64)
    blocks = np.stack(np.meshgrid(*[np.arange(b0[i], b1[i] + 1)
                                    for i in range(3)], indexing="ij"),
                      -1).reshape(-1, 3)
    layer = vlayer.make_layer("tsdf", voxel, vps=vps,
                              max_blocks=len(blocks), device=dev)
    ijk = torch.as_tensor(blocks, dtype=torch.int32, device=dev)
    layer, ovf = vlayer.allocate_blocks(
        layer, ijk, torch.ones(len(blocks), dtype=torch.bool, device=dev))
    assert not _runtime.host_bool(ovf)
    rows = vlayer.lookup_blocks(layer, ijk).long()
    lin = torch.arange(vps ** 3, device=dev)
    local = torch.stack([lin % vps, (lin // vps) % vps, lin // vps ** 2], -1)
    centres = ((ijk[:, None, :] * vps + local).to(torch.float32) + 0.5) * voxel
    d, _ = sw.distance_to_point(objs, centres.reshape(-1, 3), max_dist)
    inside = ((centres >= torch.tensor(lo, device=dev))
              & (centres <= torch.tensor(hi, device=dev))).all(-1)
    layer.channels["tsdf"][rows] = torch.clamp(d, min=-max_dist).view(
        len(blocks), -1)
    layer.channels["weight"][rows] = inside.to(torch.float32)
    return layer


def icp_margins(dev, scan_res):
    """tests/test_icp.py's case: its scene (cube, sphere, ground) as a
    ground-truth TSDF (0.08 m, vps 8, 0.5 m band), a scan of ``res`` from
    its pose, the pose given 2 deg of yaw and (5, -4, 3) cm off, run_icp
    with its configuration. Returns the errors before and after."""
    from voxblox_tpu_torch.ops import icp as icp_ops
    from voxblox_tpu_torch.utils import lie

    w = sw.SimulationWorld()
    w.add_cube((0.0, 0.0, 1.0), (1.5, 2.5, 2.0))
    w.add_sphere((2.0, -1.0, 1.0), 0.8)
    w.add_ground_level(0.0)
    objs = w.freeze(dev)
    layer = gt_tsdf_layer(objs, 0.08, (-4.0, -4.0, -0.4), (4.0, 4.0, 3.5),
                          0.5, 8, dev)
    R = torch.tensor([[0.0, 0.0, 1.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0]],
                     device=dev)
    t = torch.tensor([-3.0, 0.5, 1.0], device=dev)
    pts_G, _, valid = sw.pointcloud_from_transform(
        objs, (R, t), scan_res, np.deg2rad(70.0), 8.0)
    pts = sw.world_points_to_sensor((R, t), pts_G, valid)
    R_bad = _yaw(2.0).to(dev) @ R
    t_bad = t + torch.tensor([0.05, -0.04, 0.03], device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = icp_ops.run_icp(layer, pts, (R_bad, t_bad), ICP_CONFIG)
    torch.cuda.synchronize()
    e = dict(points=int(pts.shape[0]), s=time.perf_counter() - t0,
             num_updates=_runtime.host_int(res.num_updates),
             t_before=float((t_bad - t).norm()),
             t_after=float((res.t - t).norm()),
             r_before=float(lie.so3_log(R_bad @ R.T).norm()),
             r_after=float(lie.so3_log(res.R @ R.T).norm()))
    log(f"icp margins {scan_res}: " + json.dumps(e))
    return e


def check_icp_margins(e, translation=True):
    """tests/test_icp.py:66-75: the error cut to 0.6 (translation) and 0.7
    (rotation) of what it was, and below 4.5 cm and 0.75 deg."""
    assert e["r_after"] < 0.7 * e["r_before"], e
    assert e["r_after"] < np.deg2rad(0.75), e
    if translation:
        assert e["t_after"] < 0.6 * e["t_before"], e
        assert e["t_after"] < 0.045, e


def _quat(R):
    """Rotation matrix -> [x, y, z, w] (Shepperd's method)."""
    m = np.asarray(R, np.float64)
    tr = np.trace(m)
    if tr > 0:
        s = 2.0 * np.sqrt(tr + 1.0)
        return np.array([(m[2, 1] - m[1, 2]) / s, (m[0, 2] - m[2, 0]) / s,
                         (m[1, 0] - m[0, 1]) / s, 0.25 * s])
    i = int(np.argmax(np.diag(m)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = 2.0 * np.sqrt(1.0 + m[i, i] - m[j, j] - m[k, k])
    q = np.zeros(4)
    q[i] = 0.25 * s
    q[j] = (m[j, i] + m[i, j]) / s
    q[k] = (m[k, i] + m[i, k]) / s
    q[3] = (m[k, j] - m[j, k]) / s
    return q


CLOUD_TOPIC = "/camera/depth_registered/points"
POSE_TOPIC = "/kinect/vrpn_client/estimated_transform"
# tests/test_rosbag.py's replay of the committed fixture (the fixture's
# scans are 48x36 at a 60 deg field of view, 5 poses).
FIXTURE = os.path.join("tests", "data", "cow_fixture.bag")
FIXTURE_RES = (24, 18)


def replay_phase(scans, dev, tmp):
    """The cow-and-lady path: the orbit's 32 scans written as a ROS bag of
    640x480 PointCloud2 clouds (xyz + rgb) and TransformStamped poses,
    replayed by ``cli replay`` (5 cm, 5 m rays, fast, with the ESDF) into
    a map file and a mesh; the map against the analytic scene. Then the
    committed fixture replayed as tests/test_rosbag.py does, the card's
    map against the port's on the CPU."""
    from voxblox_tpu_torch.io import layer_io, ply, rosbag
    from voxblox_tpu_torch.server import cli
    from voxblox_tpu_torch.utils import timing

    msgs = []
    for i, (R, t, pts, cols) in enumerate(scans):
        stamp = 100.0 + 0.1 * i
        msgs.append((CLOUD_TOPIC, "sensor_msgs/PointCloud2", stamp,
                     rosbag.encode_pointcloud2(
                         _runtime.to_host(pts.reshape(-1, 3)),
                         _runtime.to_host(cols.reshape(-1, 3)),
                         stamp_sec=stamp, frame_id="camera",
                         height=RES[1])))
        msgs.append((POSE_TOPIC, "geometry_msgs/TransformStamped", stamp,
                     rosbag.encode_transform_stamped(
                         stamp, "world", "kinect", _runtime.to_host(t),
                         _quat(_runtime.to_host(R)))))
    bag = os.path.join(tmp, "orbit.bag")
    rosbag.write_bag(bag, msgs)
    del msgs
    out_map = os.path.join(tmp, "orbit.vxblx")
    out_mesh = os.path.join(tmp, "orbit.ply")
    timing.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    assert cli.main(["replay", bag, "--voxel-size", str(VOXEL),
                     "--max-ray-length", "5", "--max-blocks", str(MAX_BLOCKS),
                     "--method", "fast", "--esdf",
                     "--output-map", out_map, "--output-mesh", out_mesh,
                     "--device", str(dev)]) == 0
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    stages = {k: v["total_s"] for k, v in timing.as_dict().items()}
    layer = layer_io.load_layer(out_map, "tsdf", max_blocks=MAX_BLOCKS,
                                device=dev)
    esdf = layer_io.load_layer(out_map, "esdf", max_blocks=MAX_BLOCKS,
                               device=dev)
    trunc = 4 * VOXEL
    acc = analytic_errors(layer, orbit_objects(dev), trunc)
    res = dict(scans=len(scans), ms_per_scan=wall / len(scans) * 1e3,
               stage_host_s=stages, bag_mb=os.path.getsize(bag) / 1e6,
               map_mb=os.path.getsize(out_map) / 1e6,
               mesh_vertices=len(ply.read_ply(out_mesh)["vertices"]),
               blocks=_runtime.host_int(layer.num_blocks),
               esdf_blocks=_runtime.host_int(esdf.num_blocks), **acc)
    check_analytic(acc, trunc, res)
    os.remove(bag)

    # The committed fixture, on the card and on the CPU.
    out = []
    for device in (dev, torch.device("cpu")):
        srv = TsdfServer(
            MapConfig(voxel_size=0.1, max_blocks=1024),
            integrator_config=TsdfIntegratorConfig(
                default_truncation_distance=0.4, max_ray_length_m=8.0),
            method="projective", projective_resolution=FIXTURE_RES,
            projective_fov_deg=60.0, device=device)
        stats = rosbag.run_rosbag(srv, FIXTURE, pointcloud_topic=CLOUD_TOPIC,
                                  pose_topic=POSE_TOPIC)
        assert stats["integrated"] == 5, stats
        out.append(vlayer.layer_to_numpy(srv.layer))
    a, b = out
    for k in ("num_blocks", "block_ijk", "block_flags"):
        assert np.array_equal(a[k], b[k]), k
    wa, wb = a["channel/weight"], b["channel/weight"]
    observed = int((wb > 0).sum())
    off = int(((np.abs(wa - wb) > 1e-5 + 1e-5 * wb)
               | (np.abs(a["channel/tsdf"] - b["channel/tsdf"])
                  > 1e-5)).sum())
    res["fixture_card_vs_cpu"] = dict(blocks=int(a["num_blocks"]),
                                      observed_voxels=observed,
                                      voxels_off_by_more_than_1e5=off)
    log("replay: " + json.dumps(res))
    assert observed > 2000 and off <= 2e-3 * observed, res
    return res

# ---------------------------------------------------------------------------
# Phases 18-21: render, sim-bench, intensity, layer transforms
# ---------------------------------------------------------------------------

RENDER_RAYS = 65536
RENDER_MAX_DIST = 8.0
SIM_VIEWPOINTS = 20  # cli sim-bench's default
SIM_EXTRA: list = []  # further sim-bench arguments (none: its defaults)
SIM_CPU_VIEWPOINTS = 3


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _median_rays_per_s(call, n_rays, dev):
    """bench.py's timing: 3 groups of 4 calls, the origin varied per call,
    one sync a group; the median group."""
    times = []
    for g in range(3):
        _sync(dev)
        t0 = time.perf_counter()
        for i in range(4):
            call(np.float32(1e-4 * (4 * g + i + 1)))
        _sync(dev)
        times.append(time.perf_counter() - t0)
    return 4 * n_rays / statistics.median(times), times


def _call_profile(dev, call, name):
    """Kernel launches, stream syncs and device busy time of one call."""
    if dev.type != "cuda":
        return {}
    prof = profile_window(None, lambda i: call(np.float32(0.0)),
                          f"chiprun_out/{name}_trace.json", n=1, stack=False,
                          keep=False)
    return {k: prof[k] for k in ("kernel_launches_per_scan",
                                 "stream_syncs_per_scan",
                                 "device_busy_ms_per_scan",
                                 "traced_span_ms_per_scan")}


def _render_rays(dev):
    """bench.py _bench_render's rays (:523-529): 65,536 in the xy plane
    from (0, -4, 2), +-0.4 rad about +y."""
    ang = np.linspace(-0.4, 0.4, RENDER_RAYS).astype(np.float32)
    dirs = torch.as_tensor(np.stack([np.sin(ang), np.cos(ang),
                                     np.zeros_like(ang)], -1), device=dev)
    origins = torch.tensor([0.0, -4.0, 2.0], device=dev).expand(dirs.shape)
    return origins, dirs, ang


def _with_channels(layer, **channels):
    import dataclasses
    return dataclasses.replace(layer,
                               channels={**layer.channels, **channels})


def _share_close(a, b, atol):
    return float(((a - b).abs() <= atol).float().mean())


def render_phase(layer, stress_layer, scans, intr, dev):
    """bench.py's render section (:519-587) on the tsdf-batch map: forward
    and loss + gradient rays/s, launches and syncs per call; checks
    against a CPU copy, the general path, the analytic scene, finite
    differences and the colour path; then a 640x480 depth image of the
    2 cm stress map."""
    from voxblox_tpu_torch.ops import render

    origins, dirs, ang = _render_rays(dev)
    dim = render.fit_dense_grid_dim(layer)
    res = dict(rays=RENDER_RAYS, dense_grid_dim=dim,
               blocks=_runtime.host_int(layer.num_blocks))

    def forward(layer_, o_shift=np.float32(0.0), **kw):
        return render.render_depth(layer_, origins + o_shift, dirs,
                                   RENDER_MAX_DIST, dense_grid_dim=dim, **kw)

    syncs0 = _runtime.SYNCS
    depth, hit = forward(layer)
    _sync(dev)
    res["forward_march"] = dict(render.LAST_MARCH)
    res["forward_host_syncs_per_call"] = _runtime.SYNCS - syncs0
    assert res["forward_march"]["packed"], res["forward_march"]
    res["forward_rays_per_s"], res["forward_group_s"] = _median_rays_per_s(
        lambda s: forward(layer, s), RENDER_RAYS, dev)
    res["forward_profile"] = _call_profile(dev, lambda s: forward(layer, s),
                                           "render_forward")
    target = depth.detach()
    base = layer.channels["tsdf"]

    def loss_grad(o_shift=np.float32(0.0), tgt=target, dtype=torch.float32):
        tsdf = base.detach().clone().requires_grad_(True)
        dep, h = forward(_with_channels(layer, tsdf=tsdf), o_shift)
        err = torch.where(h, dep - tgt, 0.0).to(dtype)
        loss = (err * err).sum()
        loss.backward()
        return loss.detach(), tsdf.grad

    syncs0 = _runtime.SYNCS
    loss_grad()
    _sync(dev)
    res["backward_host_syncs_per_call"] = _runtime.SYNCS - syncs0
    res["backward_rays_per_s"], res["backward_group_s"] = _median_rays_per_s(
        loss_grad, RENDER_RAYS, dev)
    res["backward_profile"] = _call_profile(dev, loss_grad, "render_backward")
    log(f"render: {res['forward_rays_per_s'] / 1e6:.2f} M rays/s forward, "
        f"{res['backward_rays_per_s'] / 1e6:.2f} M rays/s loss + grad (grid "
        f"{dim}, march {res['forward_march']})")

    # The analytic scene: the cylinder (r 2 m about z) from (0, -4, 2).
    c = np.cos(ang.astype(np.float64))
    t_true = torch.as_tensor(4 * c - np.sqrt(16 * c * c - 12), device=dev)
    hit_share = float(hit.float().mean())
    err = (depth.double() - t_true).abs()[hit]
    res["analytic"] = dict(hit_share=hit_share,
                           within_0_04_share=float((err < 0.04).double()
                                                   .mean()),
                           max_err=float(err.max()))
    # tests/test_render.py:108 holds 0.04 m on a GT sphere; a map built
    # from scans: 95% of rays within it, all within 4 voxels.
    assert hit_share > 0.99, res["analytic"]
    assert res["analytic"]["within_0_04_share"] > 0.95, res["analytic"]
    assert res["analytic"]["max_err"] < 4 * layer.voxel_size, res["analytic"]

    # The general (two-gather) path at full width: against the packed one
    # (the same hits; on a map built from scans the two stop points differ
    # by more than on tests/test_render.py:293's GT sphere, in the JAX
    # package too), and both paths against the port on a CPU copy of the
    # layer; then the gradient against the CPU copy's (the card's sums run
    # in atomics order).
    cpu = torch.device("cpu")
    layer_c = vlayer.layer_from_numpy(vlayer.layer_to_numpy(layer), cpu)
    d_g, h_g = render.render_depth(layer, origins, dirs, RENDER_MAX_DIST,
                                   dense_grid_dim=64)
    g_march = dict(render.LAST_MARCH)
    assert not g_march["packed"]
    diff = (d_g - depth).abs()
    res["general_vs_packed"] = dict(
        same_hit_share=float((h_g == hit).float().mean()),
        within_3mm_share=float((diff < 3e-3).float().mean()),
        max_abs=float(diff.max()), march=g_march)
    assert res["general_vs_packed"]["same_hit_share"] == 1.0, res[
        "general_vs_packed"]
    share = {}
    for name, (d_k, h_k, gdim) in (("packed", (depth, hit, dim)),
                                   ("general", (d_g, h_g, 64))):
        d_c, h_c = render.render_depth(layer_c, origins.cpu(), dirs.cpu(),
                                       RENDER_MAX_DIST, dense_grid_dim=gdim)
        ok = (h_c == h_k.cpu()) & ((d_c - d_k.cpu()).abs() <= 1e-4)
        share[name] = float(ok.float().mean())
    # A target 1 cm short of the surface gives every hit a gradient.
    tgt = target - 0.01
    l_d, g_d = loss_grad(tgt=tgt, dtype=torch.float64)
    tsdf_c = layer_c.channels["tsdf"].clone().requires_grad_(True)
    dep_c, hh_c = render.render_depth(_with_channels(layer_c, tsdf=tsdf_c),
                                      origins.cpu(), dirs.cpu(),
                                      RENDER_MAX_DIST, dense_grid_dim=dim)
    e_c = torch.where(hh_c, dep_c - tgt.cpu(), 0.0).double()
    (e_c * e_c).sum().backward()
    g_c = tsdf_c.grad
    g_dc = g_d.cpu()
    nz = (g_c.abs() > 1e-6) | (g_dc.abs() > 1e-6)
    g_ok = ((g_dc - g_c).abs() <= 1e-4 + 1e-3 * g_c.abs())[nz]
    res["card_vs_cpu"] = dict(
        depth_hit_share_within_1e4=share,
        grad_voxels=int(nz.sum()),
        grad_share_within_1e4_1e3=float(g_ok.float().mean()),
        grad_max_abs_diff=float((g_dc - g_c).abs().max()),
        loss_card=float(l_d), loss_cpu=float((e_c * e_c).sum().detach()))
    log("render card vs cpu: " + json.dumps(res["card_vs_cpu"]))
    assert min(share.values()) >= 0.99, share
    assert res["card_vs_cpu"]["grad_share_within_1e4_1e3"] >= 0.99
    assert int(nz.sum()) > 100, int(nz.sum())

    # Central differences on the card (tests/test_render.py:326-350: the
    # sum of hit depths, the packed path, bar 0.1) over every 1024th ray,
    # at the 6 voxels of the largest gradients.
    o_fd, d_fd = origins[::1024], dirs[::1024]

    def depth_sum(tsdf):
        dep, h = render.render_depth(_with_channels(layer, tsdf=tsdf), o_fd,
                                     d_fd, RENDER_MAX_DIST,
                                     dense_grid_dim=dim)
        return torch.where(h, dep, 0.0).double().sum()

    tsdf = base.detach().clone().requires_grad_(True)
    depth_sum(tsdf).backward()
    flat = tsdf.grad.reshape(-1)
    fd_rows = []
    eps = 1e-3
    with torch.no_grad():
        for i in torch.topk(flat.abs(), 6).indices.tolist():
            vals = []
            for step in (eps, -eps):
                t2 = base.clone()
                t2.view(-1)[i] += step
                vals.append(float(depth_sum(t2)))
            fd = (vals[0] - vals[1]) / (2 * eps)
            fd_rows.append(dict(voxel=i, fd=fd, grad=float(flat[i])))
    res["finite_differences"] = fd_rows
    bad = [r for r in fd_rows
           if abs(r["fd"] - r["grad"]) >= 0.1 * max(1.0, abs(r["fd"]))]
    # A perturbed voxel can also move a gradient-stopped pull (the
    # implicit gradient leaves that out by design): 4 of the 6 must agree.
    assert len(bad) <= 2 and abs(fd_rows[0]["grad"]) > 0.1, fd_rows

    # Colour, forward and backward: the cylinder is green.
    color_ch = layer.channels["color"].detach().clone().requires_grad_(True)
    tsdf = base.detach().clone().requires_grad_(True)
    dep, rgb, h = forward(_with_channels(layer, tsdf=tsdf, color=color_ch),
                          with_color=True)
    (rgb[:, 1].sum() + dep.sum()).backward()
    green = float(rgb[h][:, 1].mean())
    res["color"] = dict(mean_green_on_hits=green,
                        color_grad_voxels=int((color_ch.grad != 0).sum()),
                        tsdf_grad_finite=bool(torch.isfinite(
                            tsdf.grad).all()))
    assert green > 200 and res["color"]["color_grad_voxels"] > 100, \
        res["color"]
    assert res["color"]["tsdf_grad_finite"]

    # render_depth_image of the 2 cm stress map at 640x480 from pose 0.
    R, t = scans[0][0], scans[0][1]
    img = {}
    for label, kw in (("auto", {}), ("general", dict(dense_grid_dim=64))):
        _sync(dev)
        t0 = time.perf_counter()
        d_img, h_img = render.render_depth_image(
            stress_layer, (R, t), intr, RES, RENDER_MAX_DIST, **kw)
        _sync(dev)
        ms = (time.perf_counter() - t0) * 1e3
        rng = scans[0][2].norm(dim=-1)
        both = h_img & (rng > 0)
        err = (d_img - rng)[both].abs()
        img[label] = dict(ms=ms, march=dict(render.LAST_MARCH),
                          hit_share=float(h_img.float().mean()),
                          within_2cm_of_scan=float((err < 0.02).float()
                                                   .mean()))
        assert img[label]["within_2cm_of_scan"] > 0.95, img[label]
        if not img[label]["march"]["packed"]:
            break  # the auto-fitted grid already took the general path
    img["dense_grid_dim"] = render.fit_dense_grid_dim(stress_layer)
    res["stress_image_640x480"] = img
    log("render: " + json.dumps(res))
    return res


def _parse_sim_bench(text):
    """The rows ``cli sim-bench`` prints."""
    import ast
    import re

    rows = {}
    for line in text.splitlines():
        key, _, rest = line.partition(": ")
        if key in ("TSDF", "ESDF", "ESDF-OCC"):
            m = re.search(r"rmse=([0-9.e+-]+) max=([0-9.e+-]+) "
                          r"evaluated=(\d+)", rest)
            rows[key] = dict(rmse=float(m.group(1)),
                             max_error=float(m.group(2)),
                             evaluated=int(m.group(3)))
        elif key == "OCC":
            rows[key] = ast.literal_eval(rest)
    return rows


def sim_bench_phase(dev):
    """``cli sim-bench --device cuda`` in process at the command's
    defaults, plain and with --occupancy (tests/test_server.py's bounds);
    3 viewpoints against a CPU copy; the occupancy ESDF through K1
    against the plain relaxation, and K1 timed at that path's shape."""
    import contextlib
    import io

    from voxblox_tpu_torch.ops import occupancy as occupancy_ops
    from voxblox_tpu_torch.server import cli, mapper
    from voxblox_tpu_torch.utils import timing

    kept = {}

    class _Keep(mapper.SimulationServer):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            kept["srv"] = self

    res = {}
    orig = mapper.SimulationServer
    mapper.SimulationServer = _Keep
    try:
        for name, extra in (("plain", []), ("occupancy", ["--occupancy"])):
            timing.reset()
            buf = io.StringIO()
            syncs0 = _runtime.SYNCS
            _sync(dev)
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                assert cli.main(["sim-bench", "--device", dev.type,
                                 "--viewpoints", str(SIM_VIEWPOINTS)]
                                + SIM_EXTRA + extra) == 0
            _sync(dev)
            wall = time.perf_counter() - t0
            rows = _parse_sim_bench(buf.getvalue())
            stages = {k: v["total_s"] / SIM_VIEWPOINTS
                      for k, v in timing.as_dict().items()}
            res[name] = dict(s_per_viewpoint=wall / SIM_VIEWPOINTS,
                             wall_s=wall, rows=rows,
                             stage_s_per_viewpoint=stages,
                             host_syncs_per_viewpoint=(
                                 _runtime.SYNCS - syncs0) / SIM_VIEWPOINTS,
                             blocks=_runtime.host_int(
                                 kept["srv"].tsdf_layer.num_blocks))
            log(f"sim-bench {name}: " + json.dumps(res[name]))
            voxel = kept["srv"].voxel_size
            assert rows["TSDF"]["rmse"] < 2 * voxel, rows
            assert rows["ESDF"]["rmse"] < 2 * voxel, rows
            assert rows["TSDF"]["evaluated"] > MIN_OBSERVED, rows
            if extra:
                assert rows["OCC"]["misclassified_frac"] < 0.15, rows
                assert rows["ESDF-OCC"]["rmse"] < 4 * voxel, rows
    finally:
        mapper.SimulationServer = orig
    srv = kept["srv"]

    # The occupancy ESDF through K1 against the plain relaxation.
    import dataclasses
    cfg = dataclasses.replace(srv.esdf_cfg, use_pallas_kernel=True)
    out = {}
    for impl in ("kernel", "plain"):
        esdf = vlayer.make_layer("esdf", srv.voxel_size, vps=16,
                                 max_blocks=srv.tsdf_layer.max_blocks,
                                 device=dev)
        reset_counts()
        _sync(dev)
        t0 = time.perf_counter()
        esdf, ovf, iters = occupancy_ops.esdf_from_occupancy_batch(
            esdf, srv.occ_layer, cfg, relax_impl=impl)
        _sync(dev)
        out[impl] = (esdf, time.perf_counter() - t0, int(iters),
                     esdf_relax.LAUNCHES)
        assert not _runtime.host_bool(ovf)
    (ek, k_s, k_it, k_launch), (ep, p_s, p_it, p_launch) = (
        out["kernel"], out["plain"])
    # The kernel launches on the card only (on the CPU its plain version
    # runs, uncounted).
    assert (k_launch > 0) == (dev.type == "cuda") and p_launch == 0, (
        k_launch, p_launch)
    assert torch.equal(ek.channels["esdf_flags"], ep.channels["esdf_flags"])
    obs = (ek.channels["esdf_flags"] & 1) != 0
    err = float((ek.channels["esdf"] - ep.channels["esdf"])[obs].abs().max())
    assert err == 0.0 and k_it == p_it, (err, k_it, p_it)
    res["occupancy_esdf_kernel"] = dict(
        launches=k_launch, outer_iters=k_it, kernel_s=k_s, plain_s=p_s,
        max_abs_err=err, observed_voxels=int(obs.sum()),
        n_blocks=srv.tsdf_layer.max_blocks)
    log("occupancy ESDF, kernel vs plain: "
        + json.dumps(res["occupancy_esdf_kernel"]))

    # The first viewpoints on the card and on a CPU copy: the TSDF and
    # occupancy layers. Both integrate the card's rendered scans (each
    # device's own sim differs by an ulp here and there, which on the
    # ground plane, z = 0 on a voxel border, moves merged bundles between
    # voxels); the ESDF is the card's plain sweep, checked in phase 13's
    # manner by the kernel comparison above.
    from voxblox_tpu_torch.sim import world as sim_world

    render_scan = sim_world.pointcloud_from_transform
    scans_seen = []

    def record(*a, **kw):
        out = render_scan(*a, **kw)
        scans_seen.append(out)
        return out

    def replay(*a, **kw):
        return tuple(x.cpu() for x in scans_seen.pop(0))

    layers = {}
    try:
        for device, shim in ((dev, record), (torch.device("cpu"), replay)):
            sim_world.pointcloud_from_transform = shim
            s = mapper.SimulationServer(
                srv.world, voxel_size=srv.voxel_size, method=srv.method,
                camera_res=srv.camera_res,
                max_blocks=srv.tsdf_layer.max_blocks, incremental_esdf=False,
                generate_occupancy=True, device=device)
            poses = s.generate_poses(SIM_CPU_VIEWPOINTS, seed=0)
            for pose in poses:
                s.integrate_viewpoint(pose)
            layers[device.type] = (
                vlayer.layer_to_numpy(s.tsdf_layer),
                vlayer.layer_to_numpy(s.occ_layer),
                [(_runtime.to_host(R), _runtime.to_host(t))
                 for R, t in poses])
    finally:
        sim_world.pointcloud_from_transform = render_scan
    a, b = layers[dev.type], layers["cpu"]
    for (Ra, ta), (Rb, tb) in zip(a[2], b[2]):
        assert np.array_equal(Ra, Rb) and np.array_equal(ta, tb)
    cmp = {}
    for i, (name, chans) in enumerate((("tsdf", ("tsdf", "weight")),
                                       ("occupancy", ("log_odds",)))):
        x, y = a[i], b[i]
        for k in ("num_blocks", "block_ijk", "block_flags"):
            assert np.array_equal(x[k], y[k]), (name, k)
        off = np.zeros(x[f"channel/{chans[0]}"].shape, bool)
        for c in chans:  # phase 13's bar: 1e-5, relative for weights
            ref = y[f"channel/{c}"]
            tol = 1e-5 + (1e-5 * np.abs(ref) if c == "weight" else 0.0)
            off |= np.abs(x[f"channel/{c}"] - ref) > tol
        obs_key = "channel/weight" if name == "tsdf" else "channel/occ_observed"
        observed = int((y[obs_key] > 0).sum())
        cmp[name] = dict(observed_voxels=observed,
                         voxels_off_by_more_than_1e5=int(off.sum()))
        assert observed > MIN_OBSERVED // 10 and off.sum() <= 2e-3 * observed, \
            (name, cmp[name])
    res["card_vs_cpu_3_viewpoints"] = cmp
    log("sim-bench card vs cpu: " + json.dumps(cmp))
    return res


def intensity_phase(tsdf_layer, scans, intr, dev):
    """IntensityServer over the phase-3 TSDF: a synthetic 640x480 image
    from orbit pose 0 at subsample 4 and 30 m; ms and host syncs a call;
    the first call against a CPU copy."""
    from voxblox_tpu_torch.server.mapper import IntensityServer

    w, h = RES
    vv, uu = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    image = (30.0 + 8.0 * np.sin(uu / 37.0) * np.cos(vv / 23.0)).astype(
        np.float32)
    pose = (scans[0][0], scans[0][1])
    mc = MapConfig(voxel_size=VOXEL, max_blocks=MAX_BLOCKS)

    def server(device, layer):
        s = IntensityServer(map_config=mc, device=device)
        s.layer = layer
        return s

    srv = server(dev, tsdf_layer)
    syncs0 = _runtime.SYNCS
    hits = srv.insert_intensity_image(pose, image, intr, subsample=4)
    first = vlayer.layer_to_numpy(srv.intensity_layer)
    syncs = _runtime.SYNCS - syncs0
    cpu = torch.device("cpu")
    ref = server(cpu, vlayer.layer_from_numpy(vlayer.layer_to_numpy(
        tsdf_layer), cpu))
    ref_hits = ref.insert_intensity_image(
        tuple(x.cpu() for x in pose), image, intr, subsample=4)
    got, exp = first, vlayer.layer_to_numpy(ref.intensity_layer)
    for k in ("num_blocks", "block_ijk", "block_flags"):
        assert np.array_equal(got[k], exp[k]), k
    gi, ei = got["channel/intensity"], exp["channel/intensity"]
    gw, ew = got["channel/intensity_weight"], exp["channel/intensity_weight"]
    off = (np.abs(gi - ei) > 1e-4) | (gw != ew)
    observed = int((ew > 0).sum())
    times = []
    for i in range(4):
        _sync(dev)
        t0 = time.perf_counter()
        srv.insert_intensity_image(pose, image, intr, subsample=4)
        _sync(dev)
        times.append((time.perf_counter() - t0) * 1e3)
    res = dict(rays=len(range(0, w, 4)) * len(range(0, h, 4)), hits=hits,
               cpu_hits=ref_hits, host_syncs_per_call=syncs,
               ms_per_call=statistics.median(times), times_ms=times,
               observed_voxels=observed, voxels_off_cpu=int(off.sum()))
    log("intensity: " + json.dumps(res))
    assert hits == ref_hits and hits > res["rays"] // 2, res
    assert observed > 1000 and off.sum() <= 2e-3 * observed, res
    return res


def _yaw_pose(deg, shift, dev):
    a = np.deg2rad(deg)
    R = np.array([[np.cos(a), -np.sin(a), 0.0], [np.sin(a), np.cos(a), 0.0],
                  [0.0, 0.0, 1.0]], np.float32)
    return (torch.as_tensor(R, device=dev),
            torch.as_tensor(np.asarray(shift, np.float32), device=dev))


def transform_phase(tsdf_layer, dev):
    """transform_layer of the phase-3 TSDF by a 10 degree yaw and a 0.1 m
    shift, then back; merge_layers and evaluate_layer_rmse_at_poses; ms of
    each; the forward transform against a CPU copy."""
    from voxblox_tpu_torch.ops import transform
    from voxblox_tpu_torch.utils import evaluation

    T = _yaw_pose(10.0, (0.1, 0.0, 0.0), dev)
    R_inv = T[0].T
    T_inv = (R_inv, -(R_inv @ T[1]))
    ms = {}

    def timed(name, fn):
        _sync(dev)
        t0 = time.perf_counter()
        out = fn()
        _sync(dev)
        ms[name] = (time.perf_counter() - t0) * 1e3
        return out

    moved, ovf = timed("transform", lambda: transform.transform_layer(
        tsdf_layer, T))
    back, ovf2 = timed("transform_back", lambda: transform.transform_layer(
        moved, T_inv))
    assert not any(_runtime.host_bools([ovf, ovf2]))
    merged, _ = timed("merge", lambda: transform.merge_layers(
        vlayer.clone_layer(tsdf_layer), back))
    details = timed("rmse_at_poses", lambda: (
        evaluation.evaluate_layer_rmse_at_poses(
            tsdf_layer, moved, [T_inv, _yaw_pose(0.0, (0, 0, 0), dev)])))
    round_trip = evaluation.evaluate_layers_rmse(tsdf_layer, back)
    res = dict(ms=ms, blocks_moved=_runtime.host_int(moved.num_blocks),
               blocks_merged=_runtime.host_int(merged.num_blocks),
               round_trip_rmse=round_trip.rmse,
               round_trip_evaluated=round_trip.num_evaluated_voxels,
               rmse_at_inverse=details[0].rmse,
               rmse_at_identity=details[1].rmse)
    assert res["round_trip_evaluated"] > MIN_OBSERVED, res
    assert res["round_trip_rmse"] < VOXEL, res
    assert res["rmse_at_inverse"] < res["rmse_at_identity"], res
    cpu = torch.device("cpu")
    moved_c, _ = transform.transform_layer(
        vlayer.layer_from_numpy(vlayer.layer_to_numpy(tsdf_layer), cpu),
        tuple(x.cpu() for x in T))
    a, b = vlayer.layer_to_numpy(moved), vlayer.layer_to_numpy(moved_c)
    for k in ("num_blocks", "block_ijk", "block_flags"):
        assert np.array_equal(a[k], b[k]), k
    res["card_vs_cpu_max_abs"] = {
        c: float(np.abs(a[f"channel/{c}"] - b[f"channel/{c}"]).max())
        for c in ("tsdf", "weight", "color")}
    log("transform: " + json.dumps(res))
    assert res["card_vs_cpu_max_abs"]["tsdf"] <= 1e-5, res
    assert res["card_vs_cpu_max_abs"]["weight"] <= 1e-5, res
    assert res["card_vs_cpu_max_abs"]["color"] <= 1e-3, res
    return res



# ---------------------------------------------------------------------------
# Phase 22: multi-GPU sharding (voxblox_tpu_torch/parallel/sharding.py)
# ---------------------------------------------------------------------------

# The online map's sweep: batch_phase's configuration (bench.py:269-274).
SHARD_ESDF = dict(max_distance_m=2.0, default_distance_m=2.0,
                  min_distance_m=2 * VOXEL, max_active_blocks=1024,
                  use_pallas_kernel=True, inner_sweeps=4)
SHARD_TARGET_M = 2.5  # render target depth (tests/test_parallel.py's)
SHARD_WORLD = 2  # ranks of the gloo run on the one card
SHARD_MIN_VOXELS = 20_000  # observed voxels one 640x480 scan must give


def shard_sweep_cfgs(stress_cfg=None):
    cfgs = {"online_unit": EsdfIntegratorConfig(**SHARD_ESDF),
            "online_strided": EsdfIntegratorConfig(**SHARD_ESDF,
                                                   sweep_strides=STRIDES)}
    if stress_cfg is not None:
        cfgs["stress_unit"] = stress_cfg
    return cfgs


def _shard_tsdf_cfg():
    return TsdfIntegratorConfig(default_truncation_distance=4 * VOXEL,
                                max_ray_length_m=5.0)


def _shard_batch_args(scans, intr):
    return ([torch.stack([s[i] for s in scans]) for i in range(4)]
            + [_shard_tsdf_cfg()]), dict(
        kind="pinhole_organized", intrinsics=intr, pool=RES[0] // VIRT[0],
        max_visible_blocks=192, max_mixed_slabs=1920, max_free_slabs=256)


def _shard_render_args(dev):
    origins, dirs, _ = _render_rays(dev)
    return origins, dirs, torch.full((RENDER_RAYS,), SHARD_TARGET_M,
                                     device=dev)


def _fresh_tsdf(dev):
    return vlayer.make_layer("tsdf", VOXEL, vps=16, max_blocks=MAX_BLOCKS,
                             device=dev)


def _collective_summary(log_):
    """Per collective op: calls, the distinct byte sizes, and the total
    and largest seconds of one call (CUDA events around each on the
    card, no host sync)."""
    out = {}
    for c in log_:
        o = out.setdefault(c["op"], dict(n=0, bytes_each=[], s_total=0.0,
                                         s_max=0.0))
        o["n"] += 1
        if c["bytes"] not in o["bytes_each"]:
            o["bytes_each"].append(c["bytes"])
        o["s_total"] += c["s"]
        o["s_max"] = max(o["s_max"], c["s"])
    return out


def shard_calls(dev, world, scans, intr, online_tsdf, batch_map,
                stress=None):
    """The sharded calls of phase 22 on this rank: the ray-sharded simple
    integrate of orbit scan 0 (640x480 = 307,200 points), the 32 orbit
    scans scan-sharded, the block-sharded sweeps of the phase-3 map (unit
    and strided; with ``stress`` = (2 cm TSDF, its ESDF config) also the
    2 cm map over its whole pool) and the ray-sharded render loss and
    gradient of 65,536 rays on the tsdf-batch map. Returns (results,
    records): seconds, collectives (count, bytes and seconds each) and K1
    and K2 launches per call."""
    from voxblox_tpu_torch.parallel import sharding

    import torch.distributed as dist

    mesh_rays = sharding.make_mesh(world, rays=world, device_type=dev.type)
    mesh_blocks = sharding.make_mesh(world, rays=1, device_type=dev.type)
    res, rec = {}, {"mesh_rays": list(mesh_rays.shape),
                    "mesh_blocks": list(mesh_blocks.shape)}
    # NCCL sets a group's communicator up at its first collective: do that
    # here, so that the calls' records hold the exchange alone.
    t0 = time.perf_counter()
    for mesh, axis in ((mesh_rays, "rays"), (mesh_blocks, "blocks")):
        dist.all_reduce(torch.zeros(1, device=dev), group=mesh.get_group(axis))
    _sync(dev)
    rec["group_setup_s"] = time.perf_counter() - t0

    def timed(name, fn):
        k1 = esdf_relax.LAUNCHES - esdf_relax.STRIDED_LAUNCHES
        k2 = esdf_relax.STRIDED_LAUNCHES
        sharding.COLLECTIVES = []
        _sync(dev)
        t0 = time.perf_counter()
        try:
            out = fn()
            _sync(dev)
        finally:
            coll, sharding.COLLECTIVES = sharding.COLLECTIVES, None
        rec[name] = dict(
            s=time.perf_counter() - t0,
            collectives=_collective_summary(
                sharding.collective_seconds(coll)),
            k1_launches=esdf_relax.LAUNCHES - esdf_relax.STRIDED_LAUNCHES
            - k1, k2_launches=esdf_relax.STRIDED_LAUNCHES - k2)
        return out

    R, t, pts, cols = scans[0]
    res["integrate"], ovf = timed(
        "integrate", lambda: sharding.integrate_pointcloud_sharded(
            mesh_rays, _fresh_tsdf(dev), (R, t), pts.reshape(-1, 3),
            cols.reshape(-1, 3), _shard_tsdf_cfg()))
    args, kw = _shard_batch_args(scans, intr)
    res["projective_batch"], ovf_b = timed(
        "projective_batch",
        lambda: sharding.integrate_projective_batch_sharded(
            mesh_rays, _fresh_tsdf(dev), *args, **kw))
    rec["overflow"] = _runtime.host_bools([ovf, ovf_b])
    src = {"online_unit": online_tsdf, "online_strided": online_tsdf}
    if stress is not None:
        src["stress_unit"] = stress[0]
    for name, cfg in shard_sweep_cfgs(stress and stress[1]).items():
        e = esdf_ops.seeded_layer(src[name], cfg)
        res[name] = timed(name, lambda: sharding.lower_sweep_sharded(
            mesh_blocks, e, cfg))
        rec[name]["iters"] = res[name][1]
    loss, grad = timed("render", lambda: sharding.render_loss_grad_sharded(
        mesh_rays, batch_map, *_shard_render_args(dev), RENDER_MAX_DIST))
    res["render"] = (float(loss), grad)
    return res, rec


def shard_references(dev, scans, intr, online_tsdf, batch_map, stress):
    """The unsharded results the sharded calls are held to, on the card,
    and the seconds of each call (timed as ``shard_calls`` times its
    sharded twin, without the collectives)."""
    from voxblox_tpu_torch.ops import render

    seconds = {}

    def timed(name, fn):
        _sync(dev)
        t0 = time.perf_counter()
        out = fn()
        _sync(dev)
        seconds[name] = time.perf_counter() - t0
        return out

    R, t, pts, cols = scans[0]
    ref = {}
    ref["integrate"], _, ovf = timed(
        "integrate", lambda: tsdf_ops.integrate_pointcloud(
            _fresh_tsdf(dev), (R, t), pts.reshape(-1, 3),
            cols.reshape(-1, 3), _shard_tsdf_cfg(), method="simple"))
    args, kw = _shard_batch_args(scans, intr)
    kw.pop("kind")
    ref["projective_batch"], ovf_b = timed(
        "projective_batch",
        lambda: projective_ops.integrate_organized_projective_batch(
            _fresh_tsdf(dev), *args, **kw))
    assert not any(_runtime.host_bools([ovf, ovf_b]))
    src = {"online_unit": online_tsdf, "online_strided": online_tsdf,
           "stress_unit": stress[0]}
    for name, cfg in shard_sweep_cfgs(stress[1]).items():
        e = esdf_ops.seeded_layer(src[name], cfg)
        e, it, r_ovf, _ = timed(name, lambda: esdf_ops.lower_sweep(e, cfg))
        assert not _runtime.host_bool(r_ovf), name
        ref[name] = (e, it)
    origins, dirs, target = _shard_render_args(dev)

    def loss_grad():
        tsdf = batch_map.channels["tsdf"].detach().clone().requires_grad_(
            True)
        depth, hit = render.render_depth(
            _with_channels(batch_map, tsdf=tsdf), origins, dirs,
            RENDER_MAX_DIST)
        err = torch.where(hit, depth - target, 0.0)
        loss = (err * err).sum()
        grad, = torch.autograd.grad(loss, tsdf)
        return float(loss.detach()), grad

    ref["render"] = timed("render", loss_grad)
    return ref, seconds


def shard_check(ref, got, what):
    """Hold sharded results to the unsharded ones: the sweeps bit for bit
    (esdf, flags, parents, iterations), the integrates at
    tests/test_parallel.py's bounds (atomics and collective order), the
    render loss within rel 1e-3 and its gradient within rel 1e-4 (of
    max(1, the largest gradient): single voxels sum many rays here)."""
    from voxblox_tpu_torch.utils import evaluation

    out = {}
    a, b = ref["integrate"], got["integrate"]
    assert torch.equal(a.block_ijk, b.block_ijk), what
    det = evaluation.evaluate_layers_rmse(a, b)
    well = a.channels["weight"] > 1e-3
    d = float((a.channels["tsdf"] - b.channels["tsdf"]).abs()[well].max())
    out["integrate"] = dict(rmse=det.rmse, voxels=det.num_evaluated_voxels,
                            max_abs_tsdf_well_observed=d)
    assert det.num_evaluated_voxels > SHARD_MIN_VOXELS and det.rmse < 1e-4, (
        what, det)
    assert d < 1e-4, (what, d)
    a, b = ref["projective_batch"], got["projective_batch"]
    assert torch.equal(a.block_ijk, b.block_ijk), what
    det = evaluation.evaluate_layers_rmse(a, b)
    wd = float((a.channels["weight"] - b.channels["weight"]).abs().max())
    out["projective_batch"] = dict(rmse=det.rmse, max_abs_weight=wd,
                                   voxels=det.num_evaluated_voxels)
    assert det.num_evaluated_voxels > MIN_OBSERVED and det.rmse < 1e-5, (
        what, det)
    assert wd < 1e-3, (what, wd)
    for name in ("online_unit", "online_strided", "stress_unit"):
        if name not in got:  # the 2 cm sweep runs at W=1 only
            continue
        (a, it_a), (b, it_b) = ref[name], got[name]
        for k in ("esdf", "esdf_flags", "parent"):
            assert torch.equal(a.channels[k], b.channels[k]), (what, name, k)
        assert it_a == it_b, (what, name, it_a, it_b)
        obs = int(((b.channels["esdf_flags"] & 1) != 0).sum())
        assert obs > MIN_OBSERVED, (what, name, obs)
        out[name] = dict(bit_equal=True, iters=it_b, observed_voxels=obs)
    (la, ga), (lb, gb) = ref["render"], got["render"]
    gd = float((ga - gb).abs().max())
    out["render"] = dict(loss=lb, ref_loss=la, max_abs_grad=gd,
                         grad_max=float(ga.abs().max()))
    assert la > 0.0 and abs(la - lb) < 1e-3 * max(1.0, abs(la)), (what, la,
                                                                  lb)
    assert gd < 1e-4 * max(1.0, out["render"]["grad_max"]), (what, gd)
    log(f"shard {what}: " + json.dumps(out))
    return out


def _digest(x):
    """A 64-bit checksum of a tensor's bytes, computed on its device."""
    b = x.detach().contiguous().reshape(-1).view(torch.uint8).to(torch.int64)
    w = torch.arange(b.numel(), device=b.device) % 65521 + 1
    return (b * w).sum()


def _shard_rank(rank, world, port, tmp, device_type):
    """One rank of the gloo run on the one card (spawned): the phase-22
    calls at the 5 cm sizes; every rank's results must be the same bits;
    rank 0 writes its results for the parent to check. (``device_type``
    "cpu" only to rehearse the phase on the CPU.)"""
    import pickle

    import torch.distributed as dist

    from voxblox_tpu_torch.parallel import sharding

    backend = sharding.init_multihost(f"localhost:{port}", world, rank,
                                      local_device_count=world,
                                      device_type=device_type)
    assert backend == "gloo", backend
    dev = torch.device(device_type)
    if dev.type == "cuda":
        esdf_relax._lib()  # phase 2's build; no nvcc here
    scans, intr = make_scans(dev)
    with open(os.path.join(tmp, "online_tsdf.pkl"), "rb") as f:
        online = vlayer.layer_from_numpy(pickle.load(f), dev)
    with open(os.path.join(tmp, "batch_map.pkl"), "rb") as f:
        batch_map = vlayer.layer_from_numpy(pickle.load(f), dev)
    reset_counts()
    res, rec = shard_calls(dev, world, scans, intr, online, batch_map)
    tensors = [res["integrate"].channels["tsdf"],
               res["projective_batch"].channels["tsdf"],
               res["online_unit"][0].channels["esdf"],
               res["online_strided"][0].channels["esdf"], res["render"][1]]
    mine = torch.stack([_digest(x) for x in tensors])
    parts = [torch.empty_like(mine) for _ in range(world)]
    dist.all_gather(parts, mine)
    assert all(torch.equal(p, parts[0]) for p in parts), "ranks differ"
    rec["backend"] = backend
    with open(os.path.join(tmp, f"shard_rec_{rank}.json"), "w") as f:
        json.dump(rec, f)
    if rank == 0:
        host = {k: vlayer.layer_to_numpy(res[k])
                for k in ("integrate", "projective_batch")}
        host.update({k: (vlayer.layer_to_numpy(res[k][0]), res[k][1])
                     for k in ("online_unit", "online_strided")})
        host["render"] = (res["render"][0], res["render"][1].cpu())
        with open(os.path.join(tmp, "shard_res.pkl"), "wb") as f:
            pickle.dump(host, f, protocol=4)
    dist.destroy_process_group()


def shard_phase(online_tsdf, batch_map, stress_layer, stress_cfg, scans,
                intr, dev, tmp):
    """Phase 22: parallel/sharding.py on the card. (a) W=1 in this
    process over NCCL at full width, the 2 cm sweep included, each call
    against its unsharded version; K1 and K2 counted on the sharded
    sweeps only (counts zeroed just before, read just after); K1 and K2
    against their plain versions on the sweeps' own first inputs, at W=1's
    rows and at the rows rank 0 of W=2 relaxes. (b) W=2 on the
    one card over gloo, two spawned ranks, the 5 cm calls; this measures
    the exchange, not scaling."""
    import pickle
    import socket

    import torch.distributed as dist
    import torch.multiprocessing as mp

    from voxblox_tpu_torch.parallel import sharding

    def free_port():
        with socket.socket() as s:
            s.bind(("localhost", 0))
            return s.getsockname()[1]

    stress = (stress_layer, stress_cfg)
    ref, ref_s = shard_references(dev, scans, intr, online_tsdf, batch_map,
                                  stress)
    out = {"unsharded_s": ref_s}

    # (a) W=1, NCCL (gloo when rehearsed on the CPU).
    backend = sharding.init_multihost(f"localhost:{free_port()}", 1, 0,
                                      device_type=dev.type)
    # The first relaxation of the sharded online unit sweep (K1) and of
    # the strided one (K2): the kernels are held to their plain versions
    # on these inputs below.
    first = {}
    relax = esdf_relax.relax

    def capturing(*args, **kwargs):
        first.setdefault("k2" if kwargs.get("strides") else "k1",
                         (args, kwargs))
        return relax(*args, **kwargs)

    esdf_relax.relax = capturing
    try:
        reset_counts()
        got, rec = shard_calls(dev, 1, scans, intr, online_tsdf, batch_map,
                               stress)
        launches = dict(
            k1=esdf_relax.LAUNCHES - esdf_relax.STRIDED_LAUNCHES,
            k2=esdf_relax.STRIDED_LAUNCHES)
    finally:
        esdf_relax.relax = relax
        dist.destroy_process_group()
    rec["backend"] = backend
    rec["launches"] = launches
    assert not any(rec["overflow"]), rec["overflow"]
    assert launches["k1"] > 0 and launches["k2"] > 0, launches
    out["w1"] = dict(rec, checks=shard_check(ref, got, "W=1"))
    log("shard W=1: " + json.dumps(out["w1"]))
    del got

    # K1 and K2 at the sharded sweeps' shapes: the whole padded working
    # set at W=1, and the first ceil(n/2) rows of it, which rank 0 of W=2
    # relaxes.
    (d_pad, obs_pad, upd_pad, act, sweeps, voxel, maxd, min_diff), _ = (
        first["k1"])
    assert (sweeps, voxel, maxd, min_diff) == (4, VOXEL, 2.0, MIN_DIFF)
    (d2, obs2, upd2, act2, *_), kw2 = first["k2"]
    assert tuple(kw2["strides"]) == STRIDES, kw2["strides"]
    n = d_pad.shape[0]
    out["kernel_shapes"] = {"k1": [], "k2": []}
    for rows, who in ((n, "W=1"), (-(-n // SHARD_WORLD),
                                   f"W={SHARD_WORLD} rank 0")):
        x1 = tuple(t_[:rows].contiguous()
                   for t_ in (d_pad, obs_pad, upd_pad, act))
        out["kernel_shapes"]["k1"].append(k1_phase(
            rows, dev, voxel, maxd, f"sharded sweep, {who}",
            inputs=[x1] * 7))
        x2 = tuple(t_[:rows].contiguous() for t_ in (d2, obs2, upd2, act2)
                   ) + (tuple(c[:rows].contiguous() for c in kw2["codes"]),)
        out["kernel_shapes"]["k2"].append(k2_phase(
            rows, dev, f"sharded strided sweep, {who}", inputs=[x2] * 7))
    del first

    # (b) W=2 on the one card, gloo.
    for name, layer in (("online_tsdf", online_tsdf),
                        ("batch_map", batch_map)):
        with open(os.path.join(tmp, f"{name}.pkl"), "wb") as f:
            pickle.dump(vlayer.layer_to_numpy(layer), f, protocol=4)
    t0 = time.perf_counter()
    mp.spawn(_shard_rank, args=(SHARD_WORLD, free_port(), tmp, dev.type),
             nprocs=SHARD_WORLD, join=True)
    spawn_s = time.perf_counter() - t0
    with open(os.path.join(tmp, "shard_res.pkl"), "rb") as f:
        host = pickle.load(f)
    got = {k: vlayer.layer_from_numpy(host[k], dev)
           for k in ("integrate", "projective_batch")}
    got.update({k: (vlayer.layer_from_numpy(host[k][0], dev), host[k][1])
                for k in ("online_unit", "online_strided")})
    got["render"] = (host["render"][0], host["render"][1].to(dev))
    recs = []
    for r in range(SHARD_WORLD):
        with open(os.path.join(tmp, f"shard_rec_{r}.json")) as f:
            recs.append(json.load(f))
    assert not any(any(r_["overflow"]) for r_ in recs)
    assert all(r_["online_unit"]["k1_launches"] > 0
               and r_["online_strided"]["k2_launches"] > 0 for r_ in recs)
    out[f"w{SHARD_WORLD}"] = dict(ranks=recs, spawn_s=spawn_s,
                                  checks=shard_check(ref, got,
                                                     f"W={SHARD_WORLD}"))
    log(f"shard W={SHARD_WORLD}: " + json.dumps(out[f"w{SHARD_WORLD}"]))
    return out


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

    # 2. Build (one source file holds K1 and K2: one nvcc run; the walk
    # kernel another).
    t0 = time.perf_counter()
    esdf_relax.build()
    esdf_relax._lib()
    tsdf_walk._lib()
    out["build_s"] = time.perf_counter() - t0
    out["build_ptxas"] = esdf_relax.BUILD_INFO.get("ptxas", "(cached)")
    out["build_ptxas_tsdf_walk"] = tsdf_walk.BUILD_INFO.get("ptxas",
                                                            "(cached)")
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

    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        # 14. Map files of the phase-3 maps, and the command line on them.
        out["io"] = {"online": io_phase(srv, dev, tmp, "online", True)}
        done("io online")
        # 20-21. Intensity and layer transforms on the phase-3 TSDF.
        out["intensity"] = intensity_phase(srv.layer, scans, intr, dev)
        done("intensity")
        out["transform"] = transform_phase(srv.layer, dev)
        done("transform")
        online_tsdf = srv.layer  # phase 22 shards its ESDF sweep
        del srv
        torch.cuda.empty_cache()

        # 10. The 2 cm stress loop, with a mesh update every scan.
        out["stress"], stress_srv = stress_phase(scans, intr, dev,
                                                 args.profile)
        done("stress")
        k1_other.append(out["stress"]["esdf_rebuild"]["k1_on_map_data"])
        out["kernel_other_shapes"] = k1_other

        # 15. Mesh messages, then 14 on the stress map.
        out["mesh_msg"] = mesh_msg_phase(stress_srv, scans)
        done("mesh messages")
        out["io"]["stress"] = io_phase(stress_srv, dev, tmp, "stress", False)
        done("io stress")
        stress_layer = stress_srv.layer
        stress_cfg = stress_srv.esdf_cfg
        del stress_srv
        torch.cuda.empty_cache()

        # 11-13. Batched TSDF, the velodyne street map, ray casting.
        out["tsdf_batch"], batch_layer = tsdf_batch_phase(scans, intr, dev,
                                                          args.profile)
        done("tsdf batch")
        # 22. Multi-GPU sharding on the maps of phases 3, 10 and 11.
        out["shard"] = shard_phase(online_tsdf, batch_layer, stress_layer,
                                   stress_cfg, scans, intr, dev, tmp)
        k1_other += out["shard"]["kernel_shapes"]["k1"]
        done("shard")
        del online_tsdf
        torch.cuda.empty_cache()
        # 18. The renderer on the tsdf-batch map, and a depth image of the
        # stress map.
        out["render"] = render_phase(batch_layer, stress_layer, scans, intr,
                                     dev)
        done("render")
        del batch_layer, stress_layer
        torch.cuda.empty_cache()
        out["velodyne"] = velodyne_phase(dev, args.profile)
        done("velodyne")
        torch.cuda.empty_cache()
        out["raycast"] = raycast_phase(scans, dev, args.profile)
        done("raycast")
        torch.cuda.empty_cache()

        # 16-17. ICP, bag replay through the command line.
        out["icp"] = icp_phase(scans, dev)
        done("icp")
        torch.cuda.empty_cache()
        out["replay"] = replay_phase(scans, dev, tmp)
        done("replay")
        torch.cuda.empty_cache()

        # 19. cli sim-bench, plain and with occupancy; the occupancy ESDF
        # through K1, and K1 at that path's shape.
        out["sim_bench"] = sim_bench_phase(dev)
        done("sim-bench")
        occ_k1 = out["sim_bench"]["occupancy_esdf_kernel"]
        k1_other.append(k1_phase(occ_k1["n_blocks"], dev, 0.1, 2.0,
                                 "occupancy batch"))
        done("kernel K1 at the occupancy shape")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

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
                 stress_loop=out["stress"]["relax_launches"],
                 occupancy_batch=occ_k1["launches"],
                 sharded_sweep=out["shard"]["w1"]["launches"]["k1"]),
             other_shapes=[{k: o[k] for k in shape_keys}
                           for o in k1_other]),
        dict(name="esdf_relax_k2", route="cuda", source=src,
             replaces="voxblox_tpu/ops/pallas/esdf_relax.py:208",
             launches=out["batch"]["strided"]["strided_launches"],
             **{k: k2[k] for k in keys}, library_ms=None,
             ctas_per_sm=ctas["k2"],
             launches_by_path=dict(
                 batch_strided=out["batch"]["strided"]["strided_launches"],
                 sharded_sweep=out["shard"]["w1"]["launches"]["k2"]),
             other_shapes=[{k: o[k] for k in shape_keys}
                           for o in out["shard"]["kernel_shapes"]["k2"]]),
    ]}
    walk = out["raycast"]["merged"]["walk_kernel"]
    line["kernels"].append(dict(
        name="tsdf_walk_kernel", route="cuda",
        source="voxblox_tpu_torch/csrc/tsdf_walk.cu", replaces=None,
        launches=out["raycast"]["merged"]["walk_launches"],
        **{k: walk[k] for k in keys}, library_ms=None,
        launches_by_path=dict(
            raycast_merged=out["raycast"]["merged"]["walk_launches"],
            raycast_simple=out["raycast"]["simple"]["walk_launches"],
            raycast_fast=out["raycast"]["fast"]["walk_launches"]),
        other_shapes=[dict(path="raycast simple", **{
            k: out["raycast"]["simple"]["walk_kernel"][k] for k in keys})]))
    print(json.dumps(line))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
