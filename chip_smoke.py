"""GPU smoke run of the PyTorch/CUDA port: builds the hand-written kernel,
holds it to its plain version, and drives the online mapping step
(organized scan -> projective TSDF -> incremental ESDF) at the full size
of bench.py's online-loop configuration on one CUDA card.

    python3 chip_smoke.py             # the check (one card, ~1-2 min)
    python3 chip_smoke.py --profile   # + a torch.profiler window

Phases (any failure exits non-zero; nothing falls back to the CPU):
  1 device   nvidia-smi name/power limit, refuse without a GPU
  2 build    nvcc the kernel from voxblox_tpu_torch/csrc/
  3 main     warm a 32-pose orbit, then time 12 online steps with the
             kernel counters zeroed just before and read just after
  4 kernel   K1 against its plain version at the main path's working-set
             size (expect bit-equal), timed with CUDA events
  5 replay   the same scans with the plain relaxation (relax_impl="plain"):
             TSDF identical, ESDF equal on observed voxels
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
from voxblox_tpu_torch.core.config import (  # noqa: E402
    EsdfIntegratorConfig, MapConfig, TsdfIntegratorConfig)
from voxblox_tpu_torch.ops import esdf as esdf_ops  # noqa: E402
from voxblox_tpu_torch.ops import esdf_relax  # noqa: E402
from voxblox_tpu_torch.server.mapper import EsdfServer  # noqa: E402
from voxblox_tpu_torch.sim import world as sw  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and f32 non-tensor ops/s.
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12

# bench.py online-loop configuration (bench.py:56-76, :461-487).
RES = (640, 480)
VIRT = (320, 240)
VOXEL = 0.05
FOV_DEG = 60.0
N_POSES = 32
TIMED = 12  # online steps in the timed window


def log(*a):
    print(*a, flush=True)


def _cuda_ms(fn, inputs):
    """Median device time of fn(x) over varied inputs (CUDA events)."""
    times = []
    for x in inputs:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
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
        map_config=MapConfig(voxel_size=VOXEL, max_blocks=4096),
        integrator_config=TsdfIntegratorConfig(
            default_truncation_distance=4 * VOXEL, max_ray_length_m=5.0),
        esdf_config=ecfg, projective_resolution=VIRT,
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


def profile_window(srv, scans, n=4):
    """torch.profiler over ``n`` online steps; per-scan device busy time,
    the busy share of the traced window, kernel time inside the
    projective_integrate / esdf_incremental spans, K1's time, kernel
    launches and stream synchronizations (from the exported trace)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 with_stack=True) as prof:
        for i in range(n):
            s = scans[(16 + i) % len(scans)]
            srv.insert_pointcloud_and_update_esdf(s[:2], *s[2:])
        torch.cuda.synchronize()
    srv.check_overflow()
    os.makedirs("chiprun_out", exist_ok=True)
    path = "chiprun_out/online_trace.json"
    prof.export_chrome_trace(path)
    with open(path) as f:
        ev = json.load(f)["traceEvents"]
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
    k1 = sum(e["dur"] for e in kern if e["name"].startswith("esdf_relax_k1"))
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
        / n)


def random_relax_inputs(n, seed, dev):
    g = torch.Generator(device="cpu").manual_seed(seed)
    d = (torch.rand((n, 18, 18, 18), generator=g) * 5.0 - 2.5)
    obs = torch.rand(d.shape, generator=g) < 0.8
    upd = torch.zeros(d.shape, dtype=torch.bool)
    upd[:, 1:-1, 1:-1, 1:-1] = torch.rand((n, 16, 16, 16), generator=g) < 0.7
    act = torch.rand(n, generator=g) < 0.5
    return tuple(x.to(dev).contiguous() for x in (d, obs, upd, act))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args()
    dev = torch.device("cuda")
    out = {}

    # 1. Device.
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    log(f"device: {name} | nvidia-smi: {smi} | torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    out["device"] = dict(name=name, nvidia_smi=smi)

    # 2. Build.
    t0 = time.perf_counter()
    esdf_relax.build()
    esdf_relax._lib()
    out["build_s"] = time.perf_counter() - t0
    log(f"build: {out['build_s']:.1f} s "
        f"{esdf_relax.BUILD_INFO.get('ptxas', '(cached)')}")

    # 3. Main path at full size, kernel relaxation.
    t0 = time.perf_counter()
    scans, intr = make_scans(dev)
    torch.cuda.synchronize()
    log(f"scans: {len(scans)} x {RES} in {time.perf_counter() - t0:.1f} s")
    srv = make_server(dev, intr, "kernel")
    torch.cuda.reset_peak_memory_stats()

    def zero_counts():
        esdf_relax.LAUNCHES = 0

    win = run_loop(srv, scans, on_window_start=zero_counts)
    launches = win["relax_launches"]
    bucket = esdf_ops._BUCKET_CACHE[(4096, 16, 1024)]
    win.update(bucket=bucket,
               max_memory_allocated=torch.cuda.max_memory_allocated())
    log("main path: " + json.dumps(win))
    assert launches > 0, "the online loop never launched the kernel"
    assert all(i >= 1 for i in win["outer_iters"])
    esdf = srv.esdf_layer.channels["esdf"]
    obs = (srv.esdf_layer.channels["esdf_flags"] & 1) != 0
    tsdf = srv.layer.channels["tsdf"]
    assert torch.isfinite(esdf).all() and torch.isfinite(tsdf).all()
    assert int(obs.sum()) > 100_000, int(obs.sum())
    assert float(esdf[obs].abs().max()) <= 2.0 + 1e-6
    assert float(tsdf.abs().max()) <= 4 * VOXEL + 1e-6
    out["main"] = win

    # 4. Kernel against its plain version at the main path's size.
    n = bucket
    inputs = [random_relax_inputs(n, seed, dev) for seed in range(7)]
    max_err = 0.0
    for x in inputs:
        got = esdf_relax.relax(*x, 4, VOXEL, 2.0, 0.001)
        ref = esdf_relax.relax_plain(*x, 4, VOXEL, 2.0, 0.001)
        torch.cuda.synchronize()
        max_err = max(max_err, float((got - ref).abs().max()))
    assert max_err == 0.0, f"kernel differs from plain version: {max_err}"
    ms, k_times = _cuda_ms(lambda x: esdf_relax.relax(*x, 4, VOXEL, 2.0,
                                                      0.001), inputs)
    plain_ms, p_times = _cuda_ms(lambda x: esdf_relax.relax_plain(
        *x, 4, VOXEL, 2.0, 0.001), inputs)
    act = statistics.median(int(x[3].sum()) for x in inputs)
    # Work this run's inputs need (note in csrc/esdf_relax.cu): every
    # active block's sweeps; d read and the new output written for all n
    # blocks, obs and upd read for active blocks only.
    ops = act * 4 * esdf_relax.OPS_PER_BLOCK_SWEEP
    nbytes = n * 18 ** 3 * (4 + 4) + act * 18 ** 3 * (1 + 1) + n
    bound_ms = max(nbytes / PEAK_BYTES, ops / PEAK_F32) * 1e3
    bound_by = "operations" if ops / PEAK_F32 > nbytes / PEAK_BYTES else (
        "bytes")
    kern = dict(n_blocks=n, active_blocks=act, inner_sweeps=4,
                tolerance="exact (bit-equal)", ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                ops=ops, bytes=nbytes, kernel_times_ms=k_times,
                plain_times_ms=p_times, max_abs_err=max_err)
    log("kernel: " + json.dumps(kern))
    out["kernel"] = kern

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

    if args.profile:
        # After the replay check: these scans change the kernel server's map.
        out["profile"] = profile_window(srv, scans)
        # Busy share against the unprofiled step time (the profiler itself
        # slows the host side of the traced window).
        out["profile"]["device_busy_share_of_step"] = (
            out["profile"]["device_busy_ms_per_scan"] / win["ms_per_scan"])
        log("profile: " + json.dumps(out["profile"]))

    os.makedirs("chiprun_out", exist_ok=True)
    with open("chiprun_out/chip_smoke.json", "w") as f:
        json.dump(out, f, indent=1)
    line = {"kernels": [dict(
        name="esdf_relax_k1", route="cuda",
        source="voxblox_tpu_torch/csrc/esdf_relax.cu",
        replaces="voxblox_tpu/ops/pallas/esdf_relax.py:52",
        launches=launches, max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
        bound_ms=bound_ms, bound_by=bound_by, library_ms=None)]}
    print(json.dumps(line))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
