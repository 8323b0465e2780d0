"""One run of one cell: build the server a configuration file describes,
drive it with the traffic a traffic file describes, time the window,
trace it on request, and judge the map it left against the reference.

Everything that belongs to one configuration, traffic mix or per-layer
metric is a file found by its name (``BENCHMARK.json`` names the
configuration's file; ``mapbench/traffic/<mix>.json``,
``mapbench/metrics/<metric>.py``, ``mapbench/limits/<cell>.json``), so a
later cell, mix or metric is new files and entries only.

The program is imported here, lazily, and nowhere else under mapbench/.
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import statistics
import sys
import time

import numpy as np
import torch

from . import checks, scene

TRACE_FIRST, TRACE_SCANS = 40, 16  # the traced sub-window's scans
WINDOW_SCANS_MAX = None  # a cap on the window's scans (CPU tests only)


def read_json(path):
    with open(path) as f:
        return json.load(f)


def load_benchmark(root):
    return read_json(os.path.join(root, "BENCHMARK.json"))


def find_cell(bench, name):
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; known: "
                         f"{sorted(cells)}")
    cell = cells[name]
    cfg = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    return cell, cfg


def traffic_file(root, mix):
    return os.path.join(root, "mapbench", "traffic", f"{mix}.json")


def metric_file(root, metric):
    return os.path.join(root, "mapbench", "metrics", f"{metric}.py")


def limits_file(root, cell):
    return os.path.join(root, "mapbench", "limits", f"{cell}.json")


def load_metric(root, metric):
    """The reader module of a per-layer metric, loaded from its file."""
    path = metric_file(root, metric)
    spec = importlib.util.spec_from_file_location(
        "mapbench_metric_" + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(bench, cell_name, kind):
    """The cell's metrics of one kind ("end_to_end" or "per_layer"): a
    metric without ``workloads`` belongs to every cell."""
    return [m for m in bench[kind]
            if cell_name in m.get("workloads", [cell_name])]


# ---------------------------------------------------------------------------
# The program's side
# ---------------------------------------------------------------------------


def build_server(cfg, device):
    """The tsdf_server a configuration file describes (the program's own
    configuration classes, filled from the file's sections)."""
    from voxblox_tpu_torch.core.config import (MapConfig,
                                               TsdfIntegratorConfig)
    from voxblox_tpu_torch.server.mapper import TsdfServer
    srv = dict(cfg["server"])
    if "projective_resolution" in srv:
        srv["projective_resolution"] = tuple(srv["projective_resolution"])
    if srv["method"] == "projective":
        srv["projective_intrinsics"] = scene.intrinsics(cfg["sensor"])
    return TsdfServer(map_config=MapConfig(**cfg["map"]),
                      integrator_config=TsdfIntegratorConfig(**cfg["tsdf"]),
                      device=device, **srv)


def make_step(srv, traffic):
    """The traffic's steps on one scan (R, t, points, colours), in the
    order its ``ops`` list names them."""
    flat = traffic["cloud"] == "flat"

    def integrate(s):
        pts, cols = s[2], s[3]
        if flat:
            pts, cols = pts.reshape(-1, 3), cols.reshape(-1, 3)
        srv.insert_pointcloud((s[0], s[1]), pts, cols)

    table = {"integrate": integrate}
    ops = [table[o] for o in traffic["ops"]]

    def step(s):
        for op in ops:
            op(s)

    return step


def map_rows(srv):
    """The program's map as the check reads it: block indices, flags,
    distance and weight of every pool row."""
    L = srv.layer
    return dict(t_ijk=L.block_ijk, t_flags=L.block_flags,
                tsdf=L.channels["tsdf"], weight=L.channels["weight"])


def device_info(device):
    if device.type != "cuda":
        return dict(platform="cpu", kind="cpu", count=0,
                    memory_peak_bytes=0)
    return dict(platform="gpu", kind=torch.cuda.get_device_name(device),
                count=1,
                memory_peak_bytes=int(torch.cuda.max_memory_allocated(
                    device)))


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_cell(root, workload, seed, seconds, trace, device, t_start,
             keep=None):
    """Set up, warm, measure and check one cell once. Returns the result
    dict (the contract's keys, the compared numbers last) and a few
    readings for the log. ``keep``, a dict, receives what the check
    reads (for the control)."""
    from voxblox_tpu_torch import _runtime

    bench = load_benchmark(root)
    cell, cfg_entry = find_cell(bench, workload)
    cfg = read_json(os.path.join(root, cfg_entry["file"]))
    traffic = read_json(traffic_file(root, cell["traffic"]))
    limits = read_json(limits_file(root, workload))

    # Inputs from the seed: the scene, the orbit and its scans.
    t_scans = time.perf_counter()
    _, scans = scene.make_traffic_data(traffic, cfg["sensor"], seed, device)
    sync(device)
    scans_s = time.perf_counter() - t_scans
    srv = build_server(cfg, device)
    step = make_step(srv, traffic)
    n = len(scans)
    handed = []  # scan index of every hand-off, in order

    # Warm: one pass over the orbit, resolve overflow, then a few steps.
    for i in range(n):
        step(scans[i])
        handed.append(i)
    srv.check_overflow()
    warm = traffic["warm_steps"]
    for i in range(warm):
        step(scans[i])
        handed.append(i)
    sync(device)

    tracer = None
    if trace:
        from . import trace as tracing
        tracer = tracing.Tracer(device)
    lat, failed, attempted = [], 0, 0
    k = 0
    setup_s = time.perf_counter() - t_start
    t0 = time.perf_counter()
    while True:
        now = time.perf_counter()
        done_time = now - t0 >= seconds
        trace_pending = tracer is not None and k < TRACE_FIRST + TRACE_SCANS
        capped = WINDOW_SCANS_MAX is not None and k >= WINDOW_SCANS_MAX
        if (done_time or capped) and not trace_pending:
            break
        idx = (warm + k) % n
        if tracer is not None and k == TRACE_FIRST:
            syncs0 = _runtime.SYNCS
            tracer.start()
        attempted += 1
        t_hand = time.perf_counter()
        try:
            step(scans[idx])
        except MemoryError as e:
            failed += 1
            print(f"scan {k} failed: {e}", file=sys.stderr)
        sync(device)
        t_done = time.perf_counter()
        lat.append(t_done - t_hand)
        handed.append(idx)
        k += 1
        if tracer is not None and k == TRACE_FIRST + TRACE_SCANS:
            tracer.stop(scans=TRACE_SCANS,
                        host_syncs=_runtime.SYNCS - syncs0)
    window_s = t_done - t0
    # Resolve what the server deferred before judging.
    try:
        srv.check_overflow()
    except MemoryError as e:
        failed += 1
        print(f"closing overflow check failed: {e}", file=sys.stderr)
    sync(device)
    dev_info = device_info(device)
    blocks = int(srv.layer.num_blocks)
    live_blocks = int(srv.layer.active_mask().sum())

    metrics = {}
    if trace:
        ctx = tracer.context()
        for m in cell_metrics(bench, workload, "per_layer"):
            v = load_metric(root, m["name"]).read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        dev_info.update(busy_s=ctx["busy_s"], window_s=ctx["window_s"])
    else:
        e2e = {"scans_per_s": len(lat) / window_s,
               "scan_latency_p95_ms": 1e3 * _p95(lat),
               "setup_s": setup_s}
        for m in cell_metrics(bench, workload, "end_to_end"):
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}

    breakdown = tracer.breakdown() if trace else None
    # Judge once the window has closed, the peak is read and the
    # program's state is freed.
    prog = checks.program_store(map_rows(srv), cfg)
    del srv, step, tracer
    if device.type == "cuda":
        torch.cuda.empty_cache()
    if keep is not None:
        keep.update(cfg=cfg, traffic=traffic, scans=scans, handed=handed,
                    limits=limits, failed=failed)
    t_judge = time.perf_counter()
    numbers = checks.judge(cfg, traffic, scans, handed, prog, limits,
                           device)
    judge_s = time.perf_counter() - t_judge
    result = {"correct": checks.verdict(numbers, failed),
              "attempted": attempted, "failed": failed, "metrics": metrics,
              "device": dev_info}
    if trace:
        result["breakdown"] = breakdown
    result["checks"] = numbers
    ends = np.cumsum(lat)
    per_s = np.bincount((ends // 1.0).astype(np.int64)).tolist()
    extra = dict(window_scans=len(lat), scans_s=scans_s, judge_s=judge_s,
                 blocks=blocks, live_blocks=live_blocks,
                 latency_median_ms=1e3 * statistics.median(lat),
                 scans_each_second=per_s)
    return result, extra


def _p95(xs):
    """The 95th percentile by the nearest-rank rule."""
    s = sorted(xs)
    return s[max(0, math.ceil(0.95 * len(s)) - 1)]
