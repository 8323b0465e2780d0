#!/usr/bin/env python3
"""The walk-and-accumulate kernel (``ops/tsdf_walk.py``) at one benchmark
cell's shapes, beside its bound and its plain version, on a CUDA card.

    python3 scripts/tsdf_walk_kernel.py --workload <cell> --seed <n> \
        [--scans 8] [--reps 5]

Builds the cell's server and scans as ``mapbench/run.py`` does and warms
it with one pass. Then, for ``--scans`` scans, takes the rays the step
hands the kernel and launches the kernel on them ``--reps`` more times
under torch.profiler (its own device time, by kernel name), and runs the
plain chain (``ops/tsdf._chain_samples`` and ``_accumulate_flat``) once on
the same rays (CUDA events). The bound is ``tsdf_walk.needed_bytes`` over
3.35e12 B/s: each accumulator cell added to, written once, the dirty
bytes, the valid flags, the valid lanes' per-ray inputs and the hash
table cells probed, each read once. Beside it, the bytes of 4-byte
atomic adds, one per nonzero addend of every sample, as if each went to
memory alone (the atomics resolve in L2, and a cell takes many). The
other kernels of the wrapper call (the accumulators' zero fill, the per-
ray set-up) are timed apart. The counters are given under both
definitions: the walk's (step, lane) slots as the kernel executes them
(warp slots) and as the chain did (max_steps x lanes), and the probes as
made and as the chain counted them (lookups x (probe bound + 1)).
Prints one JSON line: ms a scan of both, the counts, the bound, the
build's ptxas report and the peak device memory of the first scan
stepped after the warm pass.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from mapbench import harness, scene  # noqa: E402
from voxblox_tpu_torch.ops import tsdf as tt  # noqa: E402
from voxblox_tpu_torch.ops import tsdf_walk  # noqa: E402
from voxblox_tpu_torch.utils import timing  # noqa: E402

HBM_BYTES_PER_S = 3.35e12


def _addends(layer, rays, max_steps, cfg):
    """The chain's addends that the kernel adds (w, w * sdf, cw, cw * rgb
    of the samples it keeps)."""
    _, sdf, w, _, ok, _ = tt._chain_samples(layer, rays, max_steps, cfg)
    trunc = cfg.default_truncation_distance
    out = [w[ok], (w * torch.clamp(sdf, -trunc, trunc))[ok]]
    if rays.colors is not None:
        cw = torch.where(sdf.abs() < trunc, w, 0.0)[ok]
        lane = torch.nonzero(ok, as_tuple=True)[1]
        out += [cw, cw[:, None] * rays.colors[lane]]
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--scans", type=int, default=8)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("tsdf_walk_kernel: needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    bench = harness.load_benchmark(ROOT)
    cell, cfg_entry = harness.find_cell(bench, args.workload)
    cfg = harness.read_json(os.path.join(ROOT, cfg_entry["file"]))
    traffic = harness.read_json(harness.traffic_file(ROOT, cell["traffic"]))
    _, scans = scene.make_traffic_data(traffic, cfg["sensor"], args.seed,
                                       dev)
    srv = harness.build_server(cfg, dev)
    step = harness.make_step(srv, traffic)
    for s in scans:
        step(s)
    srv.check_overflow()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)

    seen = {}
    kernel = tt._walk_kernel

    def spy(layer, rays, max_steps, tcfg):
        seen.update(layer=layer, rays=rays, max_steps=max_steps, cfg=tcfg)
        return kernel(layer, rays, max_steps, tcfg)

    kernel_ms, other_ms, chain_ms, counters = [], [], [], []
    needed, atomic, bounds, lanes = [], [], [], []
    for i in range(args.scans):
        tt._walk_kernel = spy
        try:
            step(scans[i % len(scans)])
        finally:
            tt._walk_kernel = kernel
        torch.cuda.synchronize()
        if i == 0:  # before the chain below allocates its samples
            peak = torch.cuda.max_memory_allocated(dev)
        layer, rays = seen["layer"], seen["rays"]
        max_steps, tcfg = seen["max_steps"], seen["cfg"]
        timing.start_recording()
        acc = kernel(layer, rays, max_steps, tcfg)
        c = timing.stop_recording()["counters"]
        counters.append(c)
        needed.append(tsdf_walk.needed_bytes(
            acc, rays.valid, rays.colors is not None,
            min(int(c["hash.probes"]), layer.table.capacity)))
        atomic.append(4 * sum(int(torch.count_nonzero(x)) for x in
                              _addends(layer, rays, max_steps, tcfg)))
        bounds.append(int(layer.table.max_psl))
        lanes.append(rays.valid.numel())
        del acc
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(args.reps):
                kernel(layer, rays, max_steps, tcfg)
            torch.cuda.synchronize()
        on_card = [e for e in prof.events()
                   if e.device_type == DeviceType.CUDA]
        us = sum(e.time_range.elapsed_us() for e in on_card
                 if e.name.startswith("tsdf_walk_kernel"))
        everything = sum(e.time_range.elapsed_us() for e in on_card)
        kernel_ms.append(us / 1e3 / args.reps)
        other_ms.append((everything - us) / 1e3 / args.reps)
        t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0.record()
        _, sdf, w, flat, ok, _ = tt._chain_samples(layer, rays, max_steps,
                                                   tcfg)
        tt._accumulate_flat(layer, flat, ok, sdf, w, rays.colors, tcfg,
                            rays.colors is not None)
        t1.record()
        torch.cuda.synchronize()
        chain_ms.append(t0.elapsed_time(t1))
        del sdf, w, flat, ok

    def per_scan(name):
        return statistics.fmean(c.get(name, 0) for c in counters)

    useful = per_scan("integrate.walk_samples_useful")
    probes = per_scan("hash.probes")
    lookups = per_scan("integrate.block_lookups")
    bound_ms = 1e3 * statistics.fmean(needed) / HBM_BYTES_PER_S
    k_ms = statistics.median(kernel_ms)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    out = {"workload": args.workload, "seed": args.seed, "card": smi,
           "kernel_ms": kernel_ms, "kernel_ms_median": k_ms,
           "chain_ms": chain_ms, "chain_ms_median": statistics.median(
               chain_ms),
           "wrapper_other_kernels_ms": other_ms,
           "walk_samples": per_scan("integrate.walk_samples"),
           "walk_slots_as_the_chain": max_steps * statistics.fmean(lanes),
           "walk_samples_useful": useful,
           "block_lookups": lookups,
           "hash_probes": probes, "probe_bounds": bounds,
           "probes_as_the_chain": statistics.fmean(
               (b + 1) for b in bounds) * lookups,
           "needed_bytes": statistics.fmean(needed),
           "atomic_bytes": statistics.fmean(atomic),
           "bound_ms": bound_ms,
           "bound_share_pct": 100.0 * bound_ms / k_ms,
           "atomic_bytes_ms": 1e3 * statistics.fmean(atomic)
           / HBM_BYTES_PER_S,
           "peak_bytes_first_scan": peak,
           "ptxas": tsdf_walk.BUILD_INFO.get("ptxas", "(cached build)")}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
