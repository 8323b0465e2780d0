#!/usr/bin/env python3
"""What the port's span recorder (``voxblox_tpu_torch/utils/timing.py``)
costs on one benchmark cell, and what it reads there, on a CUDA card.

    python3 scripts/recording_cost.py --workload <cell> --seed <n> \
        [--blocks 6] [--scans 16]

Builds the cell's server and scans as ``mapbench/run.py`` does, warms it
with one pass, then times scans (each closed by a device sync) in blocks
of ``--scans``, recording off and on in turns: first untraced, then
under torch.profiler (where recording follows the profiler; "off"
suppresses it). Prints one JSON line: ms a scan per mode (mean and
quartiles), and the last untraced recording per scan: each span's calls,
device ms (CUDA events), host ms and own host syncs, and the counters.
"""

import argparse
import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from mapbench import harness, scene  # noqa: E402
from voxblox_tpu_torch.utils import timing  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--blocks", type=int, default=6)
    ap.add_argument("--scans", type=int, default=16)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("recording_cost: needs a CUDA card", file=sys.stderr)
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
    n = len(scans)
    for s in scans:
        step(s)
    srv.check_overflow()
    torch.cuda.synchronize()
    k = 0

    def block():
        nonlocal k
        out = []
        for _ in range(args.scans):
            t0 = time.perf_counter()
            step(scans[k % n])
            torch.cuda.synchronize()
            out.append(1e3 * (time.perf_counter() - t0))
            k += 1
        return out

    ms = {m: [] for m in ("plain.off", "plain.on", "profiled.off",
                          "profiled.on")}
    recorder = timing._recording
    last = None
    for traced in (False, True):
        for b in range(args.blocks):
            for rec in (("off", "on") if b % 2 == 0 else ("on", "off")):
                mode = f"{'profiled' if traced else 'plain'}.{rec}"
                if not traced:
                    if rec == "on":
                        timing.start_recording()
                    ms[mode] += block()
                    if rec == "on":
                        last = timing.stop_recording()
                    continue
                if rec == "off":
                    timing._recording = lambda: None
                try:
                    with profile(activities=[ProfilerActivity.CPU,
                                             ProfilerActivity.CUDA]):
                        ms[mode] += block()
                finally:
                    timing._recording = recorder
    per = args.scans
    out = {"workload": args.workload, "seed": args.seed,
           "card": torch.cuda.get_device_name(dev),
           "ms_per_scan": {m: {"mean": statistics.fmean(v),
                               "quartiles": statistics.quantiles(v, n=4),
                               "n": len(v)}
                           for m, v in ms.items()},
           "spans_per_scan": {t: {"calls": s["calls"] / per,
                                  "device_ms": s["device_ms"] / per,
                                  "host_ms": s["host_ms"] / per,
                                  "self_host_ms": s["self_host_ms"] / per,
                                  "syncs": s["syncs"] / per}
                              for t, s in last["spans"].items()},
           "counters_per_scan": {c: v / per
                                 for c, v in last["counters"].items()}}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
