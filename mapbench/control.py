#!/usr/bin/env python3
"""Readings the limits of ``correct`` are set from, for one cell over
many seeds in one process (the benchmark's own runs do not run this):

- the program's numbers in a run of the cell (the lower readings);
- the control's: the reference computed in bfloat16, one precision below
  the configuration's float32, put in the program's place and judged by
  the same comparison against the cell's limits (the upper readings).

    python3 mapbench/control.py --workload <cell> --seeds 1,2,3 \
        --seconds 3 [--control-seeds 1,2,3] [--out chiprun_out/x.json]

Each seed runs the cell's set-up and a short window at the cell's own
load, then the comparison; a seed of ``--control-seeds`` also judges the
control on that window's scans. One JSON line per seed on standard
output, with ``correct`` for the program and for the control.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def control_numbers(keep, device):
    """The control's numbers and verdict for a run's kept inputs."""
    from mapbench import checks
    cand = checks.control_store(keep["cfg"], keep["traffic"], keep["scans"],
                                keep["handed"], device)
    numbers = checks.judge(keep["cfg"], keep["traffic"], keep["scans"],
                           keep["handed"], cand, keep["limits"], device)
    return numbers, checks.verdict(numbers, 0)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    import torch
    from mapbench import harness
    if not torch.cuda.is_available():
        print("control: needs a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    ctl_seeds = {int(s) for s in args.control_seeds.split(",") if s}
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        keep = {}
        t0 = time.perf_counter()
        res, extra = harness.run_cell(ROOT, args.workload, seed,
                                      args.seconds, False, device, t0,
                                      keep=keep)
        row = dict(seed=seed, correct=res["correct"],
                   program={k: v["value"] for k, v in res["checks"].items()},
                   metrics={k: v["value"] for k, v in
                            res["metrics"].items()},
                   peak=res["device"]["memory_peak_bytes"],
                   window_scans=extra["window_scans"])
        if seed in ctl_seeds:
            numbers, ok = control_numbers(keep, device)
            row.update(control={k: v["value"] for k, v in numbers.items()},
                       control_correct=ok)
        row["seconds"] = time.perf_counter() - t0
        rows.append(row)
        print(json.dumps(row), flush=True)
        del keep
        torch.cuda.empty_cache()
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
