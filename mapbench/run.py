#!/usr/bin/env python3
"""The port's benchmark: one run of one cell.

    python3 mapbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

run from the root of a checkout on a machine with a CUDA card. A cell
(``BENCHMARK.json`` ``workloads``) is a configuration of the mapping
server under one traffic mix. The run makes its scene, trajectory and
scans from the seed, builds the server, warms it (the set-up), hands it
one scan after another for ``--seconds``, each closed by a device sync
(the moment a planner may read the map), and then judges the map it left
against the plain reference.

``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics from a profiler trace of a few scans of the window.
The last line of standard output is the result as one JSON object; the
numbers compared, each beside its limit, are the last lines of standard
error and the result's last key. Without a CUDA card, or without the
program beside this directory, it exits non-zero and prints no result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# Whole top-level module names that may not be loaded (the program's
# name begins with the JAX package's, so prefixes do not count).
FORBIDDEN = ("jax", "jaxlib", "flax", "voxblox_tpu")


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def card_line():
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from mapbench import harness
    bench = harness.load_benchmark(ROOT)
    cell, _ = harness.find_cell(bench, args.workload)
    if importlib.util.find_spec("voxblox_tpu_torch") is None:
        print("mapbench: the program (voxblox_tpu_torch) is not beside "
              "this directory", file=sys.stderr)
        return 2
    import torch
    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < cell["chips"]):
        print(f"mapbench: {args.workload} needs {cell['chips']} CUDA "
              f"card(s); found {torch.cuda.device_count()}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    result, extra = harness.run_cell(ROOT, args.workload, args.seed,
                                     args.seconds, bool(args.trace), device,
                                     T_START)
    bad = forbidden_modules()
    if bad:
        print(f"mapbench: loaded {bad}; the benchmark may not load JAX or "
              "the JAX package", file=sys.stderr)
        return 3
    print(f"card: {card_line()}", file=sys.stderr)
    print(f"run: {json.dumps(extra)}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
