"""Time the ESDF relaxation kernels (K1, K2) of this tree against those of
another checkout of the port, on one CUDA card, in one process.

    git archive <commit> | tar -x -C _parent     # _parent/ is git-ignored
    python3 scripts/compare_relax_kernels.py --parent _parent

Times spread between machines and between runs, so two versions are only
compared inside one run: for every shape the main paths launch (K1 at the
online loop's, the unit batch rebuild's and the stress loop's bucket, K2
at the strided batch rebuild's; inputs from chip_smoke.py's generators)
the passes run parent, this tree, this tree, parent, and each pass is the
median over seven inputs timed with CUDA events (behind a short
device-side spin, so that the host's enqueue time is not in them). Every
version's output is held to this tree's plain PyTorch version bit for
bit. Prints one JSON object (also written to
chiprun_out/compare_relax_kernels.json) with the card's name and power
limit, both builds' ptxas reports and each kernel's CTAs per SM. Without
``--parent`` only this tree's kernels are timed.

``--paths`` adds the main paths end to end with the two trees' kernels
swapped in and out of this tree's host code (the kernels compute the same
values bit for bit, so the map does not depend on which one ran): the
5 cm online loop in windows of 12 scans, the unit and the strided batch
rebuild in groups of 4 chained rebuilds, and the 2 cm stress loop with a
mesh update every scan in windows of 16 scans, in the order parent, new,
new, parent, parent, new, new, parent (eight windows for the loops, 64
for each rebuild, where the kernel is a larger part), one synchronisation
per window. Host time on a shared machine drifts by tens of percent
within a minute: alternating windows keeps the slow drift out of the
pair, not the jitter from window to window.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

SLEEP_CYCLES = 2_000_000  # ~1 ms of device spin before each timed call

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402  (exits without a CUDA device)
from voxblox_tpu_torch import _runtime  # noqa: E402
from voxblox_tpu_torch.core import layer as vlayer  # noqa: E402
from voxblox_tpu_torch.core.config import EsdfIntegratorConfig  # noqa: E402
from voxblox_tpu_torch.ops import esdf as esdf_ops  # noqa: E402
from voxblox_tpu_torch.ops import esdf_relax  # noqa: E402

ORDER = ("parent", "new", "new", "parent", "parent", "new", "new", "parent")


def load_parent(path):
    """The other checkout's ``ops/esdf_relax``, imported inside its own
    package (as ``parent_voxblox_tpu_torch``), so that its relative
    imports resolve there."""
    pkg = Path(path) / "voxblox_tpu_torch"
    spec = importlib.util.spec_from_file_location(
        "parent_voxblox_tpu_torch", pkg / "__init__.py",
        submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return importlib.import_module("parent_voxblox_tpu_torch.ops.esdf_relax")


def alternate(impls, window, rounds=1):
    """``window()`` (work ending in one synchronize, returning the number
    of items it did) under each implementation of ``relax`` in ORDER,
    ``rounds`` times over; ms per item by window and the median per
    implementation."""
    ms = {name: [] for name in impls}
    own = esdf_relax.relax
    try:
        for name in ORDER * rounds:
            esdf_relax.relax = impls[name]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            n = window()
            torch.cuda.synchronize()
            ms[name].append((time.perf_counter() - t0) * 1e3 / n)
    finally:
        esdf_relax.relax = own
    return dict(windows_ms=ms,
                median_ms={k: statistics.median(v) for k, v in ms.items()})


def paths(impls, dev):
    """The three main paths of chip_smoke.py with ``relax`` alternating
    between the implementations."""
    import dataclasses

    res = {}
    scans, intr = cs.make_scans(dev)
    # Online loop, 5 cm (chip_smoke.run_loop's warm-up, then windows).
    srv = cs.make_server(dev, intr, "kernel")
    for sc in scans:
        srv.insert_pointcloud_and_update_esdf(sc[:2], *sc[2:])
    srv.check_overflow()
    esdf_ops.presize_bucket(srv.esdf_cfg, srv.esdf_layer,
                            int(srv.layer.num_blocks) + 8)
    at = [0]

    def online_window():
        for _ in range(cs.TIMED):
            sc = scans[at[0] % len(scans)]
            srv.insert_pointcloud_and_update_esdf(sc[:2], *sc[2:])
            at[0] += 1
        return cs.TIMED

    online_window()
    res["online_ms_per_scan"] = alternate(impls, online_window)
    srv.check_overflow()
    print(json.dumps({"online": res["online_ms_per_scan"]}), flush=True)

    # Batch rebuild of that map, unit and strided (chip_smoke.batch_phase).
    base = dict(max_distance_m=2.0, default_distance_m=2.0,
                min_distance_m=2 * cs.VOXEL, max_active_blocks=1024,
                use_pallas_kernel=True, inner_sweeps=4)
    tsdf = srv.layer

    def perturbed(i):
        ch = dict(tsdf.channels)
        ch["tsdf"] = ch["tsdf"] + 1e-6 * i
        return dataclasses.replace(tsdf, channels=ch)

    layers = [perturbed(i) for i in range(8)]
    saved = dict(esdf_ops._BUCKET_CACHE)
    for key, cfg in (("batch_unit_ms", EsdfIntegratorConfig(**base)),
                     ("batch_strided_ms", EsdfIntegratorConfig(
                         **base, sweep_strides=cs.STRIDES))):
        esdf_ops._BUCKET_CACHE.clear()
        state = [esdf_ops.update_from_tsdf_batch_deferred(
            vlayer.make_layer("esdf", cs.VOXEL, vps=16,
                              max_blocks=cs.MAX_BLOCKS, device=dev),
            layers[0], cfg)[0]]
        flags = []

        def batch_window():
            for g in range(4):
                state[0], ovf, r_ovf, _ = (
                    esdf_ops.update_from_tsdf_batch_deferred(
                        state[0], layers[1 + (at[0] + g) % 7], cfg))
                flags.extend([ovf, r_ovf])
            at[0] += 4
            return 4

        batch_window()
        res[key] = alternate(impls, batch_window, rounds=8)
        assert not any(_runtime.host_bools(flags))
        print(json.dumps({key: res[key]}), flush=True)
    esdf_ops._BUCKET_CACHE.clear()
    esdf_ops._BUCKET_CACHE.update(saved)
    del srv, layers, state
    torch.cuda.empty_cache()

    # Stress loop, 2 cm, mesh update every scan (chip_smoke.stress_phase).
    srv = cs.make_stress_server(dev, intr)
    for sc in scans:
        srv.insert_pointcloud_and_update_esdf(sc[:2], *sc[2:])
    srv.check_overflow()
    esdf_ops.presize_bucket(srv.esdf_cfg, srv.esdf_layer,
                            int(srv.layer.num_blocks) + 64)
    for sc in scans[:8]:
        cs.stress_step(srv, sc)
    srv.check_overflow()
    at[0] = 0

    def stress_window():
        for _ in range(cs.STRESS_TIMED):
            cs.stress_step(srv, scans[at[0] % len(scans)])
            at[0] += 1
        return cs.STRESS_TIMED

    stress_window()
    res["stress_ms_per_scan"] = alternate(impls, stress_window)
    srv.check_overflow()
    res["stress_blocks"] = int(srv.layer.num_blocks)
    print(json.dumps({"stress": res["stress_ms_per_scan"]}), flush=True)
    return res


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", default=None)
    ap.add_argument("--paths", action="store_true")
    args = ap.parse_args()
    if args.paths and not args.parent:
        ap.error("--paths compares with --parent")
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    out = dict(nvidia_smi=smi, torch=torch.__version__)
    esdf_relax._lib()
    out["build"] = dict(esdf_relax.BUILD_INFO)
    out["ctas_per_sm"] = dict(k1=esdf_relax.ctas_per_sm(False),
                              k2=esdf_relax.ctas_per_sm(True))
    print(json.dumps(out), flush=True)
    parent = load_parent(args.parent) if args.parent else None
    if parent:
        parent._lib()
        out["parent_build"] = dict(parent.BUILD_INFO)

    versions = {"new": lambda x, **kw: esdf_relax.relax(*x, **kw)}
    if parent:
        versions = {"parent": lambda x, **kw: parent.relax(*x, **kw),
                    **versions}

    shapes = [
        ("k1", "online loop", 512, cs.VOXEL, 2.0),
        ("k1", "unit batch rebuild", 384, cs.VOXEL, 2.0),
        ("k1", "stress loop", cs.STRESS_BLOCKS, cs.STRESS_VOXEL, 1.0),
        ("k2", "strided batch rebuild", 384, cs.VOXEL, 2.0),
    ]
    out["shapes"] = []
    failed = False
    for kern, path, n, voxel, maxd in shapes:
        if kern == "k1":
            inputs = [cs.random_relax_inputs(n, seed, dev, maxd / 2.0)
                      for seed in range(7)]
        else:
            inputs = [cs.structured_relax_inputs(n, seed, dev, cs.STRIDES)
                      for seed in range(7)]
        calls = [x[:4] + (4, voxel, maxd, cs.MIN_DIFF) for x in inputs]
        kws = [dict(strides=cs.STRIDES, codes=x[4]) if kern == "k2" else {}
               for x in inputs]
        ref = esdf_relax.relax_plain(*calls[0], **kws[0])
        errs = {}
        for name, fn in versions.items():
            got = fn(calls[0], **kws[0])
            torch.cuda.synchronize()
            errs[name] = float((got - ref).abs().max())
            failed = failed or errs[name] != 0.0
        order = list(versions) + list(reversed(versions))
        passes = {name: [] for name in versions}
        for name in order:
            fn = versions[name]
            times = []
            for c, kw in zip(calls, kws):
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                # Keep the card busy while the host enqueues, so the
                # events bracket device time and not the wrapper's.
                torch.cuda._sleep(SLEEP_CYCLES)
                a.record()
                fn(c, **kw)
                b.record()
                torch.cuda.synchronize()
                times.append(a.elapsed_time(b))
            passes[name].append(statistics.median(times))
        row = dict(kernel=kern, path=path, n_blocks=n,
                   active_blocks=statistics.median(
                       int(x[3].sum()) for x in inputs),
                   max_abs_err=errs, pass_ms=passes,
                   ms={k: min(v) for k, v in passes.items()})
        if parent:
            row["speedup_new_over_parent"] = (
                row["ms"]["parent"] / row["ms"]["new"])
        out["shapes"].append(row)
        print(json.dumps(row), flush=True)
        del inputs, calls, kws, ref
        torch.cuda.empty_cache()
    if args.paths:
        out["paths"] = paths(dict(parent=parent.relax, new=esdf_relax.relax),
                             dev)
    os.makedirs(ROOT / "chiprun_out", exist_ok=True)
    with open(ROOT / "chiprun_out" / "compare_relax_kernels.json", "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))
    if failed:
        sys.exit("a kernel differs from the plain version (max_abs_err)")


if __name__ == "__main__":
    main()
