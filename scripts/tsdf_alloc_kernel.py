#!/usr/bin/env python3
"""The block-walk-and-probe kernel of allocation (``ops/tsdf_alloc.py``) at
one benchmark cell's shapes, beside its bound and its plain version, on a
CUDA card.

    python3 scripts/tsdf_alloc_kernel.py --workload <cell> --seed <n> \
        [--warm 200] [--scans 4] [--reps 3]

Builds the cell's server and scans as ``mapbench/run.py`` does and steps
``--warm`` of them (at most the traffic's scans). Then, for ``--scans``
scans, takes the allocation state and the rays each step hands
``allocate_for_rays`` and compares, ``--reps`` times each, the kernel's
path (``ops/tsdf._allocate_kernel``) with the plain chain's
(``_allocate_chain``) at two scopes:

- the first round's discovery alone (``first_discovery``: the rays' DDA
  set-up, the walk, the dilation, the lookups, the pending buffer, the
  round's one read and the winners' keys; nothing is inserted), by
  torch.profiler device time of every kernel in it, and event to event;
  the find pass's own device time beside it, by kernel name;
- the whole allocation (every round and insert, on copies of the state),
  event to event with CUDA events; the two must leave the same table,
  pool rows and flags.

Probes of the first round, on the same table and candidates: the kernel's
count (cells read until the key or an empty cell, a neighbour the
previous block found present not looked up), the chain's exact count
(``probes_each`` over its candidates in the walks' masks) and what the
chain's ``hash.lookup`` counts (every candidate times the probe bound +
1). The find pass's bound is bytes over 3.35e12 B/s: the valid lanes'
per-ray inputs (64 B), a valid byte a lane, the table cells probed (12 B,
each read once) and the pending buffer (8 B a cell); it leaves out the key
recovery, so it is a lower bound of the discovery's. Prints one JSON
line: ms of both scopes and of the find pass, the counters, the bound, the
card and the build's ptxas report.
"""

import argparse
import dataclasses
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
from voxblox_tpu_torch.core import grid  # noqa: E402
from voxblox_tpu_torch.core import hash as vhash  # noqa: E402
from voxblox_tpu_torch.core import layer as vlayer  # noqa: E402
from voxblox_tpu_torch.ops import raycast  # noqa: E402
from voxblox_tpu_torch.ops import tsdf as tt  # noqa: E402
from voxblox_tpu_torch.ops import tsdf_alloc  # noqa: E402
from voxblox_tpu_torch.utils import timing  # noqa: E402

HBM_BYTES_PER_S = 3.35e12
RAY_BYTES = 4 * (3 * 3 + 3 * 2 + 1)  # start, step, t_next, t_step, steps


def alloc_state(layer):
    """A copy of what allocation writes (table, block indices and flags,
    high-water mark); the channels are shared."""
    table = vhash.HashTable(**{f.name: getattr(layer.table, f.name).clone()
                               for f in dataclasses.fields(vhash.HashTable)})
    return dataclasses.replace(layer, table=table,
                               block_ijk=layer.block_ijk.clone(),
                               block_flags=layer.block_flags.clone(),
                               num_blocks=layer.num_blocks.clone())


def allocation_diff(a, b):
    """The names of what allocation writes that differ between two layers
    (empty when they allocated alike)."""
    out = [k for k in ("block_ijk", "block_flags", "num_blocks")
           if not torch.equal(getattr(a, k), getattr(b, k))]
    return out + [f.name for f in dataclasses.fields(vhash.HashTable)
                  if not torch.equal(getattr(a.table, f.name),
                                     getattr(b.table, f.name))]


def probes_each(table, w0, w1):
    """Cells each lookup of ``core/hash.lookup`` reads until its key or an
    empty cell, at most the probe bound + 1."""
    h = vhash.hash_words(w0, w1)
    n = torch.zeros(w0.shape, dtype=torch.int64, device=w0.device)
    done = torch.zeros(w0.shape, dtype=torch.bool, device=w0.device)
    for q in range(int(table.max_psl) + 1):
        idx = (h + q) & (table.capacity - 1)
        n += (~done).long()
        k1 = table.keys_w1[idx]
        done |= (((table.keys_w0[idx] == w0) & (k1 == w1))
                 | (k1 == grid.EMPTY_W1))
    return n


def first_discovery(path, layer, blocks, valid, block_steps):
    """The pending keys (w0, w1, ok) that the first round of ``path``
    (``tt._allocate_kernel`` or ``tt._allocate_chain``) finds, or None when
    nothing is missing; nothing is inserted and ``layer`` is only read."""
    found = []

    def one_round(layer, discover, pending_size):
        found.append(discover(layer.table))
        return layer, None

    real = vlayer.insert_pending
    vlayer.insert_pending = one_round
    try:
        path(layer, blocks, valid, block_steps)
    finally:
        vlayer.insert_pending = real
    return found[0]


def chain_candidates(blocks, valid, block_steps):
    """The chain's dilated candidates inside the walks' masks, packed."""
    bvox, bmask = raycast.cast_rays(blocks, block_steps, valid)
    offs = torch.tensor(tt._DILATE, dtype=torch.int32, device=bvox.device)
    cand = (bvox[None] + offs[:, None, None, :]).reshape(-1, 3)
    return grid.pack_block_index(cand[bmask[None].expand(
        (offs.shape[0],) + bmask.shape).reshape(-1)])


def _device_ms(fn, reps):
    """Device time of every kernel ``fn()`` launches, and of the find
    pass's, per call (torch.profiler over ``reps`` calls)."""
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    on_card = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    us = [e.time_range.elapsed_us() for e in on_card]
    find = [e.time_range.elapsed_us() for e in on_card
            if e.name.startswith("tsdf_alloc_kernel")]
    return sum(us) / 1e3 / reps, sum(find) / 1e3 / reps


def _event_ms(fn):
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    t0.record()
    out = fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1), out


def measure(workload: str, seed: int, warm: int = 200, n_scans: int = 4,
            reps: int = 3, root: str = ROOT, dev=None) -> dict:
    """The kernel against the chain on ``n_scans`` of the cell's scans
    after ``warm`` (see the module's docstring) on ``dev`` (CUDA card 0 by
    default)."""
    dev = dev or torch.device("cuda", 0)
    bench = harness.load_benchmark(root)
    cell, cfg_entry = harness.find_cell(bench, workload)
    cfg = harness.read_json(os.path.join(root, cfg_entry["file"]))
    traffic = harness.read_json(harness.traffic_file(root, cell["traffic"]))
    _, scans = scene.make_traffic_data(traffic, cfg["sensor"], seed, dev)
    srv = harness.build_server(cfg, dev)
    step = harness.make_step(srv, traffic)
    warm = min(warm, len(scans) - n_scans)
    for s in scans[:warm]:
        step(s)
    srv.check_overflow()
    torch.cuda.synchronize()

    caught = []
    real = tt.allocate_for_rays

    def spy(layer, setup, valid, max_steps):
        caught.append((alloc_state(layer), setup, valid, max_steps))
        return real(layer, setup, valid, max_steps)

    tt.allocate_for_rays = spy
    try:
        for s in scans[warm:warm + n_scans]:
            step(s)
    finally:
        tt.allocate_for_rays = real
    srv.check_overflow()

    kernel_ms, chain_ms, rounds = [], [], []
    disc_ms = {"kernel": [], "chain": []}
    disc_event_ms = {"kernel": [], "chain": []}
    find_ms, counters, chain_counted, chain_exact, needed = [], [], [], [], []
    for state, setup, valid, max_steps in caught:
        vps = state.vps
        steps = max(4, max_steps // vps + 3)
        blocks = raycast.block_segments(setup, vps)
        paths = dict(kernel=tt._allocate_kernel, chain=tt._allocate_chain)
        # The first round's discovery, on the state as the step found it.
        found = {k: first_discovery(f, state, blocks, valid, steps)
                 for k, f in paths.items()}
        if found["chain"] is None:
            assert found["kernel"] is None, "the kernel finds a missing key"
        else:
            for x, y in zip(found["kernel"], found["chain"]):
                assert torch.equal(x, y), "kernel and chain pend other keys"
        for k, f in paths.items():
            for _ in range(reps):
                disc_event_ms[k].append(_event_ms(lambda: first_discovery(
                    f, state, blocks, valid, steps))[0])
            ms, find = _device_ms(lambda: first_discovery(
                f, state, blocks, valid, steps), reps)
            disc_ms[k].append(ms)
            if k == "kernel":
                find_ms.append(find)
        timing.start_recording()
        first_discovery(tt._allocate_kernel, state, blocks, valid, steps)
        c = timing.stop_recording()["counters"]
        counters.append(c)
        timing.start_recording()
        first_discovery(tt._allocate_chain, state, blocks, valid, steps)
        chain_counted.append(int(timing.stop_recording()["counters"][
            "hash.probes"]))
        w0, w1 = chain_candidates(blocks, valid, steps)
        chain_exact.append(int(probes_each(state.table, w0, w1).sum()))
        del w0, w1
        # The find pass reads the rays and writes the buffer; the table
        # cells it probes are read once.
        needed.append(RAY_BYTES * int(valid.sum()) + valid.numel()
                      + 8 * (vlayer.PENDING_SIZE + 1)
                      + 12 * min(int(c["hash.probes"]), state.table.capacity))

        # The whole allocation, every round, on copies of the state.
        for _ in range(reps):
            finds = tsdf_alloc.LAUNCHES
            ms, (a, _) = _event_ms(lambda: tt._allocate_kernel(
                alloc_state(state), blocks, valid, steps))
            kernel_ms.append(ms)
            rounds.append(tsdf_alloc.LAUNCHES - finds)
            ms, (b, _) = _event_ms(lambda: tt._allocate_chain(
                alloc_state(state), blocks, valid, steps))
            chain_ms.append(ms)
            diff = allocation_diff(a, b)
            assert not diff, f"kernel and chain differ in {diff}"
            del a, b

    def per_scan(name):
        return statistics.fmean(c.get(name, 0) for c in counters)

    f_ms = statistics.median(find_ms)
    bound_ms = 1e3 * statistics.fmean(needed) / HBM_BYTES_PER_S
    lanes = caught[0][2].numel()
    steps = max(4, caught[0][3] // caught[0][0].vps + 3)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    med = statistics.median
    return {"workload": workload, "seed": seed, "card": smi,
            "warm_scans": warm, "scans": len(caught), "reps": reps,
            "lanes": lanes, "block_steps": steps,
            "kernel_discovery_ms": disc_ms["kernel"],
            "kernel_discovery_ms_median": med(disc_ms["kernel"]),
            "chain_discovery_ms": disc_ms["chain"],
            "chain_discovery_ms_median": med(disc_ms["chain"]),
            "find_pass_ms": find_ms, "find_pass_ms_median": f_ms,
            "kernel_discovery_event_ms_median": med(disc_event_ms["kernel"]),
            "chain_discovery_event_ms_median": med(disc_event_ms["chain"]),
            "kernel_path_ms": kernel_ms,
            "kernel_path_ms_median": med(kernel_ms),
            "chain_ms": chain_ms, "chain_ms_median": med(chain_ms),
            "rounds": rounds,
            "candidates": per_scan("integrate.alloc_candidates"),
            "candidates_as_the_chain": 7 * steps * lanes,
            "probed": per_scan("integrate.alloc_probed"),
            "missing": per_scan("integrate.alloc_missing"),
            "kernel_probes": per_scan("hash.probes"),
            "chain_probes_exact": statistics.fmean(chain_exact),
            "chain_probes_counted": statistics.fmean(chain_counted),
            "needed_bytes": statistics.fmean(needed),
            "bound_ms": bound_ms,
            "bound_share_pct": 100.0 * bound_ms / f_ms if f_ms else None,
            "blocks": int(srv.layer.num_blocks),
            "ptxas": tsdf_alloc.BUILD_INFO.get("ptxas", "(cached build)")}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--warm", type=int, default=200)
    ap.add_argument("--scans", type=int, default=4)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("tsdf_alloc_kernel: needs a CUDA card", file=sys.stderr)
        return 2
    print(json.dumps(measure(args.workload, args.seed, args.warm, args.scans,
                             args.reps)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
