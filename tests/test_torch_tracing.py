"""The port's spans and counters (``voxblox_tpu_torch/utils/timing.py``)
inside the merged TSDF step, on the CPU: recording off leaves nothing and
syncs as the step always did; recording on gives the six stage spans as
siblings under ``integrate/merged``, per-span syncs that add up, the walk
and hash counters against independent counts, and host times on the
clock of torch.profiler's trace."""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from voxblox_tpu_torch import _runtime
from voxblox_tpu_torch.core import hash as vhash
from voxblox_tpu_torch.core.config import MapConfig, TsdfIntegratorConfig
from voxblox_tpu_torch.ops import raycast, tsdf_walk
from voxblox_tpu_torch.server.mapper import TsdfServer
from voxblox_tpu_torch.utils import timing

STAGES = ["integrate.bundle", "integrate.allocate", "integrate.walk",
          "integrate.weigh", "integrate.lookup", "integrate.scatter"]
POSE = (np.eye(3, dtype=np.float32), np.zeros(3, np.float32))


def _cloud(n=3000, seed=0):
    """A wall and a floor in front of the sensor, a few points too far
    (clearing rays) and a few too close (invalid)."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform([-1.5, -1.0, 2.0], [1.5, 1.0, 2.5], (n, 3))
    pts[: n // 4, 1] = 1.0  # floor
    pts[-20:] *= 5.0  # beyond max_ray_length_m
    pts[:10] *= 0.01  # closer than min_ray_length_m
    return pts.astype(np.float32)


@pytest.fixture
def server():
    timing.stop_recording()
    srv = TsdfServer(MapConfig(voxel_size=0.1, max_blocks=256),
                     TsdfIntegratorConfig(default_truncation_distance=0.3,
                                          max_ray_length_m=6.0),
                     method="merged", device="cpu")
    srv.insert_pointcloud(POSE, _cloud())  # allocates the map's blocks
    yield srv
    timing.stop_recording()


def test_recording_off_leaves_nothing(server, monkeypatch):
    """Off: no record, no counter, no CUDA event, and the step's four
    syncs (allocation: the probe bound and ``missing.any()``; the walk
    samples' lookup: the probe bound; ``check_overflow``)."""

    def no_event(*a, **k):
        raise AssertionError("a CUDA event while recording is off")

    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "Event", no_event)
    s0 = _runtime.SYNCS
    server.insert_pointcloud(POSE, _cloud())
    assert _runtime.SYNCS - s0 == 4
    assert not timing.recording()
    assert timing.summary() == {"spans": {}, "counters": {}, "records": []}


def test_stage_spans_are_siblings_with_their_syncs(server):
    timing.start_recording()
    s0 = _runtime.SYNCS
    server.insert_pointcloud(POSE, _cloud())  # no new block: 4 syncs
    server.insert_pointcloud(POSE, _cloud())
    syncs = _runtime.SYNCS - s0
    rec = timing.stop_recording()
    recs = rec["records"]
    tops = [r for r in recs if r["tag"] == "integrate/merged"]
    assert [r["scan"] for r in tops] == [1, 2]
    for top in tops:
        kids = [r for r in recs if r["parent"] == top["id"]]
        assert [r["tag"] for r in kids] == STAGES
        assert all(r["scan"] == top["scan"] for r in kids)
        for a, b in zip(kids, kids[1:]):  # siblings, never nested
            assert a["end_ns"] <= b["start_ns"]
        assert top["start_ns"] <= kids[0]["start_ns"]
        assert kids[-1]["end_ns"] <= top["end_ns"]
    overflow = [r for r in recs if r["tag"] == "server.check_overflow"]
    assert [r["parent"] for r in overflow] == [None, None]
    assert [r["scan"] for r in overflow] == [1, 2]
    assert sum(r["syncs"] for r in recs) == syncs
    assert rec["spans"]["integrate.allocate"]["syncs"] == 4
    assert rec["spans"]["integrate.lookup"]["syncs"] == 2
    assert rec["spans"]["server.check_overflow"]["syncs"] == 2
    assert rec["spans"]["integrate/merged"]["calls"] == 2
    top = rec["spans"]["integrate/merged"]
    assert 0.0 < top["self_host_ms"] < top["host_ms"]
    assert top["device_ms"] is None  # no CUDA events on the CPU
    d = timing.as_dict()["integrate.walk"]
    assert d["syncs"] == 0 and d["device_ms"] is None


def test_counters_match_independent_counts(server, monkeypatch):
    walks, lookups = [], []
    cast_rays, lookup = raycast.cast_rays, vhash.lookup

    def spy_cast(*a, **k):
        out = cast_rays(*a, **k)
        walks.append(out[1])
        return out

    def spy_lookup(table, w0, w1, max_psl=None):
        bound = int(table.max_psl) if max_psl is None else max_psl
        lookups.append(w0.numel() * (bound + 1))
        return lookup(table, w0, w1, max_psl)

    monkeypatch.setattr(raycast, "cast_rays", spy_cast)
    monkeypatch.setattr(vhash, "lookup", spy_lookup)
    timing.start_recording()
    server.insert_pointcloud(POSE, _cloud(seed=3))
    c = timing.stop_recording()["counters"]
    # The allocation's block walk, then the voxel walk.
    assert len(walks) == 2
    mask = walks[-1]
    assert c["integrate.walk_samples"] == mask.shape[0] * mask.shape[1]
    assert c["integrate.walk_samples_useful"] == int(mask.sum())
    assert 0 < c["integrate.walk_samples_useful"] < c[
        "integrate.walk_samples"]
    assert c["hash.probes"] == sum(lookups)
    assert c["hash.lookup_lanes"] <= c["hash.probes"]


def test_recording_follows_the_profiler_on_its_clock(server, tmp_path):
    """Under torch.profiler every span is recorded, inside its
    ``user_annotation`` (``ts`` plus ``baseTimeNanoseconds``) and starting
    within 100 us of it;
    the first span after the profiler closes the recording, which stays
    readable until the next one."""
    server.insert_pointcloud(POSE, _cloud(seed=4))  # warm the labels
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        server.insert_pointcloud(POSE, _cloud(seed=5))
    server.insert_pointcloud(POSE, _cloud(seed=6))
    recs = timing.summary()["records"]
    assert {r["scan"] for r in recs} == {2}
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    base_us = trace["baseTimeNanoseconds"] / 1e3
    spans = {}
    for e in trace["traceEvents"]:
        if e.get("cat") == "user_annotation":
            t0 = float(e["ts"]) + base_us
            spans.setdefault(e["name"], []).append((t0, t0 + float(e["dur"])))
    labels = {"integrate/merged": "integrate_merged"}
    assert len(recs) == len(STAGES) + 2
    offsets = []
    for r in recs:
        got = spans[labels.get(r["tag"], r["tag"])]
        assert len(got) == 1, r["tag"]
        (a0, a1), r0, r1 = got[0], r["start_ns"] / 1e3, r["end_ns"] / 1e3
        # Inside its annotation (1 us of rounding), on the same clock.
        assert a0 - 1.0 <= r0 <= r1 <= a1 + 1.0, r["tag"]
        offsets.append(r0 - a0)
    # Within 100 us of the annotation's start; the median, so that a
    # thread preempted between the two clock reads fails no span.
    assert sorted(offsets)[len(offsets) // 2] < 100.0, offsets


def test_device_counts_fold_and_sum(server):
    timing.start_recording()
    for _ in range(timing._FOLD + 3):
        timing.count("x", torch.ones((), dtype=torch.int32))
    timing.count("x", 5)
    timing.count("y", 2)
    c = timing.stop_recording()["counters"]
    assert c == {"x": timing._FOLD + 8, "y": 2}


@pytest.mark.parametrize("lanes,steps,max_steps,slots,useful", [
    # One valid lane whose walk visits 10 voxels (num_steps 9) among 32.
    (32, {5: 9}, 100, 320, 10),
    # Lanes 0, 1 and 33 of 40: warps of 24 and 9 samples.
    (40, {0: 23, 1: 13, 33: 8}, 100, 32 * 24 + 32 * 9, 47),
    # A walk cut at max_steps; a zero-length ray still visits one voxel.
    (64, {3: 500, 40: 0}, 120, 32 * 120 + 32 * 1, 121),
    (70, {}, 50, 0, 0),
])
def test_warp_slot_count(lanes, steps, max_steps, slots, useful):
    """``integrate.walk_samples`` on the kernel's path counts each warp of
    32 consecutive lanes as running as long as its longest walk."""
    num_steps = torch.randint(0, 300, (lanes,), dtype=torch.int32)
    valid = torch.zeros(lanes, dtype=torch.bool)
    for lane, n in steps.items():
        num_steps[lane] = n
        valid[lane] = True
    lengths = tsdf_walk.walk_lengths(num_steps, valid, max_steps)
    assert int(tsdf_walk.warp_slots(lengths)) == slots
    assert int(lengths.sum()) == useful
