"""Configurations, traffic mixes and per-layer metrics are found by name:
a file dropped into a benchmark root is picked up with no edit."""

import json
import os

from mapbench import harness

from .tiny import make_root, run, small_windows


def test_new_mix_and_metric_are_found_without_an_edit(tmp_path,
                                                      monkeypatch):
    small_windows(monkeypatch)
    root = make_root(str(tmp_path))
    # A new traffic mix: the tsdf_only mix with two warm steps.
    with open(harness.traffic_file(root, "tsdf_only")) as f:
        mix = json.load(f)
    mix.update(name="tsdf_only_short_warm", warm_steps=2)
    with open(harness.traffic_file(root, "tsdf_only_short_warm"), "w") as f:
        json.dump(mix, f)
    # A new per-layer metric, a reader file of its own.
    with open(harness.metric_file(root, "test.scans_traced"), "w") as f:
        f.write("def read(ctx):\n    return float(ctx['scans'])\n")
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["workloads"].append(dict(name="tiny.short_warm",
                                   config="tiny_merged",
                                   traffic="tsdf_only_short_warm",
                                   chips=1, why="a CPU test"))
    bench["per_layer"].append(dict(
        name="test.scans_traced", unit="scans", better="higher",
        source="program_counter", layer="server step",
        moves="scans_per_s", workloads=["tiny.short_warm"]))
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    with open(harness.limits_file(root, "tiny.merged")) as f:
        limits = f.read()
    with open(harness.limits_file(root, "tiny.short_warm"), "w") as f:
        f.write(limits)
    res, _ = run(root, "short_warm", trace=True)
    assert res["metrics"]["test.scans_traced"]["value"] == 2.0
    assert set(res["checks"]) == {"tsdf"}


def test_metric_reader_found_by_name():
    from .tiny import REPO
    mod = harness.load_metric(REPO, "device.idle_share")
    assert mod.read(dict(window_s=2.0, busy_s=0.5)) == 75.0
    assert mod.read(dict(window_s=0.0, busy_s=0.0)) is None
