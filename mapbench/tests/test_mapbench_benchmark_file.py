"""BENCHMARK.json against the contract's shape, and every name it holds
resolved to the file that implements it."""

import json
import os
import re

from mapbench import harness

from .tiny import REPO

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _bench():
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        return json.load(f)


def test_top_level_keys_and_command():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["command"] == ["python3", "mapbench/run.py"]
    assert b["paths"] == ["mapbench"]
    assert 1 <= b["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(REPO, "BENCHMARK.json")) < 64 * 1024


def test_names_units_and_keys():
    b = _bench()
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and all(NAME.match(k)
                                             for k in c["reduced"])
        assert c["file"].startswith("mapbench/")
        assert os.path.exists(os.path.join(REPO, c["file"]))
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for kind in ("end_to_end", "per_layer"):
        for m in b[kind]:
            assert NAME.match(m["name"]) and UNIT.match(m["unit"])
            assert m["better"] in ("lower", "higher")
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(names) == len(set(names))
    assert {m["name"] for m in b["end_to_end"]} == {
        "scans_per_s", "scan_latency_p95_ms", "setup_s"}
    for m in b["end_to_end"]:
        assert set(m) == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in {e["name"] for e in b["end_to_end"]}


def test_every_name_resolves_to_its_file():
    b = _bench()
    cells = {w["name"] for w in b["workloads"]}
    for w in b["workloads"]:
        assert os.path.exists(harness.traffic_file(REPO, w["traffic"]))
        assert os.path.exists(harness.limits_file(REPO, w["name"]))
    for m in b["per_layer"]:
        assert set(m["workloads"]) <= cells
        assert callable(harness.load_metric(REPO, m["name"]).read)
    # Every cell reports setup_s, another end-to-end metric and a
    # per-layer metric.
    for c in cells:
        assert len(harness.cell_metrics(b, c, "end_to_end")) >= 2
        assert harness.cell_metrics(b, c, "per_layer")
