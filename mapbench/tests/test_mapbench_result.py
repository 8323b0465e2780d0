"""The result line: exactly the contract's keys, the compared numbers
last; and no result at all without a card or without the program."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from mapbench import run as runmod

from .tiny import REPO, make_root, run, small_windows

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("trace", [False, True])
def test_result_keys(tmp_path, monkeypatch, trace):
    small_windows(monkeypatch)
    root = make_root(str(tmp_path))
    res, _ = run(root, trace=trace)
    want = KEYS + (["breakdown"] if trace else []) + ["checks"]
    assert list(res) == want
    line = json.loads(json.dumps(res))
    assert list(line)[-1] == "checks"
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}
    dev = line["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    if trace:
        assert dev["window_s"] > 0.0
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        # Per-layer metrics only; the run's counters are there on the CPU.
        assert line["metrics"]["server.host_syncs_per_scan"]["value"] > 0
        assert "scans_per_s" not in line["metrics"]
    else:
        assert set(line["metrics"]) == {"scans_per_s",
                                        "scan_latency_p95_ms", "setup_s"}
        assert line["attempted"] > 0 and line["failed"] == 0


def _cli(cwd, env_extra=None):
    env = dict(os.environ, **(env_extra or {}))
    return subprocess.run(
        [sys.executable, "mapbench/run.py", "--workload",
         "cow_and_lady.5cm.merged.tsdf_only", "--seed", "3000000001",
         "--seconds", "1", "--trace", "0"], cwd=cwd, capture_output=True,
        text=True, env=env, timeout=300)


def test_no_card_no_result():
    """This machine has no CUDA card: the run refuses and prints nothing."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    p = _cli(REPO)
    assert p.returncode != 0 and p.stdout == ""
    assert "CUDA" in p.stderr


def test_lone_benchmark_directory_no_result(tmp_path):
    """A directory holding only BENCHMARK.json and mapbench/ lacks the
    program: the run exits non-zero and prints no result."""
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(REPO, "mapbench"),
                    os.path.join(tmp_path, "mapbench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _cli(str(tmp_path), {"PYTHONPATH": ""})
    assert p.returncode != 0 and p.stdout == ""


def test_forbidden_modules_compare_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "voxblox_tpu_torch_fake", object())
    assert runmod.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "voxblox_tpu.fake", object())
    assert runmod.forbidden_modules() == ["voxblox_tpu"]
