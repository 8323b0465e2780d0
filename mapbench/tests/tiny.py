"""A tiny copy of the benchmark's files for CPU tests: the 5 cm merged
configuration shrunk (0.2 m voxels, a 64x48 camera, 8 poses), with the
tsdf_only mix, in a temporary root. A cell ``tiny.<method>`` runs the
configuration with that integrator (``merged``, or the program's
``projective``). ``add_rolling`` adds ``tiny.rolling``: a spinning
LiDAR on a vehicle round a small street, mapped by ``merged`` as a
rolling map."""

from __future__ import annotations

import json
import os
import shutil

import torch

from mapbench import harness

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CPU = torch.device("cpu")
CELL = "cow_and_lady.5cm.merged.tsdf_only"
SERVERS = {
    "merged": {"method": "merged"},
    "projective": {"method": "projective", "projective_resolution": [32, 24],
                   "projective_fov_deg": 60.0, "projective_pool": 2,
                   "projective_max_visible_blocks": 256,
                   "projective_max_mixed_slabs": 2048,
                   "projective_max_free_slabs": 512},
}


def make_root(tmp, methods=("merged",), poses=8, limits=None):
    """A benchmark root under ``tmp`` with one tiny cell per integrator,
    named ``tiny.<method>``; ``limits`` (default: the real cell's)."""
    mb = os.path.join(tmp, "mapbench")
    for d in ("traffic", "metrics"):
        shutil.copytree(os.path.join(REPO, "mapbench", d),
                        os.path.join(mb, d), dirs_exist_ok=True)
    os.makedirs(os.path.join(mb, "configs"), exist_ok=True)
    os.makedirs(os.path.join(mb, "limits"), exist_ok=True)
    with open(os.path.join(REPO, "mapbench", "configs",
                           "cow_and_lady.5cm.merged.json")) as f:
        base = json.load(f)
    base["sensor"].update(width=64, height=48)
    base["map"].update(voxel_size=0.2, max_blocks=256)
    base["tsdf"]["default_truncation_distance"] = 0.8
    path = os.path.join(mb, "traffic", "tsdf_only.json")
    with open(path) as f:
        t = json.load(f)
    t["orbit"]["poses"] = poses
    with open(path, "w") as f:
        json.dump(t, f)
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    configs, cells = [], []
    for m in methods:
        cfg = dict(base, name=f"tiny_{m}", server=SERVERS[m])
        with open(os.path.join(mb, "configs", f"tiny_{m}.json"), "w") as f:
            json.dump(cfg, f)
        configs.append(dict(bench["configs"][0], name=f"tiny_{m}",
                            file=f"mapbench/configs/tiny_{m}.json"))
        cells.append(dict(name=f"tiny.{m}", config=f"tiny_{m}",
                          traffic="tsdf_only", chips=1, why="a CPU test"))
        if limits is None:
            shutil.copy(harness.limits_file(REPO, CELL),
                        harness.limits_file(tmp, f"tiny.{m}"))
        else:
            with open(harness.limits_file(tmp, f"tiny.{m}"), "w") as f:
                json.dump(limits, f)
    bench["configs"], bench["workloads"] = configs, cells
    for m in bench["per_layer"]:
        m["workloads"] = [c["name"] for c in cells]
    with open(os.path.join(tmp, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return tmp


def small_windows(monkeypatch):
    """A traced sub-window of two scans and at most six window scans, so
    a CPU run stays short."""
    monkeypatch.setattr(harness, "TRACE_FIRST", 1)
    monkeypatch.setattr(harness, "TRACE_SCANS", 2)
    monkeypatch.setattr(harness, "WINDOW_SCANS_MAX", 6)


def run(root, method="merged", seed=2 ** 31 + 5, trace=False, keep=None):
    torch.manual_seed(0)
    return harness.run_cell(root, f"tiny.{method}", seed, 0.2, trace, CPU,
                            0.0, keep=keep)


ROLLING_SENSOR = {"model": "spherical", "width": 128, "height": 16,
                  "vfov_deg": [-24.8, 2.0], "max_range_m": 20.0}
ROLLING_TRAFFIC = {
    "name": "street_tiny", "ops": ["integrate"], "cloud": "flat",
    "warm_steps": 4, "layout_seed": 20261,
    "scene": {"cylinder_radius": 0, "cylinder_height": 0,
              "road": {"radius_m": 10.0, "half_width_m": 3.0},
              "buildings": {"frontage_m": [4, 8], "depth_m": [2, 4],
                            "height_m": [3, 8], "setback_m": [1, 2],
                            "gap_m": [1, 4]},
              "cars": {"count": 6, "size_m": [4.5, 1.8, 1.5]},
              "poles": {"count": 6, "radius_m": [0.15, 0.3],
                        "height_m": [4, 8], "offset_m": [0.3, 1.0]}},
    "orbit": {"mount": "vehicle", "poses": 16, "radius_m": 10.0,
              "height_m": 1.73, "jitter_m": 0.05}}


def add_rolling(root, reach=6.0, max_blocks=3072):
    """Add the cell ``tiny.rolling`` to a root from ``make_root``: 0.2 m
    voxels, 8 m rays, blocks farther than ``reach`` from the sensor
    dropped after every scan, and a pool of ``max_blocks``, enough for
    every block the loop ever makes (the program does not reuse the rows
    of dropped blocks)."""
    mb = os.path.join(root, "mapbench")
    with open(os.path.join(REPO, "mapbench", "configs",
                           "cow_and_lady.5cm.merged.json")) as f:
        cfg = json.load(f)
    cfg.update(name="tiny_rolling", sensor=ROLLING_SENSOR,
               server={"method": "merged",
                       "max_block_distance_from_body": reach})
    cfg["map"].update(voxel_size=0.2, max_blocks=max_blocks)
    cfg["tsdf"].update(default_truncation_distance=0.8, max_ray_length_m=8.0)
    with open(os.path.join(mb, "configs", "tiny_rolling.json"), "w") as f:
        json.dump(cfg, f)
    with open(harness.traffic_file(root, "street_tiny"), "w") as f:
        json.dump(ROLLING_TRAFFIC, f)
    shutil.copy(harness.limits_file(REPO, CELL),
                harness.limits_file(root, "tiny.rolling"))
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as f:
        bench = json.load(f)
    bench["configs"].append(dict(bench["configs"][0], name="tiny_rolling",
                                 file="mapbench/configs/tiny_rolling.json"))
    bench["workloads"].append(dict(name="tiny.rolling", config="tiny_rolling",
                                   traffic="street_tiny", chips=1,
                                   why="a CPU test"))
    for m in bench["per_layer"]:
        m["workloads"].append("tiny.rolling")
    with open(path, "w") as f:
        json.dump(bench, f)
    return root
