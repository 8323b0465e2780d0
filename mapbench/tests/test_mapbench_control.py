"""The comparison fails what it should: the control (the reference in
bfloat16 in the program's place) and a run whose timed path is broken
underneath, with the card check skipped, both come out not correct
against the real cell's limits.

The faults the cell can have: a step that leaves the map unchanged; half
of a scan left out; the map altered where it is produced. The cell runs
on one card, so it has no exchange between cards to leave out."""

import pytest
import torch

from mapbench import control
from voxblox_tpu_torch.ops import tsdf as tsdf_ops
from voxblox_tpu_torch.server import mapper

from .tiny import CPU, make_root, run, small_windows


def test_control_is_not_correct(tmp_path, monkeypatch):
    small_windows(monkeypatch)
    root = make_root(str(tmp_path))
    keep = {}
    res, _ = run(root, seed=9_000_000_001, keep=keep)
    assert res["correct"] is True
    numbers, ok = control.control_numbers(keep, CPU)
    assert ok is False
    assert set(numbers) == {"tsdf"}
    assert numbers["tsdf"]["value"] > 3 * numbers["tsdf"]["limit"], numbers


def _unchanged(monkeypatch):
    monkeypatch.setattr(mapper.TsdfServer, "insert_pointcloud",
                        lambda self, T, p, c=None: T)


def _half_scan(monkeypatch):
    orig = tsdf_ops.integrate_pointcloud

    def half(layer, T, pts, cols, *a, **k):
        pts = pts.clone()
        pts[: pts.shape[0] // 2] = 0.0  # no return: left out
        return orig(layer, T, pts, cols, *a, **k)

    monkeypatch.setattr(tsdf_ops, "integrate_pointcloud", half)


def _map_altered(monkeypatch):
    orig = tsdf_ops.integrate_pointcloud

    def altered(*a, **k):
        out = orig(*a, **k)
        out[0].channels["tsdf"].add_(1e-3)
        return out

    monkeypatch.setattr(tsdf_ops, "integrate_pointcloud", altered)


FAULTS = {"unchanged": _unchanged, "half_scan": _half_scan,
          "map_altered": _map_altered}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_broken_path_is_not_correct(tmp_path, monkeypatch, fault):
    small_windows(monkeypatch)
    root = make_root(str(tmp_path))
    FAULTS[fault](monkeypatch)
    res, _ = run(root, seed=9_000_000_002)
    assert res["correct"] is False, res["checks"]
