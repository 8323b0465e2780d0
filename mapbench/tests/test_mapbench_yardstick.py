"""The frozen relaxation and its work count give the program's plain
relaxation's results and chip_smoke.py's numbers."""

import importlib
import sys

import pytest
import torch

from mapbench import yardstick
from mapbench.reference import relax as frelax


def _inputs(n, seed, scale):
    g = torch.Generator().manual_seed(seed)
    d = (torch.rand((n, 18, 18, 18), generator=g) * 5.0 - 2.5) * scale
    obs = torch.rand(d.shape, generator=g) < 0.8
    upd = torch.zeros(d.shape, dtype=torch.bool)
    upd[:, 1:-1, 1:-1, 1:-1] = torch.rand((n, 16, 16, 16), generator=g) < 0.7
    act = torch.rand(n, generator=g) < 0.5
    return d, obs, upd, act


def test_unit_block_sweep_operations():
    assert yardstick.OPS_PER_BLOCK_SWEEP == 416_976
    assert yardstick.PEAK_OPS == 132 * 128 * 1.98e9
    assert yardstick.PEAK_BYTES == 3.35e12


@pytest.mark.parametrize("seed,voxel,maxd", [(0, 0.05, 2.0), (1, 0.02, 1.0)])
def test_frozen_relax_equals_the_programs_plain(seed, voxel, maxd):
    from voxblox_tpu_torch.ops import esdf_relax
    x = _inputs(6, seed, maxd / 2.0)
    want = esdf_relax.relax_plain(*x, 4, voxel, maxd, 0.001)
    got = frelax.relax(*x, 4, voxel, maxd, 0.001)
    assert torch.equal(got, want)


@pytest.fixture
def chip_smoke(monkeypatch):
    """chip_smoke.py, imported with the card check answered yes (its
    functions then run on CPU tensors through the plain relaxation)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    sys.modules.pop("chip_smoke", None)
    mod = importlib.import_module("chip_smoke")
    yield mod
    sys.modules.pop("chip_smoke", None)


@pytest.mark.parametrize("seed,voxel,maxd", [(3, 0.05, 2.0), (4, 0.02, 1.0)])
def test_work_count_matches_chip_smoke(chip_smoke, seed, voxel, maxd):
    x = _inputs(5, seed, maxd / 2.0)
    assert yardstick.OPS_PER_BLOCK_SWEEP == chip_smoke.OPS_PER_BLOCK_SWEEP
    assert yardstick.PEAK_OPS == chip_smoke.PEAK_OPS
    assert yardstick.PEAK_BYTES == chip_smoke.PEAK_BYTES
    want = chip_smoke.relax_work(x, (1,) * 4, voxel, maxd)
    got = yardstick.relax_work(*x, 4, voxel, maxd, chip_smoke.MIN_DIFF)
    assert got == want
