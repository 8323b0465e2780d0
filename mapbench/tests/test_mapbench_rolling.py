"""A rolling map (``server.max_block_distance_from_body``) on the tiny
street cell: the reference drops distant blocks after each scan as
voxblox does, judges the program's map at 0 off on the CPU, catches a
program that drops none or drops at half the distance, fails the
control, and a replay of the suffix ``rolling_start`` picks leaves the
map of the whole replay."""

import pytest
import torch

from mapbench import checks, control
from mapbench.reference.store import BlockStore, remove_distant_blocks
from voxblox_tpu_torch.core import layer as vlayer

from .tiny import CPU, add_rolling, make_root, run, small_windows

REACH = 6.0


@pytest.fixture(scope="module")
def rolling_run(tmp_path_factory):
    """One tiny rolling run, its kept inputs and its reference map."""
    with pytest.MonkeyPatch.context() as mp:
        small_windows(mp)
        root = add_rolling(make_root(str(tmp_path_factory.mktemp("r"))),
                           reach=REACH)
        keep = {}
        res, extra = run(root, "rolling", seed=2 ** 31 + 17, keep=keep)
    return res, extra, keep


def _origins(keep):
    return [keep["scans"][i][1] for i in keep["handed"]]


def test_rolling_map_exact(rolling_run):
    res, extra, keep = rolling_run
    assert res["failed"] == 0
    assert res["checks"]["tsdf"]["value"] == 0.0
    assert res["correct"] is True
    ref = checks.replay(keep["cfg"], keep["traffic"], keep["scans"],
                        keep["handed"], CPU, torch.float32)
    assert int((ref.ch["weight"] > 0).sum()) > 5000
    # Removal did work: the pool's high-water row count is far above the
    # blocks left, and every block left lies within reach.
    assert extra["blocks"] > 4 * ref.n
    bs = ref.voxel_size * ref.vps
    centres = (ref.ijk[:ref.n].float() + 0.5) * bs
    last = keep["scans"][keep["handed"][-1]][1]
    assert float(torch.linalg.norm(centres - last, dim=-1).max()) <= REACH


def test_control_is_not_correct(rolling_run):
    res, _, keep = rolling_run
    numbers, ok = control.control_numbers(keep, CPU)
    assert ok is False
    assert numbers["tsdf"]["value"] > 3 * numbers["tsdf"]["limit"], numbers


def _never(monkeypatch):
    monkeypatch.setattr(vlayer, "remove_distant_blocks",
                        lambda layer, center, d: layer)


def _half(monkeypatch):
    orig = vlayer.remove_distant_blocks
    monkeypatch.setattr(vlayer, "remove_distant_blocks",
                        lambda layer, center, d: orig(layer, center, d / 2))


@pytest.mark.parametrize("fault", [_never, _half], ids=["never", "half"])
def test_removal_faults_are_not_correct(tmp_path, monkeypatch, fault):
    small_windows(monkeypatch)
    root = add_rolling(make_root(str(tmp_path)), reach=REACH)
    fault(monkeypatch)
    res, _ = run(root, "rolling", seed=2 ** 31 + 19)
    assert res["correct"] is False, res["checks"]
    assert res["checks"]["tsdf"]["value"] > 0.05


def test_suffix_replay_leaves_the_whole_replays_map(rolling_run, monkeypatch):
    _, _, keep = rolling_run
    start = checks.rolling_start(_origins(keep), REACH)
    assert 0 < start < len(keep["handed"]) - 2
    args = (keep["cfg"], keep["traffic"], keep["scans"], keep["handed"],
            CPU, torch.float32)
    suffix = checks.replay(*args)
    monkeypatch.setattr(checks, "rolling_start", lambda origins, reach: 0)
    whole = checks.replay(*args)
    assert suffix.n == whole.n > 0
    rows = whole.rows_of(suffix.ijk[:suffix.n])
    assert bool((rows >= 0).all())
    for name in ("tsdf", "weight"):
        assert torch.equal(suffix.ch[name][:suffix.n], whole.ch[name][rows])


def test_removed_block_comes_back_empty():
    s = BlockStore(2, 8, {"tsdf": torch.float32}, CPU)
    s.voxel_size = 1.0
    rows = s.add(torch.tensor([[0, 0, 0], [10, 0, 0], [1, 0, 0]]))
    s.ch["tsdf"][rows] = torch.tensor([1.0, 2.0, 3.0])[:, None]
    remove_distant_blocks(s, torch.tensor([0.0, 0.0, 0.0]), 5.0)
    assert s.n == 2
    assert s.rows_of(torch.tensor([[10, 0, 0]])).item() == -1
    kept = s.rows_of(torch.tensor([[0, 0, 0], [1, 0, 0]]))
    assert s.ch["tsdf"][kept, 0].tolist() == [1.0, 3.0]
    assert bool((s.ch["tsdf"][s.n:] == 0).all())
    again = s.add(torch.tensor([[10, 0, 0]]))
    assert bool((s.ch["tsdf"][again] == 0).all())
