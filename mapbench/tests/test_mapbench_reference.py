"""The reference against the port's CPU path on a tiny scene.

The merged integrator's map agrees exactly on the CPU. The projective
integrator's map differs from the reference in at most one block, the
one in the first row of the program's block pool, which the program
never updates (a fault of the program, left to a program PR); at this
size that block holds no observed voxel, so the projective map agrees
too."""

import pytest
import torch

from mapbench import checks, harness

from .tiny import CPU, make_root, run, small_windows


def _off_blocks(prog, ref):
    """Blocks (as tuples) holding a voxel the comparison counts off."""
    ra = prog.rows_of(ref.ijk[:ref.n])
    has = ra >= 0
    w_r = ref.ch["weight"][:ref.n]
    w_c = torch.where(has[:, None], prog.ch["weight"][ra.clamp(min=0)], 0.0)
    d_r = ref.ch["tsdf"][:ref.n]
    d_c = torch.where(has[:, None], prog.ch["tsdf"][ra.clamp(min=0)], 0.0)
    o_r, o_c = w_r > 0, w_c > 0
    off = (o_r != o_c) | (o_r & o_c & (
        ((d_r - d_c).abs() > checks.D_TOL)
        | ((w_r - w_c).abs() > checks.W_TOL * torch.maximum(w_r, w_c))))
    return {tuple(b) for b in ref.ijk[:ref.n][off.any(1)].tolist()}


def _run_and_reference(root, method, seed):
    """A tiny run and the reference map of its hand-offs."""
    keep = {}
    res, _ = run(root, method, seed=seed, keep=keep)
    ref = checks.replay(keep["cfg"], keep["traffic"], keep["scans"],
                        keep["handed"], CPU, torch.float32)
    return res, keep, ref


@pytest.mark.parametrize("seed", [7_000_000_001, 2 ** 31 + 99])
def test_merged_map_exact(tmp_path, monkeypatch, seed):
    small_windows(monkeypatch)
    root = make_root(str(tmp_path), methods=("merged",))
    res, _, ref = _run_and_reference(root, "merged", seed)
    assert ref.n > 10 and int((ref.ch["weight"] > 0).sum()) > 5000
    assert res["checks"]["tsdf"]["value"] == 0.0
    assert res["correct"] is True


def test_projective_differs_at_most_in_the_first_pool_row(tmp_path,
                                                          monkeypatch):
    small_windows(monkeypatch)
    root = make_root(str(tmp_path), methods=("projective",))
    res, keep, ref = _run_and_reference(root, "projective", 7_000_000_003)
    assert int((ref.ch["weight"] > 0).sum()) > 5000
    assert res["checks"]["tsdf"]["value"] == 0.0
    # The program's map of the same hand-offs, on a fresh server.
    srv = harness.build_server(keep["cfg"], CPU)
    step = harness.make_step(srv, keep["traffic"])
    for i in keep["handed"]:
        step(keep["scans"][i])
    srv.check_overflow()
    prog = checks.program_store(harness.map_rows(srv), keep["cfg"])
    row0 = tuple(srv.layer.block_ijk[0].tolist())
    assert _off_blocks(prog, ref) <= {row0}
