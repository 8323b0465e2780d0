"""Port parity, the ``sim-bench`` harness: ``sim/world.generate_gt_layer``,
``utils/evaluation``, ``SimulationServer.run`` and ``cli sim-bench``.

``SimulationServer.run`` goes through both packages at 0.2 m, 3
viewpoints, 64x48, the merged integrator and a 128-block pool: once with
occupancy and the incremental ESDF, once without occupancy and with the
batch ESDF. The JAX side runs in a subprocess (started first, so that the
two packages run side by side) and writes numpy arrays to ``tmp_path``.
The poses must be equal; the rows agree within the merged integrator's
own spread (its maps are held at a share of voxels, ROADMAP Queue 3):
evaluated counts within 3%, rmse within 10% relative, and every row within
tests/test_server.py's bounds (TSDF and ESDF under 2 voxels,
misclassified occupancy under 0.15, ESDF from occupancy under 4 voxels).
"""

import dataclasses
import os
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voxblox_tpu.core import layer as jlayer
from voxblox_tpu.sim import world as jsw
from voxblox_tpu.utils import evaluation as jeval
from voxblox_tpu_torch.core import layer as tlayer
from voxblox_tpu_torch.io import layer_io
from voxblox_tpu_torch.server import cli as tcli
from voxblox_tpu_torch.server.mapper import SimulationServer
from voxblox_tpu_torch.sim import world as tsw
from voxblox_tpu_torch.utils import evaluation as teval

import torch_parity

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOXEL = 0.2
RUNS = {"occ": dict(generate_occupancy=True),
        "batch": dict(incremental_esdf=False)}
SIM = dict(voxel_size=VOXEL, camera_res=(64, 48), method="merged",
           max_blocks=128)


def _world(pkg):
    w = pkg.SimulationWorld()
    w.add_cylinder((0.0, 0.0, 2.0), 2.0, 4.0, color=(0, 255, 0))
    w.add_ground_level(0.0)
    w.min_bound = np.array([-5.0, -5.0, -0.5], np.float32)
    w.max_bound = np.array([5.0, 5.0, 5.5], np.float32)
    return w


_JAX_SIDE = textwrap.dedent("""
    import sys
    import numpy as np
    from voxblox_tpu.server.mapper import SimulationServer
    from voxblox_tpu.sim import world as sw
    sys.path.insert(0, "tests")
    import test_torch_sim_bench as T

    out = {}
    for name, kw in T.RUNS.items():
        srv = SimulationServer(T._world(sw), **T.SIM, **kw)
        poses = srv.generate_poses(3, seed=0)
        out[name + "/R"] = np.stack([np.asarray(p[0]) for p in poses])
        out[name + "/t"] = np.stack([np.asarray(p[1]) for p in poses])
        res = srv.run(3, seed=0)
        for row in ("tsdf", "esdf", "esdf_occ"):
            if row in res:
                r = res[row]
                out[f"{name}/{row}"] = np.asarray(
                    [r.rmse, r.num_evaluated_voxels, r.max_error])
        if "occ" in res:
            out[name + "/occ"] = np.asarray(
                [res["occ"]["misclassified_frac"],
                 res["occ"]["num_evaluated_voxels"]])
        out[name + "/timing"] = np.asarray(sorted(res["timing"]))
    np.savez(sys.argv[1] + "/jax.npz", **out)
""")


def test_generate_gt_layer_matches_jax():
    for kind, max_dist in (("tsdf", 0.8), ("esdf", 2.0)):
        ref = jsw.generate_gt_layer(_world(jsw).freeze(), kind, VOXEL,
                                    (-5.0, -5.0, -0.5), (5.0, 5.0, 5.5),
                                    max_dist=max_dist, vps=16, max_blocks=256)
        got = tsw.generate_gt_layer(_world(tsw).freeze("cpu"), kind, VOXEL,
                                    (-5.0, -5.0, -0.5), (5.0, 5.0, 5.5),
                                    max_dist=max_dist, vps=16, max_blocks=256)
        torch_parity.assert_layers_equal(
            torch_parity.jax_layer_to_numpy(ref), tlayer.layer_to_numpy(got),
            atol=1e-5)
    with pytest.raises(AssertionError, match="GT world needs"):
        tsw.generate_gt_layer(_world(tsw).freeze("cpu"), "esdf", VOXEL,
                              (-5.0, -5.0, -0.5), (5.0, 5.0, 5.5), 2.0,
                              max_blocks=64)


def test_evaluation_matches_jax():
    """evaluate_layers_rmse (with and without ignoring behind the test
    surface), count_observed and is_same_layer on a GT TSDF and a noisy,
    partly missing copy in another pool order."""
    gt_j = jsw.generate_gt_layer(_world(jsw).freeze(), "tsdf", VOXEL,
                                 (-5.0, -5.0, -0.5), (5.0, 5.0, 5.5),
                                 max_dist=0.8, vps=16, max_blocks=256)
    gt = torch_parity.jax_layer_to_numpy(gt_j)
    n = int(gt["num_blocks"])
    rng = np.random.default_rng(0)
    keep = np.zeros(len(gt["block_ijk"]), bool)
    keep[:n] = rng.uniform(size=n) < 0.7
    ijk = gt["block_ijk"][keep][::-1].copy()  # another pool order
    test_t = tlayer.make_layer("tsdf", VOXEL, vps=16, max_blocks=256,
                               device="cpu")
    test_t, _ = tlayer.allocate_blocks(test_t, torch.as_tensor(ijk),
                                       torch.ones(len(ijk), dtype=torch.bool))
    rows = np.nonzero(keep)[0][::-1]
    noise = rng.normal(0.0, 0.05, (len(rows), 4096)).astype(np.float32)
    w = gt["channel/weight"][rows] * (rng.uniform(size=noise.shape) < 0.9)
    test_t.channels["tsdf"][:len(rows)] = torch.as_tensor(
        gt["channel/tsdf"][rows] + noise)
    test_t.channels["weight"][:len(rows)] = torch.as_tensor(w)
    test_j = tlayer.layer_to_numpy(test_t)
    test_jl = dataclasses.replace(
        jlayer.make_layer("tsdf", VOXEL, vps=16, max_blocks=256),
        **{k: jnp.asarray(test_j[k]) for k in ("block_ijk", "block_flags",
                                                "num_blocks")},
        channels={k: jnp.asarray(test_j[f"channel/{k}"])
                  for k in ("tsdf", "weight", "color")})
    test_jl = dataclasses.replace(test_jl, table=type(test_jl.table)(
        **{k: jnp.asarray(test_j[f"table/{k}"])
           for k in torch_parity.TABLE_FIELDS}))
    gt_t = tlayer.layer_from_numpy(gt, "cpu")
    for ignore in (False, True):
        ref = jeval.evaluate_layers_rmse(gt_j, test_jl, ignore)
        got = teval.evaluate_layers_rmse(gt_t, test_t, ignore)
        for f in ("num_evaluated_voxels", "num_ignored_voxels",
                  "num_overlapping_voxels", "num_non_overlapping_voxels"):
            assert getattr(got, f) == getattr(ref, f), f
        for f in ("rmse", "min_error", "max_error"):
            assert abs(getattr(got, f) - getattr(ref, f)) <= 1e-6, f
        assert ref.num_evaluated_voxels > 5_000
    assert teval.count_observed(test_t) == jeval.count_observed(test_jl)
    assert teval.is_same_layer(gt_t, tlayer.clone_layer(gt_t))
    assert not teval.is_same_layer(gt_t, test_t)
    other = tlayer.clone_layer(gt_t)
    other.channels["tsdf"] += 1e-4
    assert not teval.is_same_layer(gt_t, other)
    assert teval.is_same_layer(gt_t, other, atol=1e-3)
    assert jeval.is_same_layer(gt_j, gt_j)


def _row(r):
    return np.asarray([r.rmse, r.num_evaluated_voxels, r.max_error])


def _assert_row(got, ref, what):
    assert abs(got[1] - ref[1]) <= 0.03 * ref[1], (what, got, ref)
    assert abs(got[0] - ref[0]) <= 0.1 * ref[0], (what, got, ref)


def test_simulation_server_matches_jax(tmp_path):
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.Popen([sys.executable, "-c", _JAX_SIDE, str(tmp_path)],
                            cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        got = {}
        for name, kw in RUNS.items():
            srv = SimulationServer(_world(tsw), device="cpu", **SIM, **kw)
            poses = srv.generate_poses(3, seed=0)
            got[name + "/R"] = np.stack([p[0].numpy() for p in poses])
            got[name + "/t"] = np.stack([p[1].numpy() for p in poses])
            got[name] = srv.run(3, seed=0)
        _, err = proc.communicate(timeout=600)
    finally:
        proc.kill()
    assert proc.returncode == 0, err[-4000:]
    z = np.load(tmp_path / "jax.npz")
    for name in RUNS:
        np.testing.assert_array_equal(got[name + "/R"], z[name + "/R"])
        np.testing.assert_array_equal(got[name + "/t"], z[name + "/t"])
        res = got[name]
        for row, bound in (("tsdf", 2), ("esdf", 2), ("esdf_occ", 4)):
            if name + "/" + row not in z:
                assert row not in res
                continue
            _assert_row(_row(res[row]), z[name + "/" + row], (name, row))
            assert res[row].rmse < bound * VOXEL, (name, row, res[row])
            assert res[row].num_evaluated_voxels > 1000
        if name == "occ":
            occ = res["occ"]
            ref_frac, ref_n = z["occ/occ"]
            assert abs(occ["num_evaluated_voxels"] - ref_n) <= 0.03 * ref_n
            assert abs(occ["misclassified_frac"] - ref_frac) <= 0.01
            assert occ["misclassified_frac"] < 0.15
            assert occ["num_evaluated_voxels"] > 1000
        else:
            assert "occ" not in res and "esdf_occ" not in res
        assert set(res["timing"]) >= set(z[name + "/timing"].tolist())


def test_cli_sim_bench_on_cpu(tmp_path, capsys):
    """``cli sim-bench --device cpu --occupancy`` prints the four rows and
    writes a mesh and a map file that reads back (0.4 m, 2 viewpoints)."""
    mp, mesh = str(tmp_path / "m.vxblx"), str(tmp_path / "m.ply")
    assert tcli.main(["sim-bench", "--device", "cpu", "--voxel-size", "0.4",
                      "--viewpoints", "2", "--width", "32", "--height", "24",
                      "--max-blocks", "64", "--occupancy", "--output-map", mp,
                      "--output-mesh", mesh]) == 0
    out = capsys.readouterr().out
    for row in ("TSDF: rmse=", "ESDF: rmse=", "OCC: {'misclassified_frac'",
                "ESDF-OCC: rmse=", "integrate/occupancy"):
        assert row in out, out
    assert os.path.getsize(mesh) > 1000
    tsdf = layer_io.load_layer(mp, "tsdf", device="cpu")
    esdf = layer_io.load_layer(mp, "esdf", device="cpu")
    assert teval.count_observed(tsdf) > 1000
    assert teval.count_observed(esdf) > 1000
