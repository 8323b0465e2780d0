"""The port stands alone: no JAX, no voxblox_tpu and no protobuf package
in its sources or its import graph (the command line included), and its
entry points refuse to fall back to the CPU."""

import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from torch_parity import cuda_device  # noqa: F401  (fixture)

REPO = pathlib.Path(__file__).resolve().parents[1]
PKG = REPO / "voxblox_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "voxblox_tpu", "google")


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")) + [
    REPO / "chip_smoke.py"], ids=lambda p: str(p.relative_to(REPO)))
def test_sources_import_no_jax(path):
    for name in _imports(path):
        top = name.split(".")[0]
        assert top not in FORBIDDEN, f"{path}: imports {name}"


def test_import_leaves_jax_out():
    code = ("import sys, voxblox_tpu_torch.server.mapper, "
            "voxblox_tpu_torch.sim.world, voxblox_tpu_torch.ops.esdf_relax, "
            "voxblox_tpu_torch.ops.mesh, voxblox_tpu_torch.ops.marching_cubes, "
            "voxblox_tpu_torch.ops.raycast, voxblox_tpu_torch.ops.tsdf, "
            "voxblox_tpu_torch.ops.interp, voxblox_tpu_torch.models.maps, "
            "voxblox_tpu_torch.sim.objects, voxblox_tpu_torch.ops.icp, "
            "voxblox_tpu_torch.io.wire, voxblox_tpu_torch.io.layer_io, "
            "voxblox_tpu_torch.io.npz_io, voxblox_tpu_torch.io.ply, "
            "voxblox_tpu_torch.io.conversions, "
            "voxblox_tpu_torch.io.mesh_msg, voxblox_tpu_torch.io.rosbag, "
            "voxblox_tpu_torch.server.dataset, voxblox_tpu_torch.server.cli, "
            "voxblox_tpu_torch.utils.lie, voxblox_tpu_torch.utils.planning, "
            "voxblox_tpu_torch.utils.timing, "
            "voxblox_tpu_torch.utils.color_maps, "
            "voxblox_tpu_torch.utils.mesh_vis, voxblox_tpu_torch.ops.render, "
            "voxblox_tpu_torch.ops.occupancy, "
            "voxblox_tpu_torch.ops.intensity, "
            "voxblox_tpu_torch.ops.transform, "
            "voxblox_tpu_torch.utils.evaluation, "
            "voxblox_tpu_torch.utils.camera, "
            "voxblox_tpu_torch.parallel.sharding; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'voxblox_tpu') "
            "or m.startswith('google.protobuf')]; "
            "assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_cli_help_leaves_jax_and_protobuf_out():
    """``python -m voxblox_tpu_torch.server.cli --help`` runs, and every
    command's module loads, without jax, voxblox_tpu or google.protobuf."""
    code = ("import runpy, sys; sys.argv = ['cli', '--help']\n"
            "try:\n"
            "    runpy.run_module('voxblox_tpu_torch.server.cli', "
            "run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    assert e.code == 0, e.code\n"
            "import voxblox_tpu_torch.server.mapper\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'voxblox_tpu') "
            "or m.startswith('google.protobuf')]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "replay" in proc.stdout and "tsdf-to-esdf" in proc.stdout
    proc = subprocess.run(
        [sys.executable, "-m", "voxblox_tpu_torch.server.cli", "--help"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and "sim-bench" in proc.stdout, proc.stderr
    assert "not ported" not in proc.stdout
    proc = subprocess.run(
        [sys.executable, "-m", "voxblox_tpu_torch.server.cli", "sim-bench",
         "--help"], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=120)
    assert proc.returncode == 0, proc.stderr
    for flag in ("--occupancy", "--batch-esdf", "--output-mesh",
                 "--output-map", "--device"):
        assert flag in proc.stdout, flag


def test_no_gpu_means_raise_not_fallback():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the CUDA default is valid here")
    from voxblox_tpu_torch.core import layer as tlayer
    from voxblox_tpu_torch.server.mapper import EsdfServer, TsdfServer

    with pytest.raises(RuntimeError, match="device='cpu'"):
        EsdfServer()
    with pytest.raises(RuntimeError):
        TsdfServer()
    with pytest.raises(RuntimeError):
        tlayer.make_layer("tsdf", 0.1)
    assert EsdfServer(device="cpu").device.type == "cpu"


@pytest.mark.cuda
def test_kernel_matches_plain_on_the_card(cuda_device):
    from voxblox_tpu_torch.ops import esdf_relax

    rs = np.random.default_rng(3)
    d = rs.uniform(-2.5, 2.5, (32, 18, 18, 18)).astype(np.float32)
    obs = rs.uniform(size=d.shape) < 0.8
    upd = np.zeros(d.shape, bool)
    upd[:, 1:-1, 1:-1, 1:-1] = rs.uniform(size=(32, 16, 16, 16)) < 0.7
    act = rs.uniform(size=32) < 0.6
    ts = [torch.as_tensor(x, device=cuda_device) for x in (d, obs, upd, act)]
    got = esdf_relax.relax(*ts, 4, 0.05, 2.0, 0.001)
    ref = esdf_relax.relax_plain(*ts, 4, 0.05, 2.0, 0.001)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)
