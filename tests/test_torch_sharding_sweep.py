"""Port parity, the block-sharded ESDF sweep (``lower_sweep_sharded`` of
voxblox_tpu/parallel/sharding.py on torch.distributed).

The map is tests/test_parallel.py's scene (sphere + ground, a 32x24
scan, 0.1 m voxels, a pool of 256 blocks) integrated by the port's
simple integrator and seeded into an ESDF layer as test_parallel does;
the sweep runs at ``__graft_entry__.dryrun_multichip``'s distances (1 m)
over a 128-block working set, in five configurations
(tests/torch_dist.py ``SWEEP_CASES``): the unit kernel schedule, the
strided schedule, the plain sweep, full-Euclidean, and the unit schedule
from a 16-block budget, so that the retry ladder doubles it. The port
runs W=2 gloo CPU ranks on a (1,2) mesh and W=4 on a (2,2) mesh, each
world size spawned once for the module. On the CPU the kernels' plain
version stands in for K1 and K2. Bounds:
- bit-equal (esdf, flags, parents, iterations) to the port's unsharded
  ``lower_sweep``: each rank relaxes its rows of the same Jacobi outer
  iteration, so the split cannot change a bit; the retry case equals the
  unit case (the ladder stops at the same 128-row budget);
- against JAX ``lower_sweep_sharded`` on a 1x1 mesh (the Pallas kernel
  interpreted): atol 1e-5 with equal flags and parents, as in
  test_torch_esdf.py.
"""

import pickle

import numpy as np
import pytest
import torch

from voxblox_tpu.core import layer as jlayer
from voxblox_tpu.core.config import EsdfIntegratorConfig as JE
from voxblox_tpu.ops import esdf as jesdf
from voxblox_tpu.parallel import sharding as jsharding

from voxblox_tpu_torch.core import layer as tlayer
from voxblox_tpu_torch.core.config import TsdfIntegratorConfig as TT
from voxblox_tpu_torch.ops import tsdf as ttsdf
from voxblox_tpu_torch.sim import world as tsw

import torch_dist
import torch_parity
from test_torch_esdf import tlayer_to_jax

WORLDS = (2, 4)
CASES = tuple(torch_dist.SWEEP_CASES)
JAX_CASES = ("unit_kernel", "strided_kernel", "plain", "full_euclidean")


def port_map():
    """test_parallel's scan through the port's sim and simple integrator."""
    w = tsw.SimulationWorld()
    w.add_sphere((0.0, 0.0, 2.0), 1.5, color=(255, 0, 0))
    w.add_ground_level(0.0)
    objs = w.freeze("cpu")
    view = torch.tensor([0.0, 1.0, 0.0])
    R = tsw.rotation_from_two_vectors(torch.tensor([0.0, 0.0, 1.0]), view)
    t = torch.tensor([0.0, -4.0, 2.0])
    pts_G, colors, valid = tsw.pointcloud_from_viewpoint(
        objs, t, view, (32, 24), np.deg2rad(60.0), 8.0)
    pts_C = tsw.world_points_to_sensor((R, t), pts_G, valid)
    layer = tlayer.make_layer("tsdf", 0.1, vps=16, max_blocks=256,
                              device="cpu")
    layer, _, ovf = ttsdf.integrate_pointcloud(
        layer, (R, t), pts_C, colors,
        TT(default_truncation_distance=0.4, max_ray_length_m=8.0))
    assert not bool(ovf)
    return layer


def _jax_seeded(jt, cfg):
    e = jlayer.make_layer("esdf", 0.1, vps=16, max_blocks=256)
    rows = jt.active_mask()
    e, _ = jesdf._sync_blocks(e, jt, rows)
    e, _, _ = jesdf.seed_from_tsdf(e, jt, cfg, rows)
    return e


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded_sweep")
    tmap = port_map()
    d = tlayer.layer_to_numpy(tmap)
    with open(tmp / "inputs.pkl", "wb") as f:
        pickle.dump({"tsdf_map": d}, f)
    jobs = {w: torch_dist.Job("sweep", w, tmp) for w in WORLDS}
    unsharded = torch_dist.Job("sweep_reference", 1, tmp)

    ref = {"jax": {}}
    jt = tlayer_to_jax(d)
    mesh1 = jsharding.make_mesh(1, rays=1)
    for case in JAX_CASES:
        cfg = JE(**torch_dist.sweep_config(case))
        je, it = jsharding.lower_sweep_sharded(mesh1, _jax_seeded(jt, cfg),
                                               cfg)
        ref["jax"][case] = (je, int(it))
    ref["port"], = unsharded.wait()
    ref["ranks"] = {w: job.wait() for w, job in jobs.items()}
    print({w: f"{job.seconds:.1f} s" for w, job in jobs.items()})
    return ref


def test_meshes(runs):
    assert runs["ranks"][2][0]["mesh_shape"] == (1, 2)
    assert runs["ranks"][4][0]["mesh_shape"] == (2, 2)


def test_retry_budget_overflows_unsharded(runs):
    """The retry case's 16-block budget is too small for the working set,
    so the sharded call had to climb the ladder."""
    assert runs["port"]["retry_ladder"][2]
    assert not any(runs["port"][c][2] for c in CASES if c != "retry_ladder")


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("w", WORLDS)
def test_sweep_bit_equal_to_unsharded(runs, w, case):
    # The retry ladder ends at the unit case's 128-block budget.
    ref, it_ref, _ = runs["port"][
        "unit_kernel" if case == "retry_ladder" else case]
    assert ((ref["channel/esdf_flags"] & 1) != 0).sum() > 10000
    for rank in runs["ranks"][w]:
        got, it = rank[case]
        torch_parity.assert_layers_equal(ref, got)
        assert it == it_ref


@pytest.mark.parametrize("case", JAX_CASES)
@pytest.mark.parametrize("w", WORLDS)
def test_sweep_matches_jax(runs, w, case):
    je, it_j = runs["jax"][case]
    got, it = runs["ranks"][w][0][case]
    ref = torch_parity.jax_layer_to_numpy(je)
    torch_parity.assert_layers_equal(ref, got, atol=1e-5, channels=["esdf"])
    for k in ("channel/esdf_flags", "channel/parent"):
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    assert it == it_j
    if case == "full_euclidean":
        assert (ref["channel/parent"] != 0).any()
