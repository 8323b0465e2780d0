"""Multi-process helper for the port's sharding tests: runs the ranks of a
``torch.distributed`` job on the CPU (gloo), one process each, and
collects what every rank saved.

This is a test helper beside torch_parity.py, not part of either package.
The ranks run this file as a script (``python tests/torch_dist.py TASK
RANK WORLD DIR``) and import only the port. Rendezvous goes through a
``FileStore`` in the test's temporary directory (no TCP port to race other
test workers for), except in the multihost task, which exercises
``init_multihost``'s ``tcp://host:port`` on purpose. Each rank runs torch
with one thread: several ranks under several test workers would
oversubscribe the machine otherwise.
"""

from __future__ import annotations

import os
import pickle
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

# The ESDF configurations of the block-sharded sweep cases (field values
# of EsdfIntegratorConfig; both packages take the same).
SWEEP_BASE = dict(max_distance_m=1.0, default_distance_m=1.0,
                  min_distance_m=0.4, inner_sweeps=4, max_active_blocks=128)
SWEEP_CASES = {
    "unit_kernel": dict(use_pallas_kernel=True),
    "strided_kernel": dict(use_pallas_kernel=True,
                           sweep_strides=(8, 4, 2, 1, 1, 1, 1)),
    "plain": dict(use_pallas_kernel=False),
    "full_euclidean": dict(full_euclidean_distance=True),
    # A budget below the live set: the retry ladder doubles it.
    "retry_ladder": dict(use_pallas_kernel=True, max_active_blocks=16),
}


def sweep_config(case: str) -> dict:
    return dict(SWEEP_BASE, **SWEEP_CASES[case])


# ---------------------------------------------------------------------------
# The launcher (test side)
# ---------------------------------------------------------------------------


class Job:
    """``world`` rank processes of ``task``, started at once; ``wait``
    returns the per-rank results. A rank that exits non-zero fails the
    job and the other ranks are killed."""

    def __init__(self, task: str, world: int, tmp, *extra, tag=None):
        self.tmp = Path(tmp)
        self.tag = tag or f"{task}_w{world}"
        env = dict(os.environ, PYTHONPATH=f"{REPO}{os.pathsep}"
                   f"{os.environ.get('PYTHONPATH', '')}",
                   OMP_NUM_THREADS="1")
        self.world = world
        self.procs = [subprocess.Popen(
            [sys.executable, __file__, task, str(r), str(world),
             str(self.tmp), self.tag, *map(str, extra)],
            cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(world)]
        self.t0 = time.perf_counter()

    def wait(self, timeout: float = 300.0):
        outs = [None] * self.world
        deadline = time.monotonic() + timeout
        failed = None
        while any(o is None for o in outs):
            for r, p in enumerate(self.procs):
                if outs[r] is None and p.poll() is not None:
                    outs[r] = p.stdout.read()
                    if p.returncode != 0 and failed is None:
                        failed = r
            if failed is not None or time.monotonic() > deadline:
                for p in self.procs:
                    if p.poll() is None:
                        p.kill()
                for r, p in enumerate(self.procs):
                    if outs[r] is None:
                        outs[r] = p.communicate()[0]
                break
            time.sleep(0.05)
        self.seconds = time.perf_counter() - self.t0
        self.outputs = outs
        if failed is not None or any(p.returncode != 0 for p in self.procs):
            raise RankFailed(self.tag, [p.returncode for p in self.procs],
                             outs)
        res = []
        for r in range(self.world):
            with open(self.tmp / f"{self.tag}_r{r}.pkl", "rb") as f:
                res.append(pickle.load(f))
        return res


class RankFailed(AssertionError):
    def __init__(self, tag, rcs, outs):
        self.rcs, self.outs = rcs, outs
        text = "\n".join(f"--- rank {r} (rc {rc}) ---\n{(o or '')[-3000:]}"
                         for r, (rc, o) in enumerate(zip(rcs, outs)))
        super().__init__(f"{tag}: a rank failed\n{text}")


# ---------------------------------------------------------------------------
# The ranks (script side: imports the port only)
# ---------------------------------------------------------------------------


def _layer_np(layer):
    from voxblox_tpu_torch.core import layer as tlayer

    return tlayer.layer_to_numpy(layer)


def _tsdf_cfg():
    from voxblox_tpu_torch.core.config import TsdfIntegratorConfig

    return TsdfIntegratorConfig(default_truncation_distance=0.4,
                                max_ray_length_m=8.0)


def _load_layer(d):
    from voxblox_tpu_torch.core import layer as tlayer

    return tlayer.layer_from_numpy(d, "cpu")


def _inputs(tmp):
    with open(Path(tmp) / "inputs.pkl", "rb") as f:
        return pickle.load(f)


def _sharding_task(rank, world, tmp):
    """The ray- and scan-sharded calls and the block placement on the
    meshes of this world size: W=1 (1,1); W=2 (2,1) for the rays and
    (1,2) for the blocks; W=4 (2,2)."""
    import torch

    from voxblox_tpu_torch.core import layer as tlayer
    from voxblox_tpu_torch.parallel import sharding

    inp = _inputs(tmp)
    cfg = _tsdf_cfg()
    t = torch.as_tensor
    out = {}
    rays_mesh = sharding.make_mesh(world, rays=min(world, 2),
                                   device_type="cpu")
    block_mesh = rays_mesh if world != 2 else sharding.make_mesh(
        2, rays=1, device_type="cpu")
    out["mesh_shapes"] = {"rays": tuple(rays_mesh.shape),
                          "blocks": tuple(block_mesh.shape)}
    if world == 4:
        out["mesh_shapes"]["default"] = tuple(
            sharding.make_mesh(4, device_type="cpu").shape)
        out["mesh_shapes"]["rays4"] = tuple(
            sharding.make_mesh(4, rays=4, device_type="cpu").shape)

    # Ray-sharded simple integrate.
    layer = tlayer.make_layer("tsdf", 0.1, vps=16, max_blocks=256,
                              device="cpu")
    layer, ovf = sharding.integrate_pointcloud_sharded(
        rays_mesh, layer, (t(inp["R"]), t(inp["t"])), t(inp["pts_C"]),
        t(inp["colors"]), cfg)
    out["integrate"] = (_layer_np(layer), bool(ovf))

    # Scan-sharded projective batch.
    layer = tlayer.make_layer("tsdf", 0.1, vps=16, max_blocks=256,
                              device="cpu")
    layer, ovf = sharding.integrate_projective_batch_sharded(
        rays_mesh, layer, inp["Rs"], inp["ts"], t(inp["pts_K"]),
        t(inp["cols_K"]), cfg, kind="pinhole_organized",
        intrinsics=inp["intr"], pool=2, max_visible_blocks=256)
    out["projective"] = (_layer_np(layer), bool(ovf))

    # Ray-sharded render loss and gradient.
    tsdf_layer = _load_layer(inp["tsdf_map"])
    loss, grad = sharding.render_loss_grad_sharded(
        rays_mesh, tsdf_layer, t(inp["origins"]), t(inp["dirs"]),
        t(inp["target"]), 8.0)
    out["render"] = (float(loss), grad.numpy())

    # Block placement: this rank's rows and the reassembled channels.
    placed = sharding.shard_layer_blocks(block_mesh, tsdf_layer)
    out["placement"] = {
        "coordinate": tuple(block_mesh.get_coordinate()),
        "local_rows": {k: tuple(v.to_local().shape)
                       for k, v in placed.channels.items()},
        "full_equal": all(
            torch.equal(v.full_tensor(), tsdf_layer.channels[k])
            for k, v in placed.channels.items()),
        "replicated_equal": all(
            getattr(placed, k) is getattr(tsdf_layer, k)
            for k in ("table", "block_ijk", "block_flags", "num_blocks")),
    }
    return out


def _sweep_task(rank, world, tmp):
    """``lower_sweep_sharded`` of one seeded map in every configuration
    of SWEEP_CASES, on a (1,2) mesh at W=2 and a (2,2) mesh at W=4."""
    from voxblox_tpu_torch.core.config import EsdfIntegratorConfig
    from voxblox_tpu_torch.ops import esdf as tesdf
    from voxblox_tpu_torch.parallel import sharding

    mesh = sharding.make_mesh(world, rays=1 if world == 2 else None,
                              device_type="cpu")
    tsdf_layer = _load_layer(_inputs(tmp)["tsdf_map"])
    out = {"mesh_shape": tuple(mesh.shape)}
    for case in SWEEP_CASES:
        cfg = EsdfIntegratorConfig(**sweep_config(case))
        e, iters = sharding.lower_sweep_sharded(
            mesh, tesdf.seeded_layer(tsdf_layer, cfg), cfg)
        out[case] = (_layer_np(e), int(iters))
    return out


def _sweep_reference_task(rank, world, tmp):
    """The unsharded ``ops.esdf.lower_sweep`` of the same seeded map in
    every configuration of SWEEP_CASES (one process, beside the sharded
    ranks); for the retry case, whether its budget overflows."""
    from voxblox_tpu_torch.core.config import EsdfIntegratorConfig
    from voxblox_tpu_torch.ops import esdf as tesdf

    tsdf_layer = _load_layer(_inputs(tmp)["tsdf_map"])
    out = {}
    for case in SWEEP_CASES:
        cfg = EsdfIntegratorConfig(**sweep_config(case))
        e, iters, region_ovf, _ = tesdf.lower_sweep(
            tesdf.seeded_layer(tsdf_layer, cfg), cfg)
        out[case] = (_layer_np(e), int(iters), bool(region_ovf))
    return out


def _multihost_task(rank, world, tmp, port, local):
    """init_multihost over tcp://localhost:port, a (hosts, chips) mesh,
    one integrate with the rays over both axes; each rank compares with
    the unsharded simple integrator."""
    import torch

    from voxblox_tpu_torch.core import layer as tlayer
    from voxblox_tpu_torch.ops import tsdf as ttsdf
    from voxblox_tpu_torch.parallel import sharding
    from voxblox_tpu_torch.utils import evaluation

    backend = sharding.init_multihost(f"localhost:{port}", world, rank,
                                      local_device_count=int(local),
                                      device_type="cpu")
    mesh = sharding.make_multihost_mesh()
    inp = _inputs(tmp)
    t = torch.as_tensor
    args = ((t(inp["R"]), t(inp["t"])), t(inp["pts_C"]), t(inp["colors"]),
            _tsdf_cfg())

    def fresh():
        return tlayer.make_layer("tsdf", 0.1, vps=16, max_blocks=256,
                                 device="cpu")

    layer, ovf = sharding.integrate_pointcloud_sharded(
        mesh, fresh(), *args, ray_axes=("hosts", "chips"))
    ref, _, _ = ttsdf.integrate_pointcloud(fresh(), *args, method="simple")
    det = evaluation.evaluate_layers_rmse(ref, layer)
    w1, w = ref.channels["weight"], layer.channels["weight"]
    obs = (w > 1e-3) & (w1 > 1e-3)
    err = (layer.channels["tsdf"] - ref.channels["tsdf"]).abs()[obs]
    return dict(backend=backend, shape=tuple(mesh.shape),
                names=tuple(mesh.mesh_dim_names), overflow=bool(ovf),
                rmse=det.rmse, evaluated=det.num_evaluated_voxels,
                observed=int(obs.sum()), max_err=float(err.max()),
                same_blocks=bool(torch.equal(layer.block_ijk,
                                             ref.block_ijk)))


TASKS = {"sharding": _sharding_task, "sweep": _sweep_task,
         "sweep_reference": _sweep_reference_task,
         "multihost": _multihost_task}


def _rank_main(argv):
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    task, rank, world, tmp, tag, *extra = argv
    rank, world = int(rank), int(world)
    if task != "multihost":
        store = dist.FileStore(str(Path(tmp) / f"{tag}.store"), world)
        dist.init_process_group("gloo", store=store, rank=rank,
                                world_size=world)
    res = TASKS[task](rank, world, tmp, *extra)
    dist.barrier()
    dist.destroy_process_group()
    with open(Path(tmp) / f"{tag}_r{rank}.pkl", "wb") as f:
        pickle.dump(res, f)


if __name__ == "__main__":
    _rank_main(sys.argv[1:])
