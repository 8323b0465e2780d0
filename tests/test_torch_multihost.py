"""Multi-host runtime of the port (``init_multihost`` and
``make_multihost_mesh`` of voxblox_tpu_torch/parallel/sharding.py), the
counterpart of tests/test_multihost.py: 4 gloo CPU ranks rendezvous over
``tcp://localhost:<port>`` as 2 hosts x 2 chips, build the ('hosts',
'chips') mesh of shape (2, 2), and integrate one scan of test_parallel's
scene with the rays sharded over both axes. Each rank checks its map
against the unsharded simple integrator at JAX's bounds (same blocks;
max |dtsdf| < 1e-4 on voxels with weight > 1e-3 in both; rmse < 1e-4).

Cut from the JAX test's 2 processes x 4 virtual devices to 2 x 2 ranks:
a torch process drives one device, so each JAX device becomes a process
of its own, and 4 ranks keep the test small. The port is picked by
binding port 0; if another process takes it before rank 0 listens, the
job is retried once on a fresh port.
"""

import pickle
import socket

import pytest

import torch_dist
from test_torch_sharding import scene_inputs


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_four_ranks_two_hosts_integrate(tmp_path):
    with open(tmp_path / "inputs.pkl", "wb") as f:
        pickle.dump(scene_inputs(), f)
    for attempt in range(2):
        job = torch_dist.Job("multihost", 4, tmp_path, _free_port(), 2)
        try:
            ranks = job.wait()
            break
        except torch_dist.RankFailed as e:
            if attempt or not any("EADDRINUSE" in (o or "") or "address "
                                  "already in use" in (o or "").lower()
                                  for o in e.outs):
                raise
    print(f"4 ranks in {job.seconds:.1f} s")
    for r, res in enumerate(ranks):
        assert res["backend"] == "gloo"
        assert res["shape"] == (2, 2) and res["names"] == ("hosts", "chips")
        assert not res["overflow"] and res["same_blocks"], (r, res)
        assert res["observed"] > 10000, (r, res)
        assert res["max_err"] < 1e-4, (r, res)
        assert res["rmse"] < 1e-4 and res["evaluated"] > 1000, (r, res)


def test_make_mesh_refuses_without_a_group_or_a_gpu():
    import torch

    from voxblox_tpu_torch.parallel import sharding

    with pytest.raises(RuntimeError, match="init_multihost"):
        sharding.make_mesh(1, device_type="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            sharding.make_mesh(1)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            sharding.init_multihost("localhost:1", 1, 0)
