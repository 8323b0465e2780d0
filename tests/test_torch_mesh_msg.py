"""Port parity, the incremental mesh message (voxblox_tpu/io/mesh_msg.py,
held to tests/test_mesh_msg.py): the same ground-truth sphere layer (the
JAX sim's, carried over with ``layer_from_numpy``) is meshed by both
packages' mesh pools and encoded. Headers, block order, vertex counts,
colours and deletions must agree exactly; quantized vertices within one
wire unit (the JAX program may fuse the quantization's multiply-adds).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voxblox_tpu.core import layer as jlayer
from voxblox_tpu.core.config import MeshIntegratorConfig as JM
from voxblox_tpu.io import mesh_msg as jwire
from voxblox_tpu.ops import mesh as jmesh
from voxblox_tpu.sim import world as jsw
from voxblox_tpu_torch import _runtime
from voxblox_tpu_torch.core import layer as tlayer
from voxblox_tpu_torch.core.config import (MapConfig, MeshIntegratorConfig,
                                           TsdfIntegratorConfig)
from voxblox_tpu_torch.io import mesh_msg as twire
from voxblox_tpu_torch.ops import mesh as tmesh
from voxblox_tpu_torch.server.mapper import TsdfServer
from voxblox_tpu_torch.sim import world as tsw

import torch_parity

VOXEL = 0.1


def _sphere_layers():
    w = jsw.SimulationWorld()
    w.add_sphere((0.0, 0.0, 0.0), 1.0, color=(200, 30, 40))
    bound = 1.0 + 6 * VOXEL
    jl = jsw.generate_gt_layer(w.freeze(), "tsdf", VOXEL, (-bound,) * 3,
                               (bound,) * 3, max_dist=4 * VOXEL, vps=8,
                               max_blocks=512)
    return jl, tlayer.layer_from_numpy(torch_parity.jax_layer_to_numpy(jl),
                                       "cpu")


def _meshed(tri_cap=512):
    """Both packages' sphere layers with every row marched into their
    mesh pools."""
    jl, tl = _sphere_layers()
    jp = jmesh.make_mesh_pool(jl.max_blocks, tri_cap)
    tp = tmesh.make_mesh_pool(tl.max_blocks, tri_cap, "cpu")
    jcfg, tcfg = JM(device_tri_cap=tri_cap), MeshIntegratorConfig(
        device_tri_cap=tri_cap)
    for _ in range(64):
        jl, jp, jmore = jmesh.update_mesh_pool(jl, jp, jcfg, bucket=64)
        tl, tp, tmore = tmesh.update_mesh_pool(tl, tp, tcfg, bucket=64)
        assert bool(jmore) == bool(tmore)
        if not bool(tmore):
            return jl, jp, tl, tp
    raise AssertionError("drain did not converge")


def _assert_msgs_match(jmsg, tmsg):
    assert tmsg.has_color == jmsg.has_color
    assert tmsg.block_edge_length == jmsg.block_edge_length
    assert [b.index for b in tmsg.blocks] == [b.index for b in jmsg.blocks]
    for a, b in zip(tmsg.blocks, jmsg.blocks):
        assert len(a.x) == len(b.x), a.index
        for k in "xyz":
            assert np.abs(getattr(a, k).astype(np.int32)
                          - getattr(b, k).astype(np.int32)).max(
                              initial=0) <= 1, (a.index, k)
        for k in "rgb":
            np.testing.assert_array_equal(getattr(a, k), getattr(b, k))


def test_encode_matches_jax_and_round_trips():
    jl, jp, tl, tp = _meshed()
    jmsg, jl = jwire.encode_mesh_msg(jl, jp)
    syncs = _runtime.SYNCS
    tmsg, tl = twire.encode_mesh_msg(tl, tp)
    assert _runtime.SYNCS - syncs == 2  # rows + counts, payload
    assert len(tmsg.blocks) > 4
    _assert_msgs_match(jmsg, tmsg)
    np.testing.assert_array_equal(tl.block_flags.numpy(),
                                  np.asarray(jl.block_flags))
    data = twire.serialize_mesh_msg(tmsg)
    assert data[:14] == jwire.serialize_mesh_msg(jmsg)[:14]
    assert len(data) == twire.message_bytes(tmsg) == jwire.message_bytes(jmsg)
    back = twire.deserialize_mesh_msg(data)
    assert twire.serialize_mesh_msg(back) == data
    # The subscriber's layer against the pool's own export, within half a
    # wire step (2 * block size / 65535) plus the float error.
    ref = tmesh.pool_to_mesh_layer(tl, tp, tmesh.MeshLayer(tl.block_size))
    sub = twire.apply_mesh_msg(tmesh.MeshLayer(tl.block_size), back)
    jsub = jwire.apply_mesh_msg(jmesh.MeshLayer(jl.block_size),
                                jwire.deserialize_mesh_msg(data))
    assert set(sub.blocks) == set(ref.blocks) == set(jsub.blocks)
    qstep = 2.0 * tl.block_size / 65535.0
    for key, blk in ref.blocks.items():
        np.testing.assert_allclose(sub.blocks[key].vertices, blk.vertices,
                                   atol=0.5 * qstep + 1e-6)
        np.testing.assert_array_equal(sub.blocks[key].colors, blk.colors)
        np.testing.assert_array_equal(sub.blocks[key].vertices,
                                      jsub.blocks[key].vertices)


def test_deltas_are_incremental_and_empty_blocks_delete():
    jl, jp, tl, tp = _meshed()
    _, jl = jwire.encode_mesh_msg(jl, jp)
    tmsg, tl = twire.encode_mesh_msg(tl, tp)
    sub = twire.apply_mesh_msg(tmesh.MeshLayer(tl.block_size), tmsg)
    # Nothing re-meshed since the publish: an empty delta.
    assert twire.encode_mesh_msg(tl, tp)[0].blocks == []
    # One row re-marched: exactly that block ships, in both packages.
    row = int(np.flatnonzero(tl.active_mask().numpy())[0])
    jl = jlayer.mark_dirty(jl, jnp.asarray([row]), jnp.asarray([True]),
                           jlayer.DIRTY_MESH)
    tl = tlayer.mark_dirty(tl, torch.tensor([row]), torch.tensor([True]),
                           tlayer.DIRTY_MESH)
    jl, jp, _ = jmesh.update_mesh_pool(jl, jp, JM(), bucket=8)
    tl, tp, _ = tmesh.update_mesh_pool(tl, tp, MeshIntegratorConfig(),
                                       bucket=8)
    jmsg, jl = jwire.encode_mesh_msg(jl, jp)
    tmsg, tl = twire.encode_mesh_msg(tl, tp)
    assert [b.index for b in tmsg.blocks] == [
        tuple(int(v) for v in tl.block_ijk[row])]
    _assert_msgs_match(jmsg, tmsg)
    # A block with no vertex deletes the subscriber's copy.
    key = next(iter(sub.blocks))
    z16, z8 = np.zeros(0, np.uint16), np.zeros(0, np.uint8)
    deletion = twire.MeshMsg(tl.block_size, [twire.MeshBlockMsg(
        key, z16, z16, z16, z8, z8, z8)])
    data = twire.serialize_mesh_msg(deletion)
    assert data == jwire.serialize_mesh_msg(jwire.MeshMsg(
        jl.block_size, [jwire.MeshBlockMsg(key, z16, z16, z16, z8, z8, z8)]))
    twire.apply_mesh_msg(sub, twire.deserialize_mesh_msg(data))
    assert key not in sub.blocks


def test_overflow_rows_encode_dense_as_jax():
    """Rows whose march overflowed the pool's tri_cap ship the dense
    march's whole geometry, not their partial pool content."""
    jl, jp, tl, tp = _meshed(tri_cap=16)
    ovf = tp.overflow_rows.numpy() & tl.active_mask().numpy()
    assert ovf.any()
    np.testing.assert_array_equal(ovf, np.asarray(jp.overflow_rows)
                                  & np.asarray(jl.active_mask()))
    jmsg, _ = jwire.encode_mesh_msg(jl, jp)
    tmsg, _ = twire.encode_mesh_msg(tl, tp)
    _assert_msgs_match(jmsg, tmsg)
    ijk = tl.block_ijk.numpy()
    big = {tuple(ijk[r]) for r in np.flatnonzero(ovf)}
    sizes = {b.index: len(b.x) for b in tmsg.blocks}
    assert all(sizes[k] > 16 * 3 for k in big)


@pytest.mark.parametrize("use_color", [True, False])
def test_server_publish_streams_deltas(use_color):
    """TsdfServer.publish_mesh_msg: the first publish ships the map, a
    publish with nothing new is empty, a new scan ships its re-meshed
    blocks, and a subscriber applying the deltas ends at the server's own
    export."""
    w = tsw.SimulationWorld()
    w.add_sphere((0.0, 0.0, 1.0), 0.8, color=(200, 40, 40))
    w.add_ground_level(-0.5)
    objs = w.freeze("cpu")
    srv = TsdfServer(
        MapConfig(voxel_size=0.1, voxels_per_side=8, max_blocks=2048),
        integrator_config=TsdfIntegratorConfig(
            default_truncation_distance=0.4, max_ray_length_m=5.0),
        mesh_config=MeshIntegratorConfig(use_color=use_color),
        method="projective", projective_resolution=(40, 30),
        projective_fov_deg=60.0, device="cpu")
    sub = tmesh.MeshLayer(srv.layer.block_size)

    def scan(i):
        a = 2 * np.pi * i / 8
        pos = torch.tensor([2.5 * np.cos(a), 2.5 * np.sin(a), 1.0])
        view = torch.tensor([-np.cos(a), -np.sin(a), 0.0],
                            dtype=torch.float32)
        R = tsw.rotation_from_two_vectors(torch.tensor([0.0, 0.0, 1.0]),
                                          view)
        pts, cols, _, _ = tsw.organized_pointcloud_from_transform(
            objs, (R, pos), (40, 30), np.deg2rad(60.0), 5.0)
        srv.insert_pointcloud((R, pos), pts.reshape(-1, 3),
                              cols.reshape(-1, 3))
        srv.update_mesh()

    scan(0)
    msg0 = twire.deserialize_mesh_msg(srv.publish_mesh_msg())
    assert len(msg0.blocks) > 2 and msg0.has_color == use_color
    twire.apply_mesh_msg(sub, msg0)
    assert twire.deserialize_mesh_msg(srv.publish_mesh_msg()).blocks == []
    scan(1)
    msg1 = twire.deserialize_mesh_msg(srv.publish_mesh_msg())
    assert 0 < len(msg1.blocks)
    twire.apply_mesh_msg(sub, msg1)
    ml = srv.export_mesh_layer()
    assert set(sub.blocks) == set(ml.blocks)
    qstep = 2.0 * srv.layer.block_size / 65535.0
    for key, blk in ml.blocks.items():
        np.testing.assert_allclose(sub.blocks[key].vertices, blk.vertices,
                                   atol=0.75 * qstep)
        if use_color:
            np.testing.assert_array_equal(sub.blocks[key].colors, blk.colors)
    assert "mesh/publish" in srv.stats()["timing"]
