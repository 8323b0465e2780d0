"""Port parity, map files and messages: the protobuf wire codec, .vxblx
files (byte for byte the JAX package's, each package loading the other's),
the merge strategies, .npz checkpoints, PLY files and layer messages.

The same numpy layers (``_random_layer``, the fixture of tests/test_io.py)
go through voxblox_tpu and voxblox_tpu_torch (``device="cpu"``).
"""

import dataclasses
import os
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voxblox_tpu.core import layer as jlayer
from voxblox_tpu.io import conversions as jconv
from voxblox_tpu.io import layer_io as jio
from voxblox_tpu.io import npz_io as jnpz
from voxblox_tpu.io import ply as jply
from voxblox_tpu.io.proto import BlockProto
from voxblox_tpu_torch.core import layer as tlayer
from voxblox_tpu_torch.io import conversions as tconv
from voxblox_tpu_torch.io import layer_io as tio
from voxblox_tpu_torch.io import npz_io as tnpz
from voxblox_tpu_torch.io import ply as tply
from voxblox_tpu_torch.io import wire

import torch_parity
from torch_parity import cuda_device  # noqa: F401  (fixture)

LAYER_TYPES = ["tsdf", "esdf", "occupancy", "intensity"]
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _random_layer(rng, layer_type, vps=8, n_blocks=20, max_blocks=64,
                  blocks=None):
    """A JAX layer of ``n_blocks`` random blocks (tests/test_io.py), or of
    ``blocks`` int32[n, 3], with random voxels."""
    layer = jlayer.make_layer(layer_type, 0.1, vps=vps, max_blocks=max_blocks)
    if blocks is None:
        blocks = np.unique(rng.integers(-6, 6, size=(n_blocks * 2, 3)).astype(
            np.int32), axis=0)[:n_blocks]
    layer, _ = jlayer.allocate_blocks(layer, jnp.asarray(blocks),
                                      jnp.ones(len(blocks), bool))
    mask = np.asarray(layer.active_mask())
    ch = {}
    for name, arr in layer.channels.items():
        a = np.asarray(arr)
        if name == "color":
            vals = rng.integers(0, 256, a.shape).astype(np.float32)
        elif a.dtype == np.float32:
            vals = rng.uniform(-2, 2, a.shape).astype(np.float32)
        elif a.dtype == np.uint8:
            vals = rng.integers(0, 16, a.shape).astype(np.uint8)
        else:
            vals = rng.integers(-100, 100, a.shape).astype(np.int8)
        vals[~mask] = 0
        ch[name] = jnp.asarray(vals)
    return dataclasses.replace(layer, channels=ch)


def _to_port(jl):
    return tlayer.layer_from_numpy(torch_parity.jax_layer_to_numpy(jl), "cpu")


def _np(layer):
    if isinstance(layer.block_flags, torch.Tensor):
        return tlayer.layer_to_numpy(layer)
    return torch_parity.jax_layer_to_numpy(layer)


def _read(path):
    with open(path, "rb") as f:
        return f.read()


# ---------------------------------------------------------------------------
# The wire codec
# ---------------------------------------------------------------------------


def test_varints_match_protobuf_packed_and_unpacked(rng):
    edges = np.array([0, 1, 127, 128, 2 ** 14 - 1, 2 ** 14, 2 ** 21,
                      2 ** 28 - 1, 2 ** 28, 2 ** 32 - 1], np.uint32)
    words = np.concatenate([
        edges, rng.integers(0, 2 ** 32, 2000, dtype=np.uint64).astype(
            np.uint32),
        rng.standard_normal(500).astype(np.float32).view(np.uint32)])
    for w in (edges, words):
        bp = BlockProto()
        bp.voxels_per_side = 8
        bp.voxel_size = 0.1
        bp.origin_x, bp.origin_y, bp.origin_z = -0.8, 0.0, 1.6
        bp.has_data = True
        bp.voxel_data.extend(w.tolist())
        ref = bp.SerializeToString()
        body, _ = wire.encode_uint32s(w, 0x38)
        assert (wire.block_prefix(8, 0.1, (-0.8, 0.0, 1.6))
                + body.tobytes()) == ref
        got = wire.parse_block(np.frombuffer(ref, np.uint8), 0, len(ref))
        np.testing.assert_array_equal(got.voxel_data, w)
        assert (got.voxels_per_side, got.origin_x, got.has_data) == (
            8, -0.8, True)
    # Single varints at the edges, as protobuf writes them.
    for v in edges.tolist():
        bp = BlockProto()
        bp.voxel_data.append(v)
        assert bp.SerializeToString() == b"\x38" + wire.varint(v)
        assert wire.read_varint(wire.varint(v), 0) == (v, len(wire.varint(v)))
    # Packed voxel_data, another field between two unpacked runs, and an
    # unknown field: protobuf and the port read the same words.
    packed, _ = wire.encode_uint32s(words)
    msg = (b"\x38\x05" + b"\x3a" + wire.varint(len(packed)) + packed.tobytes()
           + b"\x11" + np.float64(0.25).tobytes() + b"\x38\x81\x01"
           + b"\xa0\x06\x07" + b"\x30\x01")
    ref = BlockProto()
    ref.ParseFromString(msg)
    got = wire.parse_block(np.frombuffer(msg, np.uint8), 0, len(msg))
    np.testing.assert_array_equal(got.voxel_data,
                                  np.array(ref.voxel_data, np.uint32))
    assert got.voxel_size == ref.voxel_size == 0.25 and got.has_data
    with pytest.raises(ValueError):
        wire.parse_block(np.frombuffer(msg[:-4], np.uint8), 0, len(msg) - 4)


# ---------------------------------------------------------------------------
# .vxblx files
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("layer_type", LAYER_TYPES)
def test_vxblx_bytes_equal_and_cross_load(tmp_path, rng, layer_type):
    jl = _random_layer(rng, layer_type)
    tl = _to_port(jl)
    jpath, tpath = str(tmp_path / "j.vxblx"), str(tmp_path / "t.vxblx")
    jio.save_layer(jl, jpath)
    tio.save_layer(tl, tpath)
    assert _read(tpath) == _read(jpath)
    # Each package loads the other's file into the same layer.
    ref = _np(jio.load_layer(tpath, layer_type, max_blocks=64))
    got = _np(tio.load_layer(jpath, layer_type, max_blocks=64, device="cpu"))
    torch_parity.assert_layers_equal(ref, got)
    assert tio.load_layer_header(tpath) == wire.LayerProto(0.1, 8, layer_type)


def test_multi_layer_append(tmp_path, rng):
    """TSDF + ESDF appended in one file (esdf_server.cc:172-190)."""
    jt, je = _random_layer(rng, "tsdf"), _random_layer(rng, "esdf")
    jpath, tpath = str(tmp_path / "j.vxblx"), str(tmp_path / "t.vxblx")
    jio.save_layer(jt, jpath)
    jio.save_layer(je, jpath, append=True)
    tio.save_layer(_to_port(jt), tpath)
    tio.save_layer(_to_port(je), tpath, append=True)
    assert _read(tpath) == _read(jpath)
    for lt in ("esdf", "tsdf"):
        torch_parity.assert_layers_equal(
            _np(jio.load_layer(jpath, lt)),
            _np(tio.load_layer(tpath, lt, device="cpu")))
    assert [(h.type, n) for h, n in tio.read_headers(tpath)] == [
        ("tsdf", 20), ("esdf", 20)]
    with pytest.raises(ValueError):
        tio.load_layer(tpath, "occupancy", device="cpu")


@pytest.mark.parametrize("strategy", ["PROHIBIT", "OVERWRITE", "DISCARD",
                                      "MERGE"])
@pytest.mark.parametrize("layer_type", ["tsdf", "esdf", "occupancy"])
def test_merge_strategies_match_jax(tmp_path, rng, layer_type, strategy):
    """A file loaded into a layer that shares some of its blocks."""
    src = _random_layer(rng, layer_type, n_blocks=10)
    path = str(tmp_path / "m.vxblx")
    jio.save_layer(src, path)
    src_blocks = np.asarray(src.block_ijk)[:10]
    target = _random_layer(rng, layer_type, blocks=np.concatenate(
        [src_blocks[::2], src_blocks[1::2] + 20]))
    s = getattr(jio, strategy)
    assert s == getattr(tio, strategy)
    shared = np.asarray(jlayer.lookup_blocks(target, src.block_ijk)) >= 0
    assert (shared & np.asarray(src.active_mask())).any()
    if strategy == "PROHIBIT":
        with pytest.raises(ValueError):
            jio.load_layer(path, layer_type, into=target, strategy=s)
        with pytest.raises(ValueError):
            tio.load_layer(path, layer_type, into=_to_port(target),
                           strategy=s)
        return
    ref = _np(jio.load_layer(path, layer_type, into=target, strategy=s))
    got = _np(tio.load_layer(path, layer_type, into=_to_port(target),
                             strategy=s))
    torch_parity.assert_layers_equal(ref, got)


def test_golden_file_from_cpp_protobuf(tmp_path):
    """A .vxblx written by a C++ program through google::protobuf coded
    streams (csrc/golden_writer.cc) loads with the values tests/test_io.py
    asserts."""
    if shutil.which("g++") is None or shutil.which("protoc") is None:
        pytest.skip("no native toolchain")
    build = tmp_path / "build"
    build.mkdir()
    proto_dir = os.path.join(REPO, "voxblox_tpu", "io", "proto")
    subprocess.run(
        ["protoc", f"-I{proto_dir}", f"--cpp_out={build}",
         os.path.join(proto_dir, "voxblox", "Layer.proto"),
         os.path.join(proto_dir, "voxblox", "Block.proto")], check=True)
    exe = str(build / "golden_writer")
    subprocess.run(
        ["g++", "-std=c++17", "-I" + str(build),
         os.path.join(REPO, "csrc", "golden_writer.cc"),
         str(build / "voxblox" / "Layer.pb.cc"),
         str(build / "voxblox" / "Block.pb.cc"), "-lprotobuf", "-o", exe],
        check=True, capture_output=True)
    golden = str(tmp_path / "golden.vxblx")
    subprocess.run([exe, golden], check=True)

    layer = tio.load_layer(golden, "tsdf", max_blocks=16, device="cpu")
    assert layer.vps == 4 and abs(layer.voxel_size - 0.25) < 1e-9
    slot = int(tlayer.lookup_blocks(
        layer, torch.tensor([[1, -2, 0]], dtype=torch.int32))[0])
    assert slot >= 0
    d = layer.channels["tsdf"][slot].numpy()
    w = layer.channels["weight"][slot].numpy()
    c = layer.channels["color"][slot].numpy().reshape(-1, 3)
    i = np.arange(64)
    i32 = i.astype(np.float32)
    np.testing.assert_array_equal(d, np.float32(0.01) * i32 - np.float32(0.3))
    np.testing.assert_array_equal(w, np.float32(0.5) + np.float32(0.01) * i32)
    np.testing.assert_array_equal(c[:, 0], (i * 3) % 256)
    np.testing.assert_array_equal(c[:, 1], (i * 5) % 256)
    np.testing.assert_array_equal(c[:, 2], (i * 7) % 256)


# ---------------------------------------------------------------------------
# .npz checkpoints, PLY, layer messages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("layer_type", ["tsdf", "esdf"])
def test_npz_both_ways(tmp_path, rng, layer_type):
    jl = _random_layer(rng, layer_type)
    jpath, tpath = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    jnpz.save_npz(jl, jpath)
    tnpz.save_npz(_to_port(jl), tpath)
    ref = _np(jl)
    # Bit for bit, rows and table included, whichever package wrote it.
    torch_parity.assert_layers_equal(ref, _np(tnpz.load_npz(jpath, "cpu")))
    torch_parity.assert_layers_equal(ref, _np(jnpz.load_npz(tpath)))
    zj, zt = np.load(jpath), np.load(tpath)
    assert sorted(zj.files) == sorted(zt.files)
    for k in zj.files:
        np.testing.assert_array_equal(zt[k], zj[k], err_msg=k)
        assert zt[k].dtype == zj[k].dtype, k


def test_ply_bytes_and_read(tmp_path, rng):
    verts = rng.uniform(-1, 1, (30, 3)).astype(np.float32)
    normals = rng.uniform(-1, 1, (30, 3)).astype(np.float32)
    colors = rng.integers(0, 256, (30, 3)).astype(np.uint8)
    faces = np.arange(30, dtype=np.int32).reshape(-1, 3)
    for i, kw in enumerate([dict(normals=normals, colors=colors, faces=faces),
                            dict(normals=normals), dict(colors=colors), {},
                            dict(normals=normals, colors=colors, faces=faces,
                                 ascii=True)]):
        jp, tp = str(tmp_path / f"j{i}.ply"), str(tmp_path / f"t{i}.ply")
        jply.write_mesh_ply(jp, verts, **kw)
        tply.write_mesh_ply(tp, verts, **kw)
        assert _read(tp) == _read(jp), kw.keys()
        ref, got = jply.read_ply(jp), tply.read_ply(tp)
        assert sorted(got) == sorted(ref)
        for k in ref:
            np.testing.assert_array_equal(got[k], ref[k])
    np.testing.assert_array_equal(got["colors"], colors)
    np.testing.assert_array_equal(got["faces"], faces)


@pytest.mark.parametrize("layer_type", ["tsdf", "esdf"])
def test_sdf_pointcloud_ply(tmp_path, rng, layer_type):
    jl = _random_layer(rng, layer_type, n_blocks=4)
    if layer_type == "tsdf":  # some voxels unobserved
        w = np.asarray(jl.channels["weight"])
        jl = dataclasses.replace(jl, channels=dict(
            jl.channels, weight=jnp.asarray(np.where(w < 0, 0.0, w))))
    jp, tp = str(tmp_path / "j.ply"), str(tmp_path / "t.ply")
    n = jply.sdf_layer_to_pointcloud_ply(jl, jp, surface_distance=1.5)
    assert tply.sdf_layer_to_pointcloud_ply(_to_port(jl), tp,
                                            surface_distance=1.5) == n > 0
    assert _read(tp) == _read(jp)


def test_layer_messages_byte_equal_with_actions(rng):
    """Block-exchange messages (the ROS layer pub/sub equivalent): full
    UPDATE, a delta of the DIRTY_MAP blocks, MERGE and RESET."""
    jl = _random_layer(rng, "tsdf", n_blocks=8)
    tl = _to_port(jl)
    jmsg, jl = jconv.serialize_layer_msg(jl, jconv.UPDATE)
    tmsg, tl = tconv.serialize_layer_msg(tl, tconv.UPDATE)
    assert tmsg == jmsg
    jrx = jconv.deserialize_layer_msg(jmsg, max_blocks=64)
    trx = tconv.deserialize_layer_msg(tmsg, max_blocks=64, device="cpu")
    torch_parity.assert_layers_equal(_np(jrx), _np(trx))
    # Delta: only the re-marked block travels; the bit is cleared after.
    jl = jlayer.clear_dirty(jl, jlayer.DIRTY_MAP)
    tl = tlayer.clear_dirty(tl, tlayer.DIRTY_MAP)
    jl = jlayer.mark_dirty(jl, jnp.asarray([3]), jnp.ones(1, bool),
                           jlayer.DIRTY_MAP)
    tl = tlayer.mark_dirty(tl, torch.tensor([3]), torch.ones(1, dtype=bool),
                           tlayer.DIRTY_MAP)
    jd, jl = jconv.serialize_layer_msg(jl, jconv.UPDATE, only_updated=True)
    td, tl = tconv.serialize_layer_msg(tl, tconv.UPDATE, only_updated=True)
    assert td == jd and len(td) < len(tmsg)
    torch_parity.assert_layers_equal(_np(jl), _np(tl))
    assert int(tlayer.dirty_mask(tl, tlayer.DIRTY_MAP).sum()) == 0
    for action in (tconv.MERGE, tconv.RESET):
        msg = bytes([action]) + td[1:]
        ref = _np(jconv.deserialize_layer_msg(msg, jrx))
        got = _np(tconv.deserialize_layer_msg(msg, trx))
        torch_parity.assert_layers_equal(ref, got)
    assert int(got["block_flags"].astype(bool).sum()) == 1  # RESET


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("layer_type", LAYER_TYPES)
def test_save_load_on_the_card_bit_equal(tmp_path, rng, layer_type,
                                         cuda_device):
    jl = _random_layer(rng, layer_type)
    cpu = _to_port(jl)
    card = tlayer.layer_from_numpy(tlayer.layer_to_numpy(cpu), cuda_device)
    cp, gp = str(tmp_path / "c.vxblx"), str(tmp_path / "g.vxblx")
    tio.save_layer(cpu, cp)
    tio.save_layer(card, gp)
    assert _read(gp) == _read(cp)
    back = tio.load_layer(cp, layer_type, max_blocks=64, device=cuda_device)
    torch_parity.assert_layers_equal(
        _np(tio.load_layer(cp, layer_type, max_blocks=64, device="cpu")),
        _np(back))
