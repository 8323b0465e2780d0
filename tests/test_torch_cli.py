"""Port parity, the command line and its inputs: ROS bag codecs (byte for
byte the JAX package's), the committed cow fixture replayed through both
packages' ``run_rosbag``, every CLI command with ``--device cpu`` (its
files read back by the JAX CLI), the dataset pipeline and the timing
registry.
"""

import json
import os
import struct
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voxblox_tpu.core.config import MapConfig as JMap
from voxblox_tpu.core.config import TsdfIntegratorConfig as JTsdf
from voxblox_tpu.io import layer_io as jio
from voxblox_tpu.io import ply as jply
from voxblox_tpu.io import rosbag as jbag
from voxblox_tpu.server import cli as jcli
from voxblox_tpu.server import dataset as jds
from voxblox_tpu.server.mapper import TsdfServer as JTsdfServer
from voxblox_tpu.sim import world as jsw
from voxblox_tpu_torch.core import layer as tlayer
from voxblox_tpu_torch.core.config import MapConfig, TsdfIntegratorConfig
from voxblox_tpu_torch.io import layer_io as tio
from voxblox_tpu_torch.io import ply as tply
from voxblox_tpu_torch.io import rosbag as tbag
from voxblox_tpu_torch.server import cli as tcli
from voxblox_tpu_torch.server import dataset as tds
from voxblox_tpu_torch.server.mapper import TsdfServer
from voxblox_tpu_torch.utils import timing

import torch_parity

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "data", "cow_fixture.bag")
CLOUD_TOPIC = "/camera/depth_registered/points"
POSE_TOPIC = "/kinect/vrpn_client/estimated_transform"


def _read(path):
    with open(path, "rb") as f:
        return f.read()


# ---------------------------------------------------------------------------
# Bag codecs
# ---------------------------------------------------------------------------


def test_message_codecs_byte_equal(rng):
    pts = rng.normal(size=(60, 3)).astype(np.float32)
    cols = rng.integers(0, 256, (60, 3)).astype(np.float32)
    t = np.array([1.0, -2.0, 0.5])
    q = np.array([0.1, 0.2, 0.3, 0.926])
    for args, kw in [((pts, cols), dict(stamp_sec=12.25, frame_id="cam")),
                     ((pts,), dict(stamp_sec=3.0)),
                     ((pts, cols), dict(height=6))]:
        raw = tbag.encode_pointcloud2(*args, **kw)
        assert raw == jbag.encode_pointcloud2(*args, **kw)
        got, ref = tbag.decode_pointcloud2(raw), jbag.decode_pointcloud2(raw)
        assert sorted(got) == sorted(ref)
        for k in ref:
            if isinstance(ref[k], np.ndarray):
                np.testing.assert_array_equal(got[k], ref[k])
            else:
                assert got[k] == ref[k], k
    raw = tbag.encode_transform_stamped(3.5, "world", "kinect", t, q)
    assert raw == jbag.encode_transform_stamped(3.5, "world", "kinect", t, q)
    d, n = tbag.decode_transform_stamped(raw)
    assert n == len(raw) and d["child_frame_id"] == "kinect"
    np.testing.assert_array_equal(d["quaternion"], q)
    tf = [(1.0, "world", "a", t, q), (2.0, "world", "b", -t, q)]
    raw = tbag.encode_tf_message(tf)
    assert raw == jbag.encode_tf_message(tf)
    assert [d["child_frame_id"] for d in tbag.decode_tf_message(raw)] == [
        "a", "b"]


@pytest.mark.parametrize("compression,indexed", [("none", True),
                                                 ("bz2", True),
                                                 ("none", False)])
def test_bags_byte_equal(tmp_path, compression, indexed):
    pts = np.arange(30, dtype=np.float32).reshape(10, 3)
    msgs = [("/tf", "tf2_msgs/TFMessage", 0.5, tbag.encode_tf_message(
        [(0.5, "w", "c", [0.0, 1.0, 0.0], [0.0, 0.0, 0.0, 1.0])]))]
    msgs += [(CLOUD_TOPIC, "sensor_msgs/PointCloud2", 1.0 + i,
              tbag.encode_pointcloud2(pts + i, stamp_sec=1.0 + i))
             for i in range(6)]
    tp, jp = str(tmp_path / "t.bag"), str(tmp_path / "j.bag")
    kw = dict(compression=compression, indexed=indexed, chunk_threshold=512)
    tbag.write_bag(tp, msgs, **kw)
    jbag.write_bag(jp, msgs, **kw)
    assert _read(tp) == _read(jp)
    got = list(tbag.read_messages(tp))
    assert got == list(jbag.read_messages(jp))
    assert [(g[0], g[1], g[3]) for g in got] == [(m[0], m[1], m[3])
                                                 for m in msgs]
    traj = tbag.trajectory_from_bag(tp, "/tf", child_frame_id="c")
    np.testing.assert_array_equal(traj.positions, [[0.0, 1.0, 0.0]])


# ---------------------------------------------------------------------------
# The cow fixture, replayed by both packages
# ---------------------------------------------------------------------------


def test_fixture_replay_matches_jax():
    """tests/data/cow_fixture.bag (indexed, multi-chunk, bz2) through both
    packages' run_rosbag as tests/test_rosbag.py replays it: the same
    blocks, TSDF and weights within 1e-5."""
    with open(FIXTURE, "rb") as f:
        assert f.readline() == tbag.MAGIC
        buf = f.read()
    fields = tbag._decode_fields(buf[4:4 + struct.unpack_from("<I", buf)[0]])
    assert struct.unpack("<I", fields["chunk_count"])[0] > 1
    res, fov = (48 // 2, 36 // 2), 60.0
    jsrv = JTsdfServer(JMap(voxel_size=0.1, max_blocks=1024),
                       integrator_config=JTsdf(default_truncation_distance=0.4,
                                               max_ray_length_m=8.0),
                       method="projective", projective_resolution=res,
                       projective_fov_deg=fov)
    tsrv = TsdfServer(MapConfig(voxel_size=0.1, max_blocks=1024),
                      integrator_config=TsdfIntegratorConfig(
                          default_truncation_distance=0.4,
                          max_ray_length_m=8.0),
                      method="projective", projective_resolution=res,
                      projective_fov_deg=fov, device="cpu")
    kw = dict(pointcloud_topic=CLOUD_TOPIC, pose_topic=POSE_TOPIC)
    js = jbag.run_rosbag(jsrv, FIXTURE, **kw)
    ts = tbag.run_rosbag(tsrv, FIXTURE, **kw)
    assert ts == js and ts["integrated"] == 5
    ref = torch_parity.jax_layer_to_numpy(jsrv.layer)
    got = tlayer.layer_to_numpy(tsrv.layer)
    assert int(got["num_blocks"]) > 10
    torch_parity.assert_layers_equal(ref, got, atol=1e-5,
                                     channels=["tsdf", "weight"])


# ---------------------------------------------------------------------------
# The command line
# ---------------------------------------------------------------------------


def _map_file(tmp_path):
    w = jsw.SimulationWorld()
    w.add_sphere((0.0, 0.0, 1.0), 0.8, color=(200, 40, 40))
    layer = jsw.generate_gt_layer(w.freeze(), "tsdf", 0.1, (-1.5, -1.5, -0.5),
                                  (1.5, 1.5, 2.5), max_dist=0.4, vps=8,
                                  max_blocks=512)
    path = str(tmp_path / "m.vxblx")
    jio.save_layer(layer, path)
    return path


def _run(main, argv, capsys):
    assert main(argv) == 0
    return capsys.readouterr().out


def test_cli_map_commands_on_cpu(tmp_path, capsys):
    """info, mesh, tsdf-to-esdf, traversable and eval with --device cpu,
    against the JAX CLI on the same files."""
    path = _map_file(tmp_path)
    cpu = ["--device", "cpu"]
    assert (_run(tcli.main, ["info", path] + cpu, capsys)
            == _run(jcli.main, ["info", path], capsys))
    # mesh: the soup vertex for vertex, the welded mesh face for face.
    for extra in (["--soup"], [], ["--color-mode", "lambert"]):
        tp, jp = str(tmp_path / "t.ply"), str(tmp_path / "j.ply")
        out = _run(tcli.main, ["mesh", path, tp] + extra + cpu, capsys)
        assert out.replace(tp, jp) == _run(jcli.main, ["mesh", path, jp]
                                           + extra, capsys)
        got, ref = tply.read_ply(tp), jply.read_ply(jp)
        assert got["faces"].shape == ref["faces"].shape
        if extra == ["--soup"]:
            np.testing.assert_allclose(got["vertices"], ref["vertices"],
                                       atol=1e-5)
            np.testing.assert_array_equal(got["colors"], ref["colors"])
    # tsdf-to-esdf: the JAX CLI reads the port's file; the ESDFs agree.
    te, je = str(tmp_path / "te.vxblx"), str(tmp_path / "je.vxblx")
    small = ["--max-distance", "1.0", "--max-blocks", "256"]
    _run(tcli.main, ["tsdf-to-esdf", path, te] + small + cpu, capsys)
    _run(jcli.main, ["tsdf-to-esdf", path, je] + small, capsys)
    info = _run(jcli.main, ["info", te], capsys)
    assert info == _run(jcli.main, ["info", je], capsys)
    assert "type=tsdf" in info and "type=esdf" in info
    torch_parity.assert_layers_equal(
        torch_parity.jax_layer_to_numpy(jio.load_layer(je, "esdf")),
        torch_parity.jax_layer_to_numpy(jio.load_layer(te, "esdf")),
        atol=1e-5)
    # traversable: the same cloud.
    tt, jt = str(tmp_path / "tt.ply"), str(tmp_path / "jt.ply")
    out = _run(tcli.main, ["traversable", je, tt, "--radius", "0.3"] + cpu,
               capsys)
    assert out.replace(tt, jt) == _run(
        jcli.main, ["traversable", je, jt, "--radius", "0.3"], capsys)
    assert _read(tt) == _read(jt)
    # eval: the same statistics, and a recoloured mesh.
    v = np.random.default_rng(0).normal(size=(200, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    gt = str(tmp_path / "gt.ply")
    jply.write_mesh_ply(gt, (v * 0.8 + [0, 0, 1.0]).astype(np.float32))
    rec = str(tmp_path / "rec.ply")
    out = _run(tcli.main, ["eval", path, gt, "--recolor-mesh", rec] + cpu,
               capsys)
    ref = _run(jcli.main, ["eval", path, gt], capsys)
    got = json.loads(out[:out.index("}") + 1])
    ref = json.loads(ref)
    assert got["num_evaluated"] == ref["num_evaluated"] > 150
    for k in ("mean_abs_error", "rmse", "max_abs_error"):
        assert abs(got[k] - ref[k]) < 1e-6, k
    assert os.path.getsize(rec) > 1000
    # sim-bench, ported now: the fast integrator and the batch ESDF at a
    # small size print the TSDF and ESDF rows.
    out = _run(tcli.main, ["sim-bench", "--voxel-size", "0.4", "--viewpoints",
                           "2", "--width", "32", "--height", "24",
                           "--max-blocks", "64", "--method", "fast",
                           "--batch-esdf"] + cpu, capsys)
    assert "TSDF: rmse=" in out and "ESDF: rmse=" in out, out
    assert "integrate/fast" in out and "OCC:" not in out, out


def test_cli_replay_on_cpu(tmp_path, capsys):
    """replay --esdf of the cow fixture: the map file holds TSDF and ESDF
    with the JAX replay's blocks, and the JAX CLI reads it."""
    tm, jm = str(tmp_path / "t.vxblx"), str(tmp_path / "j.vxblx")
    tmesh = str(tmp_path / "t.ply")
    args = ["replay", FIXTURE, "--voxel-size", "0.2", "--max-ray-length",
            "5", "--max-blocks", "128", "--esdf", "--output-map"]
    out = _run(tcli.main, args + [tm, "--output-mesh", tmesh, "--device",
                                  "cpu"], capsys)
    assert "'integrated': 5" in out and os.path.getsize(tmesh) > 1000
    _run(jcli.main, args + [jm], capsys)
    info = _run(jcli.main, ["info", tm], capsys)
    assert info == _run(jcli.main, ["info", jm], capsys)
    for lt in ("tsdf", "esdf"):
        ref = torch_parity.jax_layer_to_numpy(jio.load_layer(jm, lt))
        got = tlayer.layer_to_numpy(tio.load_layer(tm, lt, device="cpu"))
        n = int(ref["num_blocks"])
        assert n > 10 and int(got["num_blocks"]) == n
        np.testing.assert_array_equal(got["block_ijk"][:n],
                                      ref["block_ijk"][:n])


def test_cli_help_and_device_default(capsys):
    with pytest.raises(SystemExit):
        tcli.main(["--help"])
    assert "replay" in capsys.readouterr().out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tcli.main(["eval", "missing.vxblx", "missing.ply"])


# ---------------------------------------------------------------------------
# The dataset pipeline and the timing registry
# ---------------------------------------------------------------------------


def _rot_to_quat(R):
    w = np.sqrt(max(0.0, 1 + R[0, 0] + R[1, 1] + R[2, 2])) / 2
    return ((R[2, 1] - R[1, 2]) / (4 * w), (R[0, 2] - R[2, 0]) / (4 * w),
            (R[1, 0] - R[0, 1]) / (4 * w), w)


def test_dataset_pipeline_matches_jax(tmp_path):
    """tests/test_dataset.py's RGB-D folder and TUM poses through both
    packages' run_dataset: the same lookups, clouds and map."""
    path = str(tmp_path / "poses.txt")
    with open(path, "w") as f:
        f.write("# ts tx ty tz qx qy qz qw\n0.0 0 0 0  0 0 0 1\n"
                "1.0 1 0 0  0 0 0 1\n2.0 1 1 0  0 0 0.7071068 0.7071068\n")
    jt, tt = jds.TumTrajectory.load(path), tds.TumTrajectory.load(path)
    for stamp in (0.5, 1.5, 2.0, 2.05, 5.0):
        a, b = tt.lookup(stamp), jt.lookup(stamp)
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a[0], b[0])
            np.testing.assert_array_equal(a[1], b[1])
    depth = np.full((4, 6), 2.0, np.float32)
    depth[0, 0] = np.nan
    for a, b in zip(tds.depth_image_to_pointcloud(depth, (10, 10, 3, 2)),
                    jds.depth_image_to_pointcloud(depth, (10, 10, 3, 2))):
        np.testing.assert_array_equal(a, b)

    w = jsw.SimulationWorld()
    w.add_sphere((0.0, 0.0, 2.0), 1.0)
    objs = w.freeze()
    res, fov = (32, 24), np.deg2rad(60.0)
    fx = res[0] / (2 * np.tan(fov / 2))
    intr = (fx, fx, res[0] / 2.0, res[1] / 2.0)
    root = tmp_path / "frames"
    root.mkdir()
    lines = []
    for i, ang in enumerate([0.0, 0.5]):
        origin = np.array([4 * np.sin(ang), -4 * np.cos(ang), 2.0],
                          np.float32)
        view = -origin + [0, 0, 2.0]
        view = view / np.linalg.norm(view)
        R = np.asarray(jsw.rotation_from_two_vectors(
            jnp.asarray([0.0, 0.0, 1.0]), jnp.asarray(view, jnp.float32)))
        pts_G, _, valid = jsw.pointcloud_from_viewpoint(
            objs, jnp.asarray(origin), jnp.asarray(view), res, fov, 8.0)
        pts_C = np.asarray(jsw.world_points_to_sensor(
            (jnp.asarray(R), jnp.asarray(origin)), pts_G, valid))
        np.save(root / f"{float(i):.1f}.npy",
                pts_C[:, 2].reshape(res[0], res[1]).T)
        q = _rot_to_quat(R)
        lines.append(f"{float(i):.1f} {origin[0]} {origin[1]} {origin[2]} "
                     f"{q[0]} {q[1]} {q[2]} {q[3]}")
    (tmp_path / "traj.txt").write_text("\n".join(lines))
    kw = dict(method="projective", projective_resolution=res,
              projective_fov_deg=60.0)
    jsrv = JTsdfServer(JMap(voxel_size=0.2, max_blocks=512),
                       integrator_config=JTsdf(default_truncation_distance=0.8,
                                               max_ray_length_m=8.0), **kw)
    tsrv = TsdfServer(MapConfig(voxel_size=0.2, max_blocks=512),
                      integrator_config=TsdfIntegratorConfig(
                          default_truncation_distance=0.8,
                          max_ray_length_m=8.0), device="cpu", **kw)
    traj = str(tmp_path / "traj.txt")
    js = jds.run_dataset(jsrv, jds.DepthFolderDataset(str(root), intr),
                         jds.TumTrajectory.load(traj))
    ts = tds.run_dataset(tsrv, tds.DepthFolderDataset(str(root), intr),
                         tds.TumTrajectory.load(traj))
    assert ts == js == {"integrated": 2, "skipped_no_pose": 0}
    got = tlayer.layer_to_numpy(tsrv.layer)
    assert int(got["num_blocks"]) > 5
    torch_parity.assert_layers_equal(
        torch_parity.jax_layer_to_numpy(jsrv.layer), got, atol=1e-5,
        channels=["tsdf", "weight"])


def test_timing_registry():
    timing.reset()
    with timing.timer("integrate/test", annotate=False):
        time.sleep(0.01)
    with timing.timer("mesh/test"):  # a torch.profiler span too
        pass
    t = timing.Timer("esdf/test")
    time.sleep(0.005)
    t.stop()
    d = timing.as_dict()
    assert d["integrate/test"]["calls"] == 1
    assert d["integrate/test"]["mean_ms"] >= 5
    assert {"esdf/test", "mesh/test"} <= set(d)
    assert "integrate/test" in timing.print_timing()
    timing.DummyTimer("x").stop()
    timing.enabled = False
    with timing.timer("off"):
        pass
    timing.enabled = True
    assert "off" not in timing.as_dict()
    timing.reset()
    assert timing.as_dict() == {}
