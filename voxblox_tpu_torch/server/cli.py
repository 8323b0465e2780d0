"""Command-line tools of the port (port of voxblox_tpu/server/cli.py), the
equivalents of the reference's standalone binaries:

- ``replay``       replay a ROS1 bag (cow-and-lady style: PointCloud2 +
  transform topic) into a map, optionally with the ESDF, and save it.
- ``eval``         <- voxblox_eval.cc: a .vxblx map against a ground-truth
  PLY cloud; interpolated per-point error statistics.
- ``mesh``         <- visualize_tsdf.cc: marching-cubes mesh of a map, PLY.
- ``tsdf-to-esdf`` <- test/tsdf_to_esdf.cc: offline ESDF regeneration.
- ``traversable``  the ESDF's traversable cloud (distance > robot radius).
- ``info``         the layer headers of a map file.
- ``sim-bench``    <- SimulationServer + simulation_eval.cc: the synthetic
  end-to-end benchmark (render -> integrate -> ESDF -> evaluate against
  ground truth), with ``--occupancy`` also occupancy and its ESDF.

Every command takes ``--device`` (default ``cuda``; ``cpu`` runs the port
on the CPU). Usage: ``python -m voxblox_tpu_torch.server.cli <command>``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import numpy as np


def cmd_sim_bench(args):
    from ..sim import world as sw
    from ..utils import timing
    from .mapper import SimulationServer

    w = sw.SimulationWorld()
    w.add_cylinder((0.0, 0.0, 2.0), 2.0, 4.0, color=(0, 255, 0))
    w.add_ground_level(0.0)
    w.min_bound = np.array([-5.0, -5.0, -0.5], np.float32)
    w.max_bound = np.array([5.0, 5.0, 5.5], np.float32)
    srv = SimulationServer(
        w, voxel_size=args.voxel_size, method=args.method,
        camera_res=(args.width, args.height), max_blocks=args.max_blocks,
        incremental_esdf=not args.batch_esdf,
        generate_occupancy=args.occupancy, device=args.device)
    result = srv.run(n_viewpoints=args.viewpoints, seed=args.seed)
    print("TSDF:", result["tsdf"])
    print("ESDF:", result["esdf"])
    if args.occupancy:
        print("OCC:", result["occ"])
        print("ESDF-OCC:", result["esdf_occ"])
    print(timing.print_timing())
    if args.output_mesh:
        from ..io import ply
        from ..ops import mesh as mesh_ops

        ml = mesh_ops.MeshLayer(srv.tsdf_layer.block_size)
        mesh_ops.generate_mesh(srv.tsdf_layer, ml, only_updated=False)
        ply.mesh_layer_to_ply(ml, args.output_mesh)
        print(f"mesh written to {args.output_mesh}")
    if args.output_map:
        from ..io import layer_io

        layer_io.save_layer(srv.tsdf_layer, args.output_map)
        layer_io.save_layer(srv.esdf_layer, args.output_map, append=True)
        print(f"map written to {args.output_map}")
    return 0


def cmd_eval(args):
    """voxblox_eval.cc: the interpolated map distance at ground-truth
    surface points should be ~0; abs-error statistics. With
    ``--recolor-mesh``, colour the map voxels at the points by |error|
    (gray map, voxblox_eval.cc:199-207) and write that mesh."""
    import torch

    from .. import _runtime
    from ..io import layer_io, ply
    from ..ops import interp

    dev = _runtime.resolve_device(args.device)
    layer = layer_io.load_layer(args.map, "tsdf", max_blocks=args.max_blocks,
                                device=dev)
    gt = ply.read_ply(args.gt_ply)
    pts = torch.as_tensor(gt["vertices"], dtype=torch.float32, device=dev)
    d_t, valid_t = interp.interpolate(layer, pts)
    d, valid = _runtime.to_host(d_t), _runtime.to_host(valid_t)
    err = np.abs(d[valid])
    stats = {
        "num_points": int(len(pts)),
        "num_evaluated": int(valid.sum()),
        "mean_abs_error": float(err.mean()) if len(err) else None,
        "rmse": float(np.sqrt((err ** 2).mean())) if len(err) else None,
        "max_abs_error": float(err.max()) if len(err) else None,
    }
    print(json.dumps(stats, indent=2))
    if args.recolor_mesh:
        from ..core import grid
        from ..core import layer as vlayer
        from ..ops import mesh as mesh_ops
        from ..utils import color_maps

        trunc = 2.0 * layer.voxel_size
        rgb = color_maps.grayscale_color_map(
            np.clip(np.abs(d) / trunc, 0.0, 1.0))
        gvi = grid.point_to_grid_index(pts, 1.0 / layer.voxel_size)
        layer = vlayer.set_voxels(layer, "color", gvi,
                                  torch.as_tensor(rgb, device=dev),
                                  valid=valid_t)
        ml = mesh_ops.MeshLayer(layer.block_size)
        mesh_ops.generate_mesh(layer, ml, only_updated=False)
        ply.mesh_layer_to_ply(ml, args.recolor_mesh)
        print(f"error-recolored mesh written to {args.recolor_mesh}")
    return 0


def cmd_mesh(args):
    from ..io import layer_io, ply
    from ..ops import mesh as mesh_ops
    from ..utils import mesh_vis

    layer = layer_io.load_layer(args.map, args.layer,
                                max_blocks=args.max_blocks,
                                device=args.device)
    ml = mesh_ops.MeshLayer(layer.block_size)
    mesh_ops.generate_mesh(layer, ml, only_updated=False)
    if args.color_mode == "color" and args.layer == "tsdf":
        ply.mesh_layer_to_ply(ml, args.output, connected=not args.soup)
    else:
        mode = "gray" if args.color_mode == "color" else args.color_mode
        mesh_vis.export_mesh(ml, args.output, mode=mode,
                             connected=not args.soup)
    print(f"{ml.num_vertices()} vertices -> {args.output}")
    return 0


def cmd_tsdf_to_esdf(args):
    from .. import _runtime
    from ..core import layer as vlayer
    from ..core.config import EsdfIntegratorConfig
    from ..io import layer_io
    from ..ops import esdf as esdf_ops

    tsdf_layer = layer_io.load_layer(args.input, "tsdf",
                                     max_blocks=args.max_blocks,
                                     device=args.device)
    cfg = EsdfIntegratorConfig(max_distance_m=args.max_distance,
                               default_distance_m=args.max_distance)
    esdf_layer = vlayer.make_layer("esdf", tsdf_layer.voxel_size,
                                   vps=tsdf_layer.vps,
                                   max_blocks=tsdf_layer.max_blocks,
                                   device=tsdf_layer.device)
    esdf_layer, overflow, iters = esdf_ops.update_from_tsdf_batch(
        esdf_layer, tsdf_layer, cfg)
    if _runtime.host_bool(overflow):
        raise MemoryError("ESDF pool overflow")
    layer_io.save_layer(tsdf_layer, args.output)
    layer_io.save_layer(esdf_layer, args.output, append=True)
    print(f"esdf computed in {int(iters)} sweeps -> {args.output}")
    return 0


def cmd_replay(args):
    """Replay a ROS1 bag (cow-and-lady style: PointCloud2 + transform
    topic, cow_and_lady_dataset.launch wiring) through a mapper server."""
    from ..core.config import MapConfig, derive_defaults
    from ..io import layer_io, rosbag
    from .mapper import EsdfServer, TsdfServer

    tcfg, ecfg = derive_defaults(args.voxel_size)
    tcfg = dataclasses.replace(tcfg, max_ray_length_m=args.max_ray_length)
    map_cfg = MapConfig(voxel_size=args.voxel_size,
                        max_blocks=args.max_blocks)
    if args.esdf:
        srv = EsdfServer(map_cfg, integrator_config=tcfg, esdf_config=ecfg,
                         method=args.method, device=args.device)
    else:
        srv = TsdfServer(map_cfg, integrator_config=tcfg, method=args.method,
                         device=args.device)
    stats = rosbag.run_rosbag(
        srv, args.bag, pointcloud_topic=args.pointcloud_topic,
        pose_topic=args.pose_topic, child_frame_id=args.child_frame,
        update_esdf_every=5 if args.esdf else 0)
    print(stats)
    if args.output_map:
        layer_io.save_layer(srv.layer, args.output_map)
        if args.esdf:
            layer_io.save_layer(srv.esdf_layer, args.output_map, append=True)
        print(f"map written to {args.output_map}")
    if args.output_mesh:
        from ..io import ply
        from ..ops import mesh as mesh_ops

        ml = mesh_ops.MeshLayer(srv.layer.block_size)
        mesh_ops.generate_mesh(srv.layer, ml, only_updated=False)
        ply.mesh_layer_to_ply(ml, args.output_mesh)
        print(f"mesh written to {args.output_mesh}")
    return 0


def cmd_traversable(args):
    """EsdfServer traversable cloud (esdf_server.cc:136-142): the observed
    ESDF voxels with distance > robot radius as a PLY point cloud,
    coloured by distance (rainbow)."""
    from ..core.config import MapConfig
    from ..io import layer_io, ply
    from ..models.maps import EsdfMap
    from ..utils.color_maps import rainbow_color_map

    layer = layer_io.load_layer(args.map, "esdf", max_blocks=args.max_blocks,
                                device=args.device)
    emap = EsdfMap(layer, MapConfig(voxel_size=layer.voxel_size,
                                    voxels_per_side=layer.vps))
    pts, dist = emap.traversable_points(args.radius)
    span = max(float(np.abs(dist).max()), 1e-6) if len(dist) else 1.0
    colors = rainbow_color_map(0.5 + 0.5 * dist / span)
    ply.write_mesh_ply(args.output, pts, colors=np.asarray(colors))
    print(f"{len(pts)} traversable points (radius {args.radius}) "
          f"-> {args.output}")
    return 0


def cmd_info(args):
    from ..io import layer_io

    for hdr, n_blocks in layer_io.read_headers(args.map):
        print(f"layer type={hdr.type} voxel_size={hdr.voxel_size} "
              f"vps={hdr.voxels_per_side} blocks={n_blocks}")
    return 0


def main(argv=None):
    p = argparse.ArgumentParser(prog="voxblox_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    def add(name, fn, **kw):
        sp = sub.add_parser(name, **kw)
        sp.add_argument("--device", default="cuda",
                        help="torch device to run on (cuda or cpu)")
        sp.set_defaults(fn=fn)
        return sp

    sb = add("sim-bench", cmd_sim_bench,
             help="synthetic end-to-end benchmark")
    sb.add_argument("--voxel-size", type=float, default=0.1)
    sb.add_argument("--method", default="merged",
                    choices=["simple", "merged", "fast", "projective"])
    sb.add_argument("--viewpoints", type=int, default=20)
    sb.add_argument("--width", type=int, default=320)
    sb.add_argument("--height", type=int, default=240)
    sb.add_argument("--max-blocks", type=int, default=4096)
    sb.add_argument("--seed", type=int, default=0)
    sb.add_argument("--batch-esdf", action="store_true")
    sb.add_argument("--occupancy", action="store_true",
                    help="also integrate occupancy + ESDF-from-occupancy "
                         "and evaluate them (simulation_server.cc:235-269)")
    sb.add_argument("--output-mesh", default=None)
    sb.add_argument("--output-map", default=None)

    ev = add("eval", cmd_eval, help="evaluate a map against a GT PLY cloud")
    ev.add_argument("map")
    ev.add_argument("gt_ply")
    ev.add_argument("--max-blocks", type=int, default=8192)
    ev.add_argument("--recolor-mesh", default=None, metavar="OUT_PLY",
                    help="write a mesh recolored by |error| at the GT "
                         "points (voxblox_eval.cc:199-246)")

    me = add("mesh", cmd_mesh, help="extract mesh from a .vxblx map")
    me.add_argument("map")
    me.add_argument("output")
    me.add_argument("--soup", action="store_true",
                    help="raw triangle soup (no vertex welding)")
    me.add_argument("--layer", default="tsdf", choices=["tsdf", "esdf"],
                    help="which layer of the file to mesh")
    me.add_argument("--color-mode", default="color",
                    choices=["color", "height", "normals", "gray",
                             "lambert", "lambert_color"],
                    help="vertex color mode (mesh_vis.h:44-51)")
    me.add_argument("--max-blocks", type=int, default=8192)

    te = add("tsdf-to-esdf", cmd_tsdf_to_esdf,
             help="offline ESDF regeneration")
    te.add_argument("input")
    te.add_argument("output")
    te.add_argument("--max-distance", type=float, default=2.0)
    te.add_argument("--max-blocks", type=int, default=8192)

    rp = add("replay", cmd_replay, help="replay a ROS1 bag into a map")
    rp.add_argument("bag")
    rp.add_argument("--pointcloud-topic",
                    default="/camera/depth_registered/points")
    rp.add_argument("--pose-topic",
                    default="/kinect/vrpn_client/estimated_transform")
    rp.add_argument("--child-frame", default=None,
                    help="filter TFMessage streams by child_frame_id")
    rp.add_argument("--voxel-size", type=float, default=0.05)
    rp.add_argument("--max-ray-length", type=float, default=5.0)
    rp.add_argument("--max-blocks", type=int, default=8192)
    rp.add_argument("--method", default="fast",
                    choices=["simple", "merged", "fast", "projective"])
    rp.add_argument("--esdf", action="store_true")
    rp.add_argument("--output-map", default=None)
    rp.add_argument("--output-mesh", default=None)

    tr = add("traversable", cmd_traversable,
             help="export the ESDF traversable cloud (distance > robot "
                  "radius)")
    tr.add_argument("map")
    tr.add_argument("output")
    tr.add_argument("--radius", type=float, default=0.3,
                    help="robot/traversability radius in meters "
                         "(esdf_server.cc:136-142)")
    tr.add_argument("--max-blocks", type=int, default=8192)

    inf = add("info", cmd_info, help="print layer headers of a map file")
    inf.add_argument("map")

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
