"""Multi-GPU sharding on ``torch.distributed``: ray data parallelism and
block-row sharding of the ESDF sweep (port of
voxblox_tpu/parallel/sharding.py).

Process model: one process (rank) drives one device, torch's model. Every
rank holds the same replicated map (hash table, block metadata and
channels) and calls the same function with the same arguments; each rank
computes only its shard, and the shards merge with ``all_reduce`` or
``all_gather`` over the mesh axis that the JAX package reduces over
with ``psum``. A ``DeviceMesh`` with the axes ``('rays', 'blocks')`` (or
``('hosts', 'chips')``) takes the place of the JAX ``Mesh``, explicit
collectives the place of ``shard_map``/``psum``.

- ``integrate_pointcloud_sharded``: every rank allocates for the whole
  cloud (identical tables), casts its contiguous ray shard, and the pool
  accumulators are summed with one ``all_reduce``; one renormalize.
- ``integrate_projective_batch_sharded``: the K-scan allocation runs on
  every rank, each rank accumulates its K / n scans, one ``all_reduce``.
- ``lower_sweep_sharded``: each rank relaxes its contiguous rows of the
  sweep's working set (K1/K2 on the card) and ``all_gather`` brings the
  other rows; the result is the unsharded ``lower_sweep``'s bit for bit.
- ``render_loss_grad_sharded``: each rank renders its ray shard and
  differentiates its loss; loss and gradient are summed with
  ``all_reduce``.

Backends (chosen by ``init_multihost``): ``nccl`` when every rank has a
CUDA device of its own, ``gloo`` for CPU ranks and for ranks that share a
card. There is no fallback from CUDA to the CPU: a mesh of
``device_type="cuda"`` without a GPU raises, and a layer on another
device than the mesh's raises. Only ``all_reduce`` and ``all_gather``
are used: gloo also runs them on CUDA tensors.

On the card the accumulator sums run in atomics order and then in the
collective's order, so integrates agree with the unsharded ones at
float-summation noise, not bit for bit; the sweep is bit-equal.
"""

from __future__ import annotations

import dataclasses
import math
import time

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from .. import _runtime
from ..ops import esdf
from ..ops import projective as proj
from ..ops import raycast, render, tsdf

# Set to a list to record every collective as {"op", "bytes", "s"}; None
# records nothing. On CUDA tensors the span is a pair of CUDA events on the
# current stream (no host sync, so a recorded call takes the time an
# unrecorded one does): read the seconds with ``collective_seconds`` after
# the device has been synchronized.
COLLECTIVES: list | None = None

_GROUPS: dict = {}  # (default group, mesh, axes) -> group of several axes
_SETUP: dict = {}  # what init_multihost chose: local ranks, device type


def _collective(op: str, tensor, call):
    if COLLECTIVES is None:
        return call()
    nbytes = tensor.numel() * tensor.element_size()
    if tensor.device.type == "cuda":
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
        start.record()
        out = call()
        end.record()
        COLLECTIVES.append(dict(op=op, bytes=nbytes, s=(start, end)))
        return out
    t0 = time.perf_counter()
    out = call()
    COLLECTIVES.append(dict(op=op, bytes=nbytes, s=time.perf_counter() - t0))
    return out


def collective_seconds(records: list) -> list:
    """``records`` (a filled ``COLLECTIVES``) with every span in seconds;
    call it after synchronizing the device."""
    return [dict(r, s=r["s"][0].elapsed_time(r["s"][1]) / 1e3)
            if isinstance(r["s"], tuple) else r for r in records]


def _all_reduce(x, op: str, group):
    """In-place ``all_reduce`` of ``x`` with ``dist.ReduceOp.<op>``."""
    _collective(f"all_reduce_{op.lower()}", x, lambda: dist.all_reduce(
        x, op=getattr(dist.ReduceOp, op), group=group))
    return x


def _all_gather(x, group, count: int):
    parts = [torch.empty_like(x) for _ in range(count)]
    _collective("all_gather", x,
                lambda: dist.all_gather(parts, x, group=group))
    return torch.cat(parts)


# ---------------------------------------------------------------------------
# Meshes and the multi-host runtime
# ---------------------------------------------------------------------------


def _require_group():
    if not dist.is_initialized():
        raise RuntimeError(
            "no process group: call init_multihost (or torch.distributed."
            "init_process_group) on every rank before building a mesh")


def make_mesh(n_devices: int | None = None, rays: int | None = None,
              device_type: str = "cuda") -> DeviceMesh:
    """A ('rays', 'blocks') ``DeviceMesh`` over the initialized process
    group, one rank per device. ``rays`` defaults to the largest divisor
    of n that is at most sqrt(n) (JAX's balanced split). A torch mesh
    spans every rank, so ``n_devices`` must equal the world size.
    ``device_type="cpu"`` asks for CPU ranks (gloo)."""
    if device_type == "cuda":
        _runtime.resolve_device("cuda")
    _require_group()
    n = n_devices or dist.get_world_size()
    if n != dist.get_world_size():
        raise ValueError(f"a mesh of {n} devices over {dist.get_world_size()}"
                         " ranks: one rank drives one device")
    if rays is None:
        rays = 1
        for cand in range(int(np.sqrt(n)), 0, -1):
            if n % cand == 0:
                rays = cand
                break
    if n % rays:
        raise ValueError(f"rays={rays} does not divide {n} devices")
    return init_device_mesh(device_type, (rays, n // rays),
                            mesh_dim_names=("rays", "blocks"))


def init_multihost(coordinator_address: str, num_processes: int,
                   process_id: int, local_device_count: int | None = None,
                   device_type: str = "cuda"):
    """Join the ``torch.distributed`` runtime of an N-rank deployment:
    every rank calls this with the same ``host:port`` before building the
    ('hosts', 'chips') mesh with ``make_multihost_mesh``.

    The one difference from the JAX package: a torch process drives one
    device, so ``num_processes`` counts ranks (JAX: hosts) and
    ``local_device_count`` is the ranks per host (JAX: virtual devices per
    process); on a card host it defaults to ``torch.cuda.device_count()``,
    on CPU rigs (``device_type="cpu"``) give it. Backend: ``gloo`` on the
    CPU; on CUDA ``nccl`` when each local rank has a card of its own, else
    ``gloo`` with the ranks sharing the cards round robin."""
    if device_type == "cpu":
        backend = "gloo"
        local = local_device_count or 1
    else:
        _runtime.resolve_device("cuda")
        cards = torch.cuda.device_count()
        local = local_device_count or cards
        torch.cuda.set_device(process_id % local % cards)
        backend = "nccl" if local <= cards else "gloo"
    if num_processes % local:
        raise ValueError(f"{num_processes} ranks are not a whole number of "
                         f"hosts of {local}")
    dist.init_process_group(backend,
                            init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)
    _GROUPS.clear()  # subgroups of an earlier, destroyed world
    _SETUP.update(local=local, device_type=device_type)
    return backend


def make_multihost_mesh() -> DeviceMesh:
    """('hosts', 'chips') mesh over every rank, one row per host (ranks
    per host as given to ``init_multihost``; JAX: one row per process).
    Shard rays over both axes with ``ray_axes=('hosts', 'chips')``."""
    _require_group()
    if not _SETUP:
        raise RuntimeError("ranks per host unknown: call init_multihost")
    world = dist.get_world_size()
    return init_device_mesh(_SETUP["device_type"],
                            (world // _SETUP["local"], _SETUP["local"]),
                            mesh_dim_names=("hosts", "chips"))


def _axes_group(mesh: DeviceMesh, axes):
    """(process group, this rank's index, count) of the ranks that differ
    only along ``axes``; the index runs row-major over ``axes`` in the
    order given, as shard_map splits a dimension over several axes."""
    names = mesh.mesh_dim_names
    dims = [names.index(a) for a in axes]
    sizes = [mesh.size(d) for d in dims]
    coord = mesh.get_coordinate()
    index = int(np.ravel_multi_index([coord[d] for d in dims], sizes))
    count = math.prod(sizes)
    if len(axes) == 1:
        return mesh.get_group(axes[0]), index, count
    # A mesh of the same shape compares equal across worlds: key on the
    # world too.
    key = (dist.group.WORLD, mesh, tuple(axes))
    if key not in _GROUPS:
        others = [d for d in range(mesh.ndim) if d not in dims]
        ranks = mesh.mesh.permute(others + dims).reshape(-1, count)
        _GROUPS[key], _ = dist.new_subgroups_by_enumeration(ranks.tolist())
    return _GROUPS[key], index, count


def _check_device(mesh: DeviceMesh, layer):
    if layer.device.type != mesh.device_type:
        raise ValueError(f"the layer is on {layer.device}, the mesh's ranks "
                         f"drive {mesh.device_type} devices")


def _check_divides(n_shards: int, n: int, what: str, of: str):
    if n % n_shards:
        raise ValueError(f"{what} ({n_shards}) must divide the {of} {n}")


def _pose(T_G_C, dev):
    if isinstance(T_G_C, tuple):
        return tuple(torch.as_tensor(x, dtype=torch.float32, device=dev)
                     for x in T_G_C)
    return torch.as_tensor(T_G_C, dtype=torch.float32, device=dev)


# ---------------------------------------------------------------------------
# Ray-sharded ray casting
# ---------------------------------------------------------------------------


def integrate_pointcloud_sharded(mesh: DeviceMesh, layer, T_G_C, points_C,
                                 colors, cfg, use_color: bool = True,
                                 ray_axes: tuple = ("rays",)):
    """Ray-sharded simple-integrator step. The point count must be
    divisible by the ray axes' total size. ``ray_axes`` names the mesh
    axes rays are split over: ('rays',) on ``make_mesh``, ('hosts',
    'chips') on ``make_multihost_mesh``. Updates the layer in place;
    returns (layer, overflowed)."""
    _check_device(mesh, layer)
    group, shard, n_shards = _axes_group(mesh, ray_axes)
    _check_divides(n_shards, points_C.shape[0], "the ray axes' size",
                   "point count")
    points_G, origin = tsdf.transform_points(_pose(T_G_C, layer.device),
                                             points_C)
    valid, clearing = tsdf.point_validity(points_C, cfg)
    weights = tsdf.point_weights(points_C, cfg)
    max_steps = cfg.max_steps or raycast.max_steps_hint(
        cfg.max_ray_length_m, cfg.default_truncation_distance,
        layer.voxel_size, cfg.voxel_carving_enabled)

    # Allocation on the full cloud on every rank: identical tables.
    seg = raycast.compute_ray_segments(
        origin.expand(points_G.shape), points_G, clearing, layer.voxel_size,
        cfg.default_truncation_distance, cfg.max_ray_length_m,
        cfg.voxel_carving_enabled)
    layer, overflowed = tsdf.allocate_for_rays(layer, seg, valid, max_steps)
    m = points_C.shape[0] // n_shards
    sl = slice(shard * m, (shard + 1) * m)
    voxels, mask = raycast.cast_rays(raycast.RaySetup(*(x[sl] for x in seg)),
                                     max_steps, valid[sl])
    sdf, w = tsdf._per_sample_contributions(voxels, mask, origin,
                                            points_G[sl], weights[sl],
                                            layer.voxel_size, cfg)
    d_w, d_wd, d_wc, d_wcw, dirty = tsdf.accumulate_contributions(
        layer, voxels, mask, sdf, w, colors[sl], cfg, use_color)
    # One all_reduce of the four pool-sized sums; ``dirty`` as int32 MAX.
    sums = _all_reduce(torch.cat([d_w[:, None], d_wd[:, None], d_wc,
                                  d_wcw[:, None]], 1), "SUM",
                       group)
    dirty = _all_reduce(dirty.to(torch.int32), "MAX", group)
    layer = tsdf.apply_contributions(layer, sums[:, 0], sums[:, 1],
                                     sums[:, 2:5], sums[:, 5], dirty > 0, cfg)
    return layer, overflowed


# ---------------------------------------------------------------------------
# Scan-sharded projective batch
# ---------------------------------------------------------------------------


def integrate_projective_batch_sharded(
    mesh: DeviceMesh, layer, Rs, ts, points_C, colors, cfg,
    kind: str = "pinhole", resolution=(320, 240),
    fov_h_rad: float = float(np.deg2rad(90.0)), fov_up_deg: float = 25.0,
    fov_down_deg: float = -25.0, intrinsics=None, pool: int = 2,
    use_color: bool = True, max_visible_blocks: int = 512,
    max_mixed_slabs: int | None = None, max_free_slabs: int | None = None,
):
    """Scan-sharded projective TSDF integration: the K scans split over
    the 'rays' axis (K % axis size == 0).

    1. Allocate, on every rank: the same K-scan candidate discovery and
       allocation in scan order, so every rank holds the table the
       unsharded batch builds.
    2. Accumulate, sharded: each rank looks up its scans' rows and adds
       their weighted deltas into a pool-sized accumulator; one
       ``all_reduce`` sums the accumulators, then one fold.

    Equal to ``integrate_*_projective_batch`` up to float summation order
    (the per-scan deltas are summed in another grouping). ``kind``:
    "pinhole" | "spherical" | "spherical_organized" | "pinhole_organized"
    (the last needs ``intrinsics`` and ``pool``). Returns (layer,
    overflowed)."""
    _check_device(mesh, layer)
    group, shard, n_shards = _axes_group(mesh, ("rays",))
    dev = layer.device
    mb = layer.max_blocks
    Rs = torch.as_tensor(Rs, dtype=torch.float32, device=dev)
    ts = torch.as_tensor(ts, dtype=torch.float32, device=dev)
    K = Rs.shape[0]
    _check_divides(n_shards, K, "the 'rays' axis size", "scan count")

    def make_img(pts, cols):
        if kind == "pinhole_organized":
            return proj.build_pinhole_range_image_organized(pts, cols, pool,
                                                            intrinsics)
        return proj._make_image(pts, cols, kind, resolution, fov_h_rad,
                                fov_up_deg, fov_down_deg)

    img, feats, hiz_flats, hiz_meta, hiz_lv = proj._build_batch_images(
        points_C, colors, cfg, make_img)

    def image(k):
        return proj.RangeImage(rng=img.rng[k], color=img.color[k],
                               params=img.params, kind=img.kind)

    # Phase 1: the K-scan allocation, replicated.
    geom = dataclasses.replace(layer, channels={})
    overflowed = torch.zeros((), dtype=torch.bool, device=dev)
    for k in range(K):
        geom, _, _, p_ovf, b_ovf = proj._discover_and_allocate(
            geom, image(k), Rs[k], ts[k], cfg,
            (hiz_flats[k], hiz_meta, hiz_lv), max_visible_blocks,
            allocate=True)
        overflowed = overflowed | p_ovf | b_ovf

    # Phase 2: this rank's scans, lookup only, then the sum over ranks.
    direct_acc = mb >= 8192  # the unsharded batch's locality trade
    acc = proj._batch_acc_init(layer, use_color)
    _, _, n_slabs, _ = proj._slab_shape(layer.vps)
    acc3 = acc.view(mb + 1, n_slabs, -1)
    ovf = torch.zeros((), dtype=torch.int32, device=dev)
    per = K // n_shards
    for k in range(shard * per, (shard + 1) * per):
        _, rows, row_ok, d6, (p_o, b_o) = proj._scan_terms(
            geom, Rs[k], ts[k], image(k), cfg, use_color, max_visible_blocks,
            max_mixed_slabs, feat=feats[k], hiz=(hiz_flats[k], hiz_meta,
                                                 hiz_lv),
            max_free_slabs=max_free_slabs, allocate=False,
            acc=acc if direct_acc else None)
        ovf = ovf | (p_o | b_o).to(torch.int32)
        if not direct_acc:
            acc3.index_add_(0, torch.where(row_ok, rows, mb).to(torch.int64),
                            d6)
    acc = _all_reduce(acc, "SUM", group)
    ovf = _all_reduce(ovf, "MAX", group)
    layer = proj._fold_batch_acc(layer, geom, acc, cfg, use_color)
    return layer, overflowed | (ovf > 0)


# ---------------------------------------------------------------------------
# Block sharding and the sharded sweep
# ---------------------------------------------------------------------------


def shard_layer_blocks(mesh: DeviceMesh, layer):
    """The layer with every channel a DTensor sharded by block rows over
    the 'blocks' axis and replicated over the others (JAX:
    ``NamedSharding(mesh, P('blocks'))``); table, block indices, flags and
    row count stay plain replicated tensors. Uneven row counts split as
    ``torch.chunk`` does. Every rank holds the same map, so each takes its
    rows of its own copy (no communication). Placement only: the port's
    functions do not dispatch through DTensor."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    _check_device(mesh, layer)
    places = [Shard(0) if name == "blocks" else Replicate()
              for name in mesh.mesh_dim_names]
    channels = {k: distribute_tensor(v, mesh, places, src_data_rank=None)
                for k, v in layer.channels.items()}
    return dataclasses.replace(layer, channels=channels)


class _RowShard:
    """This rank's contiguous rows of the sweep's working set and the
    ``all_gather`` that brings the other ranks' rows (chunks padded to
    equal length: a float sum of zero-filled buffers would turn -0.0 into
    +0.0, a gather copies bits)."""

    def __init__(self, group, index: int, count: int):
        self.group, self.index, self.count = group, index, count

    def _chunk(self, n: int) -> int:
        if n < self.count:
            raise ValueError(f"{n} rows over {self.count} ranks")
        return -(-n // self.count)

    def rows(self, n: int):
        c = self._chunk(n)
        lo = min(self.index * c, n)
        return lo, min(lo + c, n)

    def gather(self, x, n: int):
        c = self._chunk(n)
        if x.shape[0] < c:
            x = torch.cat([x, x.new_zeros((c - x.shape[0],) + x.shape[1:])])
        return _all_gather(x.contiguous(), self.group, self.count)[:n]


def lower_sweep_sharded(mesh: DeviceMesh, esdf_layer, cfg, region_rows=None):
    """The ESDF sweep with the working set's rows sharded over the
    'blocks' axis (``ops.esdf.lower_sweep`` with a row split: same working
    set, neighbour table and Morton order; each rank relaxes its rows, K1
    or K2 on the card, and gathers the rest after every outer iteration).
    Bit-equal to the unsharded ``lower_sweep`` at any axis size.

    As in the JAX package, a working-set overflow (``max_active_blocks``
    below the live set) is retried from the input with a doubled budget
    until the sweep covers everything; at the pool size it raises.
    Returns (layer, iters), the result on every rank."""
    _check_device(mesh, esdf_layer)
    shard = _RowShard(*_axes_group(mesh, ("blocks",)))
    ch = esdf_layer.channels
    run_cfg = cfg
    retry = (cfg.max_active_blocks is not None
             and cfg.max_active_blocks < esdf_layer.max_blocks)
    # The sweep writes esdf (and parent) in place: keep the input for a
    # retry.
    saved = {k: ch[k].clone() for k in ("esdf", "parent")} if retry else {}
    while True:
        layer_out, iters, region_ovf, _ = esdf.lower_sweep(
            esdf_layer, run_cfg, region_rows, shard=shard)
        if (run_cfg.max_active_blocks is None
                or not _runtime.host_bool(region_ovf)):
            return layer_out, iters
        k = min(run_cfg.max_active_blocks * 2, esdf_layer.max_blocks)
        if k == run_cfg.max_active_blocks:
            raise RuntimeError(
                "lower_sweep_sharded: working set exceeds the pool size")
        for name, x in saved.items():
            ch[name].copy_(x)
        run_cfg = dataclasses.replace(run_cfg, max_active_blocks=k)


# ---------------------------------------------------------------------------
# Ray-sharded render gradient
# ---------------------------------------------------------------------------


def render_loss_grad_sharded(mesh: DeviceMesh, layer, origins, dirs,
                             target_depth, max_distance: float):
    """Ray-sharded differentiable render loss and voxel-SDF gradient:
    loss = sum over hit rays of (depth - target)^2. Each rank renders and
    differentiates its contiguous ray shard; loss and gradient are summed
    over the 'rays' axis. Returns (loss, grad_tsdf_channel)."""
    _check_device(mesh, layer)
    group, shard, n_shards = _axes_group(mesh, ("rays",))
    _check_divides(n_shards, origins.shape[0], "the 'rays' axis size",
                   "ray count")
    m = origins.shape[0] // n_shards
    sl = slice(shard * m, (shard + 1) * m)
    ch = layer.channels["tsdf"].detach().requires_grad_(True)
    lyr = dataclasses.replace(layer, channels={**layer.channels, "tsdf": ch})
    depth, hit = render.render_depth(lyr, origins[sl], dirs[sl], max_distance)
    err = torch.where(hit, depth - target_depth[sl], 0.0)
    loss = (err * err).sum()
    grad, = torch.autograd.grad(loss, ch, allow_unused=True)
    if grad is None:  # no ray of this shard reached the map
        grad = torch.zeros_like(ch)
    loss = _all_reduce(loss.detach(), "SUM", group)
    grad = _all_reduce(grad, "SUM", group)
    return loss, grad
