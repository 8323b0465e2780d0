"""Mapper services (port of the online-mapping parts of
voxblox_tpu/server/mapper.py).

- ``TsdfServer``: posed point clouds -> TSDF integration by one of the
  ray-casting integrators (``method`` "simple", "merged" or "fast", the
  default) or projectively (``method="projective"``, pinhole or spherical
  images) with the transactional grow-and-retry budget ladder: an
  overflowed scan applies nothing and is replayed at grown budgets by
  ``check_overflow``. ``max_block_distance_from_body`` drops blocks far
  from the sensor after every scan.
- ``EsdfServer``: adds the incremental ESDF; ``insert_pointcloud_and_
  update_esdf`` is the online step (projective integrate + incremental
  ESDF per scan) with overflow flags kept on the device until
  ``check_overflow``.

``update_mesh`` keeps a device-resident mesh pool up to date (one
bucket of dirty blocks per call, no host read); ``generate_mesh`` /
``export_mesh_layer`` drain it and export a host ``MeshLayer`` (and a PLY
file), ``publish_mesh_msg`` the incremental mesh message.

``enable_icp`` refines each scan's pose against the map before it is
integrated (two-dispatch path only, as in the JAX package); the ESDF
server's ``clear_sphere_for_planning`` adds the robot-position prior
after each scan. ``save_map`` / ``load_map`` take .vxblx files (the ESDF
appended after the TSDF) or .npz checkpoints. Per-stage host timers
(``utils/timing``, the JAX package's tags) feed ``stats()``.

- ``IntensityServer``: projects intensity images or bearing sets onto the
  TSDF surface (intensity_server.{h,cc}).
- ``SimulationServer``: the self-contained synthetic benchmark
  (simulation_server.cc): random viewpoints -> render -> integrate the
  TSDF (and occupancy) -> ESDF -> every built layer against ground truth.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
from torch.profiler import record_function

from .. import _runtime
from ..core import layer as vlayer
from ..core.config import (
    EsdfIntegratorConfig,
    IcpConfig,
    MapConfig,
    MeshIntegratorConfig,
    OccupancyIntegratorConfig,
    TsdfIntegratorConfig,
    derive_defaults,
)
from ..io import layer_io, mesh_msg, npz_io, ply
from ..ops import esdf as esdf_ops
from ..ops import icp as icp_ops
from ..ops import intensity as intensity_ops
from ..ops import mesh as mesh_ops
from ..ops import occupancy as occupancy_ops
from ..ops import projective as projective_ops
from ..ops import tsdf as tsdf_ops
from ..sim import world as sw
from ..utils import evaluation, planning, timing

METHODS = ("projective", "simple", "merged", "fast")
PROJECTIVE_KINDS = ("pinhole", "spherical", "spherical_organized")


def _or(acc, flag):
    return flag if acc is None else acc | flag


class TsdfServer:
    """Point-cloud -> TSDF mapping service (tsdf_server.cc) on ``device``
    (default CUDA; ``device="cpu"`` for the CPU)."""

    def __init__(
        self,
        map_config: MapConfig = MapConfig(),
        integrator_config: TsdfIntegratorConfig = TsdfIntegratorConfig(),
        mesh_config: MeshIntegratorConfig = MeshIntegratorConfig(),
        method: str = "fast",
        enable_icp: bool = False,
        icp_config: IcpConfig = IcpConfig(),
        max_block_distance_from_body: float = 0.0,
        max_points: Optional[int] = None,
        projective_resolution=(320, 240),
        projective_fov_deg: float = 90.0,
        projective_kind: str = "pinhole",
        projective_intrinsics=None,
        projective_pool: int = 1,
        projective_max_visible_blocks: int = 512,
        projective_max_mixed_slabs: Optional[int] = None,
        projective_max_free_slabs: Optional[int] = None,
        overflow_check_interval: int = 1,
        device=None,
    ):
        self.device = _runtime.resolve_device(device)
        if method not in METHODS:
            raise ValueError(f"method must be one of {METHODS}, not "
                             f"{method!r}")
        if projective_kind not in PROJECTIVE_KINDS:
            raise ValueError(f"projective_kind must be one of "
                             f"{PROJECTIVE_KINDS}, not {projective_kind!r}")
        self.enable_icp = enable_icp
        self.icp_config = icp_config
        self.map_config = map_config
        self.cfg = integrator_config
        self.mesh_config = mesh_config
        self.method = method
        self.projective_resolution = tuple(projective_resolution)
        self.projective_fov = float(np.deg2rad(projective_fov_deg))
        self.projective_kind = projective_kind
        self.projective_intrinsics = (
            tuple(float(v) for v in projective_intrinsics)
            if projective_intrinsics is not None else None)
        self.projective_pool = int(projective_pool)
        self.projective_budgets = dict(
            max_visible_blocks=projective_max_visible_blocks,
            max_mixed_slabs=projective_max_mixed_slabs,
            max_free_slabs=projective_max_free_slabs,
        )
        self.max_block_distance = float(max_block_distance_from_body)
        self.max_points = max_points
        self.layer = vlayer.make_layer(
            "tsdf", map_config.voxel_size, vps=map_config.voxels_per_side,
            max_blocks=map_config.max_blocks,
            table_capacity=map_config.table_capacity, device=self.device)
        self.fast_state = tsdf_ops.make_fast_state(device=self.device)
        # The mesh lives on the device (ops/mesh.MeshPool); the host
        # MeshLayer is only a cache filled on export.
        self.mesh_pool = mesh_ops.make_mesh_pool(
            map_config.max_blocks, mesh_config.device_tri_cap, self.device)
        self.mesh_layer = mesh_ops.MeshLayer(self.layer.block_size)
        self._mesh_more = None  # device flag: dirty rows beyond the bucket
        self.num_scans = 0
        self.icp_corrected = (torch.eye(3, device=self.device),
                              torch.zeros(3, device=self.device))
        self.overflow_check_interval = max(1, int(overflow_check_interval))
        self._overflow_acc = None  # device-side pool-overflow flag
        # Scans since the last check with their device budget-overflow
        # flag; flagged ones replay at grown budgets in check_overflow.
        self._pending_scans: list = []

    # -- input path ------------------------------------------------------
    def _tensor(self, x):
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    def _pose(self, T_G_C):
        if isinstance(T_G_C, tuple):
            return self._tensor(T_G_C[0]), self._tensor(T_G_C[1])
        T = self._tensor(T_G_C)
        return T[:3, :3], T[:3, 3]

    def _pad(self, points, colors):
        n = points.shape[0]
        cap = self.max_points or n
        if n < cap:
            z = torch.zeros((cap - n, 3), dtype=torch.float32,
                            device=self.device)
            points, colors = torch.cat([points, z]), torch.cat([colors, z])
        elif n > cap:
            points, colors = points[:cap], colors[:cap]
        return points, colors

    def _integrate(self, T_G_C, points_C, colors):
        return projective_ops.integrate_pointcloud_projective(
            self.layer, T_G_C, points_C, colors, self.cfg,
            resolution=self.projective_resolution,
            fov_h_rad=self.projective_fov, kind=self.projective_kind,
            **self.projective_budgets)

    def insert_pointcloud(self, T_G_C, points_C, colors=None):
        """Integrate one posed flat scan. Returns the pose used (refined
        by ICP against the map when ``enable_icp``)."""
        points_C = self._tensor(points_C)
        colors = (torch.zeros_like(points_C) if colors is None
                  else self._tensor(colors))
        points_C, colors = self._pad(points_C, colors)
        T_G_C = self._pose(T_G_C)
        if self.enable_icp and self.num_scans > 0:
            with timing.timer("icp"):
                res = icp_ops.run_icp(self.layer, points_C, T_G_C,
                                      self.icp_config)
                T_G_C = self.icp_corrected = (res.R, res.t)
        with timing.timer(f"integrate/{self.method}", annotate=False), \
                record_function(f"integrate_{self.method}"):
            if self.method == "projective":
                self.layer, overflow, budget_ovf = self._integrate(
                    T_G_C, points_C, colors)
                self._record_scan(T_G_C, points_C, colors, budget_ovf)
            else:
                self.layer, self.fast_state, overflow = (
                    tsdf_ops.integrate_pointcloud(
                        self.layer, T_G_C, points_C, colors, self.cfg,
                        method=self.method, state=self.fast_state))
        self._overflow_acc = _or(self._overflow_acc, overflow)
        if (self.num_scans + 1) % self.overflow_check_interval == 0:
            self.check_overflow()
        if self.max_block_distance > 0.0:
            with timing.timer("remove_distant_blocks"):
                self.layer = vlayer.remove_distant_blocks(
                    self.layer, T_G_C[1], self.max_block_distance)
                self.mesh_layer.clear_distant(_runtime.to_host(T_G_C[1]),
                                              self.max_block_distance)
        self.num_scans += 1
        return T_G_C

    # -- projective grow-and-retry ---------------------------------------
    def _record_scan(self, T_G_C, points_C, colors, budget_ovf,
                     fused: bool = False):
        self._pending_scans.append((T_G_C, points_C, colors, budget_ovf,
                                    fused))

    def _grow_projective_budgets(self) -> bool:
        """Advance the budgets one ladder rung: slab budgets first (double,
        then None = unbounded once they cover every visible slab), the
        visible-row budget only after. False when all are at maximum."""
        b = self.projective_budgets
        n_slabs = projective_ops._slab_shape(self.layer.vps)[2]
        changed = False
        for key in ("max_mixed_slabs", "max_free_slabs"):
            v = b[key]
            if v is not None:
                cap = b["max_visible_blocks"] * n_slabs
                b[key] = None if 2 * v >= cap else 2 * v
                changed = True
        if not changed:
            mvb = b["max_visible_blocks"]
            if mvb < self.layer.max_blocks:
                b["max_visible_blocks"] = min(2 * mvb, self.layer.max_blocks)
                changed = True
        return changed

    def _replay_scan(self, T_G_C, points_C, colors, fused: bool):
        """Re-dispatch one budget-overflowed scan until it applies, first
        at the current budgets, then growing a rung per fresh overflow."""
        first = True
        while True:
            if not first and not self._grow_projective_budgets():
                raise MemoryError(
                    "projective scan overflows even at the maximum "
                    "budgets; increase MapConfig.max_blocks")
            first = False
            if fused:
                self._fused_step(T_G_C, points_C, colors, record=False)
                pool_b, budget_b = _runtime.host_bools(
                    [self._overflow_acc, self._last_fused_budget])
            else:
                self.layer, pool_ovf, budget_ovf = self._integrate(
                    T_G_C, points_C, colors)
                pool_b, budget_b = _runtime.host_bools([pool_ovf, budget_ovf])
            if pool_b:
                raise MemoryError(
                    "block pool overflow; increase MapConfig.max_blocks")
            if not budget_b:
                return

    def _drain_pending_scans(self):
        if not self._pending_scans:
            return
        pending, self._pending_scans = self._pending_scans, []
        flags = _runtime.host_bools([r[3] for r in pending])
        for (T, pts, cols, _, fused), ovf in zip(pending, flags):
            if ovf:
                self._replay_scan(T, pts, cols, fused)

    def check_overflow(self):
        """Resolve deferred overflow flags: budget overflows replay their
        scans; pool overflow raises."""
        self._drain_pending_scans()
        if self._overflow_acc is None:
            return
        (ovf,) = _runtime.host_bools([self._overflow_acc])
        self._overflow_acc = None
        if ovf:
            raise MemoryError(
                "block pool overflow; increase MapConfig.max_blocks")

    # -- meshing ---------------------------------------------------------
    def update_mesh(self):
        """Incremental mesh update: march up to ``update_bucket`` mesh-dirty
        rows into the device mesh pool (no host read; export with
        ``generate_mesh`` / ``export_mesh_layer``)."""
        with timing.timer("mesh/update", annotate=False), \
                record_function("mesh_update"):
            self.layer, self.mesh_pool, more = mesh_ops.update_mesh_pool(
                self.layer, self.mesh_pool, self.mesh_config,
                bucket=self.mesh_config.update_bucket, only_updated=True)
        self._mesh_more = _or(self._mesh_more, more)

    def _drain_mesh_updates(self):
        """Mesh every remaining dirty row. The dirty count is read once so
        the loop runs without a read per iteration; a single ``more``
        check then catches stragglers."""
        bucket = self.mesh_config.update_bucket
        while True:
            n_dirty = _runtime.host_int(vlayer.dirty_mask(
                self.layer, vlayer.DIRTY_MESH).sum())
            self._mesh_more = None
            if n_dirty == 0:
                return
            more = None
            for _ in range(-(-n_dirty // bucket)):
                self.layer, self.mesh_pool, more = mesh_ops.update_mesh_pool(
                    self.layer, self.mesh_pool, self.mesh_config,
                    bucket=bucket, only_updated=True)
            if not _runtime.host_bool(more):
                return

    def publish_mesh_msg(self, drain: bool = True) -> bytes:
        """The incremental mesh delta since the last publish as wire bytes
        (``io/mesh_msg``; the updateMeshEvent -> mesh publisher path):
        every row re-marched since then ships whole. The encoding reads
        the card twice, the drain and rows over the pool's triangle cap
        (marched densely) more."""
        if drain:
            self._drain_mesh_updates()
        with timing.timer("mesh/publish"):
            msg, self.layer = mesh_msg.encode_mesh_msg(
                self.layer, self.mesh_pool,
                use_color=self.mesh_config.use_color)
            return mesh_msg.serialize_mesh_msg(msg)

    def export_mesh_layer(self) -> mesh_ops.MeshLayer:
        """Drain pending mesh updates and transfer the device mesh pool
        into the host MeshLayer cache."""
        self._drain_mesh_updates()
        with timing.timer("mesh/export"):
            mesh_ops.pool_to_mesh_layer(self.layer, self.mesh_pool,
                                        self.mesh_layer, self.mesh_config)
        return self.mesh_layer

    def generate_mesh(self, path: Optional[str] = None):
        """Full re-mesh: mark every active block mesh-dirty, drain and
        export; with ``path``, also write it as a PLY file. Returns the
        host MeshLayer."""
        with timing.timer("mesh/generate"):
            rows = torch.arange(self.layer.max_blocks, dtype=torch.int32,
                                device=self.device)
            self.layer = vlayer.mark_dirty(self.layer, rows,
                                           self.layer.active_mask(),
                                           vlayer.DIRTY_MESH)
            self.export_mesh_layer()
        if path:
            ply.mesh_layer_to_ply(self.mesh_layer, path)
        return self.mesh_layer

    def clear(self):
        """Drop the map and the mesh; budgets and configuration stay."""
        mc = self.map_config
        self.layer = vlayer.make_layer(
            "tsdf", mc.voxel_size, vps=mc.voxels_per_side,
            max_blocks=mc.max_blocks, table_capacity=mc.table_capacity,
            device=self.device)
        self.mesh_pool = mesh_ops.make_mesh_pool(
            mc.max_blocks, self.mesh_config.device_tri_cap, self.device)
        self.mesh_layer = mesh_ops.MeshLayer(self.layer.block_size)
        self._mesh_more = None
        self.fast_state = tsdf_ops.make_fast_state(device=self.device)
        self.num_scans = 0
        self._pending_scans = []
        self._overflow_acc = None

    # -- map files ---------------------------------------------------------
    def save_map(self, path: str):
        """The TSDF as a .npz checkpoint or a .vxblx file (deferred
        overflow resolved first)."""
        self.check_overflow()
        if path.endswith(".npz"):
            npz_io.save_npz(self.layer, path)
        else:
            layer_io.save_layer(self.layer, path)

    def load_map(self, path: str):
        if path.endswith(".npz"):
            self.layer = npz_io.load_npz(path, self.device)
        else:
            self.layer = layer_io.load_layer(
                path, "tsdf", max_blocks=self.map_config.max_blocks,
                device=self.device)

    def stats(self):
        return {"num_scans": self.num_scans,
                "num_blocks": _runtime.host_int(self.layer.num_blocks),
                "memory_bytes": self.layer.memory_bytes(),
                "timing": timing.as_dict()}


class EsdfServer(TsdfServer):
    """TsdfServer + incremental ESDF (esdf_server.{h,cc}).

    ``relax_impl`` selects the ESDF relaxation: "kernel" (K1/K2 on a CUDA
    device, their plain version on the CPU) or "plain" (the plain PyTorch
    version on any device — the reference the kernels are held against)."""

    def __init__(
        self,
        map_config: MapConfig = MapConfig(),
        integrator_config: TsdfIntegratorConfig = TsdfIntegratorConfig(),
        esdf_config: EsdfIntegratorConfig = EsdfIntegratorConfig(),
        clear_sphere_for_planning: bool = False,
        relax_impl: str = "kernel",
        **kw,
    ):
        super().__init__(map_config, integrator_config, **kw)
        self.clear_sphere_for_planning = clear_sphere_for_planning
        if relax_impl not in ("kernel", "plain"):
            raise ValueError(f"relax_impl must be 'kernel' or 'plain', "
                             f"not {relax_impl!r}")
        self.esdf_cfg = esdf_config
        self.relax_impl = relax_impl
        self._esdf_region_ovf = None
        self._esdf_pool_ovf = None
        self._last_fused_budget = None
        self.esdf_layer = vlayer.make_layer(
            "esdf", map_config.voxel_size, vps=map_config.voxels_per_side,
            max_blocks=map_config.max_blocks, device=self.device)

    def insert_pointcloud(self, T_G_C, points_C, colors=None):
        T = super().insert_pointcloud(T_G_C, points_C, colors)
        if self.clear_sphere_for_planning:
            # newPoseCallback -> addNewRobotPosition (esdf_server.cc:222-231)
            with timing.timer("esdf/clear_radius"):
                self.esdf_layer, _ = planning.add_new_robot_position(
                    self.esdf_layer, T[1], self.esdf_cfg)
        return T

    def insert_pointcloud_and_update_esdf(self, T_G_C, points_C,
                                          colors=None):
        """Online step: projective integrate + incremental ESDF for one
        scan. An organized [H, W, 3] cloud with ``projective_intrinsics``
        set bins by min-pooling; flat clouds by scatter-min. Overflow flags
        stay on the device until ``check_overflow``. Returns the outer
        sweep iterations."""
        if self.method != "projective":
            raise ValueError("the fused step is projective-only; construct "
                             "the server with method='projective'")
        points_C = self._tensor(points_C)
        colors = (torch.zeros_like(points_C) if colors is None
                  else self._tensor(colors))
        organized = (points_C.dim() == 3
                     and self.projective_intrinsics is not None)
        if not organized:
            points_C, colors = self._pad(points_C, colors)
        T_G_C = self._pose(T_G_C)
        with timing.timer("fused_scan", annotate=False):
            iters = self._fused_step(T_G_C, points_C, colors)
        self.num_scans += 1
        if self.num_scans % self.overflow_check_interval == 0:
            self.check_overflow()
        return iters

    def _fused_step(self, T_G_C, points_C, colors, record: bool = True):
        """Integrate + deferred incremental ESDF, with device-side overflow
        accounting; ``record`` keeps the scan for the grow-and-retry
        drain (an overflowed scan applied no TSDF update and set no dirty
        bits, so replaying the whole step is exact)."""
        run_cfg = esdf_ops._bucketed_cfg(self.esdf_cfg, self.esdf_layer,
                                         self.layer)
        b = self.projective_budgets
        # Named spans for torch.profiler (host and device time per stage).
        with record_function("projective_integrate"):
            if (points_C.dim() == 3
                    and self.projective_intrinsics is not None):
                self.layer, t_ovf, t_budget = (
                    projective_ops.integrate_organized_projective(
                        self.layer, T_G_C, points_C, colors, self.cfg,
                        intrinsics=self.projective_intrinsics,
                        pool=self.projective_pool, **b))
            else:
                self.layer, t_ovf, t_budget = self._integrate(
                    T_G_C, points_C, colors)
        with record_function("esdf_incremental"):
            (self.esdf_layer, self.layer, e_ovf, region_ovf,
             iters) = esdf_ops._incremental(self.esdf_layer, self.layer,
                                            run_cfg, self.relax_impl)
        self._overflow_acc = _or(self._overflow_acc, t_ovf)
        self._last_fused_budget = t_budget
        self._esdf_pool_ovf = _or(self._esdf_pool_ovf, e_ovf)
        self._esdf_region_ovf = _or(self._esdf_region_ovf, region_ovf)
        if record:
            self._record_scan(T_G_C, points_C, colors, t_budget, fused=True)
        return iters

    def update_esdf(self):
        """Incremental ESDF update; deferred (flags on the device) when
        ``overflow_check_interval > 1``. Returns the outer iterations."""
        if self.overflow_check_interval > 1:
            with timing.timer("esdf/update_esdf"):
                (self.esdf_layer, self.layer, overflow, region_ovf,
                 iters) = esdf_ops.update_from_tsdf_incremental_deferred(
                    self.esdf_layer, self.layer, self.esdf_cfg,
                    self.relax_impl)
            self._esdf_pool_ovf = _or(self._esdf_pool_ovf, overflow)
            self._esdf_region_ovf = _or(self._esdf_region_ovf, region_ovf)
            return iters
        with timing.timer("esdf/update_esdf"):
            self.esdf_layer, self.layer, overflow, iters = (
                esdf_ops.update_from_tsdf_incremental(
                    self.esdf_layer, self.layer, self.esdf_cfg,
                    self.relax_impl))
        if _runtime.host_bool(overflow):
            raise MemoryError("ESDF pool overflow")
        return iters

    def check_overflow(self):
        self._drain_pending_scans()
        names = [n for n in ("_overflow_acc", "_esdf_pool_ovf",
                             "_esdf_region_ovf")
                 if getattr(self, n) is not None]
        if not names:
            return
        vals = dict(zip(names, _runtime.host_bools(
            [getattr(self, n) for n in names])))
        self._overflow_acc = None
        self._esdf_pool_ovf = None
        self._esdf_region_ovf = None
        if vals.get("_overflow_acc"):
            raise MemoryError(
                "block pool overflow; increase MapConfig.max_blocks")
        if vals.get("_esdf_pool_ovf"):
            raise MemoryError(
                "ESDF pool overflow; increase MapConfig.max_blocks")
        if vals.get("_esdf_region_ovf"):
            # Some rows went unseeded/unswept with their dirty bits gone:
            # grow the bucket and rebuild the exact field.
            esdf_ops.grow_bucket_cache(self.esdf_cfg, self.esdf_layer)
            self.update_esdf_batch()

    def update_esdf_batch(self):
        with timing.timer("esdf/update_esdf_batch"):
            self.esdf_layer, overflow, iters = esdf_ops.update_from_tsdf_batch(
                self.esdf_layer, self.layer, self.esdf_cfg, self.relax_impl)
        if _runtime.host_bool(overflow):
            raise MemoryError("ESDF pool overflow")
        return iters

    def save_map(self, path: str):
        """TSDF and ESDF in one .vxblx file, the ESDF appended
        (esdf_server.cc:172-190), or two .npz checkpoints (``path`` and
        ``path + ".esdf.npz"``)."""
        self.check_overflow()
        if path.endswith(".npz"):
            npz_io.save_npz(self.layer, path)
            npz_io.save_npz(self.esdf_layer, path + ".esdf.npz")
        else:
            layer_io.save_layer(self.layer, path)
            layer_io.save_layer(self.esdf_layer, path, append=True)

    def load_map(self, path: str):
        """Load the TSDF, and the ESDF where the file (or the .esdf.npz
        beside a checkpoint) has one; otherwise regenerate the ESDF from
        the TSDF (the tsdf_to_esdf tool)."""
        super().load_map(path)
        try:
            if path.endswith(".npz"):
                self.esdf_layer = npz_io.load_npz(path + ".esdf.npz",
                                                  self.device)
            else:
                self.esdf_layer = layer_io.load_layer(
                    path, "esdf", max_blocks=self.map_config.max_blocks,
                    device=self.device)
        except (ValueError, FileNotFoundError):
            self.update_esdf_batch()


class IntensityServer(EsdfServer):
    """Thermal projection service (intensity_server.{h,cc})."""

    def __init__(self, *a, intensity_max_distance: float = 30.0,
                 prop_voxel_radius: int = 2, **kw):
        super().__init__(*a, **kw)
        self.intensity_max_distance = intensity_max_distance
        self.prop_voxel_radius = prop_voxel_radius
        mc = self.map_config
        self.intensity_layer = vlayer.make_layer(
            "intensity", mc.voxel_size, vps=mc.voxels_per_side,
            max_blocks=mc.max_blocks, device=self.device)

    def insert_intensity(self, origin, bearing_vectors, intensities) -> int:
        """Splat intensities along bearings from ``origin`` onto the TSDF
        surface. Returns the number of rays that hit it (one host read)."""
        with timing.timer("intensity/integrate"):
            self.intensity_layer, hits = (
                intensity_ops.add_intensity_bearing_vectors(
                    self.intensity_layer, self.layer, self._tensor(origin),
                    self._tensor(bearing_vectors), self._tensor(intensities),
                    max_distance=self.intensity_max_distance,
                    prop_voxel_radius=self.prop_voxel_radius))
        return _runtime.host_int(hits.sum())

    def insert_intensity_image(self, T_G_C, image, intrinsics,
                               subsample: int = 4) -> int:
        """Thermal image front end (intensity_server.cc:50-120): every
        ``subsample``-th pixel's bearing through the intrinsics (fx, fy,
        cx, cy), rotated to the world, splatted onto the TSDF surface."""
        image = (_runtime.to_host(image) if isinstance(image, torch.Tensor)
                 else np.asarray(image)).astype(np.float32)
        h, w = image.shape
        fx, fy, cx, cy = intrinsics
        us, vs = np.meshgrid(np.arange(0, w, subsample),
                             np.arange(0, h, subsample))
        rays_C = np.stack([(us - cx) / fx, (vs - cy) / fy,
                           np.ones_like(us, np.float32)], -1
                          ).reshape(-1, 3).astype(np.float32)
        rays_C /= np.linalg.norm(rays_C, axis=1, keepdims=True)
        R, t = self._pose(T_G_C)
        rays_G = rays_C @ _runtime.to_host(R).T
        vals = image[vs, us].reshape(-1)
        return self.insert_intensity(t, rays_G, vals)


class SimulationServer:
    """End-to-end synthetic benchmark (simulation_server.cc) on ``device``
    (default CUDA): random viewpoints -> render -> integrate the TSDF
    (and, with ``generate_occupancy``, occupancy; cc:235-237) -> ESDF from
    the TSDF (and from occupancy, cc:265-269) -> every built layer against
    ground truth (cc:279-287)."""

    def __init__(self, world, voxel_size: float = 0.1, vps: int = 16,
                 max_blocks: int = 4096,
                 tsdf_config: Optional[TsdfIntegratorConfig] = None,
                 esdf_config: Optional[EsdfIntegratorConfig] = None,
                 method: str = "merged", camera_res=(320, 240),
                 fov_h_deg: float = 90.0, max_dist: float = 10.0,
                 incremental_esdf: bool = True,
                 generate_occupancy: bool = False, device=None):
        if method not in METHODS:
            raise ValueError(f"method must be one of {METHODS}, not "
                             f"{method!r}")
        self.device = _runtime.resolve_device(device)
        self.world = world
        self.objects = world.freeze(self.device)
        tcfg, ecfg = derive_defaults(voxel_size, tsdf_config, esdf_config)
        self.tsdf_cfg = dataclasses.replace(tcfg, max_ray_length_m=max_dist)
        self.esdf_cfg = esdf_config or ecfg
        self.method = method
        self.camera_res = tuple(camera_res)
        self.fov = float(np.deg2rad(fov_h_deg))
        self.max_dist = max_dist
        self.incremental_esdf = incremental_esdf
        self.voxel_size = voxel_size

        def layer(kind):
            return vlayer.make_layer(kind, voxel_size, vps=vps,
                                     max_blocks=max_blocks,
                                     device=self.device)

        self.tsdf_layer = layer("tsdf")
        self.esdf_layer = layer("esdf")
        self.generate_occupancy = generate_occupancy
        if generate_occupancy:
            self.occ_cfg = OccupancyIntegratorConfig(
                max_ray_length_m=max_dist)
            self.occ_layer = layer("occupancy")
            self.esdf_occ_layer = layer("esdf")
        self.fast_state = tsdf_ops.make_fast_state(device=self.device)

    def generate_poses(self, n: int, radius: float = 0.8, seed: int = 0):
        """Random plausible viewpoints looking at the world's centre
        (simulation_server.cc:161-197): positions drawn from
        ``np.random.default_rng(seed)``, rejected within 0.5 m of an
        object (one host read a draw)."""
        rng = np.random.default_rng(seed)
        lo, hi = self.world.min_bound, self.world.max_bound
        center = (np.asarray(lo) + np.asarray(hi)) / 2.0
        poses = []
        for _ in range(n):
            for _attempt in range(64):
                pos = rng.uniform(lo + 0.05 * (hi - lo),
                                  hi - 0.05 * (hi - lo))
                d, _ = sw.distance_to_point(
                    self.objects, torch.as_tensor(
                        pos, dtype=torch.float32, device=self.device), 1e6)
                if _runtime.host_bool(d > 0.5):
                    break
            z = center - pos
            z = z / np.linalg.norm(z)
            aux = np.array([0.0, 0.0, 1.0])
            if abs(np.dot(z, aux)) > 0.95:
                aux = np.array([1.0, 0.0, 0.0])
            x = np.cross(z, aux)
            x /= np.linalg.norm(x)
            y = np.cross(z, x)
            R = np.stack([x, y, z], 1).astype(np.float32)
            poses.append((torch.as_tensor(R, device=self.device),
                          torch.as_tensor(pos, dtype=torch.float32,
                                          device=self.device)))
        return poses

    def integrate_viewpoint(self, pose):
        """Render one viewpoint, noise-free, and integrate it (TSDF,
        occupancy, the incremental ESDF)."""
        with timing.timer("sim/render"):
            pts_G, colors, valid = sw.pointcloud_from_transform(
                self.objects, pose, self.camera_res, self.fov, self.max_dist)
            pts_C = sw.world_points_to_sensor(pose, pts_G, valid)
        with timing.timer(f"integrate/{self.method}"):
            if self.method == "projective":
                self.tsdf_layer, p_ovf, b_ovf = (
                    projective_ops.integrate_pointcloud_projective(
                        self.tsdf_layer, pose, pts_C, colors, self.tsdf_cfg,
                        resolution=self.camera_res, fov_h_rad=self.fov))
                overflow = p_ovf | b_ovf
            else:
                self.tsdf_layer, self.fast_state, overflow = (
                    tsdf_ops.integrate_pointcloud(
                        self.tsdf_layer, pose, pts_C, colors, self.tsdf_cfg,
                        method=self.method, state=self.fast_state))
            _sync(self.device)
        assert not _runtime.host_bool(overflow), "pool overflow"
        if self.generate_occupancy:
            with timing.timer("integrate/occupancy"):
                self.occ_layer, occ_ovf = occupancy_ops.integrate_pointcloud(
                    self.occ_layer, pose, pts_C, self.occ_cfg)
                _sync(self.device)
            assert not _runtime.host_bool(occ_ovf), "occupancy pool overflow"
        if self.incremental_esdf:
            with timing.timer("esdf/update_esdf"):
                self.esdf_layer, self.tsdf_layer, _, _ = (
                    esdf_ops.update_from_tsdf_incremental(
                        self.esdf_layer, self.tsdf_layer, self.esdf_cfg))
                _sync(self.device)

    def _occupancy_row(self, gt_esdf) -> dict:
        """Voxelwise occupancy classification against the GT SDF's sign,
        outside the +-1-voxel band where the threshold is ambiguous (a
        quantitative stand-in for the reference's visual check)."""
        occ = self.occ_layer
        slot_gt = vlayer.lookup_blocks(gt_esdf, occ.block_ijk)
        sel = occ.active_mask() & (slot_gt >= 0)
        gt_d = gt_esdf.channels["esdf"][torch.where(sel, slot_gt, 0).to(
            torch.int64)]
        lo = occ.channels["log_odds"]
        obs = (occ.channels["occ_observed"] != 0) & sel[:, None]
        m = obs & (gt_d.abs() > self.voxel_size)
        wrong = (lo > 0.0) != (gt_d <= 0.0)
        n_eval, n_wrong = _runtime.host_ints([m.sum(), (m & wrong).sum()])
        return {"misclassified_frac": n_wrong / max(1, n_eval),
                "num_evaluated_voxels": n_eval}

    def run(self, n_viewpoints: int = 20, seed: int = 0) -> dict:
        """Integrate ``n_viewpoints`` random viewpoints, then evaluate:
        {"tsdf", "esdf"[, "occ", "esdf_occ"], "timing"}."""
        for pose in self.generate_poses(n_viewpoints, seed=seed):
            self.integrate_viewpoint(pose)
        if not self.incremental_esdf:
            self.esdf_layer, _, _ = esdf_ops.update_from_tsdf_batch(
                self.esdf_layer, self.tsdf_layer, self.esdf_cfg)
        gt = {kind: sw.generate_gt_layer(
            self.objects, kind, self.voxel_size, self.world.min_bound,
            self.world.max_bound, max_dist=max_dist,
            vps=self.tsdf_layer.vps, max_blocks=2 * self.tsdf_layer.max_blocks)
            for kind, max_dist in (
                ("tsdf", self.tsdf_cfg.default_truncation_distance),
                ("esdf", self.esdf_cfg.max_distance_m))}
        result = {kind: evaluation.evaluate_layers_rmse(
            gt[kind], layer, ignore_behind_test_surface=True)
            for kind, layer in (("tsdf", self.tsdf_layer),
                                ("esdf", self.esdf_layer))}
        if self.generate_occupancy:
            self.esdf_occ_layer, _, _ = (
                occupancy_ops.esdf_from_occupancy_batch(
                    self.esdf_occ_layer, self.occ_layer, self.esdf_cfg))
            result["occ"] = self._occupancy_row(gt["esdf"])
            result["esdf_occ"] = evaluation.evaluate_layers_rmse(
                gt["esdf"], self.esdf_occ_layer,
                ignore_behind_test_surface=True)
        result["timing"] = timing.as_dict()
        return result


def _sync(device):
    """Wait for the device, so that a stage's host timer spans its work
    (the JAX package's ``block_until_ready``)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
