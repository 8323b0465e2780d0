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
``export_mesh_layer`` drain it and export a host ``MeshLayer``.

Not ported yet (they raise): ICP, map IO, PLY export, the mesh wire
message, clear spheres, intensity and the simulation server.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch.profiler import record_function

from .. import _runtime
from ..core import layer as vlayer
from ..core.config import (
    EsdfIntegratorConfig,
    MapConfig,
    MeshIntegratorConfig,
    TsdfIntegratorConfig,
)
from ..ops import esdf as esdf_ops
from ..ops import mesh as mesh_ops
from ..ops import projective as projective_ops
from ..ops import tsdf as tsdf_ops

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
        icp_config=None,
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
        if enable_icp:
            raise NotImplementedError("ICP is not ported")
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
        """Integrate one posed flat scan. Returns the pose used."""
        points_C = self._tensor(points_C)
        colors = (torch.zeros_like(points_C) if colors is None
                  else self._tensor(colors))
        points_C, colors = self._pad(points_C, colors)
        T_G_C = self._pose(T_G_C)
        with record_function(f"integrate_{self.method}"):
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
        with record_function("mesh_update"):
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

    def export_mesh_layer(self) -> mesh_ops.MeshLayer:
        """Drain pending mesh updates and transfer the device mesh pool
        into the host MeshLayer cache."""
        self._drain_mesh_updates()
        mesh_ops.pool_to_mesh_layer(self.layer, self.mesh_pool,
                                    self.mesh_layer, self.mesh_config)
        return self.mesh_layer

    def generate_mesh(self, path: Optional[str] = None):
        """Full re-mesh: mark every active block mesh-dirty, drain and
        export. Returns the host MeshLayer."""
        if path:
            raise NotImplementedError("PLY export is not ported yet")
        rows = torch.arange(self.layer.max_blocks, dtype=torch.int32,
                            device=self.device)
        self.layer = vlayer.mark_dirty(self.layer, rows,
                                       self.layer.active_mask(),
                                       vlayer.DIRTY_MESH)
        return self.export_mesh_layer()

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

    # -- services not ported yet ------------------------------------------
    def save_map(self, path: str):
        raise NotImplementedError("map IO is not ported yet")

    def load_map(self, path: str):
        raise NotImplementedError("map IO is not ported yet")


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
        if clear_sphere_for_planning:
            raise NotImplementedError("clear spheres are not ported")
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
            (self.esdf_layer, self.layer, overflow, region_ovf,
             iters) = esdf_ops.update_from_tsdf_incremental_deferred(
                self.esdf_layer, self.layer, self.esdf_cfg, self.relax_impl)
            self._esdf_pool_ovf = _or(self._esdf_pool_ovf, overflow)
            self._esdf_region_ovf = _or(self._esdf_region_ovf, region_ovf)
            return iters
        self.esdf_layer, self.layer, overflow, iters = (
            esdf_ops.update_from_tsdf_incremental(
                self.esdf_layer, self.layer, self.esdf_cfg, self.relax_impl))
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
        self.esdf_layer, overflow, iters = esdf_ops.update_from_tsdf_batch(
            self.esdf_layer, self.layer, self.esdf_cfg, self.relax_impl)
        if _runtime.host_bool(overflow):
            raise MemoryError("ESDF pool overflow")
        return iters
