"""Map objects: a layer and its query API (port of
voxblox_tpu/models/maps.py).

- ``TsdfMap`` (core/tsdf_map.h:20-107): interpolated distance and weight
  queries and axis-aligned plane slices;
- ``EsdfMap`` (core/esdf_map.h:21-130): batched distance and
  distance-plus-gradient queries (the planner-facing API), observedness,
  the traversable cloud and plane slices;
- ``OccupancyMap`` (core/occupancy_map.h:15-66): occupancy probability.

Queries take f32 [Q,3] positions on the layer's device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import _runtime
from ..core import grid
from ..core import layer as vlayer
from ..core.config import MapConfig
from ..ops import interp


def _make(layer_type, config: MapConfig, device):
    return vlayer.make_layer(layer_type, config.voxel_size,
                             vps=config.voxels_per_side,
                             max_blocks=config.max_blocks,
                             table_capacity=config.table_capacity,
                             device=device)


def _plane_points(layer, free_plane_index: int, height: float,
                  extent: float, step):
    """The n x n lattice of an axis-aligned plane (u-major), n =
    int(2 * extent / step), centred on the origin."""
    step = step or layer.voxel_size
    n = int(2 * extent / step)
    u = (torch.arange(n, device=layer.device) - n // 2) * step
    uu, vv = torch.meshgrid(u, u, indexing="ij")
    cols = [uu, vv]
    cols.insert(free_plane_index, torch.full_like(uu, height))
    return torch.stack(cols, -1).reshape(-1, 3).to(torch.float32)


@dataclasses.dataclass
class TsdfMap:
    layer: vlayer.VoxelLayer
    config: MapConfig

    @classmethod
    def create(cls, config: MapConfig = MapConfig(), device=None):
        return cls(layer=_make("tsdf", config, device), config=config)

    def get_distance_at_position(self, positions, interpolate: bool = True):
        """(distances [Q], valid [Q])."""
        if interpolate:
            return interp.interpolate(self.layer, positions)
        return interp.nearest(self.layer, positions)

    def get_weight_at_position(self, positions, interpolate: bool = True):
        if interpolate:
            return interp.interpolate(self.layer, positions, channel="weight")
        gvi = grid.point_to_grid_index(positions, 1.0 / self.layer.voxel_size)
        return vlayer.get_voxels(self.layer, "weight", gvi)

    def coord_plane_slice(self, free_plane_index: int, height: float,
                          extent: float = 10.0, step: float | None = None):
        """(positions, distances, weights, valid) on an axis-aligned plane
        (getTsdfMapSlice, tsdf_map.h:60-89)."""
        pts = _plane_points(self.layer, free_plane_index, height, extent,
                            step)
        d, ok = interp.interpolate(self.layer, pts)
        w, _ = interp.interpolate(self.layer, pts, channel="weight")
        return pts, d, w, ok

    def block_size(self):
        return self.layer.block_size

    def memory_bytes(self):
        return self.layer.memory_bytes()


@dataclasses.dataclass
class EsdfMap:
    layer: vlayer.VoxelLayer
    config: MapConfig

    @classmethod
    def create(cls, config: MapConfig = MapConfig(), device=None):
        return cls(layer=_make("esdf", config, device), config=config)

    def get_distance_at_position(self, positions, interpolate: bool = True):
        """Batch distance query (esdf_map.h:55-67, :93-99)."""
        if interpolate:
            return interp.interpolate(self.layer, positions)
        return interp.nearest(self.layer, positions)

    def get_distance_and_gradient_at_position(self, positions,
                                              interpolate: bool = True,
                                              adaptive: bool = False):
        """Batch distance + gradient (esdf_map.h:69-77, :100-106): the
        analytic trilinear gradient; ``interpolate=False`` the nearest
        distance with a central-difference gradient; ``adaptive`` the
        reference's getAdaptiveDistanceAndGradient."""
        if adaptive:
            return interp.adaptive_distance_and_gradient(self.layer,
                                                         positions)
        if interpolate:
            return interp.interpolate_with_gradient(self.layer, positions)
        d, ok = interp.nearest(self.layer, positions)
        g, gok = interp.gradient_central(self.layer, positions)
        return d, g, ok & gok

    def is_observed(self, positions):
        gvi = grid.point_to_grid_index(positions, 1.0 / self.layer.voxel_size)
        f, found = vlayer.get_voxels(self.layer, "esdf_flags", gvi, fill=0)
        return found & ((f & vlayer.ESDF_OBSERVED) != 0)

    def traversable_points(self, traversability_radius: float):
        """Centres of observed voxels of active blocks whose distance
        exceeds the robot radius (esdf_server.cc:136-142), as numpy
        (points f32[N,3], distances f32[N]) in (row, voxel) order."""
        layer = self.layer
        flags = _runtime.to_host(layer.channels["esdf_flags"])
        d = _runtime.to_host(layer.channels["esdf"])
        active = _runtime.to_host(layer.active_mask())
        obs = ((flags & vlayer.ESDF_OBSERVED) != 0) & active[:, None]
        rows, vox = np.nonzero(obs & (d > traversability_radius))
        lin = np.arange(layer.voxels_per_block)
        v = layer.vps
        local = np.stack([lin % v, (lin // v) % v, lin // (v * v)], -1)
        gvi = _runtime.to_host(layer.block_ijk)[rows] * v + local[vox]
        pts = ((gvi + 0.5) * layer.voxel_size).astype(np.float32)
        return pts, d[rows, vox]

    def coord_plane_slice(self, free_plane_index: int, height: float,
                          extent: float = 10.0, step: float | None = None):
        """(positions, distances, valid) on an axis-aligned plane
        (coordPlaneSliceGetDistance, esdf_map.cc:112-196)."""
        pts = _plane_points(self.layer, free_plane_index, height, extent,
                            step)
        d, ok = interp.interpolate(self.layer, pts)
        return pts, d, ok


@dataclasses.dataclass
class OccupancyMap:
    layer: vlayer.VoxelLayer
    config: MapConfig

    @classmethod
    def create(cls, config: MapConfig = MapConfig(), device=None):
        return cls(layer=_make("occupancy", config, device), config=config)

    def occupancy_probability(self, positions):
        gvi = grid.point_to_grid_index(positions, 1.0 / self.layer.voxel_size)
        lo, found = vlayer.get_voxels(self.layer, "log_odds", gvi)
        return 1.0 - 1.0 / (1.0 + torch.exp(lo)), found
