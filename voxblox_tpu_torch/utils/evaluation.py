"""Layer-against-layer error evaluation (port of
voxblox_tpu/utils/evaluation.py; reference utils/evaluation_utils.{h,cc}):
RMSE and error statistics between a ground-truth layer and a test layer
over co-located voxels observed in both, as ``VoxelEvaluationDetails``
(evaluation_utils.h:23-46). The sums run on the layers' device; the
results are read once per call.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import _runtime
from ..core import layer as vlayer


@dataclasses.dataclass
class VoxelEvaluationDetails:
    """Mirrors evaluation_utils.h:23-46."""

    rmse: float = 0.0
    min_error: float = 0.0
    max_error: float = 0.0
    num_evaluated_voxels: int = 0
    num_ignored_voxels: int = 0
    num_overlapping_voxels: int = 0
    num_non_overlapping_voxels: int = 0

    def __str__(self):
        return (f"rmse={self.rmse:.6f} max={self.max_error:.6f} "
                f"evaluated={self.num_evaluated_voxels} "
                f"overlap={self.num_overlapping_voxels}")


def _observed(layer, rows):
    """bool[len(rows), vps^3]: per-voxel observedness."""
    if layer.layer_type == "tsdf":
        return layer.channels["weight"][rows] > 1e-6
    if layer.layer_type == "esdf":
        return (layer.channels["esdf_flags"][rows]
                & vlayer.ESDF_OBSERVED) != 0
    if layer.layer_type == "occupancy":
        return layer.channels["occ_observed"][rows] != 0
    raise ValueError(layer.layer_type)


def _distance(layer, rows):
    ch = {"tsdf": "tsdf", "esdf": "esdf",
          "occupancy": "log_odds"}[layer.layer_type]
    return layer.channels[ch][rows]


def evaluate_layers_rmse(gt_layer: vlayer.VoxelLayer,
                         test_layer: vlayer.VoxelLayer,
                         ignore_behind_test_surface: bool = False
                         ) -> VoxelEvaluationDetails:
    """RMSE of test against GT over co-located voxels observed in both
    (evaluation_utils.h:73-160). ``ignore_behind_test_surface`` skips
    voxels whose test distance is deeply negative (inside objects,
    kIgnoreErrorBehindTestSurface)."""
    assert gt_layer.vps == test_layer.vps
    assert abs(gt_layer.voxel_size - test_layer.voxel_size) < 1e-9
    rows = torch.arange(gt_layer.max_blocks, device=gt_layer.device)
    gt_active = gt_layer.active_mask()
    test_slot = vlayer.lookup_blocks(test_layer, gt_layer.block_ijk)
    has_pair = gt_active & (test_slot >= 0)
    safe = torch.where(has_pair, test_slot, 0).to(torch.int64)
    gt_obs = _observed(gt_layer, rows) & gt_active[:, None]
    te_obs = _observed(test_layer, safe) & has_pair[:, None]
    gt_d = _distance(gt_layer, rows)
    te_d = _distance(test_layer, safe)
    both = gt_obs & te_obs
    ignored = torch.zeros_like(both)
    if ignore_behind_test_surface:
        behind = te_d < -4.0 * test_layer.voxel_size + 1e-6
        ignored = both & behind
        both = both & ~behind
    err = torch.where(both, te_d - gt_d, 0.0)
    n = both.sum()
    rmse = torch.sqrt((err * err).sum() / torch.clamp(n, min=1))
    abs_err = err.abs()
    max_err = abs_err.max()
    min_err = torch.where(both, abs_err, float("inf")).min()
    non_overlap = ((gt_obs | te_obs) & ~both).sum()
    vals = _runtime.to_host(torch.stack([
        rmse, torch.where(torch.isfinite(min_err), min_err, 0.0), max_err,
        n.to(torch.float64), ignored.sum().to(torch.float64),
        non_overlap.to(torch.float64)]).to(torch.float64))
    return VoxelEvaluationDetails(
        rmse=float(vals[0]), min_error=float(vals[1]),
        max_error=float(vals[2]), num_evaluated_voxels=int(vals[3]),
        num_ignored_voxels=int(vals[4]),
        num_overlapping_voxels=int(vals[3]),
        num_non_overlapping_voxels=int(vals[5]))


def count_observed(layer) -> int:
    rows = torch.arange(layer.max_blocks, device=layer.device)
    obs = _observed(layer, rows) & layer.active_mask()[:, None]
    return _runtime.host_int(obs.sum())


def is_same_layer(a: vlayer.VoxelLayer, b: vlayer.VoxelLayer,
                  atol: float = 0.0) -> bool:
    """Exact (or ``atol``) equality over co-located blocks (utils/
    layer_utils.h isSameLayer, keyed by block index, not pool row)."""
    if a.vps != b.vps or abs(a.voxel_size - b.voxel_size) > 1e-12:
        return False
    if set(a.channels) != set(b.channels):
        return False
    a_active = _runtime.to_host(a.active_mask())
    b_active = _runtime.to_host(b.active_mask())
    if int(a_active.sum()) != int(b_active.sum()):
        return False
    a_blocks = _runtime.to_host(a.block_ijk)[a_active]
    slot_b = _runtime.to_host(vlayer.lookup_blocks(
        b, torch.as_tensor(a_blocks, device=b.device)))
    if (slot_b < 0).any():
        return False
    rows_a = np.nonzero(a_active)[0]
    for name in a.channels:
        ca = _runtime.to_host(a.channels[name])[rows_a]
        cb = _runtime.to_host(b.channels[name])[slot_b]
        if atol == 0.0:
            if not np.array_equal(ca, cb):
                return False
        elif not np.allclose(ca, cb, atol=atol):
            return False
    return True


def evaluate_layer_rmse_at_poses(layer_a: vlayer.VoxelLayer,
                                 layer_b: vlayer.VoxelLayer, transforms_a_b,
                                 ignore_behind_test_surface: bool = False,
                                 return_aligned: bool = False):
    """Pose-sweep RMSE (merge_integration.h:236-307): ``layer_b`` aligned
    into ``layer_a``'s frame by each (R, t) of ``transforms_a_b``
    (``ops/transform.transform_layer``), each alignment evaluated against
    ``layer_a``. Returns the list of details, or (details, aligned
    layers) with ``return_aligned``."""
    from ..ops import transform as transform_ops

    assert layer_a.vps == layer_b.vps
    assert abs(layer_a.voxel_size - layer_b.voxel_size) < 1e-8
    details, aligned = [], []
    for T_a_b in transforms_a_b:
        aligned_b, _ = transform_ops.transform_layer(layer_b, T_a_b)
        details.append(evaluate_layers_rmse(
            layer_a, aligned_b,
            ignore_behind_test_surface=ignore_behind_test_surface))
        if return_aligned:
            aligned.append(aligned_b)
    if return_aligned:
        return details, aligned
    return details
