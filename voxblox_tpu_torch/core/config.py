"""Configuration dataclasses — the port's own copy of voxblox_tpu's.

Field names and defaults equal the JAX package's (a test holds them
equal); the port keeps the names even where they speak of the TPU
(``use_pallas_kernel`` selects the hand-written relaxation kernel here).
``config_from_dict`` rebuilds any of them from a plain dict of fields.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class MapConfig:
    voxel_size: float = 0.2
    voxels_per_side: int = 16
    max_blocks: int = 4096
    table_capacity: Optional[int] = None

    @property
    def block_size(self) -> float:
        return self.voxel_size * self.voxels_per_side


@dataclasses.dataclass(frozen=True)
class TsdfIntegratorConfig:
    default_truncation_distance: float = 0.1
    max_weight: float = 10000.0
    voxel_carving_enabled: bool = True
    min_ray_length_m: float = 0.1
    max_ray_length_m: float = 5.0
    use_const_weight: bool = False
    allow_clear: bool = True
    use_weight_dropoff: bool = True
    use_sparsity_compensation_factor: bool = False
    sparsity_compensation_factor: float = 1.0
    enable_anti_grazing: bool = False
    start_voxel_subsampling_factor: float = 2.0
    max_consecutive_ray_collisions: int = 2
    clear_checks_every_n_frames: int = 1
    max_steps: Optional[int] = None
    max_points: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class EsdfIntegratorConfig:
    full_euclidean_distance: bool = False
    max_distance_m: float = 2.0
    min_distance_m: float = 0.2
    default_distance_m: float = 2.0
    min_diff_m: float = 0.001
    min_weight: float = 1e-6
    num_buckets: int = 20
    multi_queue: bool = False
    add_occupied_crust: bool = False
    clear_sphere_radius: float = 1.5
    occupied_sphere_radius: float = 5.0
    # Inner relaxations per halo exchange.
    inner_sweeps: int = 8
    # Hard cap on outer sweep iterations per update.
    max_outer_sweeps: int = 64
    # Rows materialized per sweep (None = whole pool); see ops/esdf.
    max_active_blocks: Optional[int] = None
    # Relax in the hand-written kernels' padded-block path (vps 16).
    use_pallas_kernel: bool = False
    # Kernel-path relaxation schedule: one sweep per entry at that stride
    # (e.g. (8, 4, 2, 1, 1, 1, 1)); None = ``inner_sweeps`` unit sweeps.
    sweep_strides: Optional[tuple] = None
    # Incremental outer-sweep cap with carried SWEEP_DEBT.
    max_outer_sweeps_incremental: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class OccupancyIntegratorConfig:
    probability_hit: float = 0.65
    probability_miss: float = 0.4
    threshold_min: float = 0.12
    threshold_max: float = 0.97
    threshold_occupancy: float = 0.7
    min_ray_length_m: float = 0.1
    max_ray_length_m: float = 5.0
    max_steps: Optional[int] = None
    max_points: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class MeshIntegratorConfig:
    use_color: bool = True
    min_weight: float = 1e-4
    device_tri_cap: int = 512
    update_bucket: int = 64
    march_cube_budget: "int | None" = None


@dataclasses.dataclass(frozen=True)
class IcpConfig:
    refine_roll_pitch: bool = False
    mini_batch_size: int = 20
    min_match_ratio: float = 0.8
    subsample_keep_ratio: float = 0.5
    inital_translation_weighting: float = 100.0
    inital_rotation_weighting: float = 100.0


def derive_defaults(
    voxel_size: float,
    tsdf: TsdfIntegratorConfig | None = None,
    esdf: EsdfIntegratorConfig | None = None,
):
    """ROS-layer derived defaults: truncation = 4 * voxel_size, ESDF
    min_distance = truncation / 2 but at least the struct default."""
    tsdf = tsdf or TsdfIntegratorConfig()
    truncation = 4.0 * voxel_size
    tsdf = dataclasses.replace(tsdf, default_truncation_distance=truncation)
    esdf = esdf or EsdfIntegratorConfig()
    esdf = dataclasses.replace(
        esdf, min_distance_m=max(truncation / 2.0, esdf.min_distance_m))
    return tsdf, esdf


_CONFIGS = {
    c.__name__: c
    for c in (MapConfig, TsdfIntegratorConfig, EsdfIntegratorConfig,
              OccupancyIntegratorConfig, MeshIntegratorConfig, IcpConfig)
}


def config_from_dict(name: str, d: dict):
    """Build the config class ``name`` from a dict of its fields (tuples
    stay tuples; unknown keys raise)."""
    cls = _CONFIGS[name]
    fields = {f.name for f in dataclasses.fields(cls)}
    unknown = set(d) - fields
    if unknown:
        raise TypeError(f"{name}: unknown fields {sorted(unknown)}")
    kw = {k: (tuple(v) if isinstance(v, list) else v) for k, v in d.items()}
    return cls(**kw)
