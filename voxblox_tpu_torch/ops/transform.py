"""Layer merge, rigid transform and resample (port of
voxblox_tpu/ops/transform.py; reference merge_integration.h and
utils/voxel_utils.cc).

- ``merge_layers``: voxel-wise merge of co-located layers
  (mergeLayerAintoLayerB, merge_integration.h:20-54) by the rules of
  mergeVoxelAIntoVoxelB (voxel_utils.cc:9-39): TSDF weighted average,
  ESDF plain average, occupancy log-odds sum, intensity weighted average.
- ``transform_layer``: rigid-transform resample (merge_integration.h:
  145-220): a conservative target block cover from the transformed source
  bounds (on the host), then inverse-warp trilinear sampling at
  T^-1 * voxel centres, in chunks of target blocks.
- ``naive_transform_layer``: the forward nearest-voxel copy
  (naiveTransformLayer, merge_integration.h:94-138); where several source
  voxels land on one target voxel the last in lane order wins, as in the
  JAX CPU scatter.

Every function updates layers in place and returns (layer, overflow).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _runtime
from ..core import grid
from ..core import layer as vlayer
from . import interp

_WARP_BLOCKS = 256  # target blocks resampled per pass


def _gather_rows(arr, rows, ok):
    """``arr.at[where(ok, rows, len(arr))].get(mode="fill", fill_value=0)``."""
    safe = torch.where(ok, rows, 0).to(torch.int64)
    okb = ok.view((-1,) + (1,) * (arr.dim() - 1))
    return torch.where(okb, arr[safe], 0).to(arr.dtype)


def merge_layers(target: vlayer.VoxelLayer, source: vlayer.VoxelLayer):
    """Merge ``source`` into ``target`` (same voxel size, vps and type), in
    place. Returns (target, overflow)."""
    assert target.vps == source.vps
    assert abs(target.voxel_size - source.voxel_size) < 1e-9
    assert target.layer_type == source.layer_type
    src_active = source.active_mask()
    target, overflow = vlayer.allocate_blocks(target, source.block_ijk,
                                              src_active)
    tgt_slot = vlayer.lookup_blocks(target, source.block_ijk)
    sel = src_active & (tgt_slot >= 0)
    ch = target.channels
    sc = source.channels
    lt = target.layer_type

    def get(name):
        return _gather_rows(ch[name], tgt_slot, sel)

    def put(name, vals):
        vlayer.put_rows(ch[name], tgt_slot, sel, vals)

    if lt == "tsdf":
        tw, sw_ = get("weight"), sc["weight"]
        tot = torch.clamp(tw + sw_, min=1e-12)
        new_d = (get("tsdf") * tw + sc["tsdf"] * sw_) / tot
        # Colour is interleaved [mb, vpb*3]: repeat the weights per rgb.
        tw3 = tw.repeat_interleave(3, dim=-1)
        sw3 = sw_.repeat_interleave(3, dim=-1)
        new_c = ((get("color") * tw3 + sc["color"] * sw3)
                 / tot.repeat_interleave(3, dim=-1))
        put("tsdf", new_d)
        put("color", new_c)
        put("weight", tw + sw_)
    elif lt == "esdf":
        te, tf = get("esdf"), get("esdf_flags")
        se, sf = sc["esdf"], sc["esdf_flags"]
        t_obs = (tf & vlayer.ESDF_OBSERVED) != 0
        s_obs = (sf & vlayer.ESDF_OBSERVED) != 0
        put("esdf", torch.where(t_obs & s_obs, (te + se) / 2.0,
                                torch.where(s_obs, se, te)))
        put("esdf_flags", tf | sf)
    elif lt == "occupancy":
        put("log_odds", get("log_odds") + sc["log_odds"])
        put("occ_observed", get("occ_observed") | sc["occ_observed"])
    elif lt == "intensity":
        tw, sw_ = get("intensity_weight"), sc["intensity_weight"]
        tot = torch.clamp(tw + sw_, min=1e-12)
        put("intensity", (get("intensity") * tw + sc["intensity"] * sw_)
            / tot)
        put("intensity_weight", tw + sw_)
    else:
        raise ValueError(lt)
    return target, overflow


def _pose_np(T):
    R, t = T
    if isinstance(R, torch.Tensor):
        R, t = _runtime.to_host(R), _runtime.to_host(t)
    return np.asarray(R), np.asarray(t)


def _corner_units():
    return np.stack(np.meshgrid([0, 1], [0, 1], [0, 1], indexing="ij"),
                    -1).reshape(-1, 3)


def transform_layer(source: vlayer.VoxelLayer, T_out_in,
                    out_voxel_size: float | None = None,
                    out_vps: int | None = None,
                    max_blocks: int | None = None):
    """A new layer on the source's device with ``out(x) = in(T_out_in^-1
    x)`` by inverse-warp trilinear interpolation (merge_integration.h:
    145-220). TSDF layers carry distance, weight and colour; other types
    their primary channel and observedness. Returns (layer, overflow)."""
    dev = source.device
    Rn, tn = _pose_np(T_out_in)
    out_voxel_size = out_voxel_size or source.voxel_size
    out_vps = out_vps or source.vps
    max_blocks = max_blocks or source.max_blocks
    out = vlayer.make_layer(source.layer_type, out_voxel_size, vps=out_vps,
                            max_blocks=max_blocks, device=dev)
    no = torch.zeros((), dtype=torch.bool, device=dev)
    # Conservative target block cover: the 8 corners of every active
    # source block, transformed, dilated by one target block.
    src_active = _runtime.to_host(source.active_mask())
    rows = np.nonzero(src_active)[0]
    if len(rows) == 0:
        return out, no
    bijk = _runtime.to_host(source.block_ijk)[rows]
    corners = _corner_units()
    pts = ((bijk[:, None, :] + corners[None]) * source.block_size
           ).reshape(-1, 3)
    tpts = pts @ Rn.T + tn
    out_block_size = out_voxel_size * out_vps
    lo = np.floor(tpts.min(0) / out_block_size).astype(np.int64) - 1
    hi = np.floor(tpts.max(0) / out_block_size).astype(np.int64) + 1
    cand = np.stack(np.meshgrid(*[np.arange(lo[i], hi[i] + 1)
                                  for i in range(3)], indexing="ij"),
                    -1).reshape(-1, 3)
    # Keep candidates whose back-projected centre block, or one of its 8
    # diagonal neighbours, exists in the source.
    back = ((cand + 0.5) * out_block_size - tn) @ Rn
    src_block = np.floor(back / source.block_size).astype(np.int32)
    srcset = {tuple(b) for b in bijk}
    keep = np.zeros(len(cand), bool)
    for i, b in enumerate(src_block):
        for d in corners * 2 - 1:
            if tuple(b) in srcset or tuple(b + d) in srcset:
                keep[i] = True
                break
    cand = cand[keep]
    if len(cand) == 0:
        return out, no
    cand_t = torch.as_tensor(cand, dtype=torch.int32, device=dev)
    out, overflow = vlayer.allocate_blocks(
        out, cand_t, torch.ones(len(cand), dtype=torch.bool, device=dev))
    slots = vlayer.lookup_blocks(out, cand_t)

    vpb = out_vps ** 3
    local = grid.linear_to_local(
        torch.arange(vpb, dtype=torch.int32, device=dev), out_vps)
    R_inv = torch.as_tensor(Rn.T, dtype=torch.float32, device=dev)
    t_j = torch.as_tensor(tn, dtype=torch.float32, device=dev)
    psl = _runtime.host_int(source.table.max_psl)
    lt = source.layer_type
    ch = out.channels
    for b0 in range(0, len(cand), _WARP_BLOCKS):
        blk = cand_t[b0:b0 + _WARP_BLOCKS]
        sl = slots[b0:b0 + _WARP_BLOCKS]
        ok = sl >= 0
        gvi = blk[:, None, :] * out_vps + local
        centres = grid.grid_index_to_center_point(gvi, out_voxel_size)
        src_pts = ((centres - t_j) @ R_inv.T).reshape(-1, 3)
        nb = blk.shape[0]
        if lt == "tsdf":
            d, dok = interp.interpolate(source, src_pts, max_psl=psl)
            w, _ = interp.interpolate(source, src_pts, channel="weight",
                                      max_psl=psl)
            c, _ = interp.interpolate_trilinear_color(source, src_pts,
                                                      max_psl=psl)
            vlayer.put_rows(ch["tsdf"], sl, ok, d.view(nb, vpb))
            vlayer.put_rows(ch["weight"], sl, ok,
                            torch.where(dok, w, 0.0).view(nb, vpb))
            vlayer.put_rows(ch["color"], sl, ok, c.reshape(nb, vpb * 3))
            continue
        name, flag = {"esdf": ("esdf", "esdf_flags"),
                      "occupancy": ("log_odds", "occ_observed"),
                      "intensity": ("intensity", "intensity_weight")}[lt]
        d, dok = interp.interpolate(source, src_pts, channel=name,
                                    max_psl=psl)
        obs = dok.view(nb, vpb)
        vlayer.put_rows(ch[name], sl, ok, d.view(nb, vpb))
        if lt == "esdf":
            obs = obs.to(torch.uint8) * vlayer.ESDF_OBSERVED
        vlayer.put_rows(ch[flag], sl, ok, obs)
    return out, overflow


def naive_transform_layer(source: vlayer.VoxelLayer, T_out_in,
                          max_blocks: int | None = None):
    """Forward nearest-voxel transform: every source voxel's value goes to
    the output voxel holding its transformed centre (same voxel size and
    vps). Rotations alias, as in the reference. Returns (layer,
    overflow)."""
    dev = source.device
    Rn, tn = _pose_np(T_out_in)
    max_blocks = max_blocks or source.max_blocks
    out = vlayer.make_layer(source.layer_type, source.voxel_size,
                            vps=source.vps, max_blocks=max_blocks,
                            device=dev)
    src_active = _runtime.to_host(source.active_mask())
    rows = np.nonzero(src_active)[0]
    if len(rows) == 0:
        return out, torch.zeros((), dtype=torch.bool, device=dev)
    rows_t = torch.as_tensor(rows, dtype=torch.int64, device=dev)
    vps = source.vps
    vpb = source.voxels_per_block
    local = grid.linear_to_local(
        torch.arange(vpb, dtype=torch.int32, device=dev), vps)
    R = torch.as_tensor(np.asarray(Rn, np.float32), device=dev)
    t = torch.as_tensor(np.asarray(tn, np.float32), device=dev)
    gvi_in = source.block_ijk[rows_t][:, None, :] * vps + local
    centres = grid.grid_index_to_center_point(gvi_in, source.voxel_size)
    world = centres @ R.T + t
    gvi_out = torch.floor(world / source.voxel_size).to(torch.int32)
    out_bijk = torch.floor(gvi_out.to(torch.float32) / vps).to(torch.int32)
    out, overflow = vlayer.allocate_blocks(
        out, out_bijk.reshape(-1, 3),
        torch.ones(len(rows) * vpb, dtype=torch.bool, device=dev))
    slots = vlayer.lookup_blocks(out, out_bijk.reshape(-1, 3))
    lo = (gvi_out - out_bijk * vps).reshape(-1, 3).to(torch.int64)
    lin_out = (lo[:, 2] * vps + lo[:, 1]) * vps + lo[:, 0]
    ok = slots >= 0
    flat = slots.to(torch.int64) * vpb + lin_out
    for name, arr in source.channels.items():
        extra = vlayer.channel_extra(source, name)
        src = arr[rows_t].reshape((len(rows) * vpb,) + extra)
        tgt = out.channels[name].view((out.max_blocks * vpb,) + extra)
        vlayer.put_last(tgt, flat, ok, src)
    return out, overflow
