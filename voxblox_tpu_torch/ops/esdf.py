"""ESDF propagation by parallel 26-neighbour relaxation sweeps (port of
voxblox_tpu/ops/esdf.py).

Seeding classifies every observed TSDF voxel (fixed band copies the TSDF
distance, the rest start at sign * default); the raise resets the
influence region of retracted surfaces, gated by a Chebyshev reach
margin; the lower sweep relaxes to the fixpoint in outer iterations of
``inner_sweeps`` relaxations with one halo exchange each. With
``max_active_blocks`` the sweep runs on a compact, Morton-ordered working
set sized by a bucket ladder, and an overflow is retried at a grown
bucket (or, deferred, by a batch rebuild).

Layout: the sweep state is a stack of halo-padded cubes
``[n, v+2, v+2, v+2]`` ([z, y, x]); the halo exchange refreshes the ring
from the 26 neighbours' interiors with one gather. With
``use_pallas_kernel`` (and vps 16) each outer iteration is one launch of
the relaxation kernel (ops/esdf_relax.relax): K1, or K2 when
``sweep_strides`` has a stride > 1, whose per-voxel jump codes
(``stride_codes``) are built once per sweep by halo-synchronized erosion.
Otherwise the plain ``_relax_once`` transcription of the XLA path runs
(which ignores ``sweep_strides``, as the reference does). With
``full_euclidean_distance`` every voxel also carries the offset to its
seed (the ``parent`` channel, packed into one int32 during the sweep) and
a candidate costs the growth of that offset's length; this path never
takes the kernels, as in the JAX package.

The outer loop is a Python loop reading one device flag per iteration
(``_runtime.host_bool``); its first iteration needs no read.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import _runtime
from ..core import layer as vlayer
from ..core.config import EsdfIntegratorConfig
from . import esdf_relax
from .compaction import compact_ids

_OFFSETS = np.array(
    [(dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1)
     for dz in (-1, 0, 1) if (dx, dy, dz) != (0, 0, 0)], np.int32)
_DISTANCES = np.linalg.norm(_OFFSETS.astype(np.float64), axis=1).astype(
    np.float32)
# [27, 3] 3x3x3 neighbourhood, centre at index 13; offset k =
# ((dx+1)*3 + (dy+1))*3 + (dz+1).
_OFFS27 = np.array([(dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1)
                    for dz in (-1, 0, 1)], np.int32)

OBS = vlayer.ESDF_OBSERVED
FIX = vlayer.ESDF_FIXED
HALL = vlayer.ESDF_HALLUCINATED


# ---------------------------------------------------------------------------
# Neighbourhoods and the halo
# ---------------------------------------------------------------------------


def _offs27(device):
    return _runtime.const(_OFFS27, torch.int32, device)


def neighbor_slot_table(layer):
    """int32[max_blocks, 27] pool rows of each block's 3x3x3
    neighbourhood (-1 absent; inactive rows get none)."""
    nbr_ijk = layer.block_ijk[:, None, :] + _offs27(layer.device)[None]
    slots = vlayer.lookup_blocks(layer, nbr_ijk)
    return torch.where(layer.active_mask()[:, None], slots, -1)


def probe_neighbor_rows(layer, rows, row_ok):
    """int32[N, 27] neighbourhood slots of the selected rows only."""
    safe = torch.where(row_ok, rows, 0).to(torch.int64)
    nbr_ijk = layer.block_ijk[safe][:, None, :] + _offs27(layer.device)[None]
    slots = vlayer.lookup_blocks(layer, nbr_ijk)
    return torch.where(row_ok[:, None], slots, -1)


_RING_CACHE: dict = {}


def _ring_maps(v: int, device):
    """For the padded side P = v+2: flat ring-cell ids, the 27-offset
    index of the neighbour owning each ring cell, and the flat id of the
    source cell in that neighbour's interior (every ring cell has
    exactly one owner)."""
    key = (v, str(device))
    if key not in _RING_CACHE:
        p = v + 2
        dst, owner, src = [], [], []
        for z in range(p):
            for y in range(p):
                for x in range(p):
                    o = [(-1 if c == 0 else (1 if c == p - 1 else 0))
                         for c in (x, y, z)]
                    if o == [0, 0, 0]:
                        continue
                    s = [(v if oc == -1 else (1 if oc == 1 else c))
                         for oc, c in zip(o, (x, y, z))]
                    dst.append((z * p + y) * p + x)
                    owner.append(((o[0] + 1) * 3 + (o[1] + 1)) * 3 + o[2] + 1)
                    src.append((s[2] * p + s[1]) * p + s[0])
        _RING_CACHE[key] = tuple(torch.as_tensor(a, dtype=torch.int64,
                                                 device=device)
                                 for a in (dst, owner, src))
    return _RING_CACHE[key]


def halo_exchange(x, nbr):
    """Refresh the 1-voxel ring of padded cubes ``x`` [n, P, P, P] from
    each neighbour's interior boundary (``nbr`` [n, 27] rows into the same
    stack, -1 missing). Ring cells with a missing neighbour keep their
    value. Port of ``_halo_exchange_2d`` in the padded-cube layout; the
    -1 sentinel never indexes (clamped, then masked)."""
    n = x.shape[0]
    dst, owner, src = _ring_maps(x.shape[1] - 2, x.device)
    flat = x.reshape(n, -1)
    nb = nbr[:, owner].to(torch.int64)
    vals = flat[nb.clamp(min=0), src[None, :]]
    out = flat.clone()
    out[:, dst] = torch.where(nb >= 0, vals, flat[:, dst])
    return out.view_as(x)


def _pad(x, n: int, v: int, fill=0):
    """Flat [n, v^3] -> padded cubes [n, v+2, v+2, v+2] with a ring of
    ``fill``. Followed by ``halo_exchange`` this is the JAX ``_padded`` /
    ``build_padded`` (absent neighbours keep the fill)."""
    out = torch.full((n, v + 2, v + 2, v + 2), fill, dtype=x.dtype,
                     device=x.device)
    out[:, 1:-1, 1:-1, 1:-1] = x.reshape(n, v, v, v)
    return out


# ---------------------------------------------------------------------------
# Strided-jump admissibility codes
# ---------------------------------------------------------------------------


def erode1(m):
    """One Chebyshev (3x3x3 box) erosion of a bool mask on padded cubes
    [n, P, P, P], separable over x, y, z; the ring is zeroed
    (conservative) — callers refill it from the neighbour blocks between
    steps. Port of ``erode1_2d``."""
    out = torch.zeros_like(m)
    mx = m[..., :-2] & m[..., 1:-1] & m[..., 2:]
    my = mx[:, :, :-2] & mx[:, :, 1:-1] & mx[:, :, 2:]
    out[:, 1:-1, 1:-1, 1:-1] = my[:, :-2] & my[:, 1:-1] & my[:, 2:]
    return out


def _erosion_codes(m, strides, exchange):
    """uint8 code cube of one sign's traversable mask ``m``: level i+1
    where the Chebyshev ball of radius ``stride_radii(strides)[i]`` is
    traversable. ``exchange`` refills the ring after each erosion step."""
    code = torch.zeros(m.shape, dtype=torch.uint8, device=m.device)
    done = 0
    for r in esdf_relax.stride_radii(strides):
        for _ in range(r - done):
            m = exchange(erode1(m))
        done = r
        code += m
    return code


def stride_codes(d_pad, obs_pad, fixed_pad, nbr, strides):
    """Per-voxel strided-jump admissibility codes (code_pos, code_neg),
    uint8 [n, P, P, P] (port of ``_stride_codes_2d``). A voxel's code
    reaches level i+1 iff the Chebyshev ball of radius
    ``stride_radii(strides)[i]`` around it is traversable on that sign's
    side: observed, not fixed, and of that sign (``d > 0`` positive,
    ``d <= 0`` negative) in the seeded field. One erosion then one halo
    exchange per unit radius, so admissibility flows across block
    borders; blocks with a missing neighbour keep a zero ring there
    (conservative). Observedness, fixedness and signs are static across
    sweeps, so the codes are built once per update."""
    trav = obs_pad & ~fixed_pad
    pos = d_pad > 0.0

    def exchange(m):
        return halo_exchange(m, nbr)

    return (_erosion_codes(trav & pos, strides, exchange),
            _erosion_codes(trav & ~pos, strides, exchange))


def stride_codes_standalone(d_pad, upd_pad, strides):
    """Codes for standalone padded blocks (no neighbour table), as
    ``relax_padded`` builds them: traversable = may update, split by the
    voxel sign, eroded without a halo refresh (zero ring each step)."""
    pos = d_pad > 0.0
    return (_erosion_codes(upd_pad & pos, strides, lambda m: m),
            _erosion_codes(upd_pad & ~pos, strides, lambda m: m))


def stride_gate_stats(esdf_layer, cfg: EsdfIntegratorConfig):
    """Diagnostic: how many observed voxels (and blocks holding any) may
    take each stride-k jump of ``cfg.sweep_strides`` on the current
    field. Full-pool build, one host read. Returns a dict with ``radii``,
    ``admitted_voxels``/``admitted_blocks`` (per level),
    ``observed_voxels`` and ``active_blocks``."""
    if esdf_layer.vps != 16:
        raise ValueError("stride gate requires vps=16 (kernel layout)")
    radii = esdf_relax.stride_radii(cfg.sweep_strides or ())
    active = esdf_layer.active_mask()
    v, mb = esdf_layer.vps, esdf_layer.max_blocks
    flags = torch.where(active[:, None], esdf_layer.channels["esdf_flags"],
                        0).to(torch.uint8)
    obs = (flags & OBS) != 0
    counts = [active.sum(), obs.sum()]
    if radii:
        nbr = neighbor_slot_table(esdf_layer).to(torch.int64)
        fixed = (flags & FIX) != 0
        d_pad = halo_exchange(_pad(esdf_layer.channels["esdf"], mb, v), nbr)
        obs_pad = halo_exchange(_pad(obs, mb, v), nbr)
        fixed_pad = halo_exchange(_pad(fixed, mb, v), nbr)
        cp, cn = stride_codes(d_pad, obs_pad, fixed_pad, nbr,
                              cfg.sweep_strides)
        code = torch.maximum(cp, cn)[:, 1:-1, 1:-1, 1:-1].reshape(mb, -1)
        for lvl in range(1, len(radii) + 1):
            hit = code >= lvl
            counts += [hit.sum(), hit.any(1).sum()]
    vals = _runtime.host_ints(counts)
    return {
        "radii": tuple(radii),
        "active_blocks": vals[0],
        "observed_voxels": vals[1],
        "admitted_voxels": vals[2::2],
        "admitted_blocks": vals[3::2],
    }


# ---------------------------------------------------------------------------
# Seeding (propagate pass)
# ---------------------------------------------------------------------------


def _sync_blocks(esdf_layer, tsdf_layer, rows_mask):
    return vlayer.allocate_blocks(esdf_layer, tsdf_layer.block_ijk, rows_mask)


def _propagate_classify(t_d, t_w, e_d, e_f, row_mask, cfg, crust=False):
    """Propagate-pass voxel classification (cc:124-302): (out_d, out_f,
    update, raised)."""
    observed_t = (t_w >= cfg.min_weight) & row_mask[:, None]
    tsdf_fixed = observed_t & (t_d.abs() < cfg.min_distance_m)
    sgn = torch.where(t_d >= 0.0, 1.0, -1.0)
    seed_d = torch.where(tsdf_fixed, t_d, sgn * cfg.default_distance_m)
    was_obs = (e_f & OBS) != 0
    was_fixed = (e_f & FIX) != 0
    was_hall = (e_f & HALL) != 0
    new_voxel = observed_t & (~was_obs | was_hall)
    exist = observed_t & was_obs & ~was_hall
    either_fixed = tsdf_fixed | was_fixed
    unfix = exist & either_fixed & ~tsdf_fixed
    pe = e_d > 0.0
    lower = exist & either_fixed & tsdf_fixed & (
        (pe & (t_d + cfg.min_diff_m < e_d))
        | (~pe & (t_d - cfg.min_diff_m > e_d)))
    raise_ = exist & either_fixed & tsdf_fixed & (
        (pe & (t_d - cfg.min_diff_m > e_d))
        | (~pe & (t_d + cfg.min_diff_m < e_d)))
    flip = exist & ~either_fixed & (torch.sign(t_d) != torch.sign(e_d))
    update = new_voxel | unfix | lower | raise_ | flip
    out_d = torch.where(update, seed_d, e_d)
    raised = unfix | raise_ | (flip & (t_d >= e_d)) | (new_voxel & was_hall)
    new_flags = torch.where(tsdf_fixed, OBS | FIX, OBS).to(torch.uint8)
    out_f = torch.where(observed_t, new_flags, e_f)
    if crust:
        crust_v = ~observed_t & row_mask[:, None]
        out_d = torch.where(crust_v, -cfg.default_distance_m, out_d)
        out_f = torch.where(crust_v, OBS | HALL, out_f)
        update = update | crust_v
    return out_d, out_f, update, raised


def _selected_rows(esdf_layer, tsdf_layer, tsdf_rows_mask):
    """ESDF rows whose TSDF counterpart is selected, and that counterpart."""
    slot_t = vlayer.lookup_blocks(tsdf_layer, esdf_layer.block_ijk)
    sel_t = tsdf_rows_mask[torch.where(slot_t >= 0, slot_t, 0).to(torch.int64)]
    sel = esdf_layer.active_mask() & (slot_t >= 0) & sel_t
    return sel, slot_t


def seed_from_tsdf(esdf_layer, tsdf_layer, cfg, tsdf_rows_mask,
                   crust: bool = False):
    """Full-pool propagate pass: (layer, changed_rows, raised_rows)."""
    sel, slot_t = _selected_rows(esdf_layer, tsdf_layer, tsdf_rows_mask)
    safe_t = torch.where(sel, slot_t, 0).to(torch.int64)
    ch = esdf_layer.channels
    t_d = tsdf_layer.channels["tsdf"][safe_t]
    t_w = tsdf_layer.channels["weight"][safe_t]
    e_d = ch["esdf"]
    out_d, out_f, update, raised = _propagate_classify(
        t_d, t_w, e_d, ch["esdf_flags"], sel, cfg, crust=crust)
    changed = (update | ((out_d - e_d).abs() > cfg.min_diff_m)).any(1)
    raised_rows = raised.any(1)
    ch["esdf"].copy_(out_d)
    ch["esdf_flags"].copy_(out_f)
    ch["parent"].masked_fill_(update.repeat_interleave(3, dim=1), 0)
    return esdf_layer, changed, raised_rows


def _seed_compact(esdf_layer, tsdf_layer, cfg, tsdf_rows_mask, k: int,
                  crust: bool = False):
    """Propagate pass over a compacted working set of <= k rows:
    (layer, changed_rows, raised_rows, overflow)."""
    mbe = esdf_layer.max_blocks
    sel, slot_t = _selected_rows(esdf_layer, tsdf_layer, tsdf_rows_mask)
    overflow = sel.sum() > k
    rows = compact_ids(sel, k, fill=-1)
    ok = rows >= 0
    safe = torch.where(ok, rows, 0).to(torch.int64)
    safe_t = torch.where(ok, slot_t[safe], 0).to(torch.int64)
    ch = esdf_layer.channels
    t_d = tsdf_layer.channels["tsdf"][safe_t]
    t_w = tsdf_layer.channels["weight"][safe_t]
    e_d = ch["esdf"][safe]
    e_f = ch["esdf_flags"][safe]
    out_d, out_f, update, raised = _propagate_classify(
        t_d, t_w, e_d, e_f, ok, cfg, crust=crust)
    out_p = torch.where(update.repeat_interleave(3, dim=1),
                        torch.zeros((), dtype=torch.int8, device=e_d.device),
                        ch["parent"][safe])
    vlayer.put_rows(ch["esdf"], rows, ok, out_d)
    vlayer.put_rows(ch["esdf_flags"], rows, ok, out_f)
    vlayer.put_rows(ch["parent"], rows, ok, out_p)
    changed_r = (update | ((out_d - e_d).abs() > cfg.min_diff_m)).any(1) & ok
    raised_r = raised.any(1) & ok
    changed_rows = torch.zeros(mbe, dtype=torch.bool, device=e_d.device)
    raised_rows = torch.zeros_like(changed_rows)
    vlayer.put_rows(changed_rows, rows, ok, changed_r)
    vlayer.put_rows(raised_rows, rows, ok, raised_r)
    return esdf_layer, changed_rows, raised_rows, overflow


# ---------------------------------------------------------------------------
# Lower sweep
# ---------------------------------------------------------------------------


def _pack_parent(px, py, pz):
    """Parent offset vector (each axis in [-126, 126]) -> packed int32."""
    return (((px + 128) << 16) | ((py + 128) << 8) | (pz + 128)).to(
        torch.int32)


def _unpack_parent(p):
    return (p >> 16) - 128, ((p >> 8) & 0xFF) - 128, (p & 0xFF) - 128


_PARENT_ZERO = (128 << 16) | (128 << 8) | 128  # packed (0, 0, 0)


def _relax_once(d_pad, obs_pad, src_pad, d, upd_mask, voxel_size, cfg,
                parent_pad=None, parent=None):
    """One 26-neighbour relaxation on padded cubes — the plain
    transcription of the JAX XLA path (the sweep's path without the
    kernel). Quasi-Euclidean: a neighbour costs its edge length.
    Full-Euclidean (``parent_pad``/``parent``, packed int32 offsets to
    the seed): a neighbour costs voxel_size * (|parent + offset| -
    |parent|), never negative, and a winning candidate adopts the
    extended offset; returns (d, parent) then."""
    v = d.shape[1]
    full_euclid = parent_pad is not None
    pos = d > 0.0
    best_pos = torch.full_like(d, float("inf"))
    best_neg = torch.full_like(d, -float("inf"))
    flip_len = torch.full_like(d, float("inf"))
    if full_euclid:
        best_pos_par = torch.full(d.shape, _PARENT_ZERO, dtype=torch.int32,
                                  device=d.device)
        best_neg_par = best_pos_par.clone()
    for k in range(26):
        dx, dy, dz = (int(c) for c in _OFFSETS[k])
        step = float(np.float32(_DISTANCES[k]) * voxel_size)
        sl = (slice(None), slice(1 + dz, 1 + dz + v),
              slice(1 + dy, 1 + dy + v), slice(1 + dx, 1 + dx + v))
        nd = d_pad[sl]
        n_ok = obs_pad[sl] & src_pad[sl]
        n_pos = nd > 0.0
        if full_euclid:
            # The source sits at centre + offset: walking back to the
            # centre extends its seed vector by +offset.
            px, py, pz = _unpack_parent(parent_pad[sl])
            cx = torch.clamp(px + dx, -126, 126)
            cy = torch.clamp(py + dy, -126, 126)
            cz = torch.clamp(pz + dz, -126, 126)
            norm_n = torch.sqrt((px * px + py * py + pz * pz).to(
                torch.float32))
            norm_c = torch.sqrt((cx * cx + cy * cy + cz * cz).to(
                torch.float32))
            inc = torch.clamp((norm_c - norm_n) * voxel_size, min=0.0)
            cand_par = _pack_parent(cx, cy, cz)
        else:
            inc = step
        cp = torch.where(n_ok & n_pos, nd + inc, float("inf"))
        cn = torch.where(n_ok & ~n_pos, nd - inc, -float("inf"))
        if full_euclid:
            take_p = cp < best_pos
            best_pos_par = torch.where(take_p, cand_par, best_pos_par)
            best_pos = torch.where(take_p, cp, best_pos)
            take_n = cn > best_neg
            best_neg_par = torch.where(take_n, cand_par, best_neg_par)
            best_neg = torch.where(take_n, cn, best_neg)
        else:
            best_pos = torch.minimum(best_pos, cp)
            best_neg = torch.maximum(best_neg, cn)
        potential = nd - torch.where(n_pos, step, -step)
        discrepant = (potential - d).abs() > step
        flip_len = torch.minimum(flip_len, torch.where(
            n_ok & (n_pos != pos) & discrepant, step, float("inf")))
    cand = torch.where(pos, torch.minimum(d, best_pos),
                       torch.maximum(d, best_neg))
    sgn = torch.where(pos, 1.0, -1.0)
    cand = torch.where(torch.isfinite(flip_len) & (cand.abs() > flip_len),
                       sgn * flip_len, cand)
    improved = (cand - d).abs() > cfg.min_diff_m
    take = upd_mask & improved
    d_out = torch.where(take, cand, d)
    if not full_euclid:
        return d_out
    # A neighbour's parent is adopted only where its candidate won; the
    # flip cap restarts at the interface (parent zero).
    from_nbr = take & torch.where(pos, cand == best_pos, cand == best_neg)
    parent_out = torch.where(from_nbr, torch.where(pos, best_pos_par,
                                                   best_neg_par), parent)
    parent_out = torch.where(take & ~from_nbr, _PARENT_ZERO, parent_out)
    return d_out, parent_out


def _morton10(rel):
    """Interleave 3x10-bit non-negative coords [N, 3] -> Morton codes."""

    def part1by2(x):
        x = x & 0x3FF
        x = (x | (x << 16)) & 0x30000FF
        x = (x | (x << 8)) & 0x300F00F
        x = (x | (x << 4)) & 0x30C30C3
        x = (x | (x << 2)) & 0x9249249
        return x

    rel = rel.to(torch.int64)
    return (part1by2(rel[:, 0]) | (part1by2(rel[:, 1]) << 1)
            | (part1by2(rel[:, 2]) << 2))


def _sweep_on(esdf_layer, d, flags, nbr, region_rows, cfg, write_back_rows,
              relax_impl: str = "kernel", parent8=None, shard=None):
    """Relax flat working-set arrays d/flags [n, vpb] with neighbour table
    nbr [n, 27] (rows of the same arrays, -1 missing) to convergence or
    ``cfg.max_outer_sweeps``; write back into the layer (whole pool when
    ``write_back_rows`` is None, else into ``(rows, ok)``). ``parent8``:
    int8 [n, vpb*3] seed offsets of the rows (full-Euclidean). Returns
    (layer, iters, unconverged bool[max_blocks]) — unconverged = rows
    whose last outer iteration still changed a voxel > min_diff.

    ``shard`` (parallel/sharding.py's block-sharded sweep): an object whose
    ``rows(n)`` gives this process's contiguous rows ``(lo, hi)`` and whose
    ``gather(x, n)`` concatenates every process's rows of ``x`` in order.
    Each outer iteration then relaxes only the own rows and gathers the
    result, so the halo exchange and the convergence test run on the same
    full arrays everywhere and every process leaves the loop together. A
    row's relaxation reads only its own padded cube, so the result is the
    unsharded one bit for bit."""
    v = esdf_layer.vps
    n = d.shape[0]
    mb = esdf_layer.max_blocks
    obs = (flags & OBS) != 0
    fixed = (flags & FIX) != 0
    upd = obs & ~fixed & region_rows[:, None]
    nbr = nbr.to(torch.int64)
    obs_pad = halo_exchange(_pad(obs, n, v), nbr)
    upd_pad = _pad(upd, n, v)
    d_pad = halo_exchange(_pad(d, n, v), nbr)
    rc = torch.ones(n, dtype=torch.bool, device=d.device)
    it = 0
    full_euclid = cfg.full_euclidean_distance
    use_kernel = cfg.use_pallas_kernel and v == 16 and not full_euclid
    if full_euclid:
        p8 = parent8.reshape(n, -1, 3).to(torch.int32)
        pp = _pack_parent(p8[..., 0], p8[..., 1], p8[..., 2]).reshape(
            n, v, v, v)
    if relax_impl not in ("kernel", "plain"):
        raise ValueError(f"relax_impl must be 'kernel' or 'plain', "
                         f"not {relax_impl!r}")
    relax = esdf_relax.relax if relax_impl == "kernel" else (
        esdf_relax.relax_plain)
    upd_c = upd.view(n, v, v, v)
    own = slice(None) if shard is None else slice(*shard.rows(n))

    def merged(x):  # the own rows of x -> every row
        return x if shard is None else shard.gather(x, n)

    obs_own, upd_own, upd_c_own = obs_pad[own], upd_pad[own], upd_c[own]
    codes = None
    if use_kernel and cfg.sweep_strides and any(
            int(k) > 1 for k in cfg.sweep_strides):
        # Observedness, fixedness and signs are static across the sweep:
        # the jump codes are built once, from the seeded state.
        fixed_pad = halo_exchange(_pad(fixed, n, v), nbr)
        codes = tuple(c[own] for c in stride_codes(
            d_pad, obs_pad, fixed_pad, nbr, cfg.sweep_strides))
    while it < cfg.max_outer_sweeps and (it == 0 or _runtime.host_bool(
            rc.any())):
        if use_kernel:
            # A block can change this outer only if it or a 1-ring
            # neighbour changed in the previous one. Missing (-1)
            # neighbours are clamped to row 0 for the gather, then masked
            # (a JAX gather clamps; a torch one would raise).
            act = rc | torch.where(nbr >= 0, rc[nbr.clamp(min=0)],
                                   False).any(1)
            new = merged(relax(
                d_pad[own], obs_own, upd_own, act[own], cfg.inner_sweeps,
                esdf_layer.voxel_size, cfg.max_distance_m, cfg.min_diff_m,
                strides=cfg.sweep_strides, codes=codes))
        else:
            new = d_pad[own]
            di = new[:, 1:-1, 1:-1, 1:-1]
            if full_euclid:
                # The parent halo is taken at the outer iteration's start,
                # as the distance halo is.
                p_new = halo_exchange(_pad(pp, n, v, _PARENT_ZERO), nbr)[own]
                pp = pp[own]
            for _ in range(cfg.inner_sweeps):
                src_pad = obs_own & (new.abs() < cfg.max_distance_m)
                if full_euclid:
                    di, pp = _relax_once(new, obs_own, src_pad, di,
                                         upd_c_own, esdf_layer.voxel_size,
                                         cfg, parent_pad=p_new, parent=pp)
                    p_new = p_new.clone()
                    p_new[:, 1:-1, 1:-1, 1:-1] = pp
                else:
                    di = _relax_once(new, obs_own, src_pad, di, upd_c_own,
                                     esdf_layer.voxel_size, cfg)
                new = new.clone()
                new[:, 1:-1, 1:-1, 1:-1] = di
            new = merged(new)
            if full_euclid:
                pp = merged(pp)
        rc = ((new - d_pad).abs() > cfg.min_diff_m).reshape(n, -1).any(1)
        d_pad = halo_exchange(new, nbr)
        it += 1
    d_out = d_pad[:, 1:-1, 1:-1, 1:-1].reshape(n, -1)
    ch = esdf_layer.channels
    if full_euclid:
        par8 = torch.stack(_unpack_parent(pp), -1).to(torch.int8).reshape(
            n, -1)
    if write_back_rows is None:
        ch["esdf"].copy_(d_out)
        unconverged = rc
        if full_euclid:
            ch["parent"].copy_(par8)
    else:
        rows, ok = write_back_rows
        vlayer.put_rows(ch["esdf"], rows, ok, d_out)
        unconverged = torch.zeros(mb, dtype=torch.bool, device=d.device)
        vlayer.put_rows(unconverged, rows, ok, rc & ok)
        if full_euclid:
            vlayer.put_rows(ch["parent"], rows, ok, par8)
    return esdf_layer, it, unconverged


def lower_sweep(esdf_layer, cfg: EsdfIntegratorConfig, region_rows=None,
                relax_impl: str = "kernel", shard=None):
    """Relax to convergence (or the outer cap) over ``region_rows`` (None
    = all active rows). ``shard``: the row split of the block-sharded
    sweep (see ``_sweep_on``). Returns (layer, iters, region_overflow,
    unconverged)."""
    mb = esdf_layer.max_blocks
    dev = esdf_layer.device
    active = esdf_layer.active_mask()
    if region_rows is None:
        region_rows = active
    region_rows = region_rows & active
    k = cfg.max_active_blocks
    if k is None or k >= mb:
        nbr = neighbor_slot_table(esdf_layer)
        layer_out, iters, unconverged = _sweep_on(
            esdf_layer, esdf_layer.channels["esdf"],
            esdf_layer.channels["esdf_flags"], nbr, region_rows, cfg, None,
            relax_impl, parent8=esdf_layer.channels["parent"], shard=shard)
        return (layer_out, iters, torch.zeros((), dtype=torch.bool,
                                              device=dev), unconverged)

    # Compact working set: region rows + their 1-ring neighbour sources.
    reg_rows = compact_ids(region_rows, k, fill=-1)
    reg_ok = reg_rows >= 0
    nbr_r = probe_neighbor_rows(esdf_layer, reg_rows, reg_ok)
    in_set = region_rows | vlayer.scatter_mask(mb, nbr_r, nbr_r >= 0)
    in_set = in_set & active
    region_overflow = (in_set.sum() > k) | (region_rows.sum() > k)
    rows = compact_ids(in_set, k, fill=-1)
    r_ok = rows >= 0
    # Morton-order the working set (spatially coherent blocks together).
    bijk_ws = esdf_layer.block_ijk[torch.where(r_ok, rows, 0).to(torch.int64)]
    base = torch.where(r_ok[:, None], bijk_ws, 1 << 20).amin(0)
    code = _morton10(torch.clamp(bijk_ws - base, 0, 1023))
    order = torch.argsort(torch.where(r_ok, code, 0x7FFFFFFF), stable=True)
    rows = rows[order]
    r_ok = rows >= 0
    safe = torch.where(r_ok, rows, 0).to(torch.int64)
    # Pool row -> working-set id; slot mb is the dump for dropped rows and
    # the lookup target of missing (-1) neighbours.
    inv = torch.full((mb + 1,), -1, dtype=torch.int64, device=dev)
    inv[torch.where(r_ok, rows, mb).to(torch.int64)] = torch.arange(
        k, device=dev)
    nbr_k = probe_neighbor_rows(esdf_layer, rows, r_ok)
    nbr_c = inv[torch.where(nbr_k >= 0, nbr_k, mb).to(torch.int64)]
    nbr_c = torch.where(r_ok[:, None], nbr_c, -1)
    d_c = esdf_layer.channels["esdf"][safe]
    f_c = torch.where(r_ok[:, None], esdf_layer.channels["esdf_flags"][safe],
                      0).to(torch.uint8)
    region_c = region_rows[safe] & r_ok
    out_layer, iters, unconverged = _sweep_on(
        esdf_layer, d_c, f_c, nbr_c, region_c, cfg, (rows, r_ok), relax_impl,
        parent8=esdf_layer.channels["parent"][safe], shard=shard)
    return out_layer, iters, region_overflow, unconverged


def seeded_layer(tsdf_layer, cfg: EsdfIntegratorConfig):
    """A new ESDF layer over every block of ``tsdf_layer``, seeded from it
    and ready for ``lower_sweep`` (on the TSDF layer's device)."""
    e = vlayer.make_layer("esdf", tsdf_layer.voxel_size, vps=tsdf_layer.vps,
                          max_blocks=tsdf_layer.max_blocks,
                          device=tsdf_layer.device)
    rows = tsdf_layer.active_mask()
    e, _ = _sync_blocks(e, tsdf_layer, rows)
    e, _, _ = seed_from_tsdf(e, tsdf_layer, cfg, rows)
    return e


# ---------------------------------------------------------------------------
# Region reset (the parallel raise)
# ---------------------------------------------------------------------------


def _dilate_rows(layer, rows_mask, radius_blocks: int, nbr=None):
    """Dilate a block-row mask by ``radius_blocks`` 1-ring steps."""
    if nbr is None:
        nbr = neighbor_slot_table(layer)
    mb = layer.max_blocks
    for _ in range(radius_blocks):
        rows_mask = vlayer.scatter_mask(
            mb, nbr, rows_mask[:, None] & (nbr >= 0)) | rows_mask
    return rows_mask & layer.active_mask()


def reset_region(esdf_layer, region_rows, cfg, keep_below=None):
    """Reset non-fixed voxels of the region to sign*default; voxels with
    |d| < keep_below[row] keep their value."""
    flags = esdf_layer.channels["esdf_flags"]
    d = esdf_layer.channels["esdf"]
    m = ((flags & OBS) != 0) & ((flags & FIX) == 0) & region_rows[:, None]
    if keep_below is not None:
        m = m & (d.abs() >= keep_below[:, None])
    sgn = torch.where(d >= 0.0, 1.0, -1.0)
    d.copy_(torch.where(m, sgn * cfg.default_distance_m, d))
    return esdf_layer


# ---------------------------------------------------------------------------
# Working-set buckets
# ---------------------------------------------------------------------------

# Last working-set bucket per (pool size, vps, cap): sized once from a
# block-count read (a host sync), then only grown by overflow retries.
_BUCKET_CACHE: dict = {}


def _bucket_for(n: int) -> int:
    """Smallest bucket >= n on the {2^i, 3*2^(i-1)} ladder from 64."""
    b = 64
    while True:
        for c in (b, 3 * b // 2):
            if c >= n:
                return c
        b *= 2


def _bucketed_cfg(cfg: EsdfIntegratorConfig, esdf_layer, tsdf_layer):
    k = cfg.max_active_blocks
    if k is None or k >= esdf_layer.max_blocks:
        return cfg
    key = (esdf_layer.max_blocks, esdf_layer.vps, k)
    b = _BUCKET_CACHE.get(key)
    if b is None:
        n = max(_runtime.host_int(esdf_layer.num_blocks),
                _runtime.host_int(tsdf_layer.num_blocks))
        b = min(_bucket_for(n), k)
        _BUCKET_CACHE[key] = b
    if b >= k:
        return cfg
    return dataclasses.replace(cfg, max_active_blocks=b)


def _grow_cfg(cfg, cap, esdf_layer):
    k = min(cfg.max_active_blocks * 2,
            cap.max_active_blocks or cfg.max_active_blocks * 2)
    if k == cfg.max_active_blocks:
        return None
    key = (esdf_layer.max_blocks, esdf_layer.vps, cap.max_active_blocks)
    _BUCKET_CACHE[key] = max(_BUCKET_CACHE.get(key, 0), k)
    return dataclasses.replace(cfg, max_active_blocks=k)


def presize_bucket(cfg: EsdfIntegratorConfig, esdf_layer, n_blocks: int):
    """Pre-size the cached working-set bucket to cover ``n_blocks``."""
    if (cfg.max_active_blocks is None
            or cfg.max_active_blocks >= esdf_layer.max_blocks):
        return
    key = (esdf_layer.max_blocks, esdf_layer.vps, cfg.max_active_blocks)
    b = min(_bucket_for(int(n_blocks)), cfg.max_active_blocks)
    _BUCKET_CACHE[key] = max(_BUCKET_CACHE.get(key, 0), b)


def grow_bucket_cache(cfg: EsdfIntegratorConfig, esdf_layer):
    """Double the cached bucket (deferred-overflow recovery)."""
    if (cfg.max_active_blocks is None
            or cfg.max_active_blocks >= esdf_layer.max_blocks):
        return
    _grow_cfg(_bucketed_cfg(cfg, esdf_layer, esdf_layer), cfg, esdf_layer)


# ---------------------------------------------------------------------------
# Updates
# ---------------------------------------------------------------------------


def _set_debt(esdf_layer, unconverged):
    f = esdf_layer.block_flags
    f.copy_(torch.where(unconverged, f | vlayer.SWEEP_DEBT,
                        f & (~vlayer.SWEEP_DEBT & 0xFF)))


def _batch(esdf_layer, tsdf_layer, cfg, relax_impl):
    """Drop + reseed from every TSDF block and sweep:
    (esdf_layer, overflow, region_ovf, iters)."""
    for c in esdf_layer.channels.values():
        c.zero_()
    rows_mask = tsdf_layer.active_mask()
    esdf_layer, overflow = _sync_blocks(esdf_layer, tsdf_layer, rows_mask)
    k = cfg.max_active_blocks
    crust = cfg.add_occupied_crust
    if k is None or k >= esdf_layer.max_blocks:
        esdf_layer, _, _ = seed_from_tsdf(esdf_layer, tsdf_layer, cfg,
                                          rows_mask, crust=crust)
        seed_ovf = torch.zeros((), dtype=torch.bool,
                               device=esdf_layer.device)
    else:
        esdf_layer, _, _, seed_ovf = _seed_compact(
            esdf_layer, tsdf_layer, cfg, rows_mask, k, crust=crust)
    esdf_layer, iters, region_ovf, unconverged = lower_sweep(
        esdf_layer, cfg, relax_impl=relax_impl)
    _set_debt(esdf_layer, unconverged)
    return esdf_layer, overflow, region_ovf | seed_ovf, iters


def _incremental(esdf_layer, tsdf_layer, cfg, relax_impl):
    """Incremental update from the TSDF kEsdf dirty bits (clears them):
    (esdf_layer, tsdf_layer, overflow, region_ovf, iters)."""
    dev = esdf_layer.device
    dirty_rows = vlayer.dirty_mask(tsdf_layer, vlayer.DIRTY_ESDF)
    esdf_layer, overflow = _sync_blocks(esdf_layer, tsdf_layer, dirty_rows)
    k = cfg.max_active_blocks
    mb = esdf_layer.max_blocks
    seed_ovf = torch.zeros((), dtype=torch.bool, device=dev)
    if k is None or k >= mb:
        esdf_layer, changed_rows, raised_rows = seed_from_tsdf(
            esdf_layer, tsdf_layer, cfg, dirty_rows)
    else:
        esdf_layer, changed_rows, raised_rows, seed_ovf = _seed_compact(
            esdf_layer, tsdf_layer, cfg, dirty_rows, k)
    radius = max(1, int(np.ceil(cfg.max_distance_m / esdf_layer.block_size)))
    dil_ovf = torch.zeros((), dtype=torch.bool, device=dev)
    active = esdf_layer.active_mask()
    if k is None or k >= mb:
        nbr = neighbor_slot_table(esdf_layer)

        def dilate1(mask):
            return _dilate_rows(esdf_layer, mask, 1, nbr=nbr), False
    else:
        def dilate1(mask):
            rows = compact_ids(mask, k, fill=-1)
            ok = rows >= 0
            nbr_r = probe_neighbor_rows(esdf_layer, rows, ok)
            out = mask | vlayer.scatter_mask(mb, nbr_r, nbr_r >= 0)
            return out & active, mask.sum() > k

    # Chebyshev block-graph arrival distance to the raised set; voxels
    # with |d| < (reach-1)*block_size keep their value in the reset.
    reach = torch.where(raised_rows, 0, radius + 1)
    mask = raised_rows
    for it in range(1, radius + 1):
        mask, o = dilate1(mask)
        dil_ovf = dil_ovf | o
        reach = torch.minimum(reach, torch.where(mask, it, radius + 1))
    raise_region = mask
    margin = (torch.clamp(reach - 1, min=0).to(torch.float32)
              * esdf_layer.block_size)
    esdf_layer = reset_region(esdf_layer, raise_region, cfg,
                              keep_below=margin)
    sweep_region = changed_rows | raise_region
    for _ in range(radius):
        sweep_region, o = dilate1(sweep_region)
        dil_ovf = dil_ovf | o
    # Convergence-debt carry: rows a capped sweep left changing re-enter
    # (+1 block); the sweep runs at most the capped outer count.
    cap = cfg.max_outer_sweeps_incremental
    debt = (esdf_layer.block_flags & vlayer.SWEEP_DEBT) != 0
    debt1, o = dilate1(debt)
    dil_ovf = dil_ovf | o
    sweep_region = sweep_region | debt1
    run_cfg = (dataclasses.replace(cfg, max_outer_sweeps=min(
        cap, cfg.max_outer_sweeps)) if cap is not None else cfg)
    esdf_layer, iters, region_ovf, unconverged = lower_sweep(
        esdf_layer, run_cfg, sweep_region, relax_impl=relax_impl)
    _set_debt(esdf_layer, unconverged)
    tsdf_layer = vlayer.clear_dirty(tsdf_layer, vlayer.DIRTY_ESDF)
    return (esdf_layer, tsdf_layer, overflow,
            region_ovf | seed_ovf | dil_ovf, iters)


def update_from_tsdf_batch(esdf_layer, tsdf_layer,
                           cfg: EsdfIntegratorConfig,
                           relax_impl: str = "kernel"):
    """Batch rebuild, retried at a grown bucket on working-set overflow:
    (esdf_layer, overflow, iters). Each attempt runs on a copy of the
    input so a retry starts from the same state."""
    run_cfg = _bucketed_cfg(cfg, esdf_layer, tsdf_layer)
    while True:
        out, overflow, region_ovf, iters = _batch(
            vlayer.clone_layer(esdf_layer), tsdf_layer, run_cfg, relax_impl)
        if not _runtime.host_bool(region_ovf):
            return out, overflow, iters
        grown = _grow_cfg(run_cfg, cfg, esdf_layer)
        if grown is None:
            return out, overflow | region_ovf, iters
        run_cfg = grown


def update_from_tsdf_batch_deferred(esdf_layer, tsdf_layer,
                                    cfg: EsdfIntegratorConfig,
                                    relax_impl: str = "kernel"):
    """Batch rebuild without the retry: (esdf_layer, overflow, region_ovf,
    iters), flags as device booleans."""
    run_cfg = _bucketed_cfg(cfg, esdf_layer, tsdf_layer)
    return _batch(esdf_layer, tsdf_layer, run_cfg, relax_impl)


def update_from_tsdf_incremental(esdf_layer, tsdf_layer,
                                 cfg: EsdfIntegratorConfig,
                                 relax_impl: str = "kernel"):
    """Incremental update, retried at a grown bucket on working-set
    overflow: (esdf_layer, tsdf_layer, overflow, iters)."""
    run_cfg = _bucketed_cfg(cfg, esdf_layer, tsdf_layer)
    while True:
        out_e, out_t, overflow, region_ovf, iters = _incremental(
            vlayer.clone_layer(esdf_layer), vlayer.clone_layer(tsdf_layer),
            run_cfg, relax_impl)
        if not _runtime.host_bool(region_ovf):
            return out_e, out_t, overflow, iters
        grown = _grow_cfg(run_cfg, cfg, esdf_layer)
        if grown is None:
            return out_e, out_t, overflow | region_ovf, iters
        run_cfg = grown


def update_from_tsdf_incremental_deferred(esdf_layer, tsdf_layer,
                                          cfg: EsdfIntegratorConfig,
                                          relax_impl: str = "kernel"):
    """Incremental update without the retry: (esdf_layer, tsdf_layer,
    overflow, region_ovf, iters); on a late region overflow recover with
    grow_bucket_cache + update_from_tsdf_batch. Updates in place."""
    run_cfg = _bucketed_cfg(cfg, esdf_layer, tsdf_layer)
    return _incremental(esdf_layer, tsdf_layer, run_cfg, relax_impl)
