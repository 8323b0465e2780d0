"""Sphere tracing and the differentiable depth/colour renderer (port of
voxblox_tpu/ops/render.py).

1. ``surface_distance_along_rays``: the reference's
   ``getSurfaceDistanceAlongRay`` stepping rules (voxblox
   utils/distance_utils.h:16-78) in lockstep over rays: one voxel through
   unobserved space, the stored distance where it exceeds a voxel, a hit
   at or just before the surface. The intensity integrator runs on it.
2. ``render_depth``: the march is gradient-stopped (it runs under
   ``torch.no_grad``), then one Newton step with trilinear SDF sampling,
   ``t* = t - sdf(x_t) / <grad sdf, d>`` with the denominator detached,
   makes the depth differentiable in the voxel SDF (and the colour in the
   colour channel) through plain gather adjoints (index-add in the
   backward; on the GPU in atomics order).

Torch has no ``while_loop``. A lane that is done is frozen, so marching a
few more steps after every lane is done changes nothing: the march runs
groups of 8 steps (JAX's ``step8``) and reads its done mask on the host
every ``CHECK_EVERY`` groups, never past JAX's own step bound (phase 1:
``phase1_iters`` groups; phase 2: ``max_steps`` steps rounded up to whole
groups). Each read is one host sync (``_runtime.SYNCS``);
``LAST_MARCH`` holds the last call's steps, survivors and syncs.

The JAX CPU program contracts ``o + t * d`` and ``x - (low + 0.5) * vs``
into fused multiply-adds; the port computes both with ``raycast.fma``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import _runtime
from ..core import grid
from ..core import layer as vlayer
from . import interp
from .compaction import compact_ids
from .raycast import fma

# Payload codes of the packed dense voxel field (the march's fast path): a
# cell holds a real SDF sample (< _UNOBS), the unobserved sentinel, or
# _SKIP0 + k, "no surface within k blocks".
_UNOBS = 5e5
_SKIP0 = 1e6
MAX_CHEB = 8
CHECK_EVERY = 2  # step8 groups between host reads of the march's done mask
SURFACE_CHECK_EVERY = 16  # steps between reads in surface_distance_along_rays

LAST_MARCH: dict = {}


def _unit(v):
    return v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)


def _fma_rows(t, d, o):
    """o + t[:, None] * d rounded once (the contracted JAX program)."""
    return fma(t[:, None], d, o)


def surface_distance_along_rays(layer: vlayer.VoxelLayer, origins,
                                bearing_vectors, max_distance: float,
                                max_steps: int = 0):
    """Reference stepping rules, lockstep over rays. origins and
    bearing_vectors f32[R,3] (bearings need not be unit). Returns (t f32[R],
    hit bool[R]); the surface point is origin + t * unit bearing. The
    table's probe bound is read once; the loop stops once every lane is
    done (exact: done lanes are frozen)."""
    dirs = _unit(bearing_vectors)
    vs = layer.voxel_size
    if not max_steps:
        max_steps = int(max_distance / vs * 1.05) + 8
    psl = _runtime.host_int(layer.table.max_psl)
    tsdf = layer.channels["tsdf"].reshape(-1)
    weight = layer.channels["weight"].reshape(-1)
    n = dirs.shape[0]
    t = torch.zeros(n, dtype=torch.float32, device=dirs.device)
    hit = torch.zeros(n, dtype=torch.bool, device=dirs.device)
    done = torch.zeros_like(hit)
    for step in range(max_steps):
        x = _fma_rows(t, dirs, origins)
        gvi = grid.point_to_grid_index(x, 1.0 / vs)
        flat, found = vlayer.global_voxel_to_flat(layer, gvi, psl)
        safe = torch.where(found, flat, 0)
        d = torch.where(found, tsdf[safe], 0.0)
        w = torch.where(found, weight[safe], 0.0)
        observed = found & (w > 1e-6)
        # Rule order mirrors distance_utils.h:35-69.
        step_far = observed & (d > vs)
        hit_neg = observed & (d < 0.0)
        hit_near = observed & (d >= 0.0) & (d < vs)
        dt = torch.where(step_far, d, vs)  # unobserved and d == vs: a voxel
        dt = torch.where(hit_near, d, dt)
        newly_hit = ~done & (hit_neg | hit_near)
        t = torch.where(done, t, t + torch.where(hit_neg, 0.0, dt))
        hit = hit | newly_hit
        done = done | newly_hit | (t >= max_distance)
        if ((step + 1) % SURFACE_CHECK_EVERY == 0 and step + 1 < max_steps
                and _runtime.host_bool(done.all())):
            break
    return t, hit


def _min3(x, axis: int):
    """3-window minimum along one axis of [D,D,D], +inf beyond the edge
    (``lax.reduce_window`` SAME with a -inf init on the negation)."""
    k = [1, 1, 1]
    p = [0, 0, 0]
    k[axis], p[axis] = 3, 1
    return -F.max_pool3d(-x[None, None], kernel_size=k, stride=1,
                         padding=p)[0, 0]


def _cell_addr(rel, dim: int):
    return (rel[..., 0] * dim + rel[..., 1]) * dim + rel[..., 2]


def _corner_offsets(device):
    return _runtime.const(interp._CORNERS, torch.int64, device)


class _Grid:
    """The march's acceleration structures, built once per call: the dense
    block grid over the active map's bounding box with the "may contain a
    surface" test and the Chebyshev block skip folded in, and the voxel
    field (packed dense for grids of <= 32 blocks a side)."""

    def __init__(self, layer, dim: int):
        self.vs = vs = layer.voxel_size
        self.bs = layer.block_size
        self.v = layer.vps
        self.vpb = vpb = layer.voxels_per_block
        self.dim = dim
        dev = layer.device
        tsdf = layer.channels["tsdf"]
        observed = layer.channels["weight"] > 1e-6
        ncell = dim ** 3
        with torch.no_grad():
            active = layer.active_mask()
            surface_block = (observed & (tsdf.abs() < 2.0 * vs)).any(1) \
                & active
            bijk = layer.block_ijk.to(torch.int64)
            big = 1 << 20
            any_active = active.any()
            lo = torch.where(active[:, None], bijk, big).amin(0)
            hi = torch.where(active[:, None], bijk, -big).amax(0)
            self.origin_blk = torch.where(any_active, lo, 0)
            self.max_blk = torch.where(any_active, hi, 0)
            rel = bijk - self.origin_blk
            ing = ((rel >= 0) & (rel < dim)).all(-1)
            addr = _cell_addr(rel, dim)
            rows = torch.arange(layer.max_blocks, dtype=torch.int32,
                                device=dev)

            def block_grid(sel):
                # Selected rows have distinct cells; the rest land on the
                # dump cell ``ncell``, which is cut off.
                g = torch.full((ncell + 1,), -1, dtype=torch.int32,
                               device=dev)
                g[torch.where(sel, addr, ncell)] = rows
                return g[:ncell]

            dense = block_grid(ing & surface_block)
            # Block-level Chebyshev distance to the nearest surface block,
            # capped: separable 3-window minimum dilations.
            surf3 = (dense >= 0).view(dim, dim, dim)
            cheb = torch.where(surf3, 0.0, float(MAX_CHEB))
            for _ in range(MAX_CHEB - 1):
                nmin = cheb
                for ax in range(3):
                    nmin = _min3(nmin, ax)
                cheb = torch.minimum(cheb, nmin + 1.0)
            cheb = cheb.reshape(-1)
            self.gridv = torch.where(surf3.reshape(-1), dense,
                                     -cheb.to(torch.int32))
        self.packed = dim <= 32
        if self.packed:
            # Every cell holds its block's skip code; rows of active blocks
            # within one block of a surface (the only blocks the
            # refinement can sample) overwrite it with SDF / _UNOBS
            # payloads in one row scatter, differentiable in the TSDF.
            with torch.no_grad():
                skipv = _SKIP0 + torch.clamp(cheb - 1.0, min=0.0)
                chb_row = cheb[torch.where(ing, addr, 0)]
                write = ing & active & (chb_row <= 1.0)
                base = torch.cat([skipv[:, None].expand(ncell, vpb),
                                  torch.zeros((1, vpb), device=dev)])
            field_rows = torch.where(observed, tsdf, _UNOBS)
            self.field = torch.index_put(
                base, (torch.where(write, addr, ncell),),
                field_rows)[:ncell].reshape(-1)
            self.dense_all = None
        else:
            self.field = torch.where(observed, tsdf, float("inf")).reshape(-1)
            with torch.no_grad():
                self.dense_all = block_grid(ing & active)
        self.field_d = self.field.detach()

    # -- the march ---------------------------------------------------------
    def _locate(self, x):
        gvi = grid.point_to_grid_index(x, 1.0 / self.vs).to(torch.int64)
        block, local = grid.split_global(gvi, self.v)
        rel = block - self.origin_blk
        inb = ((rel >= 0) & (rel < self.dim)).all(-1)
        return block, rel, inb, grid.local_to_linear(local, self.v)

    def step(self, o, d, inv_d, stop_at, t, done):
        vs, bs = self.vs, self.bs
        x = _fma_rows(t, d, o)
        block, rel, inb, lin = self._locate(x)
        a = _cell_addr(rel, self.dim)
        corner = (block + (d > 0.0).to(torch.int64)).to(torch.float32) * bs
        t_exit = ((corner - x) * inv_d).amin(-1)
        if self.packed:
            val = self.field_d[torch.where(inb, a * self.vpb + lin, 0)]
            val = torch.where(inb, val, _SKIP0)
            real = val < _UNOBS
            unobs = (val >= _UNOBS) & (val < _SKIP0)
            skip = (torch.clamp(t_exit, min=0.0)
                    + torch.clamp(val - _SKIP0, min=0.0) * bs + 0.05 * vs)
            adv = torch.where(real, torch.clamp(val, min=0.9 * vs),
                              torch.where(unobs, vs,
                                          torch.clamp(skip, min=vs)))
            hit_now = val < 0.9 * vs  # only real payloads are this small
        else:
            g = self.gridv[torch.where(inb, a, 0)]
            g = torch.where(inb, g, -1)
            has_surface = g >= 0
            far = torch.clamp(-g - 1, min=0).to(torch.float32) * bs
            skip = torch.clamp(t_exit, min=0.0) + far + 0.05 * vs
            flat = g.to(torch.int64) * self.vpb + lin
            s = torch.where(has_surface,
                            self.field_d[torch.where(has_surface, flat, 0)],
                            float("inf"))
            observed = torch.isfinite(s)
            adv_vox = torch.where(observed, torch.clamp(s, min=0.9 * vs), vs)
            adv = torch.where(has_surface, adv_vox, torch.clamp(skip, min=vs))
            hit_now = has_surface & observed & (s < 0.9 * vs)
        t = torch.where(done | hit_now, t, t + adv)
        done = done | hit_now | (t >= stop_at)
        return t, done

    def march(self, rays, t, done, max_groups: int):
        """At most ``max_groups`` groups of 8 steps, stopping at the first
        host check that finds every lane done. Returns (t, done, steps,
        lanes still alive at the last check)."""
        groups = 0
        alive = None
        while groups < max_groups:
            for _ in range(min(CHECK_EVERY, max_groups - groups)):
                for _ in range(8):
                    t, done = self.step(*rays, t, done)
                groups += 1
            alive = _runtime.host_int((~done).sum())
            if alive == 0:
                break
        if alive is None:
            alive = _runtime.host_int((~done).sum())
        return t, done, 8 * groups, alive

    # -- sampling ----------------------------------------------------------
    def corner_vals(self, x, field):
        """8-corner field values [Q,8] (0 where invalid), fractional
        coordinates and validity (every corner observed)."""
        vs, v = self.vs, self.v
        inv = 1.0 / vs
        low = torch.floor(x * inv - 0.5 + grid.EPS).to(torch.int64)
        frac = fma(-(low.to(torch.float32) + 0.5), vs, x) * inv
        corners = low[:, None, :] + _corner_offsets(x.device)
        block, local = grid.split_global(corners, v)
        rel = block - self.origin_blk
        inb = ((rel >= 0) & (rel < self.dim)).all(-1)
        a = _cell_addr(rel, self.dim)
        lin = grid.local_to_linear(local, v)
        if self.packed:
            vals = field[torch.where(inb, a * self.vpb + lin, 0)]
            vals = torch.where(inb, vals, _SKIP0)
            ok = vals < _UNOBS
            return torch.where(ok, vals, 0.0), frac, ok.all(-1)
        slot = self.dense_all[torch.where(inb, a, 0)]
        slot = torch.where(inb, slot, -1)
        has = slot >= 0
        flat = slot.to(torch.int64) * self.vpb + lin
        vals = torch.where(has, field[torch.where(has, flat, 0)],
                           float("inf"))
        ok = torch.isfinite(vals)
        return torch.where(ok, vals, 0.0), frac, ok.all(-1)

    def nearest_value(self, x):
        """March-field value of the containing voxel, and its validity."""
        _, rel, inb, lin = self._locate(x)
        a = _cell_addr(rel, self.dim)
        if self.packed:
            s = self.field_d[torch.where(inb, a * self.vpb + lin, 0)]
            s = torch.where(inb, s, _SKIP0)
            return torch.where(s < _UNOBS, s, 0.0), s < _UNOBS
        slot = self.dense_all[torch.where(inb, a, 0)]
        slot = torch.where(inb, slot, -1)
        has = slot >= 0
        flat = slot.to(torch.int64) * self.vpb + lin
        s = torch.where(has, self.field_d[torch.where(has, flat, 0)],
                        float("inf"))
        return s, torch.isfinite(s)


def _tri_val_grad(vals, frac, vs: float):
    """Trilinear value and its exact spatial gradient from corner values
    (corner index cx + 2 cy + 4 cz), summed in the JAX package's order."""
    w8 = interp._trilinear_weights(frac)
    val = torch.sum(w8 * vals, dim=-1)
    fx, fy, fz = frac[..., 0], frac[..., 1], frac[..., 2]
    gxw, gyw, gzw = 1.0 - fx, 1.0 - fy, 1.0 - fz

    def axis_grad(wa0, wa1, wb0, wb1, pick):
        tot = 0.0
        for cb in (0, 1):
            for ca in (0, 1):
                wa = wa1 if ca else wa0
                wb = wb1 if cb else wb0
                hi, lo = pick(ca, cb)
                tot = tot + wa * wb * (vals[:, hi] - vals[:, lo])
        return tot

    gx = axis_grad(gyw, fy, gzw, fz,
                   lambda cy, cz: (1 + 2 * cy + 4 * cz, 2 * cy + 4 * cz))
    gy = axis_grad(gxw, fx, gzw, fz,
                   lambda cx, cz: (2 + cx + 4 * cz, cx + 4 * cz))
    gz = axis_grad(gxw, fx, gyw, fy,
                   lambda cx, cy: (4 + cx + 2 * cy, cx + 2 * cy))
    return val, torch.stack([gx, gy, gz], dim=-1) / vs


def render_depth(layer: vlayer.VoxelLayer, origins, dirs,
                 max_distance: float, max_steps: int = 0,
                 with_color: bool = False, dense_grid_dim: int = 64,
                 nearest_pulls: int = 4, trilinear_pulls: int = 1,
                 phase1_iters: int = 10):
    """Differentiable depth (and colour) along rays.

    origins/dirs f32[R,3], dirs unit, on the layer's device. Returns
    (depth [R], hit [R]) or (depth, color [R,3], hit). ``depth`` carries
    gradients to the layer's ``tsdf`` channel, ``color`` to ``color`` (and
    through the hit point to ``tsdf``): give the layer channels that
    require grad. ``dense_grid_dim`` sizes the dense acceleration grid
    (``fit_dense_grid_dim``); grids of <= 32 blocks a side march the
    packed single-gather field, larger ones the two-gather general path.
    """
    vs = layer.voxel_size
    bs = layer.block_size
    if not max_steps:
        max_steps = int(max_distance / vs * 0.6) + int(max_distance / bs) + 16
    syncs0 = _runtime.SYNCS
    acc = _Grid(layer, dense_grid_dim)
    n = dirs.shape[0]
    with torch.no_grad():
        inv_dirs = 1.0 / torch.where(dirs.abs() < 1e-12, 1e-12, dirs)
        # Clip rays to the active map's bounding box.
        bbox_lo = acc.origin_blk.to(torch.float32) * bs
        bbox_hi = (acc.max_blk + 1).to(torch.float32) * bs
        ta = (bbox_lo - origins) * inv_dirs
        tb = (bbox_hi - origins) * inv_dirs
        t_enter = torch.minimum(ta, tb).amax(-1)
        t_leave = torch.maximum(ta, tb).amin(-1)
        miss = (t_enter > t_leave) | (t_leave < 0.0)
        t_stop_at = torch.clamp(t_leave + 0.5 * vs, max=max_distance)

        # Phase 1: full width for at most phase1_iters groups. Phase 2:
        # the survivors compacted into an n/8 buffer and marched to the
        # end there; if they overflow it, the march finishes at full
        # width (both compute every lane the same way).
        full = (origins, dirs, inv_dirs, t_stop_at)
        t0 = torch.clamp(torch.where(miss, t_stop_at, t_enter), min=0.0)
        t1, done1, steps1, alive = acc.march(
            full, t0, miss | (t0 >= t_stop_at),
            min(phase1_iters, max_steps))
        groups2 = -(-max_steps // 8)
        n2 = max(128, n // 8)
        compacted = False
        if alive == 0:
            t_raw, steps2 = t1, 0
        elif n2 >= n or alive > n2:
            t_raw, _, steps2, _ = acc.march(full, t1, done1, groups2)
        else:
            compacted = True
            ids = compact_ids(~done1, n2)
            safe = torch.where(ids < n, ids, 0).to(torch.int64)
            sub = tuple(x[safe] for x in full)
            t2, _, steps2, _ = acc.march(sub, t1[safe], ids >= n, groups2)
            t_raw = torch.cat([t1, t1[:1]])
            t_raw[torch.where(ids < n, ids, n).to(torch.int64)] = t2
            t_raw = t_raw[:n]
        # Rays that left the map unhit report max_distance.
        t_raw = torch.where(t_raw >= t_stop_at, max_distance, t_raw)

        # Gradient-stopped pulls into the final interpolation cell: the
        # nearest-voxel value first, then the trilinear one.
        t_stop = t_raw
        for _ in range(nearest_pulls):
            s_r, v_r = acc.nearest_value(_fma_rows(t_stop, dirs, origins))
            t_stop = torch.where(
                v_r, t_stop + torch.clamp(s_r, -2 * vs, 2 * vs), t_stop)
        for _ in range(trilinear_pulls):
            vals, frac, v_r = acc.corner_vals(
                _fma_rows(t_stop, dirs, origins), acc.field_d)
            s_r = torch.sum(interp._trilinear_weights(frac) * vals, dim=-1)
            t_stop = torch.where(
                v_r, t_stop + torch.clamp(s_r, -2 * vs, 2 * vs), t_stop)
        x_stop = _fma_rows(t_stop, dirs, origins)
    # The Newton step, differentiable in the map through s only.
    vals, frac, valid = acc.corner_vals(x_stop, acc.field)
    s, g = _tri_val_grad(vals, frac, vs)
    denom = torch.sum(g.detach() * dirs, dim=-1)
    # Along-ray SDF slope ~1 near a surface; clamp away from 0.
    denom = torch.where(denom.abs() < 0.3,
                        torch.where(denom < 0.0, -0.3, 0.3), denom)
    depth = t_stop - s / denom
    hit = valid & (t_stop < max_distance) & (s.detach().abs() < 2.0 * vs)
    depth = torch.where(hit, depth, max_distance)
    LAST_MARCH.clear()
    LAST_MARCH.update(rays=n, phase1_steps=steps1, phase2_steps=steps2,
                      survivors=alive, compacted=compacted,
                      packed=acc.packed, max_steps=max_steps)
    if with_color:
        # The sample position moves with the depth: colour reaches the
        # SDF channel through the hit point, the colour channel through
        # the trilinear weights.
        x_surf = fma(depth[:, None], dirs, origins)
        color, cvalid = interp.interpolate_trilinear_color(layer, x_surf)
        color = torch.where((hit & cvalid)[:, None], color, 0.0)
        LAST_MARCH["syncs"] = _runtime.SYNCS - syncs0
        return depth, color, hit
    LAST_MARCH["syncs"] = _runtime.SYNCS - syncs0
    return depth, hit


def fit_dense_grid_dim(layer, dense_grid_dim: int = 64) -> int:
    """The active bounding box's extent in blocks, rounded up to a multiple
    of 16 (at least 16): maps within 32 blocks get the packed march. One
    host read. ``dense_grid_dim`` caps nothing (signature compatibility)."""
    active = _runtime.to_host(layer.active_mask())
    if not active.any():
        return 16
    ijk = _runtime.to_host(layer.block_ijk)[active]
    extent = int((ijk.max(axis=0) - ijk.min(axis=0)).max()) + 1
    return max(16, ((extent + 15) // 16) * 16)


def render_depth_image(layer, T_G_C, intrinsics, resolution, max_distance,
                       **kw):
    """A pinhole depth image, intrinsics = (fx, fy, cx, cy), resolution =
    (W, H): depth [H, W] and hit (and color [H, W, 3] between them with
    ``with_color``). The dense grid is sized to the active map unless
    ``dense_grid_dim`` is given."""
    if "dense_grid_dim" not in kw:
        kw["dense_grid_dim"] = fit_dense_grid_dim(layer)
    dev = layer.device
    w, h = resolution
    fx, fy, cx, cy = intrinsics
    vv, uu = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                            torch.arange(w, dtype=torch.float32, device=dev),
                            indexing="ij")
    rays_C = _unit(torch.stack([(uu - cx) / fx, (vv - cy) / fy,
                                torch.ones_like(uu)], dim=-1).reshape(-1, 3))
    R, tr = T_G_C
    R = torch.as_tensor(R, dtype=torch.float32, device=dev)
    tr = torch.as_tensor(tr, dtype=torch.float32, device=dev)
    rays_G = rays_C @ R.T
    out = render_depth(layer, tr.expand(rays_G.shape), rays_G, max_distance,
                       **kw)
    shapes = [(h, w), (h, w, 3), (h, w)] if len(out) == 3 else [(h, w)] * 2
    return tuple(x.reshape(s) for x, s in zip(out, shapes))
