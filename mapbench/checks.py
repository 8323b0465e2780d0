"""What decides ``correct``: the map the window left against the plain
reference (``mapbench/reference``), as one number beside its limit.

``tsdf``: the reference integrates every scan handed over, in order,
from the empty map, by the rule of the configuration's integrator
(``server.method``: ``merged`` is voxblox's merged ray-casting
integrator, ``projective`` the program's projective one). A rolling map
(``server.max_block_distance_from_body`` > 0) drops, after each scan,
every block farther than that from the scan's sensor, as voxblox's
tsdf_server does (tsdf_server.cc:314-319). The number is
the share of voxels observed on either side whose distance differs by
more than ``D_TOL`` or whose weight differs by more than ``W_TOL`` of
it. The reference takes nothing from the program: the scans and poses
are the benchmark's own.

``judge`` compares any candidate map with the reference: the program's
(``program_store``) in a run, the reference's own in bfloat16 for the
control (``control_store``), so both come out of one comparison.
"""

from __future__ import annotations

import torch

from .reference import merged as rmerged
from .reference import tsdf as rtsdf
from .reference.store import BlockStore, remove_distant_blocks

D_TOL = 1e-4  # metres
W_TOL = 1e-4  # share of the weight
ACTIVE = 128
VPS = 16
# A replay keeps a scan's samples for its next hand-off while they fit.
CACHE_BYTES = 8 << 30
# Room for float32 rounding in the distances ``rolling_start`` relies on.
ROLLING_MARGIN_M = 1.0


def tsdf_cfg(cfg):
    t = dict(cfg["tsdf"])
    for key, want in (("voxel_carving_enabled", True),
                      ("use_const_weight", False), ("allow_clear", True),
                      ("use_weight_dropoff", True),
                      ("use_sparsity_compensation_factor", False),
                      ("enable_anti_grazing", False)):
        if t.get(key, want) != want:
            raise ValueError(f"the reference supports {key}={want} only")
    t["voxel_size"] = cfg["map"]["voxel_size"]
    return t


def program_store(snap, cfg):
    """The program's map (a copy of its block pool's active rows)."""
    act = (snap["t_flags"] & ACTIVE) != 0
    s = BlockStore.from_rows(
        snap["t_ijk"][act], {"tsdf": snap["tsdf"][act],
                             "weight": snap["weight"][act]},
        cfg["map"]["max_blocks"], VPS)
    s.voxel_size = cfg["map"]["voxel_size"]
    return s


def _share(off, total):
    return 0.0 if total == 0 else off / total


def compare_tsdf(cand, ref):
    """Share of the voxels observed on either side that differ."""
    ra = cand.rows_of(ref.ijk[:ref.n])
    only = torch.nonzero(ref.rows_of(cand.ijk[:cand.n]) < 0).flatten()
    has = ra >= 0
    rows_c = ra.clamp(min=0)
    w_r = ref.ch["weight"][:ref.n].float()
    d_r = ref.ch["tsdf"][:ref.n].float()
    w_c = torch.where(has[:, None], cand.ch["weight"][rows_c].float(), 0.0)
    d_c = torch.where(has[:, None], cand.ch["tsdf"][rows_c].float(), 0.0)
    o_r, o_c = w_r > 0, w_c > 0
    off = (o_r != o_c) | (o_r & o_c & (
        ((d_r - d_c).abs() > D_TOL)
        | ((w_r - w_c).abs() > W_TOL * torch.maximum(w_r, w_c))))
    extra = int((cand.ch["weight"][only] > 0).sum())
    return _share(int(off.sum()) + extra, int((o_r | o_c).sum()) + extra)


def scan_samples(store, scan, cfg, traffic, dtype):
    """One scan's samples by the configuration's integrator."""
    tc = tsdf_cfg(cfg)
    method = cfg["server"]["method"]
    if method == "merged":
        return rmerged.samples(store, scan[0], scan[1],
                               scan[2].reshape(-1, 3), tc, dtype)
    if method == "projective":
        img = rtsdf.make_image(scan, traffic["cloud"], cfg["sensor"],
                               cfg["server"], dtype)
        return rtsdf.samples(store, scan[0], scan[1], img, tc, dtype)
    raise ValueError(f"no reference for the integrator {method!r}")


def rolling_start(origins, reach):
    """The first hand-off from which a replay of a rolling map leaves the
    same map as a replay of them all: the latest k such that two sensor
    origins from k on lie more than ``2 * reach`` (and a margin) apart,
    0 if none do. No block lies within ``reach`` of both, so whatever a
    block held before k, it is dropped at one of them in both replays,
    and from there on both fold the same samples into it from empty (the
    samples do not depend on the map, nor a block's fold on another)."""
    o = torch.stack([x.double() for x in origins])
    far = torch.cdist(o, o) > 2 * reach + ROLLING_MARGIN_M
    firsts = torch.nonzero(far.triu(1).any(1)).flatten()
    return int(firsts.max()) if firsts.numel() else 0


def _nbytes(s):
    return sum(x.numel() * x.element_size() for x in s)


def replay(cfg, traffic, scans, handed, device, dtype):
    """The reference map of every scan handed over, from the empty map.
    A rolling map replays only from ``rolling_start`` on."""
    store = rtsdf.new_store(cfg["map"]["voxel_size"], VPS,
                            cfg["map"]["max_blocks"], device, dtype)
    tc = tsdf_cfg(cfg)
    reach = float(cfg["server"].get("max_block_distance_from_body", 0.0))
    if reach > 0:
        handed = handed[rolling_start([scans[i][1] for i in handed],
                                      reach):]
    last = {idx: k for k, idx in enumerate(handed)}
    cache, cached = {}, 0
    for k, idx in enumerate(handed):
        s = cache.pop(idx, None)
        if s is None:
            s = scan_samples(store, scans[idx], cfg, traffic, dtype)
        else:
            cached -= _nbytes(s)
        if last[idx] > k and cached + _nbytes(s) <= CACHE_BYTES:
            cache[idx] = s
            cached += _nbytes(s)
        rtsdf.fold(store, *s, tc)
        if reach > 0:
            remove_distant_blocks(store, scans[idx][1], reach)
    return store


def control_store(cfg, traffic, scans, handed, device):
    """The control's map: the reference computed in bfloat16."""
    return replay(cfg, traffic, scans, handed, device, torch.bfloat16)


def judge(cfg, traffic, scans, handed, cand, limits, device):
    """The numbers compared for a candidate map, beside their limits."""
    ref = replay(cfg, traffic, scans, handed, device, torch.float32)
    return {"tsdf": {"value": compare_tsdf(cand, ref),
                     "limit": limits["tsdf"]}}


def verdict(numbers, failed):
    """``correct``: every number within its limit and no scan failed."""
    return failed == 0 and all(v["value"] <= v["limit"]
                               for v in numbers.values())
