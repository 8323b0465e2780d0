"""Port parity, core modules: config, grid, hash, layer, compaction.

Same numpy inputs through voxblox_tpu (JAX, CPU) and voxblox_tpu_torch
(device="cpu"). Integer results are held exactly equal; the hash claim
order is ported exactly, so pool rows and table cells match one for one.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voxblox_tpu.core import config as jcfg
from voxblox_tpu.core import grid as jgrid
from voxblox_tpu.core import hash as jhash
from voxblox_tpu.core import layer as jlayer
from voxblox_tpu.ops import compaction as jcomp

from voxblox_tpu_torch.core import config as tcfg
from voxblox_tpu_torch.core import grid as tgrid
from voxblox_tpu_torch.core import hash as thash
from voxblox_tpu_torch.core import layer as tlayer
from voxblox_tpu_torch.ops import compaction as tcomp

import torch_parity

CPU = "cpu"


def _t(x, dtype=None):
    return torch.as_tensor(np.array(x), dtype=dtype)


@pytest.mark.parametrize("name", ["MapConfig", "TsdfIntegratorConfig",
                                  "EsdfIntegratorConfig",
                                  "MeshIntegratorConfig"])
def test_config_fields_and_defaults_match(name):
    ref = dataclasses.asdict(getattr(jcfg, name)())
    got = dataclasses.asdict(getattr(tcfg, name)())
    assert got == ref
    # config_from_dict rebuilds a non-default config field for field.
    rebuilt = tcfg.config_from_dict(name, ref)
    assert dataclasses.asdict(rebuilt) == ref


def test_grid_conversions_exact(rng):
    pts = rng.uniform(-20.0, 20.0, (4000, 3)).astype(np.float32)
    # Points on and just below negative block boundaries, and the epsilon
    # floor (k * voxel - 5e-7 floors up into cell k).
    edges = (np.arange(-40, 40, dtype=np.float32) * 0.8)[:, None]
    pts = np.concatenate([pts, np.repeat(edges, 3, 1),
                          np.repeat(edges - 5e-7, 3, 1),
                          np.repeat(edges - 1e-4, 3, 1)])
    for inv in (1 / 0.05, 1 / 0.2, 1.25):
        np.testing.assert_array_equal(
            tgrid.point_to_grid_index(_t(pts), inv).numpy(),
            np.asarray(jgrid.point_to_grid_index(jnp.asarray(pts), inv)))
    gi = rng.integers(-3000, 3000, (5000, 3)).astype(np.int32)
    for vps in (8, 16):
        jb, jl = jgrid.split_global(jnp.asarray(gi), vps)
        tb, tl = tgrid.split_global(_t(gi), vps)
        np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
        lin = np.asarray(jgrid.local_to_linear(jl, vps))
        np.testing.assert_array_equal(
            tgrid.local_to_linear(tl, vps).numpy(), lin)
        np.testing.assert_array_equal(
            tgrid.linear_to_local(_t(lin), vps).numpy(),
            np.asarray(jgrid.linear_to_local(jnp.asarray(lin), vps)))
    np.testing.assert_array_equal(
        tgrid.grid_index_to_center_point(_t(gi), 0.05).numpy(),
        np.asarray(jgrid.grid_index_to_center_point(jnp.asarray(gi), 0.05)))
    blocks = rng.integers(-32768, 32768, (5000, 3)).astype(np.int32)
    jw0, jw1 = jgrid.pack_block_index(jnp.asarray(blocks))
    tw0, tw1 = tgrid.pack_block_index(_t(blocks))
    np.testing.assert_array_equal(tw0.numpy(), np.asarray(jw0))
    np.testing.assert_array_equal(tw1.numpy(), np.asarray(jw1))
    np.testing.assert_array_equal(
        tgrid.unpack_block_index(tw0, tw1).numpy(), blocks)


def test_hash_words_equal(rng):
    blocks = rng.integers(-32768, 32768, (20000, 3)).astype(np.int32)
    w0, w1 = jgrid.pack_block_index(jnp.asarray(blocks))
    ref = np.asarray(jhash.hash_words(w0, w1)).astype(np.int64)
    got = thash.hash_words(_t(w0), _t(w1)).numpy()
    np.testing.assert_array_equal(got, ref)


def _table_np(table):
    return {k: np.asarray(getattr(table, k)) for k in torch_parity.TABLE_FIELDS}


def _assert_tables_equal(jt, tt):
    ref = _table_np(jt)
    for k in torch_parity.TABLE_FIELDS:
        np.testing.assert_array_equal(getattr(tt, k).numpy(), ref[k],
                                      err_msg=k)


def test_hash_insert_lookup_remove_rebuild_exact(rng):
    cap = 1024
    blocks = np.unique(rng.integers(-200, 200, (700, 3)).astype(np.int32),
                       axis=0)[:600]
    rng.shuffle(blocks)
    w0, w1 = jgrid.pack_block_index(jnp.asarray(blocks))
    valid = rng.uniform(size=len(blocks)) > 0.1
    jt, js, jok = jhash.insert(jhash.make_table(cap), w0, w1,
                               jnp.asarray(valid))
    tt, ts, tok = thash.insert(thash.make_table(cap, CPU), _t(w0), _t(w1),
                               _t(valid))
    _assert_tables_equal(jt, tt)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    # Lookups: present, absent and invalid-inserted keys.
    q = np.concatenate([blocks, rng.integers(-300, 300, (500, 3))]
                       ).astype(np.int32)
    qw0, qw1 = jgrid.pack_block_index(jnp.asarray(q))
    np.testing.assert_array_equal(
        thash.lookup(tt, _t(qw0), _t(qw1)).numpy(),
        np.asarray(jhash.lookup(jt, qw0, qw1)))
    # Remove a subset (tombstones), then lookups still probe past them.
    rm = rng.uniform(size=len(blocks)) < 0.3
    jt2, jn = jhash.remove(jt, w0, w1, jnp.asarray(rm))
    tt2, tn = thash.remove(tt, _t(w0), _t(w1), _t(rm))
    _assert_tables_equal(jt2, tt2)
    assert int(tn) == int(jn)
    np.testing.assert_array_equal(
        thash.lookup(tt2, _t(qw0), _t(qw1)).numpy(),
        np.asarray(jhash.lookup(jt2, qw0, qw1)))
    # Rebuild drops tombstones, slots = row ids.
    act = valid & ~rm
    jt3 = jhash.rebuild(jt2, w0, w1, jnp.asarray(act))
    tt3 = thash.rebuild(tt2, _t(w0), _t(w1), _t(act))
    _assert_tables_equal(jt3, tt3)


def test_allocate_blocks_and_dirty_mask_exact(rng):
    blocks = rng.integers(-12, 12, (3000, 3)).astype(np.int32)
    valid = rng.uniform(size=len(blocks)) > 0.2
    jl = jlayer.make_layer("tsdf", 0.1, vps=8, max_blocks=2048)
    tl = tlayer.make_layer("tsdf", 0.1, vps=8, max_blocks=2048, device=CPU)
    jl, jovf = jlayer.allocate_blocks(jl, jnp.asarray(blocks),
                                      jnp.asarray(valid))
    tl, tovf = tlayer.allocate_blocks(tl, _t(blocks), _t(valid))
    assert bool(tovf) == bool(jovf)
    torch_parity.assert_layers_equal(torch_parity.jax_layer_to_numpy(jl),
                                     tlayer.layer_to_numpy(tl))
    # A second, overlapping batch (existing keys + new ones) and a pool
    # overflow on a small pool.
    more = rng.integers(-14, 14, (800, 3)).astype(np.int32)
    ones = np.ones(len(more), bool)
    jl, _ = jlayer.allocate_blocks(jl, jnp.asarray(more), jnp.asarray(ones))
    tl, _ = tlayer.allocate_blocks(tl, _t(more), _t(ones))
    torch_parity.assert_layers_equal(torch_parity.jax_layer_to_numpy(jl),
                                     tlayer.layer_to_numpy(tl))
    rows = np.arange(0, 2048, 3, dtype=np.int32)
    sel = rng.uniform(size=len(rows)) > 0.5
    jl = jlayer.clear_dirty(jl, jlayer.DIRTY_ALL)
    tl = tlayer.clear_dirty(tl, tlayer.DIRTY_ALL)
    jl = jlayer.mark_dirty(jl, jnp.asarray(rows), jnp.asarray(sel),
                           jlayer.DIRTY_ESDF)
    tl = tlayer.mark_dirty(tl, _t(rows), _t(sel), tlayer.DIRTY_ESDF)
    np.testing.assert_array_equal(
        tlayer.dirty_mask(tl, tlayer.DIRTY_ESDF).numpy(),
        np.asarray(jlayer.dirty_mask(jl, jlayer.DIRTY_ESDF)))
    small_j = jlayer.make_layer("esdf", 0.1, vps=8, max_blocks=64)
    small_t = tlayer.make_layer("esdf", 0.1, vps=8, max_blocks=64,
                                device=CPU)
    small_j, so_j = jlayer.allocate_blocks(small_j, jnp.asarray(blocks[:200]),
                                           jnp.ones(200, bool))
    small_t, so_t = tlayer.allocate_blocks(small_t, _t(blocks[:200]),
                                           torch.ones(200, dtype=torch.bool))
    assert bool(so_t) and bool(so_j)
    torch_parity.assert_layers_equal(torch_parity.jax_layer_to_numpy(small_j),
                                     tlayer.layer_to_numpy(small_t))


def test_voxel_get_set_and_layer_roundtrip(rng):
    jl = jlayer.make_layer("tsdf", 0.1, vps=8, max_blocks=256)
    blocks = rng.integers(-3, 3, (60, 3)).astype(np.int32)
    jl, _ = jlayer.allocate_blocks(jl, jnp.asarray(blocks),
                                   jnp.ones(60, bool))
    tl = tlayer.layer_from_numpy(torch_parity.jax_layer_to_numpy(jl), CPU)
    gi = np.unique(rng.integers(-30, 30, (3000, 3)).astype(np.int32), axis=0)
    vals = rng.uniform(-1, 1, len(gi)).astype(np.float32)
    jl = jlayer.set_voxels(jl, "tsdf", jnp.asarray(gi), jnp.asarray(vals))
    tl = tlayer.set_voxels(tl, "tsdf", _t(gi), _t(vals))
    jv, jf = jlayer.get_voxels(jl, "tsdf", jnp.asarray(gi), fill=-7.0)
    tv, tf = tlayer.get_voxels(tl, "tsdf", _t(gi), fill=-7.0)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    d = tlayer.layer_to_numpy(tl)
    torch_parity.assert_layers_equal(torch_parity.jax_layer_to_numpy(jl), d)
    back = tlayer.layer_to_numpy(tlayer.layer_from_numpy(d, CPU))
    torch_parity.assert_layers_equal(d, back)


def test_compact_ids_exact(rng):
    for n, size, p in ((1000, 64, 0.1), (1000, 64, 0.01), (4096, 700, 0.3),
                       (37, 37, 0.9)):
        mask = rng.uniform(size=n) < p
        for fill in (None, -1):
            ref = np.asarray(jcomp.compact_ids(jnp.asarray(mask), size,
                                               fill=fill))
            got = tcomp.compact_ids(_t(mask), size, fill=fill).numpy()
            np.testing.assert_array_equal(got, ref)
            np.testing.assert_array_equal(
                got, np.asarray(jnp.nonzero(jnp.asarray(mask), size=size,
                                            fill_value=n if fill is None
                                            else fill)[0]))


def test_remove_blocks_and_cube_rows_exact(rng):
    jl = jlayer.make_layer("esdf", 0.1, vps=8, max_blocks=128)
    blocks = np.unique(rng.integers(-4, 4, (90, 3)).astype(np.int32),
                       axis=0)
    n = len(blocks)
    jl, _ = jlayer.allocate_blocks(jl, jnp.asarray(blocks),
                                   jnp.ones(n, bool))
    vals = rng.uniform(-1, 1, jl.channels["esdf"].shape).astype(np.float32)
    jl.channels["esdf"] = jnp.asarray(vals)
    tl = tlayer.layer_from_numpy(torch_parity.jax_layer_to_numpy(jl), CPU)
    rows = np.arange(0, 40, dtype=np.int32)
    kill = rng.uniform(size=40) < 0.5
    jl = jlayer.remove_blocks(jl, jnp.asarray(rows), jnp.asarray(kill))
    tl = tlayer.remove_blocks(tl, _t(rows), _t(kill))
    torch_parity.assert_layers_equal(torch_parity.jax_layer_to_numpy(jl),
                                     tlayer.layer_to_numpy(tl))
    sel = np.array([3, 1, 7], np.int64)
    np.testing.assert_array_equal(
        tlayer.cube_rows(tl, "parent", _t(sel)).numpy(),
        np.asarray(jlayer.cube_rows(jl, "parent", jnp.asarray(sel))))
    np.testing.assert_array_equal(
        tlayer.cube_rows(tl, "esdf", _t(sel)).numpy(),
        np.asarray(jlayer.cube_rows(jl, "esdf", jnp.asarray(sel))))


def test_grid_helpers_exact(rng):
    pts = rng.uniform(-30, 30, (3000, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        tgrid.scaled_point_to_grid_index(_t(pts)).numpy(),
        np.asarray(jgrid.scaled_point_to_grid_index(jnp.asarray(pts))))
    ijk = rng.integers(-500, 500, (3000, 3)).astype(np.int32)
    loc = rng.integers(0, 16, (3000, 3)).astype(np.int32)
    np.testing.assert_array_equal(
        tgrid.grid_index_to_origin_point(_t(ijk), 0.2).numpy(),
        np.asarray(jgrid.grid_index_to_origin_point(jnp.asarray(ijk), 0.2)))
    np.testing.assert_array_equal(
        tgrid.global_from_block_and_local(_t(ijk), _t(loc), 16).numpy(),
        np.asarray(jgrid.global_from_block_and_local(
            jnp.asarray(ijk), jnp.asarray(loc), 16)))
