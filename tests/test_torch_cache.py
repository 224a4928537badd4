"""Parity of the port's radiance cache, LuminCache probe kernel and cached
rasterization with the JAX package, on the CPU.

Cache state (``tags``, ``values``, ``age``, ``clock``), set indices, hit
masks and ways are held exactly after numpy-seeded lookup/insert sequences
that both sides run on the same inputs.  The probe wrapper (plain version on
CPU tensors) is held against ``rc_lookup_pallas(interpret=True)``, and
``ops.rasterize_with_rc`` against the JAX package's on a real frame
(``structured_scene(PRNGKey(7), 800)``, 64x64): integer state exactly,
colors to 128 ulps x magnitude.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import projection as jproj
from repro.core import radiance_cache as jrc
from repro.core import sorting as jsorting
from repro.core import tiling as jtiling
from repro.core.groups import num_groups
from repro.data.scenes import structured_scene as jax_structured_scene
from repro.data.trajectory import orbit_trajectory as jax_orbit
from repro.kernels import ops as jops
from repro.kernels import rc_lookup as jlk

from repro_torch import interop
from repro_torch.core import radiance_cache as trc
from repro_torch.core.tiling import TileFeatures
from repro_torch.kernels import ops as tops
from repro_torch.kernels import rc_lookup as tlk


def assert_images_ulp_close(got, want, *, ulps=128, err_msg=''):
    """Float comparison with an ulp-scaled float32 tolerance: ``ulps`` x
    float32-eps x magnitude (floored at 1.0).  Copied from
    tests/test_serve.py so this file stands alone."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    scale = np.maximum(np.maximum(np.abs(got), np.abs(want)), 1.0)
    tol = np.float32(ulps) * np.finfo(np.float32).eps * scale
    err = np.abs(got - want)
    worst = float((err / (np.finfo(np.float32).eps * scale)).max()) \
        if err.size else 0.0
    assert (err <= tol).all(), (
        f'{err_msg}: images differ by {worst:.0f} ulps (> {ulps} allowed)')


jinsert = jax.jit(jrc.insert, static_argnums=(1, 5))
jlookup = jax.jit(jrc.lookup, static_argnums=(1, 3))
jinsert_all = jax.jit(jrc.insert_all_groups, static_argnums=4)
jlookup_all = jax.jit(jrc.lookup_all_groups, static_argnums=2)
jtouch_all = jax.jit(jrc.touch_all_groups, static_argnums=4)


def _np(x):
    return x.detach().cpu().numpy()


def _t(x):
    return interop.tensor(np.asarray(x), device='cpu')


def to_cache(c) -> trc.CacheState:
    return interop.cache_from_numpy(*(np.asarray(x) for x in c), device='cpu')


def assert_cache_equal(got: trc.CacheState, want):
    """Integer state exactly; cached colors to the ulp bound (they are
    rasterized colors, which may differ by ulps)."""
    for field in ('tags', 'age', 'clock'):
        np.testing.assert_array_equal(_np(getattr(got, field)),
                                      np.asarray(getattr(want, field)), field)
    assert_images_ulp_close(_np(got.values), want.values, err_msg='values')


def records(rng, g, b, k, pool):
    """Records drawn from a small pool so that lookups hit and inserts
    collide; -1 padding appears as a record does when it never fills."""
    base = rng.integers(-1, pool, (g, b, k)).astype(np.int32)
    dup = rng.integers(0, b, (g, b))
    take = rng.random((g, b)) < 0.5
    return np.where(take[..., None], np.take_along_axis(
        base, dup[..., None].repeat(k, -1), axis=1), base)


@pytest.mark.parametrize('mode', ['hash', 'bitconcat'])
@pytest.mark.parametrize('n_sets,k', [(1024, 5), (64, 3), (16, 7)])
def test_set_index_matches(mode, n_sets, k):
    rng = np.random.default_rng(n_sets + k)
    ids = rng.integers(-3, 2 ** 31 - 1, (500, k), dtype=np.int64).astype(np.int32)
    ids[:50] = rng.integers(-2, 40, (50, k))
    ids[50] = 2 ** 31 - 1
    cfg_j = jrc.CacheConfig(n_sets=n_sets, k=k, index_mode=mode)
    cfg_t = trc.CacheConfig(n_sets=n_sets, k=k, index_mode=mode)
    want = np.asarray(jrc.set_index(jnp.asarray(ids), cfg_j))
    got = _np(trc.set_index(torch.from_numpy(ids), cfg_t))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('mode', ['hash', 'bitconcat'])
def test_lookup_insert_sequence_matches(mode):
    g, b, k = 3, 256, 5
    cfg_j = jrc.CacheConfig(n_sets=32, n_ways=4, k=k, index_mode=mode,
                            index_bits_shift=0)
    cfg_t = trc.CacheConfig(*cfg_j)
    rng = np.random.default_rng(11)
    lookup_j = jax.jit(functools.partial(jrc.lookup_all_groups, cfg=cfg_j))
    insert_j = jax.jit(functools.partial(jrc.insert_all_groups, cfg=cfg_j))
    cj = jrc.init_cache(g, cfg_j)
    ct = trc.init_cache(g, cfg_t)
    assert_cache_equal(ct, cj)
    pool = records(rng, g, b, k, pool=60)
    for step in range(4):
        # later steps repeat records of earlier ones, so lookups hit
        ids = np.take_along_axis(pool, rng.integers(0, b, (g, b, 1)), axis=1)
        rgb = rng.random((g, b, 3), dtype=np.float32)
        live = rng.random((g, b)) < 0.9
        hj, vj, sj, wj, cj = lookup_j(cj, jnp.asarray(ids), live=jnp.asarray(live))
        ht, vt, st, wt, ct = trc.lookup_all_groups(ct, torch.from_numpy(ids),
                                                   cfg_t,
                                                   live=torch.from_numpy(live))
        for a, w in ((ht, hj), (vt, vj), (st, sj), (wt, wj)):
            np.testing.assert_array_equal(_np(a), np.asarray(w))
        assert_cache_equal(ct, cj)
        do = ~np.asarray(hj) & (rng.random((g, b)) < 0.8)
        cj = insert_j(cj, jnp.asarray(ids), jnp.asarray(rgb), jnp.asarray(do))
        ct = trc.insert_all_groups(ct, torch.from_numpy(ids),
                                   torch.from_numpy(rgb), torch.from_numpy(do),
                                   cfg_t)
        assert_cache_equal(ct, cj)
    assert np.asarray(hj).mean() > 0.2
    # a mean of 0/1 flags: the two frameworks may round the sum differently
    assert abs(float(_np(trc.occupancy(ct))) - float(jrc.occupancy(cj))) < 1e-6


def test_single_group_lookup_and_insert_match():
    cfg_j = jrc.CacheConfig(n_sets=16, n_ways=2, k=3)
    cfg_t = trc.CacheConfig(*cfg_j)
    rng = np.random.default_rng(4)
    cj, ct = jrc.init_cache(3, cfg_j), trc.init_cache(3, cfg_t)
    for group in (1, 2, 1):
        ids = records(rng, 1, 64, 3, pool=20)[0]
        rgb = rng.random((64, 3), dtype=np.float32)
        do = rng.random(64) < 0.7
        cj = jinsert(cj, group, jnp.asarray(ids), jnp.asarray(rgb),
                     jnp.asarray(do), cfg_j)
        ct = trc.insert(ct, group, torch.from_numpy(ids), torch.from_numpy(rgb),
                        torch.from_numpy(do), cfg_t)
        assert_cache_equal(ct, cj)
        hj, vj, sj, wj, cj = jlookup(cj, group, jnp.asarray(ids), cfg_j)
        ht, vt, st, wt, ct = trc.lookup(ct, group, torch.from_numpy(ids), cfg_t)
        np.testing.assert_array_equal(_np(ht), np.asarray(hj))
        np.testing.assert_array_equal(_np(wt), np.asarray(wj))
        assert_cache_equal(ct, cj)


def test_touch_and_finite_gate_match():
    g, b, k = 2, 128, 5
    cfg_j = jrc.CacheConfig(n_sets=16, n_ways=4, k=k)
    cfg_t = trc.CacheConfig(*cfg_j)
    rng = np.random.default_rng(8)
    ids = records(rng, g, b, k, pool=30)
    rgb = rng.random((g, b, 3), dtype=np.float32)
    rgb[0, ::7, 1] = np.nan
    rgb[1, ::5, 0] = np.inf
    do = np.ones((g, b), bool)
    cj = jinsert_all(jrc.init_cache(g, cfg_j), jnp.asarray(ids),
                     jnp.asarray(rgb), jnp.asarray(do), cfg_j)
    ct = trc.insert_all_groups(trc.init_cache(g, cfg_t), torch.from_numpy(ids),
                               torch.from_numpy(rgb), torch.from_numpy(do), cfg_t)
    assert_cache_equal(ct, cj)
    assert np.isfinite(_np(ct.values)).all()

    hit, _, _, way, _ = jlookup_all(cj, jnp.asarray(ids), cfg_j)
    live = rng.random((g, b)) < 0.5
    want = jtouch_all(cj, jnp.asarray(ids), hit, way, cfg_j,
                      live=jnp.asarray(live))
    got = trc.touch_all_groups(ct, torch.from_numpy(ids), _t(hit),
                               _t(way).long(), cfg_t, live=torch.from_numpy(live))
    assert_cache_equal(got, want)


@pytest.mark.parametrize('g,b,sets,ways,k,mode', [(4, 128, 64, 4, 5, 'hash'),
                                                  (2, 256, 32, 4, 2, 'bitconcat')])
def test_rc_lookup_kernel_matches(g, b, sets, ways, k, mode):
    cfg_j = jrc.CacheConfig(n_sets=sets, n_ways=ways, k=k, index_mode=mode,
                            index_bits_shift=0)
    cfg_t = trc.CacheConfig(*cfg_j)
    rng = np.random.default_rng(g * 10 + b)
    ids = records(rng, g, b, k, pool=200)
    rgb = rng.random((g, b, 3), dtype=np.float32)
    do = np.arange(b)[None].repeat(g, 0) % 2 == 0
    cj = jinsert_all(jrc.init_cache(g, cfg_j), jnp.asarray(ids),
                     jnp.asarray(rgb), jnp.asarray(do), cfg_j)
    want = jax.jit(functools.partial(jlk.rc_lookup_pallas, cfg=cfg_j,
                                     query_chunk=64, interpret=True))(
        cj.tags, cj.values, jnp.asarray(ids))
    ct = to_cache(cj)
    got = tlk.rc_lookup(ct.tags, ct.values, torch.from_numpy(ids), cfg_t)
    for a, w in zip(got, want):
        np.testing.assert_array_equal(_np(a), np.asarray(w))
    assert np.asarray(want[0]).mean() > 0.1


@pytest.fixture(scope='module')
def frame():
    scene = jax.jit(jax_structured_scene, static_argnums=1)(
        jax.random.PRNGKey(7), 800)
    cams = jax_orbit(8, width=64, height_px=64)

    @jax.jit
    def prep(scene, cam):
        proj = jproj.project(scene, cam)
        lists = jsorting.sort_scene(proj, 64, 64, 128)
        return jtiling.gather_tile_features(proj, lists)

    return [prep(scene, cams[i]) for i in (2, 3)]


jrasterize_with_rc = jax.jit(jops.rasterize_with_rc, static_argnums=(1, 2, 4, 5),
                             static_argnames=('bg', 'compact', 'interpret'))


@pytest.mark.parametrize('compact', [True, False])
def test_rasterize_with_rc_matches(frame, compact):
    """Two frames through cached rasterization: the second probes a warm
    cache, so hits, the miss resume and the insert all run."""
    cfg_j = jrc.CacheConfig(n_sets=1024, n_ways=4, k=5)
    cfg_t = trc.CacheConfig(*cfg_j)
    g = num_groups(64, 64, 4)
    cj, ct = jrc.init_cache(g, cfg_j), trc.init_cache(g, cfg_t)
    live = np.ones((16, 256), bool)
    live[3, :100] = False
    for jf in frame:
        tf = TileFeatures(*(_t(x) for x in jf))
        fj, cj, aux_j, sj = jrasterize_with_rc(
            jf, 4, 4, cj, cfg_j, 4, bg=0.1, live=jnp.asarray(live),
            compact=compact, interpret=True)
        ft, ct, aux_t, st = tops.rasterize_with_rc(
            tf, 4, 4, ct, cfg_t, 4, bg=0.1, live=torch.from_numpy(live),
            compact=compact)
        assert_images_ulp_close(_np(ft), fj, err_msg='colors')
        assert_cache_equal(ct, cj)
        for field in ('alpha_record', 'n_significant', 'n_iterated', 'iter_at_k'):
            np.testing.assert_array_equal(_np(getattr(aux_t, field)),
                                          np.asarray(getattr(aux_j, field)), field)
        for field in ('hit', 'chunks_prefix', 'chunks_resume', 'chunks_bound'):
            np.testing.assert_array_equal(_np(getattr(st, field)),
                                          np.asarray(getattr(sj, field)), field)
    assert float(sj.hit_rate) > 0.5
