"""Parity of the port's slot-batched shade with the JAX package, on the CPU.

* The multi-viewer cache forms, held exactly against JAX over two scenes of
  two viewers each: the lowest slot wins an insert conflict, a record that
  two viewers carry lands once, and a dead viewer probes without touching
  the LRU state.
* ``ops.rasterize_with_rc_slots`` with one and two viewers per scene and
  one idle slot, phase B compacted across slots or per slot, against JAX's
  (Pallas in interpret mode).
* ``batched_render_step``, the per-lane parity oracle.
* ``batched_shade_phase`` on both backends over 4 frames of 3 slots with a
  sort every second frame, as ``tests/test_backend.py::
  test_slot_batched_shade_matches_per_slot`` drives JAX's.

Integer state (cache tags/age/clock, hit counts, records, chunk counts) and
``saved_frac`` are held exactly; images and cached values to 128 ulps x
magnitude.  Inputs come from ``structured_scene(PRNGKey(7), 800)`` and
``orbit_trajectory`` at 64x64, handed over through ``repro_torch.interop``.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import pipeline as jpipe
from repro.core import projection as jproj
from repro.core import radiance_cache as jrc
from repro.core import sorting as jsorting
from repro.core import tiling as jtiling
from repro.core.camera import stack_cameras as jax_stack_cameras
from repro.data.scenes import structured_scene as jax_structured_scene
from repro.data.trajectory import orbit_trajectory as jax_orbit
from repro.kernels import ops as jops

from repro_torch import interop
from repro_torch.core import pipeline as tpipe
from repro_torch.core import radiance_cache as trc
from repro_torch.core.camera import stack_cameras
from repro_torch.core.tiling import TileFeatures
from repro_torch.kernels import ops as tops

SEED, GAUSSIANS, WIDTH = 7, 800, 64


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


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _t(x):
    return interop.tensor(np.asarray(x), device='cpu')


def to_cam(c):
    return interop.camera_from_numpy(c.position, c.quat, c.fx, c.fy, c.cx,
                                     c.cy, c.width, c.height, c.near, c.far,
                                     device='cpu')


def assert_cache_matches(got, want, err_msg=''):
    for field in ('tags', 'age', 'clock'):
        np.testing.assert_array_equal(_np(getattr(got, field)),
                                      _np(getattr(want, field)),
                                      f'{err_msg} {field}')
    assert_images_ulp_close(_np(got.values), _np(want.values),
                            err_msg=f'{err_msg} values')


# -- the multi-viewer cache forms ---------------------------------------------

CFG_SMALL = dict(n_sets=8, n_ways=2, k=3)


def _records(rng, c, v, g, b, k):
    """Records from a small id alphabet (so sets and tags collide), with
    viewer 1 of every scene carrying viewer 0's records in its first half
    (duplicates across viewers)."""
    ids = rng.integers(0, 6, (c, v, g, b, k)).astype(np.int32)
    ids[:, 1, :, :b // 2] = ids[:, 0, :, :b // 2]
    return ids


def test_multi_cache_forms_match_jax():
    rng = np.random.default_rng(4)
    c, v, g, b, k = 2, 2, 3, 16, 3
    jcfg = jrc.CacheConfig(**CFG_SMALL)
    tcfg = trc.CacheConfig(**CFG_SMALL)
    jcache = jax.tree.map(lambda x: jnp.stack([x] * c),
                          jrc.init_cache(g, jcfg))
    tcache = trc.init_caches(c, g, tcfg)
    live = np.array([[True, True], [True, False]])        # one dead viewer
    lookup = jax.jit(jax.vmap(
        lambda cc, ii, lv: jrc.lookup_all_groups_multi(cc, ii, jcfg, live=lv)))
    insert = jax.jit(jax.vmap(
        lambda cc, ii, rr, dd: jrc.insert_all_groups_multi(cc, ii, rr, dd,
                                                           jcfg)))
    for step in range(3):
        ids = _records(rng, c, v, g, b, k)
        rgb = rng.random((c, v, g, b, 3), dtype=np.float32)
        hit_j, val_j, _, _, jcache = lookup(jcache, jnp.asarray(ids),
                                            jnp.asarray(live))
        ids_v = trc.viewer_major(_t(ids.reshape(c * v, g, b, k)), v)
        live_v = trc.viewer_major(_t(live.reshape(c * v, 1)).expand(c * v, g), v)
        hit_v, val_v, _, _, cache_f = trc.lookup_all_groups_multi(
            trc.flatten_scenes(tcache), ids_v, tcfg, live=live_v)
        hit_t = trc.slot_order(hit_v, c).reshape(c, v, g, b)
        np.testing.assert_array_equal(_np(hit_t), np.asarray(hit_j),
                                      f'step {step} hits')
        np.testing.assert_array_equal(
            _np(trc.slot_order(val_v, c)).reshape(c, v, g, b, 3),
            np.asarray(val_j), f'step {step} values')
        do = ~np.asarray(hit_j) & live[:, :, None, None]
        jcache = insert(jcache, jnp.asarray(ids), jnp.asarray(rgb),
                        jnp.asarray(do))
        cache_f = trc.insert_all_groups_multi(
            cache_f, ids_v, trc.viewer_major(_t(rgb.reshape(c * v, g, b, 3)), v),
            trc.viewer_major(_t(do.reshape(c * v, g, b)), v), tcfg)
        tcache = trc.split_scenes(cache_f, c)
        assert_cache_matches(tcache, jcache, f'step {step}')
    assert np.asarray(hit_j).any() and (~np.asarray(hit_j)).any()


def test_multi_cache_conflicts_resolve_by_slot_then_pixel():
    """Two viewers insert different values under one record: the lowest
    slot's lands, once; a dead viewer's probe leaves the ages alone."""
    cfg = trc.CacheConfig(**CFG_SMALL)
    cache = trc.init_cache(1, cfg)
    ids = torch.tensor([[[[1, 2, 3]]], [[[1, 2, 3]]]], dtype=torch.int32)
    rgb = torch.tensor([[[[0.1, 0.1, 0.1]]], [[[0.9, 0.9, 0.9]]]])
    cache = trc.insert_all_groups_multi(cache, ids, rgb,
                                        torch.ones((2, 1, 1), dtype=torch.bool),
                                        cfg)
    slots = (cache.tags[0] == torch.tensor([1, 2, 3])).all(-1)
    assert int(slots.sum()) == 1
    assert float(cache.values[0][slots][0, 0]) == pytest.approx(0.1)
    hit, _, _, _, after = trc.lookup_all_groups_multi(
        cache, ids, cfg, live=torch.tensor([False, False]))
    assert bool(hit.all())
    assert torch.equal(after.age, cache.age)


# -- slot-batched kernel path ------------------------------------------------

@pytest.fixture(scope='module')
def scene():
    jscene = jax.jit(jax_structured_scene, static_argnums=1)(
        jax.random.PRNGKey(SEED), GAUSSIANS)
    return jscene, interop.scene_from_numpy(*[np.asarray(x) for x in jscene],
                                            device='cpu')


@pytest.fixture(scope='module')
def slot_feats(scene):
    """The JAX package's tile features of 4 slots at 64x64: two pairs of
    nearby poses (two co-watching viewers per scene)."""
    jscene, _ = scene

    @jax.jit
    def prep(cam):
        proj = jproj.project(jscene, cam)
        lists = jsorting.sort_scene(proj, WIDTH, WIDTH, 128)
        return jtiling.gather_tile_features(proj, lists)

    cams = [jax_orbit(3, width=WIDTH, height_px=WIDTH,
                      start_deg=180.0 * (i // 2))[i % 2 * 2] for i in range(4)]
    frames = [prep(c) for c in cams]
    jf = jtiling.TileFeatures(*(jnp.stack(xs) for xs in zip(*frames)))
    tf = TileFeatures(*(_t(x) for x in (jf.mean2d, jf.conic, jf.color,
                                        jf.opacity, jf.ids)))
    return jf, tf


@pytest.mark.parametrize('viewers_per_scene,compact', [(1, True), (2, True),
                                                       (2, False)])
def test_rasterize_with_rc_slots_matches_jax(slot_feats, viewers_per_scene,
                                             compact):
    jf, tf = slot_feats
    s, v = 4, viewers_per_scene
    c = s // v
    tx = ty = WIDTH // 16
    cfg_j = jrc.CacheConfig(n_sets=64, k=5)
    cfg_t = trc.CacheConfig(n_sets=64, k=5)
    jcache = jax.tree.map(lambda x: jnp.stack([x] * c), jrc.init_cache(1, cfg_j))
    tcache = trc.init_caches(c, 1, cfg_t)
    live = np.array([True, True, False, True])            # slot 2 idle
    run_j = jax.jit(functools.partial(
        jops.rasterize_with_rc_slots, tiles_x=tx, tiles_y=ty, cfg=cfg_j,
        group_tiles=4, viewers_per_scene=v, compact=compact, interpret=True))
    for rep in range(2):      # a cold and a warm cache
        cj, jcache, aux_j, st_j = run_j(jf, caches=jcache, live=jnp.asarray(live))
        ct, tcache, aux_t, st_t = tops.rasterize_with_rc_slots(
            tf, tx, ty, tcache, cfg_t, 4, viewers_per_scene=v,
            live=torch.from_numpy(live), compact=compact)
        assert_images_ulp_close(_np(ct), cj, err_msg=f'rep {rep} colors')
        assert_cache_matches(tcache, jcache, f'rep {rep}')
        for field in ('alpha_record', 'n_significant', 'n_iterated',
                      'iter_at_k'):
            np.testing.assert_array_equal(_np(getattr(aux_t, field)),
                                          np.asarray(getattr(aux_j, field)),
                                          f'rep {rep} {field}')
        for field in ('hit_rate', 'chunks_prefix', 'chunks_resume',
                      'chunks_bound', 'hit'):
            np.testing.assert_array_equal(_np(getattr(st_t, field)),
                                          np.asarray(getattr(st_j, field)),
                                          f'rep {rep} {field}')
    assert float(np.asarray(st_j.hit_rate)[0]) > 0.3
    assert not np.asarray(aux_j.n_iterated)[2].any()      # the idle slot


# -- batched_shade_phase on both backends -------------------------------------

@pytest.mark.parametrize('jax_backend,port_backend', [('reference', 'reference'),
                                                      ('pallas', 'kernel')])
def test_batched_shade_phase_matches_jax(scene, jax_backend, port_backend):
    jscene, tscene = scene
    s, frames = 3, 4
    jcfg = jpipe.LuminaConfig(capacity=128, window=2, backend=jax_backend)
    tcfg = tpipe.LuminaConfig(capacity=128, window=2, backend=port_backend)
    trajs = [jax_orbit(frames, width=WIDTH, height_px=WIDTH,
                       start_deg=120.0 * i) for i in range(s)]
    jshared, jpriv = jpipe.init_fleet(jscene, jcfg, trajs[0][0], slots=s)
    tshared, tpriv = tpipe.init_fleet(tscene, tcfg, to_cam(trajs[0][0]),
                                      slots=s)
    sortp = jax.jit(functools.partial(jpipe.batched_sort_phase, cfg=jcfg))
    shade = jax.jit(functools.partial(jpipe.batched_shade_phase, cfg=jcfg))
    sorted_mask = np.zeros((s,), np.float32)
    active = np.array([True, True, False])                 # slot 2 idle
    for f in range(frames):
        jcams = jax_stack_cameras([t[f] for t in trajs])
        tcams = stack_cameras([to_cam(t[f]) for t in trajs])
        if f % jcfg.window == 0:
            entries = sortp(jscene, jpriv, jcams)
            jshared = dataclasses.replace(jshared, pool=jax.tree.map(
                lambda p, e: p.at[:, 0].set(e), jshared.pool, entries))
            entries_t = tpipe.batched_sort_phase(tscene, tpriv, tcams, tcfg)
            tshared = dataclasses.replace(
                tshared, pool=tuple((e,) for e in entries_t))
        jshared, jpriv, jimgs, jstats = shade(
            jscene, jshared, jpriv, jcams, jnp.asarray(sorted_mask),
            jnp.asarray(active))
        tshared, tpriv, timgs, tstats = tpipe.batched_shade_phase(
            tscene, tshared, tpriv, tcams, torch.from_numpy(sorted_mask),
            torch.from_numpy(active), tcfg)
        for i in range(s):
            if active[i]:
                assert_images_ulp_close(_np(timgs[i]), jimgs[i],
                                        err_msg=f'slot {i} frame {f}')
        for field in ('hit_rate', 'saved_frac'):
            np.testing.assert_array_equal(_np(getattr(tstats, field)),
                                          np.asarray(getattr(jstats, field)),
                                          f'frame {f} {field}')
        np.testing.assert_array_equal(_np(tpriv.frame_idx),
                                      np.asarray(jpriv.frame_idx))
        assert_cache_matches(tshared.cache, jshared.cache, f'frame {f}')
    assert float(np.asarray(jstats.hit_rate)[0]) > 0.5


def test_batched_render_step_matches_jax(scene):
    """The parity oracle: every lane keeps its own sort cadence."""
    jscene, tscene = scene
    s, frames = 2, 3
    jcfg = jpipe.LuminaConfig(capacity=128, window=2)
    tcfg = tpipe.LuminaConfig(capacity=128, window=2)
    trajs = [jax_orbit(frames, width=WIDTH, height_px=WIDTH,
                       start_deg=90.0 * i) for i in range(s)]
    jstates = jax.tree.map(lambda *xs: jnp.stack(xs), *[
        jpipe.init_viewer_state(jscene, jcfg, t[0]) for t in trajs])
    tstates = [tpipe.init_viewer_state(tscene, tcfg, to_cam(t[0]))
               for t in trajs]
    step = jax.jit(functools.partial(jpipe.batched_render_step, cfg=jcfg))
    for f in range(frames):
        jstates, jimgs, jstats = step(
            jscene, jstates, jax_stack_cameras([t[f] for t in trajs]))
        tstates, timgs, tstats = tpipe.batched_render_step(
            tscene, tstates, stack_cameras([to_cam(t[f]) for t in trajs]),
            tcfg)
        assert_images_ulp_close(_np(timgs), jimgs, err_msg=f'frame {f}')
        for field in ('hit_rate', 'sorted_this_frame'):
            np.testing.assert_array_equal(_np(getattr(tstats, field)),
                                          np.asarray(getattr(jstats, field)),
                                          f'frame {f} {field}')
    for i in range(s):
        assert_cache_matches(tstates[i].cache, jax.tree.map(
            lambda x: x[i], jstates.scene_shared.cache), f'slot {i}')
