"""Parity of the port's whole LuminCache probe (``ops.rc_probe`` and
``ops.rc_probe_multi``, the lookup with its LRU touch) with the JAX package,
on the CPU.

The same numpy-made caches and records go through the port's CPU route
(``rc_lookup_plain`` + ``touch_all_groups``, the plain versions of the CUDA
kernel's lookup-only and fused modes) and through the JAX package's
``ops.rc_probe(_multi)`` (interpret mode, where it is
``radiance_cache.lookup_all_groups(_multi)``) and
``radiance_cache.lookup_all_groups(_multi)`` itself.  Hit, value, way and
the cache's ``tags``/``age``/``clock`` are held exactly.  The caches hold
-2 invalid tags, -1 padded records, the same tag in two ways of a set, and
slots that every record of a batch hits.  The index map by which the kernel
reads viewer-major ids in place of ``slot_major`` is held against
``radiance_cache.slot_major``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import radiance_cache as jrc
from repro.kernels import ops as jops

from repro_torch import interop
from repro_torch.core import radiance_cache as trc
from repro_torch.kernels import ops as tops
from repro_torch.kernels import rc_lookup as tlk

G, B, SETS, WAYS, K = 6, 96, 64, 4, 5


def _np(x):
    return x.detach().cpu().numpy()


def make_case(seed: int, v: int, mode: str):
    """A cache of G groups and viewer-major records [V, G, B, k], as numpy.

    Each group draws its records from a pool of 40, a quarter of them -1
    padded.  Half of the pool sits in the cache: in its set's first free
    way, and every third one a second time in a later way with another
    value (the first way must win).  The other ways hold -2 or stray tags.
    The first 64 records of every viewer of group 0 are one cached record,
    so that one slot takes many touches of one batch."""
    cfg = jrc.CacheConfig(n_sets=SETS, n_ways=WAYS, k=K, index_mode=mode,
                          index_bits_shift=0)
    rng = np.random.default_rng(seed)
    pool = rng.integers(0, 300, (G, 40, K)).astype(np.int32)
    pool[:, ::4, 3:] = -1
    sets = np.asarray(jrc.set_index(jnp.asarray(pool), cfg))
    tags = np.full((G, SETS, WAYS, K), jrc.INVALID_TAG, np.int32)
    stray = rng.random((G, SETS, WAYS)) < 0.3
    tags[stray] = rng.integers(300, 400, (int(stray.sum()), K))
    values = rng.random((G, SETS, WAYS, 3), dtype=np.float32)
    for g in range(G):
        for i in range(0, 40, 2):
            s = sets[g, i]
            if (tags[g, s] == pool[g, i]).all(-1).any():
                continue
            free = np.flatnonzero((tags[g, s] == jrc.INVALID_TAG).all(-1))
            for w in free[:2 if i % 3 == 0 else 1]:
                tags[g, s, w] = pool[g, i]
    age = rng.integers(0, 500, (G, SETS, WAYS)).astype(np.int32)
    clock = rng.integers(500, 1000, (G,)).astype(np.int32)
    pick = rng.integers(0, 40, (v, G, B))
    ids = np.take_along_axis(pool[None], pick[..., None], axis=2)
    ids[:, 0, :64] = pool[0, 0]
    return cfg, (tags, values, age, clock), ids


def jax_cache(arrays):
    return jrc.CacheState(*(jnp.asarray(x) for x in arrays))


def port_cache(arrays):
    return interop.cache_from_numpy(*arrays, device='cpu')


def assert_probe_equal(got, want):
    """(hit, value, way, cache) of the port against the JAX package's."""
    for name, x, y in zip(('hit', 'value', 'way'), got[:3], want[:3]):
        np.testing.assert_array_equal(_np(x), np.asarray(y), name)
    for name in ('tags', 'age', 'clock'):
        np.testing.assert_array_equal(_np(getattr(got[3], name)),
                                      np.asarray(getattr(want[3], name)), name)


def duplicate_ways(tags, ids):
    """Records of ``ids`` whose set holds their tag in more than one way."""
    return sum(int((tags[g] == r).all(-1).sum(-1).max() > 1)
               for g in range(G) for r in np.unique(ids[:, g].reshape(-1, K), axis=0))


@pytest.mark.parametrize('mode', ['hash', 'bitconcat'])
def test_rc_probe_matches_jax(mode):
    """One viewer: ``ops.rc_probe`` against ``jops.rc_probe`` and
    ``jrc.lookup_all_groups``."""
    cfg, arrays, ids = make_case(1, 1, mode)
    got = tops.rc_probe(port_cache(arrays), torch.from_numpy(ids[0]),
                        trc.CacheConfig(*cfg))
    want = jops.rc_probe(jax_cache(arrays), jnp.asarray(ids[0]), cfg,
                         interpret=True)
    assert_probe_equal(got, want)
    hit, val, _, way, cache = jrc.lookup_all_groups(jax_cache(arrays),
                                                    jnp.asarray(ids[0]), cfg)
    assert_probe_equal(got, (hit, val, way, cache))
    hit = np.asarray(hit)
    assert 0.2 < hit.mean() < 1.0 and hit[0, :64].all()
    assert duplicate_ways(arrays[0], ids) > 0
    # the hot slot keeps the touch of the batch's last record that hits it
    g0 = np.asarray(jrc.set_index(jnp.asarray(ids[0, 0, :1]), cfg))[0]
    w0 = int(np.asarray(way)[0, 0])
    last = np.flatnonzero((ids[0, 0] == ids[0, 0, 0]).all(-1))[-1]
    assert int(_np(got[3].age)[0, g0, w0]) == arrays[3][0] + 1 + last


@pytest.mark.parametrize('mode', ['hash', 'bitconcat'])
@pytest.mark.parametrize('v', [1, 4])
@pytest.mark.parametrize('live', [None, 'viewers'])
def test_rc_probe_multi_matches_jax(mode, v, live):
    """V viewers on one shared cache, ``live`` None or [V] with the second
    viewer dead (the only viewer, for V = 1): ``ops.rc_probe_multi`` against
    ``jops.rc_probe_multi`` and ``jrc.lookup_all_groups_multi``."""
    cfg, arrays, ids = make_case(2 + v, v, mode)
    lv = None if live is None else np.arange(v) != min(1, v - 1)
    got = tops.rc_probe_multi(port_cache(arrays), torch.from_numpy(ids),
                              trc.CacheConfig(*cfg),
                              live=None if lv is None else torch.from_numpy(lv))
    jlive = None if lv is None else jnp.asarray(lv)
    assert_probe_equal(got, jops.rc_probe_multi(
        jax_cache(arrays), jnp.asarray(ids), cfg, live=jlive, interpret=True))
    hit, val, _, way, cache = jrc.lookup_all_groups_multi(
        jax_cache(arrays), jnp.asarray(ids), cfg, live=jlive)
    assert_probe_equal(got, (hit, val, way, cache))
    assert 0.2 < np.asarray(hit).mean() < 1.0


@pytest.mark.parametrize('mode', ['hash', 'bitconcat'])
def test_rc_probe_multi_live_per_group_matches_jax(mode):
    """``live`` [V, G], as the serving tick passes it for C scenes' caches
    flattened to C*G groups: two scenes of G/2 groups, each with its own
    dead viewers, against the JAX package's probe of each scene with its
    [V] mask; and a mask that differs group by group against
    ``jrc.lookup_all_groups`` on the slot-major batch."""
    v = 4
    cfg, arrays, ids = make_case(9, v, mode)
    cfg_t = trc.CacheConfig(*cfg)
    per_scene = np.array([[True, False], [False, True], [True, True],
                          [False, False]])                        # [V, C]
    lv = np.repeat(per_scene, G // 2, axis=1)                     # [V, G]
    got = tops.rc_probe_multi(port_cache(arrays), torch.from_numpy(ids), cfg_t,
                              live=torch.from_numpy(lv))
    halves = [jops.rc_probe_multi(
        jrc.CacheState(*(jnp.asarray(x[c * G // 2:(c + 1) * G // 2])
                         for x in arrays)),
        jnp.asarray(ids[:, c * G // 2:(c + 1) * G // 2]), cfg,
        live=jnp.asarray(per_scene[:, c]), interpret=True) for c in range(2)]
    want = (*(np.concatenate([h[i] for h in halves], axis=1) for i in range(3)),
            jrc.CacheState(*(np.concatenate([getattr(h[3], f) for h in halves])
                             for f in ('tags', 'values', 'age', 'clock'))))
    assert_probe_equal(got, want)

    lv = np.random.default_rng(10).random((v, G)) < 0.5
    got = tops.rc_probe_multi(port_cache(arrays), torch.from_numpy(ids), cfg_t,
                              live=torch.from_numpy(lv))
    live_f = np.asarray(jrc.slot_major(jnp.asarray(
        np.broadcast_to(lv[:, :, None], ids.shape[:3]))))
    hit, val, _, way, cache = jrc.lookup_all_groups(
        jax_cache(arrays), jrc.slot_major(jnp.asarray(ids)), cfg,
        live=jnp.asarray(live_f))
    assert_probe_equal(got, tuple(np.asarray(jrc.slot_split(x, v))
                                  for x in (hit, val, way)) + (cache,))


@pytest.mark.parametrize('seed', [0, 1, 2, 3])
def test_viewer_major_index_mirrors_slot_major(seed):
    """The kernel reads record j of group g of the slot-major batch, and
    writes its outputs, at ``viewer_major_index`` of the viewer-major
    records: a gather there is ``rc.slot_major``'s copy, and a scatter
    there is its inverse ``rc.slot_split``, on random shapes."""
    rng = np.random.default_rng(seed)
    for _ in range(5):
        v, g, b = (int(x) for x in rng.integers(1, [6, 9, 40]))
        idx = tlk.viewer_major_index(v, g, b)
        x = torch.from_numpy(rng.random((v, g, b, 3)))
        assert torch.equal(x.reshape(-1, 3)[idx], trc.slot_major(x))
        y = torch.from_numpy(rng.random((g, v * b)))
        out = torch.empty(v * g * b, dtype=y.dtype)
        out[idx.reshape(-1)] = y.reshape(-1)
        assert torch.equal(out.reshape(v, g, b), trc.slot_split(y, v))


def test_rc_probe_refuses_other_devices():
    """A tensor neither on the CPU nor on the card is refused; no fallback."""
    i32 = torch.int32

    def z(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device='meta')

    cfg = trc.CacheConfig(n_sets=8)
    with pytest.raises(ValueError, match='no rc_lookup kernel'):
        tlk.rc_probe(z(1, 8, 4, 5, dtype=i32), z(1, 8, 4, 3), z(1, 8, 4, dtype=i32),
                     z(1, dtype=i32), z(2, 1, 16, 5, dtype=i32), cfg)
