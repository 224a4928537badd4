"""Parity of the port's slot-batched rasterizer with the JAX package, on the
CPU.

``rasterize_slots`` (which takes its plain version on CPU tensors) is held
against ``rasterize_slots_pallas`` run as the JAX package's tests run it:
``interpret=True`` with the ``'seq'`` body.  Integer state and the shared
trip count ``chunks`` are held exactly, colors and transmittance to 128 ulps
x magnitude.  A second test holds the identity the CUDA kernel relies on:
every lane equals the single-slot rasterizer's, and the shared trip count
is the largest per-slot count among the live slots.  The flattened
slot x tile forms of the trim and of the compacted phase B (``t_img``) are
held against JAX on real frames of ``structured_scene(PRNGKey(7), 800)``.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import projection as jproj
from repro.core import rasterize as jrast
from repro.core import sorting as jsorting
from repro.core import tiling as jtiling
from repro.data.scenes import structured_scene as jax_structured_scene
from repro.data.trajectory import orbit_trajectory as jax_orbit
from repro.kernels import ops as jops
from repro.kernels import rasterize as jrk

from repro_torch import interop
from repro_torch.core.tiling import TileFeatures
from repro_torch.kernels import ops as tops
from repro_torch.kernels import rasterize as trk

INT_FIELDS = ('record', 'rec_cnt', 'n_sig', 'n_iter', 'iter_at_k', 'chunks')
P = 256


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
    return x.detach().cpu().numpy()


def _t(x):
    return interop.tensor(np.asarray(x), device='cpu')


def assert_state_matches(got, want, err_msg=''):
    for field in INT_FIELDS:
        np.testing.assert_array_equal(_np(getattr(got, field)),
                                      np.asarray(getattr(want, field)),
                                      f'{err_msg} {field}')
    assert_images_ulp_close(_np(got.acc), want.acc, err_msg=f'{err_msg} acc')
    assert_images_ulp_close(_np(got.trans), want.trans,
                            err_msg=f'{err_msg} trans')


@functools.partial(jax.jit, static_argnames=('tiles_x', 'k_record', 'chunk',
                                             'stop_at_k'))
def jax_slots_kernel(*args, tiles_x, k_record, chunk, stop_at_k):
    *args, ncap = args
    return jrk.rasterize_slots_pallas(*args, tiles_x=tiles_x,
                                      k_record=k_record, chunk=chunk,
                                      stop_at_k=stop_at_k, ncap=ncap,
                                      interpret=True, body='seq')


def random_slots(s, t, k, chunk, seed):
    """Random features for S slots of T tiles, a dead slot (slot 1), a
    partial live mask elsewhere and unequal per-slot chunk caps."""
    rng = np.random.default_rng(seed)
    tiles_x = int(np.ceil(np.sqrt(t)))
    spread = 16.0 * tiles_x
    mean2d = rng.uniform(-4.0, spread + 4.0, (s, t, k, 2)).astype(np.float32)
    a = rng.uniform(0.02, 0.35, (s, t, k))
    c = rng.uniform(0.02, 0.35, (s, t, k))
    b = np.clip(rng.uniform(-0.05, 0.05, (s, t, k)), -0.9 * np.sqrt(a * c),
                0.9 * np.sqrt(a * c))
    conic = np.stack([a, b, c], -1).astype(np.float32)
    color = rng.random((s, t, k, 3), dtype=np.float32)
    opacity = rng.uniform(0.05, 0.95, (s, t, k)).astype(np.float32)
    # slot i's lists end at a different depth: unequal ncap per slot
    ids = np.tile(np.arange(k, dtype=np.int32), (s, t, 1))
    ids = np.where(np.arange(k)[None, None] < k - 1 - 40 * np.arange(s)[:, None, None],
                   ids, -1)
    ids = np.where(rng.random((s, t, k)) < 0.05, -1, ids).astype(np.int32)
    opacity = np.where(ids < 0, 0.0, opacity).astype(np.float32)
    live = rng.random((s, t, P)) < 0.8
    live[1] = False
    state = [np.zeros((s, t, P, 3), np.float32), np.ones((s, t, P), np.float32),
             np.full((s, t, P, 5), -1, np.int32), np.zeros((s, t, P), np.int32),
             live.astype(np.int32)]
    ncap = np.asarray(jrast.chunk_caps(jnp.asarray(ids.reshape(s * t, k)),
                                       chunk)).reshape(s, t)
    return (mean2d, conic, color, opacity, ids), state, ncap, tiles_x


def run_both(feats, state, ncap, **kw):
    acc0, trans0, rec0, cnt0, live = state
    want = jax_slots_kernel(*[jnp.asarray(x) for x in (
        *feats, acc0, trans0, rec0, cnt0, np.zeros_like(cnt0), live, ncap)],
        **kw)
    got = trk.rasterize_slots(*[_t(x) for x in (*feats, *state, ncap)], **kw)
    return got, want


@pytest.mark.parametrize('stop_at_k', [True, False])
def test_slots_kernel_matches_jax(stop_at_k):
    feats, state, ncap, tiles_x = random_slots(3, 6, 128, 32, seed=11)
    assert len(set(ncap.max(axis=1).tolist())) == 3       # unequal caps
    got, want = run_both(feats, state, ncap, tiles_x=tiles_x, k_record=5,
                         chunk=32, stop_at_k=stop_at_k)
    assert_state_matches(got, want)
    assert int(np.asarray(want.chunks).sum()) > 0
    # the dead slot is untouched by the chunks the others ride
    assert not np.asarray(want.n_iter)[1].any()


def test_shared_trip_count_is_the_max_over_live_slots():
    """Each lane equals the single-slot rasterizer's, and the shared count
    of a tile is the largest per-slot count among its live slots: the
    identity the CUDA kernel's atomicMax relies on."""
    chunk = 32
    feats, state, ncap, tiles_x = random_slots(3, 6, 128, chunk, seed=12)
    kw = dict(tiles_x=tiles_x, k_record=5, chunk=chunk, stop_at_k=True)
    coupled = trk.rasterize_slots_plain(*[_t(x) for x in (*feats, *state, ncap)],
                                        **kw)
    counts = []
    for i in range(3):
        acc0, trans0, rec0, cnt0, live = (x[i] for x in state)
        one = trk.rasterize_plain(*[_t(x[i]) for x in feats], _t(acc0),
                                  _t(trans0), _t(rec0), _t(cnt0),
                                  _t(np.zeros_like(cnt0)), _t(live),
                                  _t(ncap[i]), **kw)
        for field in INT_FIELDS[:-1] + ('acc', 'trans'):
            np.testing.assert_array_equal(_np(getattr(coupled, field)[i]),
                                          _np(getattr(one, field)),
                                          f'slot {i} {field}')
        counts.append(_np(one.chunks)[:, 0])
    counts = np.stack(counts)
    assert not counts[1].any()                             # the dead slot
    np.testing.assert_array_equal(_np(coupled.chunks)[:, 0], counts.max(0))
    assert (counts[0] != counts[2]).any()                  # the max matters


@pytest.fixture(scope='module')
def slot_frames():
    """The JAX package's tile features of 3 slots (3 orbit poses) of a
    64x64 frame, stacked [S, T, K, ...]."""
    scene = jax.jit(jax_structured_scene, static_argnums=1)(
        jax.random.PRNGKey(7), 800)

    @jax.jit
    def prep(scene, cam):
        proj = jproj.project(scene, cam)
        lists = jsorting.sort_scene(proj, 64, 64, 128)
        return jtiling.gather_tile_features(proj, lists)

    frames = [prep(scene, jax_orbit(1, width=64, height_px=64,
                                    start_deg=120.0 * i)[0]) for i in range(3)]
    jf = jtiling.TileFeatures(*(jnp.stack(xs) for xs in zip(*frames)))
    tf = TileFeatures(*(_t(x) for x in (jf.mean2d, jf.conic, jf.color,
                                        jf.opacity, jf.ids)))
    return jf, tf, 4


def _flat(f, cls):
    s, t = f.ids.shape[:2]
    return cls(*(x.reshape((s * t,) + tuple(x.shape[2:]))
                 for x in (f.mean2d, f.conic, f.color, f.opacity, f.ids)))


def test_trim_features_with_t_img_matches(slot_frames):
    jf, tf, tiles_x = slot_frames
    t = jf.ids.shape[1]
    want = jax.jit(jops.trim_features, static_argnums=(1, 2))(
        _flat(jf, jtiling.TileFeatures), tiles_x, t)
    got = tops.trim_features(_flat(tf, TileFeatures), tiles_x, t_img=t)
    for field in ('mean2d', 'conic', 'color', 'opacity', 'ids'):
        np.testing.assert_array_equal(_np(getattr(got, field)),
                                      np.asarray(getattr(want, field)), field)
    # without t_img every slot after the first would be trimmed against
    # the wrong tiles
    wrong = tops.trim_features(_flat(tf, TileFeatures), tiles_x)
    assert not np.array_equal(_np(wrong.ids), np.asarray(want.ids))


def test_resume_compacted_with_t_img_matches(slot_frames):
    jf, tf, tiles_x = slot_frames
    s, t = jf.ids.shape[:2]
    live = np.ones((s,), bool)
    st_j = jops.rasterize_prefix_slots(jf, tiles_x, live=jnp.asarray(live),
                                       interpret=True)
    st_t = tops.rasterize_prefix_slots(tf, tiles_x, live=torch.from_numpy(live))
    assert_state_matches(st_t, st_j, 'prefix')
    miss = np.random.default_rng(3).random((s, t, P)) < 0.4
    cj, aux_j, ch_j = jops.rasterize_resume_compacted_slots(
        jf, tiles_x, st_j, jnp.asarray(miss), t_img=t, bg=0.5, interpret=True)
    ct, aux_t, ch_t = tops.rasterize_resume_compacted_slots(
        tf, tiles_x, st_t, torch.from_numpy(miss), t_img=t, bg=0.5)
    assert_images_ulp_close(_np(ct), cj, err_msg='colors')
    for field in ('alpha_record', 'n_significant', 'n_iterated', 'iter_at_k'):
        np.testing.assert_array_equal(_np(getattr(aux_t, field)),
                                      np.asarray(getattr(aux_j, field)), field)
    np.testing.assert_array_equal(_np(ch_t), np.asarray(ch_j))
    assert int(np.asarray(aux_j.n_significant)[2].sum()) > 1000


def test_slots_wrapper_refuses_other_devices():
    """A tensor neither on the CPU nor on the card is refused; no fallback."""
    def z(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device='meta')

    i32 = torch.int32
    feats = (z(2, 1, 64, 2), z(2, 1, 64, 3), z(2, 1, 64, 3), z(2, 1, 64),
             z(2, 1, 64, dtype=i32))
    state = (z(2, 1, 256, 3), z(2, 1, 256), z(2, 1, 256, 5, dtype=i32),
             z(2, 1, 256, dtype=i32), z(2, 1, 256, dtype=i32))
    with pytest.raises(ValueError, match='no rasterize_slots kernel'):
        trk.rasterize_slots(*feats, *state, z(2, 1, dtype=i32), tiles_x=1)
