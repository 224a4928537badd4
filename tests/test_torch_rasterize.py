"""Parity of the port's rasterizers with the JAX package, on the CPU.

The reference rasterizer (``core.rasterize.rasterize_tiles``) is held
against JAX's; the kernel wrappers (which take their plain versions on CPU
tensors) against the Pallas kernels run as the JAX package's own tests run
them: ``interpret=True`` with the ``'seq'`` body, whose per-Gaussian op
order the CUDA kernel follows.  Inputs are the JAX package's tile features
of a real frame (``structured_scene(PRNGKey(7), 800)``, 64x64) or
numpy-seeded random tiles.  Integer state (records, counts, ``n_sig``,
``n_iter``, ``iter_at_k``, ``chunks``) is held exactly; colors and
transmittance to 128 ulps x magnitude (``exp`` differs by up to 1 ulp
between the frameworks).
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
from repro_torch.core import rasterize as trast
from repro_torch.core.tiling import TileFeatures
from repro_torch.kernels import ops as tops
from repro_torch.kernels import rasterize as trk

INT_FIELDS = ('record', 'rec_cnt', 'n_sig', 'n_iter', 'iter_at_k', 'chunks')


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


def assert_state_matches(got: trk.RasterState, want: jrk.RasterState):
    for field in INT_FIELDS:
        np.testing.assert_array_equal(_np(getattr(got, field)),
                                      np.asarray(getattr(want, field)), field)
    assert_images_ulp_close(_np(got.acc), want.acc, err_msg='acc')
    assert_images_ulp_close(_np(got.trans), want.trans, err_msg='trans')


def assert_aux_matches(got, want):
    for field in ('alpha_record', 'n_significant', 'n_iterated', 'iter_at_k'):
        np.testing.assert_array_equal(_np(getattr(got, field)),
                                      np.asarray(getattr(want, field)), field)
    assert_images_ulp_close(_np(got.transmittance), want.transmittance,
                            err_msg='transmittance')


@functools.partial(jax.jit, static_argnames=('tiles_x', 'k_record', 'chunk',
                                             'stop_at_k'))
def jax_kernel(*args, tiles_x, k_record, chunk, stop_at_k):
    *args, ncap = args
    return jrk.rasterize_pallas(*args, tiles_x=tiles_x, k_record=k_record,
                                chunk=chunk, stop_at_k=stop_at_k, ncap=ncap,
                                interpret=True, body='seq')


@functools.partial(jax.jit, static_argnames=('k_record', 'chunk'))
def jax_compact_kernel(*args, k_record, chunk):
    return jrk.rasterize_compact_pallas(*args, k_record=k_record, chunk=chunk,
                                        interpret=True, body='seq')


@pytest.fixture(scope='module')
def frame():
    """The JAX package's tile features of one 64x64 frame (4x4 tiles)."""
    scene = jax.jit(jax_structured_scene, static_argnums=1)(
        jax.random.PRNGKey(7), 800)
    cam = jax_orbit(8, width=64, height_px=64)[5]

    @jax.jit
    def prep(scene, cam):
        proj = jproj.project(scene, cam)
        lists = jsorting.sort_scene(proj, 64, 64, 128)
        return jtiling.gather_tile_features(proj, lists)

    jf = prep(scene, cam)
    tf = TileFeatures(*(_t(x) for x in jf))
    return jf, tf, 4


def baseline_state(t, k_record, live):
    p = 256
    return [np.zeros((t, p, 3), np.float32), np.ones((t, p), np.float32),
            np.full((t, p, k_record), -1, np.int32), np.zeros((t, p), np.int32),
            np.zeros((t, p), np.int32), live.astype(np.int32)]


def run_both(feats_np, state_np, ncap_np, **kw):
    want = jax_kernel(*[jnp.asarray(x) for x in (*feats_np, *state_np, ncap_np)],
                      **kw)
    got = trk.rasterize(*[_t(x) for x in (*feats_np, *state_np)], _t(ncap_np),
                        **kw)
    return got, want


@pytest.mark.parametrize('live_kind', ['all', 'partial'])
def test_rasterize_tiles_matches(frame, live_kind):
    jf, tf, tiles_x = frame
    live = None
    if live_kind == 'partial':
        live = np.random.default_rng(0).random((16, 256)) < 0.7
    jfun = jax.jit(lambda f, lv: jrast.rasterize_tiles(f, tiles_x, k_record=5,
                                                       bg=0.25, live=lv))
    colors_j, aux_j = jfun(jf, None if live is None else jnp.asarray(live))
    colors_t, aux_t = trast.rasterize_tiles(
        tf, tiles_x, k_record=5, bg=0.25,
        live=None if live is None else torch.from_numpy(live))
    assert_images_ulp_close(_np(colors_t), colors_j, err_msg='colors')
    assert_aux_matches(aux_t, aux_j)
    assert int(np.asarray(aux_j.n_significant).sum()) > 1000


@pytest.mark.parametrize('mode', ['full', 'prefix', 'resume'])
def test_kernel_modes_match_on_a_real_frame(frame, mode):
    jf, _, tiles_x = frame
    feats = [np.asarray(x) for x in jf]
    t = feats[4].shape[0]
    ncap = np.asarray(jrast.chunk_caps(jf.ids, 64))
    rng = np.random.default_rng(1)
    state = baseline_state(t, 5, np.ones((t, 256), bool))
    kw = dict(tiles_x=tiles_x, k_record=5, chunk=64)
    if mode == 'resume':
        _, st_a = run_both(feats, state, ncap, stop_at_k=True, **kw)
        live = (rng.random((t, 256)) < 0.3) & (np.asarray(st_a.rec_cnt) >= 5)
        state = [np.asarray(x) for x in (st_a.acc, st_a.trans, st_a.record,
                                         st_a.rec_cnt, st_a.iter_at_k)]
        state.append(live.astype(np.int32))
        assert live.sum() > 50
    got, want = run_both(feats, state, ncap, stop_at_k=(mode == 'prefix'), **kw)
    assert_state_matches(got, want)


@pytest.mark.parametrize('t,k,chunk,k_record,stop_at_k', [
    (1, 32, 16, 5, False), (4, 64, 32, 3, True), (9, 128, 64, 5, True),
    (6, 96, 32, 8, False)])
def test_kernel_matches_on_random_tiles(t, k, chunk, k_record, stop_at_k):
    """Random features, a partial live mask, random start positions and
    per-tile caps below the list length."""
    rng = np.random.default_rng(t * 1000 + k + chunk + k_record)
    tiles_x = int(np.ceil(np.sqrt(t)))
    spread = 16.0 * tiles_x
    mean2d = rng.uniform(-4.0, spread + 4.0, (t, k, 2)).astype(np.float32)
    a = rng.uniform(0.02, 0.35, (t, k))
    c = rng.uniform(0.02, 0.35, (t, k))
    b = np.clip(rng.uniform(-0.05, 0.05, (t, k)), -0.9 * np.sqrt(a * c),
                0.9 * np.sqrt(a * c))
    conic = np.stack([a, b, c], -1).astype(np.float32)
    color = rng.random((t, k, 3), dtype=np.float32)
    opacity = rng.uniform(0.1, 0.95, (t, k)).astype(np.float32)
    ids = np.where(np.arange(k)[None] < k - 3,
                   np.tile(np.arange(k, dtype=np.int32), (t, 1)), -1)
    ids = np.where(rng.random((t, k)) < 0.05, -1, ids).astype(np.int32)
    state = baseline_state(t, k_record, rng.random((t, 256)) < 0.8)
    state[4] = rng.integers(0, k // 2, (t, 256)).astype(np.int32)
    ncap = np.minimum(np.asarray(jrast.chunk_caps(jnp.asarray(ids), chunk)),
                      rng.integers(1, k // chunk + 1, (t,))).astype(np.int32)
    got, want = run_both((mean2d, conic, color, opacity, ids), state, ncap,
                         tiles_x=tiles_x, k_record=k_record, chunk=chunk,
                         stop_at_k=stop_at_k)
    assert_state_matches(got, want)


def test_compact_kernel_matches_on_random_lanes():
    rng = np.random.default_rng(5)
    t, k, chunk, ct, kr = 6, 128, 32, 3, 5
    mean2d = rng.uniform(-4.0, 52.0, (t, k, 2)).astype(np.float32)
    conic = np.tile(np.asarray([0.08, 0.01, 0.1], np.float32), (t, k, 1))
    color = rng.random((t, k, 3), dtype=np.float32)
    opacity = rng.uniform(0.1, 0.95, (t, k)).astype(np.float32)
    ids = np.tile(np.arange(k, dtype=np.int32), (t, 1))
    ids[:, 100:] = -1
    src = rng.integers(0, t, (ct, 256)).astype(np.int32)
    px = rng.integers(0, 48, (ct, 256)).astype(np.float32) + 0.5
    py = rng.integers(0, 32, (ct, 256)).astype(np.float32) + 0.5
    ncap = np.asarray(jrast.chunk_caps(jnp.asarray(ids), chunk))[src]
    state = baseline_state(ct, kr, rng.random((ct, 256)) < 0.6)
    state[0] = rng.random((ct, 256, 3), dtype=np.float32) * 0.2
    state[1] = rng.uniform(0.05, 1.0, (ct, 256)).astype(np.float32)
    state[4] = rng.integers(0, 40, (ct, 256)).astype(np.int32)
    state[5][2] = 0                                    # one all-dead tile
    args = (mean2d, conic, color, opacity, ids, px, py, src, ncap, *state)
    want = jax_compact_kernel(*[jnp.asarray(x) for x in args], k_record=kr,
                              chunk=chunk)
    got = trk.rasterize_compact(*[_t(x) for x in args], k_record=kr, chunk=chunk)
    assert_state_matches(got, want)
    assert int(np.asarray(want.chunks)[2, 0]) == 0


@pytest.mark.parametrize('op', ['full', 'resume', 'resume_compacted'])
def test_ops_match(frame, op):
    jf, tf, tiles_x = frame
    if op == 'full':
        cj, aux_j, ch_j = jops.rasterize_full(jf, tiles_x, bg=0.5,
                                              interpret=True)
        ct, aux_t, ch_t = tops.rasterize_full(tf, tiles_x, bg=0.5)
    else:
        st_j = jops.rasterize_prefix(jf, tiles_x, interpret=True)
        st_t = tops.rasterize_prefix(tf, tiles_x)
        assert_state_matches(st_t, st_j)
        miss = np.random.default_rng(2).random(np.asarray(st_j.trans).shape) < 0.4
        fj = getattr(jops, f'rasterize_{op}')
        ft = getattr(tops, f'rasterize_{op}')
        cj, aux_j, ch_j = fj(jf, tiles_x, st_j, jnp.asarray(miss), bg=0.5,
                             interpret=True)
        ct, aux_t, ch_t = ft(tf, tiles_x, st_t, torch.from_numpy(miss), bg=0.5)
    assert_images_ulp_close(_np(ct), cj, err_msg='colors')
    assert_aux_matches(aux_t, aux_j)
    np.testing.assert_array_equal(_np(ch_t), np.asarray(ch_j))


def test_trim_features_matches_exactly(frame):
    jf, tf, tiles_x = frame
    want = jax.jit(jops.trim_features, static_argnums=1)(jf, tiles_x)
    got = tops.trim_features(tf, tiles_x)
    for field in ('mean2d', 'conic', 'color', 'opacity', 'ids'):
        np.testing.assert_array_equal(_np(getattr(got, field)),
                                      np.asarray(getattr(want, field)), field)
    assert (np.asarray(want.ids) < 0).sum() > (np.asarray(jf.ids) < 0).sum()


def test_chunk_caps_padding_and_assembly_match(frame):
    jf, tf, tiles_x = frame
    for chunk in (16, 48, 64):
        np.testing.assert_array_equal(_np(trast.chunk_caps(tf.ids, chunk)),
                                      np.asarray(jrast.chunk_caps(jf.ids, chunk)))
    jp = jrast.pad_tile_features(jf, 48)
    tp = trast.pad_tile_features(tf, 48)
    for field in ('mean2d', 'conic', 'color', 'opacity', 'ids'):
        np.testing.assert_array_equal(_np(getattr(tp, field)),
                                      np.asarray(getattr(jp, field)), field)
    colors = np.random.default_rng(3).random((20, 256, 3), dtype=np.float32)
    np.testing.assert_array_equal(
        _np(trast.assemble_image(torch.from_numpy(colors), 5, 4, 70, 60)),
        np.asarray(jrast.assemble_image(jnp.asarray(colors), 5, 4, 70, 60)))


def test_wrappers_take_plain_versions_only_on_the_cpu():
    """A tensor neither on the CPU nor on the card is refused; no fallback."""
    from repro_torch.core.radiance_cache import CacheConfig
    from repro_torch.kernels.rc_lookup import rc_lookup

    def z(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device='meta')

    i32 = torch.int32
    feats = (z(1, 64, 2), z(1, 64, 3), z(1, 64, 3), z(1, 64), z(1, 64, dtype=i32))
    state = (z(1, 256, 3), z(1, 256), z(1, 256, 5, dtype=i32),
             *(z(1, 256, dtype=i32) for _ in range(3)))
    with pytest.raises(ValueError, match='no rasterize kernel'):
        trk.rasterize(*feats, *state, z(1, dtype=i32), tiles_x=1)
    lanes = (z(1, 256), z(1, 256), z(1, 256, dtype=i32), z(1, 256, dtype=i32))
    with pytest.raises(ValueError, match='no rasterize_compact kernel'):
        trk.rasterize_compact(*feats, *lanes, *state)
    cfg = CacheConfig(n_sets=8)
    with pytest.raises(ValueError, match='no rc_lookup kernel'):
        rc_lookup(z(1, 8, 4, 5, dtype=i32), z(1, 8, 4, 3), z(1, 16, 5, dtype=i32), cfg)
