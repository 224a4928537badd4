"""The miss-compacted phase B of the port against the JAX package, on the CPU.

``ops.rasterize_resume_compacted`` (and its ``_slots`` form) addresses the
compacted lanes through their home pixels (``rasterize_compact_home``); on
the CPU that entry takes its plain route (gather, ``rasterize_compact_plain``,
scatter).  Here it is held against the JAX package's
``rasterize_resume_compacted(_slots)``, whose Pallas kernel runs in interpret
mode with the ``'seq'`` body, on the tile features of a real 64x64 frame
(``structured_scene(PRNGKey(7), 800)``).  The plain mirror of the CUDA
kernel's decoupled trip count (``compact_lane_stops_plain`` /
``compact_chunks_plain``) is held against the JAX kernel's ``chunks`` on
seeded lanes: lanes that start at their source tile's cap, NaN and floor
transmittances, all-dead lane tiles, and n_live of 0, 1, 256 and 257.
Integer state and ``chunks`` are held exactly; colors and transmittance to
128 ulps x magnitude (``exp`` differs by up to 1 ulp between the
frameworks).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import projection as jproj
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

P = 256
CHUNK = 16          # K = 128 lists walk in 8 chunks
K_RECORD = 5
AUX_INT_FIELDS = ('alpha_record', 'n_significant', 'n_iterated', 'iter_at_k')


def assert_ulp_close(got, want, *, ulps=128, err_msg=''):
    """``ulps`` x float32-eps x magnitude (floored at 1.0), as
    tests/test_serve.py bounds images."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    scale = np.maximum(np.maximum(np.abs(got), np.abs(want)), 1.0)
    tol = np.float32(ulps) * np.finfo(np.float32).eps * scale
    err = np.abs(got - want)
    assert (err <= tol).all(), f'{err_msg}: differs by more than {ulps} ulps'


def _np(x):
    return x.detach().cpu().numpy()


def _t(x):
    return interop.tensor(np.asarray(x), device='cpu')


def assert_resume_matches(got, want):
    colors_t, aux_t, chunks_t = got
    colors_j, aux_j, chunks_j = want
    assert_ulp_close(_np(colors_t), colors_j, err_msg='colors')
    for field in AUX_INT_FIELDS:
        np.testing.assert_array_equal(_np(getattr(aux_t, field)),
                                      np.asarray(getattr(aux_j, field)), field)
    assert_ulp_close(_np(aux_t.transmittance), aux_j.transmittance,
                     err_msg='transmittance')
    np.testing.assert_array_equal(_np(chunks_t), np.asarray(chunks_j))


@functools.partial(jax.jit, static_argnames=('k_record', 'chunk'))
def jax_compact_kernel(*args, k_record, chunk):
    return jrk.rasterize_compact_pallas(*args, k_record=k_record, chunk=chunk,
                                        interpret=True, body='seq')


@functools.lru_cache(maxsize=None)
def _prep():
    @jax.jit
    def prep(scene, cam):
        proj = jproj.project(scene, cam)
        lists = jsorting.sort_scene(proj, 64, 64, 128)
        return jtiling.gather_tile_features(proj, lists)
    return prep


def jax_frame(start_deg: float):
    scene = jax.jit(jax_structured_scene, static_argnums=1)(
        jax.random.PRNGKey(7), 800)
    return _prep()(scene, jax_orbit(1, width=64, height_px=64,
                                    start_deg=start_deg)[0])


def torch_features(jf) -> TileFeatures:
    return TileFeatures(*(_t(x) for x in (jf.mean2d, jf.conic, jf.color,
                                          jf.opacity, jf.ids)))


@pytest.fixture(scope='module')
def frame():
    """The JAX package's tile features of one 64x64 frame (4x4 tiles) and
    its phase-A state on both sides."""
    jf = jax_frame(0.0)
    tf = torch_features(jf)
    st_j = jops.rasterize_prefix(jf, 4, interpret=True)
    st_t = tops.rasterize_prefix(tf, 4)
    return jf, tf, st_j, st_t


@pytest.mark.parametrize('miss_rate', [0.0, 0.003, 0.4, 1.0])
def test_home_route_matches_jax(frame, miss_rate):
    """No live lane, a handful (one lane tile), many, every miss pixel."""
    jf, tf, st_j, st_t = frame
    miss = np.random.default_rng(11).random((16, P)) < miss_rate
    want = jops.rasterize_resume_compacted(jf, 4, st_j, jnp.asarray(miss),
                                           bg=0.5, interpret=True)
    got = tops.rasterize_resume_compacted(tf, 4, st_t, torch.from_numpy(miss),
                                          bg=0.5)
    assert_resume_matches(got, want)


@pytest.mark.parametrize('live_slots', [(True, True, True), (True, False, True)])
def test_home_route_with_t_img_matches_jax(live_slots):
    """Cross-slot compaction: the lanes of 3 slots in one compacted order,
    pixel coordinates repeating every t_img tiles; an idle slot too."""
    frames = [jax_frame(120.0 * i) for i in range(3)]
    jf = jtiling.TileFeatures(*(jnp.stack(xs) for xs in zip(*frames)))
    tf = torch_features(jf)
    live = np.asarray(live_slots)
    st_j = jops.rasterize_prefix_slots(jf, 4, live=jnp.asarray(live),
                                       interpret=True)
    st_t = tops.rasterize_prefix_slots(tf, 4, live=torch.from_numpy(live))
    miss = (np.random.default_rng(5).random((3, 16, P)) < 0.5) & live[:, None, None]
    want = jops.rasterize_resume_compacted_slots(
        jf, 4, st_j, jnp.asarray(miss), t_img=16, bg=0.25, interpret=True)
    got = tops.rasterize_resume_compacted_slots(
        tf, 4, st_t, torch.from_numpy(miss), t_img=16, bg=0.25)
    assert_resume_matches(got, want)


def seeded_lanes(jf, case: str, seed: int):
    """Home-indexed operands over the frame's 16 tiles: a resume state whose
    starts reach the source tile's cap (a fifth start exactly at ncap *
    chunk), with NaN and floor transmittances, and a live set chosen by
    ``case``: 'n_live=<n>' random lanes; 'staggered', 48 random lanes
    of which those starting in the first two chunks sit just above the
    transmittance floor (their first significant pair ends them), so a
    late starter holds the lane tile's largest stop; or 'dead_tiles', every
    lane live but those packed into lane tiles 3 and 7."""
    rng = np.random.default_rng(seed)
    feats = [_t(x) for x in (jf.mean2d, jf.conic, jf.color, jf.opacity,
                             jf.ids)]
    t = feats[4].shape[0]
    ncap = tops.chunk_caps(feats[4], CHUNK)
    cap_pos = _np(ncap)[:, None] * CHUNK
    start = np.minimum(rng.integers(0, 128, (t, P)), cap_pos)
    start = np.where(rng.random((t, P)) < 0.2, cap_pos, start).astype(np.int32)
    trans = rng.uniform(0.0, 1.0, (t, P)).astype(np.float32)
    trans[rng.random((t, P)) < 0.05] = 1e-5
    trans[rng.random((t, P)) < 0.03] = np.nan
    state = [_t(rng.random((t, P, 3), dtype=np.float32) * 0.3), _t(trans),
             _t(rng.integers(-1, 800, (t, P, K_RECORD)).astype(np.int32)),
             _t(rng.integers(K_RECORD, K_RECORD + 3, (t, P)).astype(np.int32)),
             _t(rng.integers(0, 40, (t, P)).astype(np.int32)),
             _t(rng.integers(0, 400, (t, P)).astype(np.int32)), _t(start)]
    if case == 'dead_tiles':
        live = np.ones(t * P, bool)
        home, n_live = tops.compaction_order(torch.from_numpy(live.reshape(t, P)))
        lanes = list(trk.compact_lanes(ncap, *state[:4], state[6], home, n_live,
                                       tiles_x=4, t_img=t))
        lanes[-1][[3, 7]] = 0
        return feats, ncap, state, None, lanes
    n = 48 if case == 'staggered' else int(case.split('=')[1])
    if case == 'staggered':
        state[1] = _t(np.where(start < 2 * CHUNK, np.float32(1.0002e-4),
                               np.float32(1.0)))
    live = np.zeros(t * P, bool)
    live[rng.permutation(t * P)[:n]] = True
    home, n_live = tops.compaction_order(torch.from_numpy(live.reshape(t, P)))
    lanes = trk.compact_lanes(ncap, *state[:4], state[6], home, n_live,
                              tiles_x=4, t_img=t)
    return feats, ncap, state, (home, n_live), list(lanes)


LANE_CASES = ['n_live=0', 'n_live=1', 'n_live=256', 'n_live=257',
              'n_live=2000', 'staggered', 'dead_tiles']


def jax_lanes(feats, lanes):
    return jax_compact_kernel(*[jnp.asarray(_np(x)) for x in (*feats, *lanes)],
                              k_record=K_RECORD, chunk=CHUNK)


@pytest.mark.parametrize('case', LANE_CASES)
def test_trip_count_mirror_matches_jax(frame, case):
    jf = frame[0]
    feats, _, _, _, lanes = seeded_lanes(jf, case, seed=LANE_CASES.index(case))
    want = jax_lanes(feats, lanes)
    got = trk.compact_chunks_plain(*feats, *lanes, k_record=K_RECORD,
                                   chunk=CHUNK)
    np.testing.assert_array_equal(_np(got), np.asarray(want.chunks))
    if case in ('n_live=0', 'dead_tiles'):
        assert not _np(got)[[3, 7]].any()


@pytest.mark.parametrize('case', [c for c in LANE_CASES if c != 'dead_tiles'])
def test_home_entry_matches_the_jax_kernel(frame, case):
    """``rasterize_compact_home`` (plain route) against the JAX kernel on the
    same lanes, scattered home and combined with phase A's counts."""
    jf = frame[0]
    feats, ncap, state, (home, n_live), lanes = seeded_lanes(
        jf, case, seed=LANE_CASES.index(case))
    got = trk.rasterize_compact_home(*feats, ncap, *state, home, n_live,
                                     tiles_x=4, t_img=16, k_record=K_RECORD,
                                     chunk=CHUNK)
    want = jax_lanes(feats, lanes)
    inv = np.empty(16 * P, np.int64)
    inv[_np(home)] = np.arange(16 * P)

    def home_of(x):
        x = np.asarray(x)
        return x.reshape(16 * P, *x.shape[2:])[inv].reshape(x.shape)

    nsig0, niter0, itk0 = (_np(x) for x in state[4:])
    np.testing.assert_array_equal(_np(got.record), home_of(want.record))
    np.testing.assert_array_equal(_np(got.rec_cnt), home_of(want.rec_cnt))
    np.testing.assert_array_equal(_np(got.n_sig), nsig0 + home_of(want.n_sig))
    np.testing.assert_array_equal(_np(got.n_iter), niter0 + home_of(want.n_iter))
    np.testing.assert_array_equal(_np(got.iter_at_k),
                                  np.minimum(itk0, home_of(want.iter_at_k)))
    np.testing.assert_array_equal(_np(got.chunks), np.asarray(want.chunks))
    trans_t, trans_j = _np(got.trans), home_of(want.trans)
    np.testing.assert_array_equal(np.isnan(trans_t), np.isnan(trans_j))
    assert_ulp_close(np.nan_to_num(trans_t), np.nan_to_num(trans_j),
                     err_msg='trans')
    assert_ulp_close(_np(got.acc), home_of(want.acc), err_msg='acc')


def test_the_mirror_check_catches_a_wrong_count(frame):
    """The count needs its floor at 0 and the tile's c0: a mirror without
    the floor, or with each lane's own start chunk in place of c0, differs
    from the JAX kernel on these lanes."""
    jf = frame[0]
    want = []
    pieces = []
    for seed, case in enumerate(('staggered', 'dead_tiles', 'n_live=2000')):
        feats, _, _, _, lanes = seeded_lanes(jf, case, seed=seed)
        want.append(np.asarray(jax_lanes(feats, lanes).chunks)[:, 0])
        pieces.append(trk.compact_lane_stops_plain(
            *feats, *lanes, k_record=K_RECORD, chunk=CHUNK))

    def agrees(count):
        return all(np.array_equal(_np(count(*piece)), w)
                   for piece, w in zip(pieces, want))

    assert agrees(lambda stop, start, c0: torch.clamp(stop.amax(1) - c0, min=0))
    assert not agrees(lambda stop, start, c0: stop.amax(1) - c0)
    assert not agrees(lambda stop, start, c0:
                      torch.clamp((stop - start).amax(1), min=0))


def test_home_entry_refuses_other_devices():
    """A tensor neither on the CPU nor on the card is refused; no fallback."""
    def z(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device='meta')

    i32 = torch.int32
    feats = (z(1, 64, 2), z(1, 64, 3), z(1, 64, 3), z(1, 64), z(1, 64, dtype=i32))
    state = (z(1, P, 3), z(1, P), z(1, P, 5, dtype=i32),
             *(z(1, P, dtype=i32) for _ in range(4)))
    with pytest.raises(ValueError, match='no rasterize_compact kernel'):
        trk.rasterize_compact_home(*feats, z(1, dtype=i32), *state,
                                   z(P, dtype=i32), z(dtype=i32), tiles_x=1,
                                   t_img=1)
