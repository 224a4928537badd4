"""The band cull of the CUDA tile rasterizer, held on the CPU.

``rasterize_kernel`` (``csrc/rasterize.cu``) lets each warp (a 16x2-pixel
band of a tile) skip the Gaussians of a chunk that cannot be significant at
any of its pixel centres.  That is exact only if the cull is conservative:
a culled (Gaussian, band) pair must give, at every pixel centre of the
band, no significant alpha.  ``tile_cull_plain`` mirrors the kernel's
predicate; these tests hold it against the JAX package's own per-pair
arithmetic (its plain raster walk, ``repro.core.rasterize.rasterize_tiles``,
over each list position alone) on hypothesis-drawn Gaussians (elongated,
near-singular, non-finite, tiny and full opacity, means inside, on the
border of and far from the tile, and placed on the edge of the cull's own
ellipse) and on the JAX package's tile lists of a real frame, where some
pairs must be culled.  The port's float32 expressions (those of
``rasterize._walk``) are held against the same walk as a cross-check.
"""
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core import projection as jproj
from repro.core import rasterize as jrasterize
from repro.core import sorting as jsorting
from repro.core import tiling as jtiling
from repro.data.scenes import structured_scene as jax_structured_scene
from repro.data.trajectory import orbit_trajectory as jax_orbit

from repro_torch import interop
from repro_torch.core.gaussians import ALPHA_MAX, ALPHA_SIGNIFICANT
from repro_torch.kernels import rasterize as trk

TILES_X = 3          # the tests' tiles lie in a 3-wide grid
TILE = 16
K_SIG = float(np.float32(ALPHA_SIGNIFICANT))


@functools.partial(jax.jit, static_argnums=4)
def _jax_significant(mean2d, conic, opacity, ids, tiles_x):
    """[T, K, 256] bool: is list position k of tile t significant at pixel
    p?  Each position is walked alone from a fresh pixel state by the JAX
    package's plain rasterizer, so n_significant is 1 exactly where it is."""
    def one(m, c, o, i):                     # one list position of every tile
        feats = jtiling.TileFeatures(m[:, None], c[:, None],
                                     jnp.zeros(m.shape[:1] + (1, 3)),
                                     o[:, None], i[:, None])
        _, aux = jrasterize.rasterize_tiles(feats, tiles_x, early_exit=False)
        return aux.n_significant > 0
    return jax.vmap(one, in_axes=1, out_axes=1)(mean2d, conic, opacity, ids)


def jax_significant(mean2d, conic, opacity, ids, tiles_x):
    """``_jax_significant`` on torch [T, K] lists, K padded to a multiple
    of 64 (one compile per padded width)."""
    k = ids.shape[1]
    pad = -k % 64

    def arr(x, fill):
        x = x.numpy()
        return jnp.asarray(np.pad(x, [(0, 0), (0, pad)] + [(0, 0)] * (x.ndim - 2),
                                  constant_values=fill))
    sig = _jax_significant(arr(mean2d, 0), arr(conic, 0), arr(opacity, 0),
                           arr(ids, -1), tiles_x)
    return torch.from_numpy(np.array(sig[:, :k]))


def significant(mean2d, conic, opacity, ids, tiles):
    """[N, 256] bool: is Gaussian n significant at pixel p of tile
    ``tiles[n]``?  The port's per-pair float32 expressions (those of
    ``rasterize._walk``), the cross-check of ``jax_significant``."""
    p = torch.arange(TILE * TILE)
    px = (tiles[:, None] % TILES_X * TILE + p % TILE).float() + 0.5
    py = (tiles[:, None] // TILES_X * TILE + p // TILE).float() + 0.5
    dx = px - mean2d[:, None, 0]
    dy = py - mean2d[:, None, 1]
    power = (-0.5 * (conic[:, None, 0] * dx * dx + conic[:, None, 2] * dy * dy)
             - conic[:, None, 1] * dx * dy)
    alpha = torch.clamp(opacity[:, None] * torch.exp(power), max=ALPHA_MAX)
    return (alpha > ALPHA_SIGNIFICANT) & (power <= 0.0) & (ids[:, None] >= 0)


def tile_grid(mean2d, conic, opacity, ids, tiles):
    """[9, N] lists: Gaussian n at list position n of its tile, every other
    position padding."""
    n = ids.shape[0]
    grid = torch.full((TILES_X * TILES_X, n), -1, dtype=torch.int32)
    grid[tiles, torch.arange(n)] = ids

    def rows(x):
        return x[None].expand(TILES_X * TILES_X, *x.shape).contiguous()
    return rows(mean2d), rows(conic), rows(opacity), grid


def cull_violations(mean2d, conic, opacity, ids, tiles):
    """(culled pairs, culled pairs with a significant pixel) of the mirror
    over N Gaussians, each in its own tile, significance by the JAX walk."""
    n = ids.shape[0]
    lists = tile_grid(mean2d, conic, opacity, ids, tiles)
    at = (tiles, torch.arange(n))
    keep = trk.tile_cull_plain(*lists, tiles_x=TILES_X)[at]
    sig = jax_significant(*lists, TILES_X)[at]
    sig_band = sig.reshape(n, TILE // trk.BAND_ROWS, -1).any(-1)
    culled = ~keep & (ids >= 0)[:, None]
    return int(culled.sum()), int((culled & sig_band).sum())


def _conic(sx, sy, theta):
    """Inverse covariance (a, b, c) of an ellipse with axis sigmas sx, sy."""
    cs, sn = math.cos(theta), math.sin(theta)
    ia, ib = 1.0 / (sx * sx), 1.0 / (sy * sy)
    return (cs * cs * ia + sn * sn * ib, cs * sn * (ia - ib),
            sn * sn * ia + cs * cs * ib)


OPACITIES = [0.0, 1e-3, K_SIG * (1 - 2e-7), K_SIG, K_SIG * (1 + 2e-7),
             0.0040, 0.05, 0.5, 0.99, 1.0, 1.5, math.inf, math.nan]
gaussian = st.tuples(
    st.floats(-3.0, 2.5),                    # log10 sigma, major axis (px)
    st.floats(-3.0, 2.5),                    # log10 sigma, minor axis (px)
    st.floats(0.0, math.pi),                 # orientation
    st.sampled_from(OPACITIES + [None] * 4), # None: uniform opacity
    st.floats(0.0, 1.0),                     # that uniform opacity
    st.sampled_from(['inside', 'border', 'far', 'ellipse_edge']),
    st.floats(-1.0, 1.0), st.floats(-1.0, 1.0),
    st.sampled_from(['ok'] * 8 + ['singular', 'rho_limit', 'nan', 'inf',
                                  'negative']),
    st.integers(0, TILES_X * TILES_X - 1),
    st.floats(0.995, 1.005))                 # ellipse_edge: distance factor


def make_gaussians(draws):
    """Tensors of N drawn Gaussians and their tiles."""
    means, conics, ops, tiles = [], [], [], []
    for (ls1, ls2, theta, op_pick, op_u, where, fx, fy, kind, tile,
         edge) in draws:
        a, b, c = _conic(10 ** ls1, 10 ** ls2, theta)
        if kind == 'singular':
            b = math.copysign(math.sqrt(a * c), b or 1.0)
        elif kind == 'rho_limit':
            b = math.copysign((1 - 2 ** -11) * math.sqrt(a * c), b or 1.0)
        elif kind == 'nan':
            a = math.nan
        elif kind == 'inf':
            c = math.inf
        elif kind == 'negative':
            a = -a
        op = op_u if op_pick is None else op_pick
        x0, y0 = tile % TILES_X * TILE, tile // TILES_X * TILE
        if where == 'inside':
            mx, my = x0 + 8 + 8 * fx, y0 + 8 + 8 * fy
        elif where == 'border':
            mx, my = x0 + 8 + 8.6 * math.copysign(1, fx), y0 + 8 + 9 * fy
        elif where == 'far':
            mx, my = x0 + 8 + 400 * fx, y0 + 8 + 400 * fy
        else:
            # the mean just outside a tile edge, at the tangent distance of
            # the ellipse alpha = 1/255 (times ``edge``) along x or y
            det = a * c - b * b
            r2 = 2 * math.log(max(op, 1e-30) / K_SIG) if op == op and op > 0 else 0.0
            ok = det > 0 and r2 > 0 and math.isfinite(det) and a > 0 and c > 0
            ex = math.sqrt(r2 * c / det) if ok else 4.0
            ey = math.sqrt(r2 * a / det) if ok else 4.0
            if fx > 0:
                mx = x0 + 15.5 + ex * edge if fy > 0 else x0 + 0.5 - ex * edge
                my = y0 + 8 + 7.5 * fy
            else:
                my = y0 + 15.5 + ey * edge if fy > 0 else y0 + 0.5 - ey * edge
                mx = x0 + 8 + 7.5 * fx
        means.append((mx, my))
        conics.append((a, b, c))
        ops.append(op)
        tiles.append(tile)
    ids = torch.arange(len(draws), dtype=torch.int32)
    return (torch.tensor(means, dtype=torch.float32),
            torch.tensor(conics, dtype=torch.float32),
            torch.tensor(ops, dtype=torch.float32), ids,
            torch.tensor(tiles))


@settings(max_examples=150, deadline=None)
@given(st.lists(gaussian, min_size=1, max_size=48))
def test_culled_pairs_have_no_significant_pixel(draws):
    mean2d, conic, opacity, ids, tiles = make_gaussians(draws)
    _, bad = cull_violations(mean2d, conic, opacity, ids, tiles)
    assert bad == 0


def _seeded_batch(n=4000, seed=0):
    rng = np.random.default_rng(seed)
    kinds = ['inside', 'border', 'far', 'ellipse_edge']
    draws = [(rng.uniform(-1, 2), rng.uniform(-1, 2), rng.uniform(0, math.pi),
              None, rng.uniform(0.005, 1.0), kinds[rng.integers(0, 4)],
              rng.uniform(-1, 1), rng.uniform(-1, 1), 'ok',
              int(rng.integers(0, 9)), rng.uniform(0.995, 1.005))
             for _ in range(n)]
    return make_gaussians(draws)


def test_seeded_batch_culls_without_violations():
    mean2d, conic, opacity, ids, tiles = _seeded_batch()
    culled, bad = cull_violations(mean2d, conic, opacity, ids, tiles)
    assert bad == 0
    assert culled > 0.3 * ids.numel() * (TILE // trk.BAND_ROWS)


def test_the_check_catches_an_over_eager_cull(monkeypatch):
    """The property above can fail: with the radius shrunk by 5 %, pairs on
    the ellipse's edge are culled while a pixel is still significant."""
    mean2d, conic, opacity, ids, tiles = _seeded_batch()
    monkeypatch.setattr(trk, '_CULL_PAD', 0.9)
    _, bad = cull_violations(mean2d, conic, opacity, ids, tiles)
    assert bad > 0


def test_port_arithmetic_matches_the_jax_walk():
    """The cross-check: the port's per-pair expressions and the JAX
    package's walk agree on which pixels each seeded Gaussian is
    significant at."""
    mean2d, conic, opacity, ids, tiles = _seeded_batch(1000, seed=1)
    n = ids.shape[0]
    want = jax_significant(*tile_grid(mean2d, conic, opacity, ids, tiles),
                           TILES_X)[tiles, torch.arange(n)]
    got = significant(mean2d, conic, opacity, ids, tiles)
    assert int(want.sum()) > 0
    assert torch.equal(got, want)


@pytest.fixture(scope='module')
def frame_features():
    """The JAX package's tile features of one 64x64 frame (4x4 tiles) of
    ``structured_scene(PRNGKey(7), 800)``."""
    scene = jax.jit(jax_structured_scene, static_argnums=1)(
        jax.random.PRNGKey(7), 800)
    cam = jax_orbit(8, width=64, height_px=64)[5]

    @jax.jit
    def prep(scene, cam):
        proj = jproj.project(scene, cam)
        lists = jsorting.sort_scene(proj, 64, 64, 128)
        return jtiling.gather_tile_features(proj, lists)

    return [interop.tensor(np.asarray(x), device='cpu') for x in prep(scene, cam)]


def test_real_tile_lists_are_culled_exactly(frame_features):
    mean2d, conic, _, opacity, ids = frame_features
    t, k = ids.shape
    keep = trk.tile_cull_plain(mean2d, conic, opacity, ids, tiles_x=4)
    valid = ids >= 0
    culled = ~keep & valid[..., None]
    assert int(culled.sum()) > 0
    # every culled (Gaussian, band) pair: no significant pixel in the band
    sig = jax_significant(mean2d, conic, opacity, ids, 4)
    sig_band = sig.reshape(t, k, TILE // trk.BAND_ROWS, -1).any(-1)
    assert int((culled & sig_band).sum()) == 0
    # some valid Gaussian of the lists is significant somewhere
    assert int(sig_band.sum()) > 0
