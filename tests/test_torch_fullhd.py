"""The port against the JAX package at the paper's resolution, 1920x1080,
on the CPU: the sorted path on the expanded grid, the S^2 prep and the
reference rasterizer, where the 64-px fixtures of the other files cannot
show a fault that depends on the grid size.

Fixture: ``structured_scene(PRNGKey(7), 8000)`` and two frames of
``orbit_trajectory`` at 1920x1080, with ``window=6``, ``margin=4``,
``sort_method='sorted'`` and capacity 16, so that about a third of the
lists are cut at capacity.  Frame 0 sorts on the 122x70 expanded grid and
frame 1 shades from that sort.  Both sides run the ``'reference'`` backend
(the kernel backend is held against the reference backend at full width on
the card, by ``chip_smoke.py``).

What is exact and what is not.  The sort (tile lists and counts) is held
exactly.  The rasterizer's per-pixel state is not exact at this size, even
on identical features: ``jnp.exp`` and ``torch.exp`` differ by one ulp on
about a tenth of inputs, and among 2M pixels times 16 Gaussians a few
alphas lie within an ulp of the 1/255 significance threshold.  Such a pixel
gains or loses one record entry, which changes its cache key, the hit count
and which pixel wins an insert.  So per-pixel state and cache slots are
held on all but ``FLIP_FRAC`` of them, and the rest within 128 ulps x
magnitude.  Image pixels are held on all but ``IMAGE_FRAC``: a value
inserted by a flipped pixel is served to every pixel that later hits its
entry (40 pixels for one entry in this fixture).  ROADMAP.md queue 3
records this fixture.
"""
import jax
import numpy as np
import pytest
import torch

from repro.core import pipeline as jpipe
from repro.core import rasterize as jrast
from repro.data.scenes import structured_scene as jax_structured_scene
from repro.data.trajectory import orbit_trajectory as jax_orbit

from repro_torch import interop
from repro_torch.core import pipeline as tpipe
from repro_torch.core import rasterize as trast
from repro_torch.core.tiling import TileFeatures

SEED, GAUSSIANS, WIDTH, HEIGHT = 7, 8000, 1920, 1080
KW = dict(capacity=16, window=6, margin=4, sort_method='sorted')
# threshold flips allowed, as a fraction of pixels (or of cache slots):
# about 20 of 2,073,600 pixels
FLIP_FRAC = 1e-5
IMAGE_FRAC = 1e-4
ULPS = 128


def ulp_bad(got, want, ulps=ULPS, floor=1.0):
    """Mask of elements farther apart than ``ulps`` x float32-eps x
    magnitude (floored at ``floor``), the bound of tests/test_serve.py."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    scale = np.maximum(np.maximum(np.abs(got), np.abs(want)), floor)
    return np.abs(got - want) > np.float32(ulps) * np.finfo(np.float32).eps * scale


@pytest.fixture(scope='module')
def run():
    scene = jax.jit(jax_structured_scene, static_argnums=1)(
        jax.random.PRNGKey(SEED), GAUSSIANS)
    cams = jax_orbit(2, width=WIDTH, height_px=HEIGHT)
    tscene = interop.scene_from_numpy(*[np.asarray(x) for x in scene],
                                      device='cpu')
    tcams = [interop.camera_from_numpy(c.position, c.quat, c.fx, c.fy, c.cx,
                                       c.cy, c.width, c.height, c.near, c.far,
                                       device='cpu') for c in cams]
    jcfg = jpipe.LuminaConfig(**KW)
    tcfg = tpipe.LuminaConfig(**KW)
    state = jpipe.init_viewer_state(scene, jcfg, cams[0])
    step = jax.jit(lambda s, c: jpipe.render_step(scene, s, c, jcfg))
    sys_ = tpipe.LuminSys(tscene, tcfg, tcams[0], device='cpu')
    frames = []
    for f, (cam, tcam) in enumerate(zip(cams, tcams)):
        state, image, stats = step(state, cam)
        timage, tstats = sys_.step(tcam)
        frames.append(dict(
            jax=(np.asarray(image), float(stats.hit_rate),
                 float(stats.sorted_this_frame), np.asarray(state.cache.tags),
                 np.asarray(state.cache.clock)),
            port=(timage.numpy(), float(tstats.hit_rate),
                  float(tstats.sorted_this_frame), sys_.cache.tags.numpy(),
                  sys_.cache.clock.numpy())))
        if f == 0:
            lists = (state.shared.lists, sys_.state.shared.lists)
            # frame 1's S^2 prep from frame 0's sort, on both sides
            jfeats, jlists = jax.jit(
                lambda sh, c: jpipe._prep_features(scene, sh, c, jcfg))(
                    state.shared, cams[1])
            with torch.no_grad():
                tfeats, _ = tpipe._prep_features(tscene, sys_.state.shared,
                                                 tcams[1], tcfg)
    return dict(lists=lists, frames=frames, feats=(jfeats, tfeats),
                tiles_x=jlists.tiles_x)


def test_full_hd_sort_matches_jax_exactly(run):
    jl, tl = run['lists']
    assert (tl.tiles_x, tl.tiles_y) == (jl.tiles_x, jl.tiles_y) == (122, 70)
    np.testing.assert_array_equal(tl.indices.numpy(), np.asarray(jl.indices))
    np.testing.assert_array_equal(tl.count.numpy(), np.asarray(jl.count))
    full = int((np.asarray(jl.count) >= KW['capacity']).sum())
    assert full > 0.2 * jl.count.shape[0], full   # truncation is exercised


def test_full_hd_s2_prep_matches_jax(run):
    jf, tf = run['feats']
    np.testing.assert_array_equal(tf.ids.numpy(), np.asarray(jf.ids))
    for name in ('mean2d', 'conic', 'color', 'opacity'):
        # a pixel coordinate is cx + fx * x / z, a sum of terms as large as
        # the image: its magnitude floor is the width, not 1
        floor = float(WIDTH) if name == 'mean2d' else 1.0
        bad = ulp_bad(getattr(tf, name).numpy(), np.asarray(getattr(jf, name)),
                      floor=floor)
        assert not bad.any(), f'{name}: {int(bad.sum())} values past {ULPS} ulps'


def test_full_hd_rasterizer_on_jax_features(run):
    """Identical inputs: the port's reference rasterizer on JAX's frame-1
    features.  Only threshold flips may differ."""
    jf, _ = run['feats']
    tx = run['tiles_x']
    colors_j, aux_j = jax.jit(lambda f: jrast.rasterize_tiles(f, tx))(jf)
    feats = TileFeatures(*(interop.tensor(np.asarray(getattr(jf, n)), device='cpu')
                           for n in ('mean2d', 'conic', 'color', 'opacity', 'ids')))
    colors_t, aux_t = trast.rasterize_tiles(feats, tx)
    differs = np.zeros(aux_t.n_iterated.shape, bool)
    for field in ('alpha_record', 'n_significant', 'n_iterated', 'iter_at_k'):
        a, b = getattr(aux_t, field).numpy(), np.asarray(getattr(aux_j, field))
        differs |= (a != b).reshape(*differs.shape, -1).any(-1)
    assert differs.sum() <= FLIP_FRAC * differs.size, int(differs.sum())
    bad = ulp_bad(colors_t.numpy(), colors_j).any(-1)
    assert not (bad & ~differs).any(), 'colors differ where records agree'


@pytest.mark.parametrize('frame', [0, 1])
def test_full_hd_frame_matches_jax(run, frame):
    """Sort frame and shade frame through ``render_step`` on both sides."""
    (j_img, j_hit, j_sorted, j_tags, j_clock) = run['frames'][frame]['jax']
    (t_img, t_hit, t_sorted, t_tags, t_clock) = run['frames'][frame]['port']
    pixels = WIDTH * HEIGHT
    assert t_sorted == j_sorted == float(frame == 0)
    np.testing.assert_array_equal(t_clock, j_clock)
    assert abs(round(t_hit * pixels) - round(j_hit * pixels)) <= FLIP_FRAC * pixels
    if frame == 1:
        assert j_hit > 0.9
    slots = (t_tags != j_tags).any(-1)
    assert slots.sum() <= FLIP_FRAC * slots.size, int(slots.sum())
    assert t_img.shape == j_img.shape == (HEIGHT, WIDTH, 3)
    bad = ulp_bad(t_img, j_img).any(-1)
    assert bad.sum() <= IMAGE_FRAC * pixels, int(bad.sum())
