"""Parity of the port's tiling, sorting, cache-group reshaping and S^2
helpers with the JAX package, on the CPU.

Sorting is fed the JAX package's own ``Projected`` (through numpy), so the
tile lists are held exactly without resting on projection's floats: the
indices and counts of ``tile_lists_dense`` and ``tile_lists_sorted``, with
and without the S^2 radius margin.  Floats (features gathered from a
projection the port computed itself) are held to 128 ulps x magnitude.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import groups as jgroups
from repro.core import projection as jproj
from repro.core import s2 as js2
from repro.core import sorting as jsorting
from repro.core import tiling as jtiling
from repro.data.scenes import structured_scene as jax_structured_scene
from repro.data.trajectory import orbit_trajectory as jax_orbit

from repro_torch import interop
from repro_torch.core import groups as tgroups
from repro_torch.core import projection as tproj
from repro_torch.core import s2 as ts2
from repro_torch.core import sorting as tsorting
from repro_torch.core import tiling as ttiling


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


jproject = jax.jit(jproj.project)
jsort_scene = jax.jit(jsorting.sort_scene, static_argnums=(1, 2, 3),
                      static_argnames=('method', 'radius_margin'))
jlists_sorted = jax.jit(jtiling.tile_lists_sorted, static_argnums=(1, 2, 3),
                        static_argnames=('max_tiles_per_gaussian',))
jlists_dense = jax.jit(jtiling.tile_lists_dense, static_argnums=(1, 2, 3))
jspeculative_sort = jax.jit(js2.speculative_sort, static_argnames=(
    'margin', 'capacity', 'method'))
jshared_features = jax.jit(js2.shared_features)


def _np(x):
    return x.detach().cpu().numpy()


def to_scene(scene):
    return interop.scene_from_numpy(*[np.asarray(x) for x in scene], device='cpu')


def to_cam(c):
    return interop.camera_from_numpy(c.position, c.quat, c.fx, c.fy, c.cx, c.cy,
                                     c.width, c.height, c.near, c.far,
                                     device='cpu')


def to_proj(p) -> tproj.Projected:
    return tproj.Projected(*(interop.tensor(np.asarray(x), device='cpu') for x in p))


@pytest.fixture(scope='module')
def jscene():
    return jax.jit(jax_structured_scene, static_argnums=1)(
        jax.random.PRNGKey(7), 800)


@pytest.fixture(scope='module')
def jcams():
    return jax_orbit(8, width=64, height_px=64)


@pytest.mark.parametrize('method', ['dense', 'sorted'])
@pytest.mark.parametrize('frame,margin', [(0, 0.0), (4, 0.0), (7, 4.0)])
def test_tile_lists_match_exactly(jscene, jcams, method, frame, margin):
    cam = jcams[frame]
    jp = jproject(jscene, cam)
    want = jsort_scene(jp, cam.width, cam.height, 128, method=method,
                       radius_margin=margin)
    got = tsorting.sort_scene(to_proj(jp), cam.width, cam.height, 128,
                              method=method, radius_margin=margin)
    assert (got.tiles_x, got.tiles_y) == (want.tiles_x, want.tiles_y)
    np.testing.assert_array_equal(_np(got.indices), np.asarray(want.indices))
    np.testing.assert_array_equal(_np(got.count), np.asarray(want.count))
    assert int(np.asarray(want.count).sum()) > 500


def test_sorted_lists_on_an_expanded_grid_match(jscene, jcams):
    """The expanded S^2 viewport, with a capacity small enough to truncate."""
    from repro.core.camera import expand_viewport
    cam = expand_viewport(jcams[2], 16)
    jp = jproject(jscene, cam)
    want = jlists_sorted(jp, cam.width, cam.height, 48,
                         max_tiles_per_gaussian=9)
    got = ttiling.tile_lists_sorted(to_proj(jp), cam.width, cam.height, 48,
                                    max_tiles_per_gaussian=9)
    np.testing.assert_array_equal(_np(got.indices), np.asarray(want.indices))
    np.testing.assert_array_equal(_np(got.count), np.asarray(want.count))
    assert (np.asarray(want.count) == 48).any()


def test_depth_ties_keep_the_lower_index_first():
    n = 6
    depth = np.array([2.0, 1.0, 2.0, 1.0, 3.0, 2.0], np.float32)
    mean2d = np.full((n, 2), 8.0, np.float32)
    fields = dict(mean2d=mean2d, conic=np.ones((n, 3), np.float32),
                  radius=np.full((n,), 4.0, np.float32), depth=depth,
                  color=np.ones((n, 3), np.float32),
                  opacity=np.ones((n,), np.float32),
                  valid=np.ones((n,), bool))
    jp = jproj.Projected(**{k: jnp.asarray(v) for k, v in fields.items()})
    tp = tproj.Projected(**{k: torch.from_numpy(v) for k, v in fields.items()})
    want = jlists_dense(jp, 16, 16, 8)
    dense = ttiling.tile_lists_dense(tp, 16, 16, 8)
    np.testing.assert_array_equal(_np(dense.indices), np.asarray(want.indices))
    assert _np(dense.indices)[0, :6].tolist() == [1, 3, 0, 2, 5, 4]
    srt = ttiling.tile_lists_sorted(tp, 16, 16, 8, max_tiles_per_gaussian=1)
    assert _np(srt.indices)[0, :6].tolist() == [1, 3, 0, 2, 5, 4]


def test_gather_tile_features_matches(jscene, jcams):
    cam = jcams[1]
    jp = jproject(jscene, cam)
    lists = jsort_scene(jp, cam.width, cam.height, 128)
    want = jtiling.gather_tile_features(jp, lists)
    tl = ttiling.TileLists(interop.tensor(np.asarray(lists.indices), device='cpu'),
                           interop.tensor(np.asarray(lists.count), device='cpu'),
                           lists.tiles_x, lists.tiles_y)
    got = ttiling.gather_tile_features(to_proj(jp), tl)
    for field in ('mean2d', 'conic', 'color', 'opacity', 'ids'):
        np.testing.assert_array_equal(_np(getattr(got, field)),
                                      np.asarray(getattr(want, field)), field)


@pytest.mark.parametrize('tiles_x,tiles_y,gt', [(4, 4, 4), (6, 4, 4), (5, 3, 4),
                                                (120, 68, 4)])
def test_groups_match(tiles_x, tiles_y, gt):
    assert tgroups.group_dims(tiles_x, tiles_y, gt) == \
        jgroups.group_dims(tiles_x, tiles_y, gt)
    assert tgroups.num_groups(tiles_x * 16, tiles_y * 16, gt) == \
        jgroups.num_groups(tiles_x * 16, tiles_y * 16, gt)
    if tiles_x * tiles_y > 100:
        return
    x = np.arange(tiles_x * tiles_y * 256 * 2, dtype=np.int32).reshape(
        tiles_x * tiles_y, 256, 2)
    want = jgroups.regroup(jnp.asarray(x), tiles_x, tiles_y, gt)
    got = tgroups.regroup(torch.from_numpy(x), tiles_x, tiles_y, gt)
    np.testing.assert_array_equal(_np(got), np.asarray(want))
    back = tgroups.ungroup(got, tiles_x, tiles_y, gt)
    np.testing.assert_array_equal(_np(back), x)


def test_predict_pose_matches(jcams):
    for frame_idx in (0, 5):
        want = js2.predict_window_pose(jcams[2], jcams[3], jnp.int32(frame_idx), 6)
        got = ts2.predict_window_pose(to_cam(jcams[2]), to_cam(jcams[3]),
                                      frame_idx, 6)
        assert_images_ulp_close(_np(got.position), want.position,
                                err_msg='position')
        assert_images_ulp_close(_np(got.quat), want.quat, err_msg='quat')


@pytest.mark.parametrize('method', ['dense', 'sorted'])
def test_speculative_sort_and_shared_features_match(jscene, jcams, method):
    pred = js2.predict_window_pose(jcams[0], jcams[1], jnp.int32(1), 3)
    want = jspeculative_sort(jscene, pred, margin=4, capacity=128,
                             method=method)
    scene = to_scene(jscene)
    got = ts2.speculative_sort(scene, to_cam(pred), margin=4, capacity=128,
                               method=method)
    assert (got.margin_tiles, got.render_tiles_x, got.render_tiles_y) == \
        (want.margin_tiles, want.render_tiles_x, want.render_tiles_y)
    np.testing.assert_array_equal(_np(got.lists.indices),
                                  np.asarray(want.lists.indices))
    np.testing.assert_array_equal(_np(got.proj.valid),
                                  np.asarray(want.proj.valid))

    jf, jl = jshared_features(jscene, jcams[2], want)
    tf, tl = ts2.shared_features(scene, to_cam(jcams[2]), got)
    np.testing.assert_array_equal(_np(tl.indices), np.asarray(jl.indices))
    np.testing.assert_array_equal(_np(tl.count), np.asarray(jl.count))
    np.testing.assert_array_equal(_np(tf.ids), np.asarray(jf.ids))
    for field in ('mean2d', 'conic', 'color', 'opacity'):
        assert_images_ulp_close(_np(getattr(tf, field)),
                                np.asarray(getattr(jf, field)), err_msg=field)
