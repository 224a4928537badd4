"""Parity of the port's scene math, cameras, projection and scene/trajectory
generators with the JAX package, on the CPU.

Inputs come from the JAX package (``structured_scene(PRNGKey(7), 800)``,
``orbit_trajectory(8, width=64, height_px=64)``) and cross to the port
through numpy (``repro_torch.interop``).  Floats are held to 128 ulps x
magnitude (``exp``, ``sqrt`` and matrix products may differ by an ulp
between the frameworks); integer and boolean outputs exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.lumina_3dgs import CONFIG as JAX_CONFIG
from repro.core import camera as jcam
from repro.core import gaussians as jg
from repro.core import metrics as jmetrics
from repro.core import projection as jproj
from repro.data.scenes import structured_scene as jax_structured_scene
from repro.data.trajectory import orbit_trajectory as jax_orbit

from repro_torch import interop
from repro_torch.configs.lumina_3dgs import CONFIG
from repro_torch.core import camera as tcam
from repro_torch.core import gaussians as tg
from repro_torch.core import metrics as tmetrics
from repro_torch.core import projection as tproj
from repro_torch.core import tiling as ttiling
from repro_torch.data.scenes import structured_scene
from repro_torch.data.trajectory import orbit_trajectory


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


def _np(x):
    return x.detach().cpu().numpy()


def to_scene(scene):
    return interop.scene_from_numpy(*[np.asarray(x) for x in scene], device='cpu')


def to_cam(c):
    return interop.camera_from_numpy(c.position, c.quat, c.fx, c.fy, c.cx, c.cy,
                                     c.width, c.height, c.near, c.far,
                                     device='cpu')


@pytest.fixture(scope='module')
def jscene():
    return jax.jit(jax_structured_scene, static_argnums=1)(
        jax.random.PRNGKey(7), 800)


@pytest.fixture(scope='module')
def jcams():
    return jax_orbit(8, width=64, height_px=64)


def test_constants_and_config_match():
    for name in ('ALPHA_SIGNIFICANT', 'TRANSMITTANCE_EPS', 'ALPHA_MAX',
                 'SH_C0', 'SH_C1'):
        assert getattr(tg, name) == getattr(jg, name), name
    assert (tproj.COV2D_BLUR, tproj.CUTOFF_SIGMA) == (jproj.COV2D_BLUR,
                                                       jproj.CUTOFF_SIGMA)
    assert ttiling.TILE == 16
    assert dataclasses.asdict(CONFIG) == dataclasses.asdict(JAX_CONFIG)
    assert dataclasses.asdict(CONFIG.reduced()) == \
        dataclasses.asdict(JAX_CONFIG.reduced())


def test_scene_is_a_module_of_parameters(jscene):
    scene = to_scene(jscene)
    assert isinstance(scene, torch.nn.Module)
    names = [n for n, _ in scene.named_parameters()]
    assert names == list(tg.FIELDS)
    assert scene.num_gaussians == 800


def test_gaussian_math_matches(jscene, jcams):
    scene = to_scene(jscene)
    assert_images_ulp_close(_np(tg.quat_to_rotmat(scene.quats)),
                            jg.quat_to_rotmat(jscene.quats), err_msg='rotmat')
    assert_images_ulp_close(_np(tg.covariances_3d(scene)),
                            jg.covariances_3d(jscene), err_msg='cov3d')
    assert_images_ulp_close(_np(tg.opacities(scene)), jg.opacities(jscene),
                            err_msg='opacity')
    dirs = np.asarray(jscene.means) - np.asarray(jcams[3].position)[None]
    assert_images_ulp_close(_np(tg.eval_sh(scene, torch.from_numpy(dirs))),
                            jg.eval_sh(jscene, jnp.asarray(dirs)),
                            err_msg='eval_sh')


@pytest.mark.parametrize('frame', [0, 3, 7])
def test_project_matches(jscene, jcams, frame):
    want = jproject(jscene, jcams[frame])
    got = tproj.project(to_scene(jscene), to_cam(jcams[frame]))
    np.testing.assert_array_equal(_np(got.valid), np.asarray(want.valid))
    np.testing.assert_array_equal(_np(got.radius), np.asarray(want.radius))
    np.testing.assert_array_equal(np.isinf(_np(got.depth)),
                                  np.isinf(np.asarray(want.depth)))
    v = np.asarray(want.valid)
    assert v.sum() > 100
    for field in ('mean2d', 'conic', 'color', 'opacity'):
        assert_images_ulp_close(_np(getattr(got, field))[v],
                                np.asarray(getattr(want, field))[v],
                                err_msg=field)
    assert_images_ulp_close(_np(got.depth)[v], np.asarray(want.depth)[v],
                            err_msg='depth')


def test_reproject_geometry_matches(jscene, jcams):
    jp0 = jproject(jscene, jcams[0])
    want = jproj.reproject_geometry(jscene, jcams[2], jp0)
    scene = to_scene(jscene)
    got = tproj.reproject_geometry(scene, to_cam(jcams[2]),
                                   tproj.project(scene, to_cam(jcams[0])))
    np.testing.assert_array_equal(_np(got.valid), np.asarray(want.valid))
    np.testing.assert_array_equal(_np(got.radius), np.asarray(want.radius))
    v = np.asarray(want.valid)
    assert_images_ulp_close(_np(got.mean2d)[v], np.asarray(want.mean2d)[v],
                            err_msg='mean2d')
    assert_images_ulp_close(_np(got.opacity), np.asarray(want.opacity),
                            err_msg='opacity')


def test_camera_utilities_match():
    pos, quat = jcam.look_at((0.3, 0.4, 2.0), (0.0, 0.0, 0.0))
    tpos, tquat = tcam.look_at((0.3, 0.4, 2.0), (0.0, 0.0, 0.0))
    assert_images_ulp_close(_np(tpos), pos, err_msg='position')
    assert_images_ulp_close(_np(tquat), quat, err_msg='look_at quat')

    rng = np.random.default_rng(0)
    for _ in range(4):
        q = rng.normal(size=4).astype(np.float32)
        r = np.array(jg.quat_to_rotmat(jnp.asarray(q)))
        assert_images_ulp_close(_np(tcam.rotmat_to_quat(torch.from_numpy(r))),
                                jcam.rotmat_to_quat(jnp.asarray(r)),
                                err_msg='rotmat_to_quat')
    q0 = rng.normal(size=4).astype(np.float32)
    q1 = q0 + 0.05 * rng.normal(size=4).astype(np.float32)
    for t in (0.5, 1.0, 4.0):
        assert_images_ulp_close(
            _np(tcam.slerp(torch.from_numpy(q0), torch.from_numpy(q1), t)),
            jcam.slerp(jnp.asarray(q0), jnp.asarray(q1), t), err_msg='slerp')

    jc = jcam.make_camera(pos, quat, 60.0, 96, 64)
    tc = tcam.make_camera(tpos, tquat, 60.0, 96, 64)
    for field in ('fx', 'fy', 'cx', 'cy'):
        assert_images_ulp_close(_np(getattr(tc, field)), getattr(jc, field),
                                err_msg=field)
    je, te = jcam.expand_viewport(jc, 16), tcam.expand_viewport(tc, 16)
    assert (te.width, te.height) == (je.width, je.height)
    assert_images_ulp_close(_np(te.cx), je.cx, err_msg='expanded cx')


def test_orbit_trajectory_matches(jcams):
    cams = orbit_trajectory(8, width=64, height_px=64, device='cpu')
    assert len(cams) == len(jcams)
    for c, j in zip(cams, jcams):
        assert (c.width, c.height, c.near, c.far) == (j.width, j.height,
                                                      j.near, j.far)
        for field in ('position', 'quat', 'fx', 'fy', 'cx', 'cy'):
            assert_images_ulp_close(_np(getattr(c, field)), getattr(j, field),
                                    err_msg=field)


def test_structured_scene_is_seeded_and_sane(jscene):
    a = structured_scene(3, 800, device='cpu')
    b = structured_scene(torch.Generator().manual_seed(3), 800, device='cpu')
    c = structured_scene(4, 800, device='cpu')
    assert a.means.shape == (800, 3) and a.sh_rest.shape == (800, 3, 3)
    for name in tg.FIELDS:
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == torch.float32 and bool(torch.isfinite(x).all())
        assert torch.equal(x, y), name
    assert not torch.equal(a.means, c.means)
    # the same surfaces and ranges as the JAX generator
    j = jscene
    for name in ('log_scales', 'opacity_logit', 'sh_dc'):
        lo, hi = float(np.min(getattr(j, name))), float(np.max(getattr(j, name)))
        x = _np(getattr(a, name))
        span = hi - lo
        assert x.min() >= lo - 0.05 * span and x.max() <= hi + 0.05 * span, name


def test_psnr_matches():
    rng = np.random.default_rng(1)
    a = rng.random((16, 16, 3), dtype=np.float32)
    b = a + 0.01 * rng.standard_normal((16, 16, 3)).astype(np.float32)
    got = float(tmetrics.psnr(torch.from_numpy(a), torch.from_numpy(b)))
    want = float(jmetrics.psnr(jnp.asarray(a), jnp.asarray(b)))
    assert abs(got - want) < 1e-4
