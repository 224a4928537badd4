"""The port's single-viewer frame against the JAX package, end to end, on
the CPU, plus the structure rules of the port.

The decision stream of ``tests/test_golden_trace.py::trace_digests`` (sort
cadence, hit count, sha256 of the cache's ``tags`` and ``age``, clock) is
computed live on both sides for 8 frames of ``structured_scene(PRNGKey(7),
800)`` at 64x64 (capacity 128, window 3): the JAX ``'reference'`` backend
against the port's ``'reference'``, and JAX ``'pallas'`` (interpret mode,
``'seq'`` body) against the port's ``'kernel'`` (plain versions on the CPU).
The streams must be identical and the images within 128 ulps x magnitude.
"""
import hashlib
import importlib
import pathlib
import pkgutil
import re
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.core import pipeline as jpipe
from repro.data.scenes import structured_scene as jax_structured_scene
from repro.data.trajectory import orbit_trajectory as jax_orbit

import repro_torch
from repro_torch import interop
from repro_torch.core import pipeline as tpipe
from repro_torch.data.scenes import structured_scene
from repro_torch.data.trajectory import orbit_trajectory

ROOT = pathlib.Path(__file__).resolve().parents[1]
SEED, GAUSSIANS, FRAMES, WIDTH = 7, 800, 8, 64
CAPACITY, WINDOW = 128, 3


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


def _digest(arr) -> str:
    return hashlib.sha256(np.ascontiguousarray(np.asarray(arr))
                          .tobytes()).hexdigest()[:16]


def _row(frame, image, stats, cache) -> dict:
    n_pix = int(np.prod(np.asarray(image).shape[:2]))
    return {'frame': frame, 'sorted': int(float(stats.sorted_this_frame)),
            'hits': round(float(stats.hit_rate) * n_pix),
            'tags': _digest(cache.tags), 'age': _digest(cache.age),
            'clock': int(np.asarray(cache.clock).max())}


def to_cam(c):
    return interop.camera_from_numpy(c.position, c.quat, c.fx, c.fy, c.cx, c.cy,
                                     c.width, c.height, c.near, c.far,
                                     device='cpu')


@pytest.fixture(scope='module')
def inputs():
    scene = jax.jit(jax_structured_scene, static_argnums=1)(
        jax.random.PRNGKey(SEED), GAUSSIANS)
    cams = jax_orbit(FRAMES, width=WIDTH, height_px=WIDTH)
    tscene = interop.scene_from_numpy(*[np.asarray(x) for x in scene], device='cpu')
    return scene, cams, tscene, [to_cam(c) for c in cams]


def run_jax(scene, cams, cfg):
    state = jpipe.init_viewer_state(scene, cfg, cams[0])
    step = jax.jit(lambda st, cm: jpipe.render_step(scene, st, cm, cfg))
    rows, images, stats_all = [], [], []
    for f, cam in enumerate(cams):
        state, image, stats = step(state, cam)
        rows.append(_row(f, image, stats, state.cache))
        images.append(np.asarray(image))
        stats_all.append(stats)
    return rows, images, stats_all


def run_port(scene, cams, cfg):
    sys_ = tpipe.LuminSys(scene, cfg, cams[0], device='cpu')
    rows, images, stats_all = [], [], []
    for f, cam in enumerate(cams):
        image, stats = sys_.step(cam)
        cache = sys_.cache
        rows.append(_row(f, image.numpy(),
                         stats, tpipe.rc.CacheState(
                             cache.tags.numpy(), cache.values.numpy(),
                             cache.age.numpy(), cache.clock.numpy())))
        images.append(image.numpy())
        stats_all.append(stats)
    return rows, images, stats_all


def assert_streams_match(jax_run, port_run):
    (jrows, jimgs, jstats), (trows, timgs, tstats) = jax_run, port_run
    for w, g in zip(jrows, trows):
        assert g == w, f'frame {w["frame"]}: port {g} != JAX {w}'
    assert len(trows) == len(jrows)
    for f, (a, b) in enumerate(zip(timgs, jimgs)):
        assert a.shape == b.shape
        assert_images_ulp_close(a, b, err_msg=f'frame {f}')
    for a, b in zip(tstats, jstats):
        for field in ('sig_frac', 'mean_iterated', 'saved_frac'):
            assert abs(float(getattr(a, field)) - float(getattr(b, field))) \
                < 1e-5, field


@pytest.mark.parametrize('jax_backend,port_backend', [('reference', 'reference'),
                                                      ('pallas', 'kernel')])
def test_decision_stream_matches_jax(inputs, jax_backend, port_backend):
    scene, cams, tscene, tcams = inputs
    want = run_jax(scene, cams, jpipe.LuminaConfig(
        capacity=CAPACITY, window=WINDOW, backend=jax_backend))
    got = run_port(tscene, tcams, tpipe.LuminaConfig(
        capacity=CAPACITY, window=WINDOW, backend=port_backend))
    assert_streams_match(want, got)
    assert sum(r['sorted'] for r in got[0]) == 3
    assert min(r['hits'] for r in got[0][1:]) > 2000


@pytest.mark.parametrize('options', [dict(use_rc=False),
                                     dict(use_s2=False, rc_compact=False,
                                          sort_method='sorted')])
def test_kernel_backend_variants_match_jax(inputs, options):
    scene, cams, tscene, tcams = inputs
    want = run_jax(scene, cams[:3], jpipe.LuminaConfig(
        capacity=CAPACITY, window=WINDOW, backend='pallas', **options))
    got = run_port(tscene, tcams[:3], tpipe.LuminaConfig(
        capacity=CAPACITY, window=WINDOW, backend='kernel', **options))
    assert_streams_match(want, got)


def test_render_frame_baseline_matches_jax(inputs):
    scene, cams, tscene, tcams = inputs
    jcfg = jpipe.LuminaConfig(capacity=CAPACITY)
    tcfg = tpipe.LuminaConfig(capacity=CAPACITY)
    image_j, _, aux_j, lists_j = jax.jit(
        lambda s, c: jpipe.render_frame_baseline(s, c, jcfg))(scene, cams[4])
    image_t, _, aux_t, lists_t = tpipe.render_frame_baseline(
        tscene, tcams[4], tcfg, device='cpu')
    np.testing.assert_array_equal(lists_t.indices.numpy(),
                                  np.asarray(lists_j.indices))
    for field in ('alpha_record', 'n_significant', 'n_iterated', 'iter_at_k'):
        np.testing.assert_array_equal(getattr(aux_t, field).numpy(),
                                      np.asarray(getattr(aux_j, field)), field)
    assert_images_ulp_close(image_t.numpy(), image_j, err_msg='baseline image')


def test_entry_points_default_to_the_card(inputs, monkeypatch):
    _, _, tscene, tcams = inputs
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    cfg = tpipe.LuminaConfig(capacity=CAPACITY)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        tpipe.LuminSys(tscene, cfg, tcams[0])
    with pytest.raises(RuntimeError, match='no CUDA device'):
        tpipe.render_frame_baseline(tscene, tcams[0], cfg)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        structured_scene(0, 30)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        orbit_trajectory(2)
    with pytest.raises(ValueError, match='lies on'):
        tpipe.LuminSys(tscene, cfg, tcams[0], device='meta')


def test_config_names_the_kernel_backend():
    with pytest.raises(ValueError, match='unknown shade backend'):
        tpipe.LuminaConfig(backend='pallas')
    cfg = tpipe.LuminaConfig(k_record=3, backend='kernel')
    assert cfg.cache.k == 3


def _port_modules():
    names = [repro_torch.__name__]
    for info in pkgutil.walk_packages(repro_torch.__path__,
                                      repro_torch.__name__ + '.'):
        names.append(info.name)
    return names


def test_port_imports_neither_jax_nor_the_jax_package():
    modules = _port_modules()
    assert len(modules) >= 20
    code = ('import importlib, sys\n'
            f'for m in {modules!r}:\n'
            '    importlib.import_module(m)\n'
            'bad = sorted(m for m in sys.modules if m == "jax" or '
            'm.startswith("jax.") or m == "repro" or m.startswith("repro."))\n'
            'print(bad)\n'
            'sys.exit(1 if bad else 0)\n')
    out = subprocess.run([sys.executable, '-c', code], capture_output=True,
                         text=True, timeout=120,
                         env={'PYTHONPATH': str(ROOT / 'src'),
                              'PATH': '/usr/bin:/bin'})
    assert out.returncode == 0, out.stdout + out.stderr
    forbidden = re.compile(r'^\s*(import jax|from jax|import repro\.|from repro[ .])',
                           re.M)
    sources = list((ROOT / 'src' / 'repro_torch').rglob('*.py'))
    sources.append(ROOT / 'chip_smoke.py')
    for path in sources:
        assert not forbidden.search(path.read_text()), path
    for name in modules:    # every module imports in this process too
        importlib.import_module(name)


def test_chip_smoke_refuses_without_a_card_or_the_repo(tmp_path):
    here = subprocess.run([sys.executable, str(ROOT / 'chip_smoke.py')],
                          capture_output=True, text=True, timeout=300,
                          env={'CUDA_VISIBLE_DEVICES': '', 'PATH': '/usr/bin:/bin'})
    assert here.returncode != 0 and here.stdout == '', here.stdout
    shutil.copy(ROOT / 'chip_smoke.py', tmp_path / 'chip_smoke.py')
    alone = subprocess.run([sys.executable, str(tmp_path / 'chip_smoke.py')],
                           capture_output=True, text=True, timeout=300,
                           cwd=tmp_path)
    assert alone.returncode != 0 and alone.stdout == '', alone.stdout
