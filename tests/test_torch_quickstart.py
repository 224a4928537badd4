"""The port's quickstart loop (``repro_torch.tools.quickstart``) against
the JAX package's ``examples/quickstart.py`` loop, on the CPU.

JAX's ``structured_scene(PRNGKey(0), 600)`` reaches the port through
``interop``; 4 orbit frames at 64x64, capacity 1024, window 3, both
variants (S^2 alone, S^2 + RC).  The JAX side runs the example's calls
(``LuminSys.step``, ``render_frame_baseline``, ``psnr``, ``ssim``) here,
on its ``'reference'`` backend (the example's) against the port's
``'reference'``, and on its ``'pallas'`` backend (interpret mode) against
the port's ``'kernel'`` (plain versions on the CPU), whose ``saved_frac``
counts chunk iterations.  Per frame, ``sorted_this_frame``, the hit rate
and ``saved_frac`` must be equal; PSNR within ``PSNR_REL`` relative and
SSIM within ``SSIM_ABS``: the images differ by float32 roundings, which
move the PSNR of frames that S^2 renders almost exactly (81 dB) by up to
1.3e-3 dB and SSIM by up to 5.4e-7.
"""
import jax
import numpy as np
import pytest

from repro.core.metrics import psnr, ssim
from repro.core.pipeline import LuminaConfig, LuminSys, render_frame_baseline
from repro.data.scenes import structured_scene
from repro.data.trajectory import orbit_trajectory

from repro_torch import interop
from repro_torch.tools import quickstart
from torch_serve_parity import one_torch_thread  # noqa: F401

GAUSSIANS, FRAMES, SIZE = 600, 4, 64
CAPACITY, WINDOW = quickstart.CAPACITY, quickstart.WINDOW   # 1024, 3
PSNR_REL, SSIM_ABS = 1e-4, 2e-6


def to_cam(c):
    return interop.camera_from_numpy(c.position, c.quat, c.fx, c.fy, c.cx,
                                     c.cy, c.width, c.height, c.near, c.far,
                                     device='cpu')


@pytest.fixture(scope='module')
def inputs():
    scene = structured_scene(jax.random.PRNGKey(0), GAUSSIANS)
    cams = orbit_trajectory(FRAMES, width=SIZE, height_px=SIZE)
    tscene = interop.scene_from_numpy(*[np.asarray(x) for x in scene],
                                      device='cpu')
    return scene, cams, tscene, [to_cam(c) for c in cams]


def jax_rows(scene, cams, use_rc: bool, backend: str) -> list:
    """``examples/quickstart.py``'s loop for one variant, as rows."""
    cfg = LuminaConfig(capacity=CAPACITY, window=WINDOW, use_rc=use_rc,
                       backend=backend)
    sys_ = LuminSys(scene, cfg, cams[0])
    rows = []
    for cam in cams:
        img, stats = sys_.step(cam)
        exact, _, _, _ = render_frame_baseline(scene, cam, cfg)
        rows.append({'psnr': float(psnr(img, exact)),
                     'ssim': float(ssim(img, exact)),
                     'hit_rate': float(stats.hit_rate),
                     'saved_frac': float(stats.saved_frac),
                     'sorted': int(stats.sorted_this_frame)})
    return rows


@pytest.mark.parametrize('use_rc', (False, True))
@pytest.mark.parametrize('jax_backend,port_backend',
                         (('reference', 'reference'), ('pallas', 'kernel')))
def test_quickstart_rows_match_jax(inputs, use_rc, jax_backend,
                                   port_backend):
    scene, cams, tscene, tcams = inputs
    want = jax_rows(scene, cams, use_rc, jax_backend)
    got = quickstart.run_variant(tscene, tcams, use_rc, backend=port_backend,
                                 device='cpu')
    assert len(got) == len(want) == FRAMES
    for f, (g, w) in enumerate(zip(got, want)):
        for key in ('sorted', 'hit_rate', 'saved_frac'):
            assert g[key] == w[key], (f, key, g, w)
        assert abs(g['psnr'] - w['psnr']) <= PSNR_REL * w['psnr'], (f, g, w)
        assert abs(g['ssim'] - w['ssim']) <= SSIM_ABS, (f, g, w)
    assert [r['sorted'] for r in got] == [1, 0, 0, 1]
    if use_rc:
        assert min(r['hit_rate'] for r in got[1:]) > 0.9


def test_quickstart_cli_on_the_cpu(capsys, monkeypatch):
    """The CLI end to end at a cut size: both variants, a line a frame."""
    monkeypatch.setattr(quickstart, 'GAUSSIANS', 200)
    monkeypatch.setattr(quickstart, 'FRAMES', 2)
    monkeypatch.setattr(quickstart, 'SIZE', 32)
    monkeypatch.setattr(quickstart, 'CAPACITY', 64)
    assert quickstart.main(['--device', 'cpu']) == 0
    out = capsys.readouterr().out
    assert out.count('frame 0: psnr=') == 2
    assert '--- Lumina (S2+RC) ---' in out and 'sorted=1' in out
    assert out.count('chunk iters saved=') == 4
