"""Cache-aware fine-tuning in both packages on the same scene, on the CPU.

    PYTHONPATH=src JAX_PLATFORMS=cpu python3 tools/finetune_same_scene.py

Runs ``examples/finetune_3dgs.py``'s whole loop twice: in the JAX package
(the example's own ``rc_quality``, its calls in the order of its
``main``) and in the port (``repro_torch.tools.finetune_3dgs``'s
``rc_quality`` and the port's ``finetune``), on one scene: JAX's
``structured_scene(PRNGKey(3), 1500)`` as the target scene, the same key
with ``large_gaussian_frac=0.25`` as the start, and JAX's 6 orbit
cameras at 96x96 and 30 FPS, all reaching the port through
``repro_torch.interop``.  Each side renders its own targets, fine-tunes
60 steps with the scale-constrained loss (alpha 8, theta 0.03) and
measures RC-only quality (capacity 384) before and after.  It prints, for
each package, RC-only PSNR and the hit rate of frames 1-5 before and
after, and the PSNR gains, then one JSON line with the numbers.  It
imports both packages (as the tests do); it checks nothing.
"""
from __future__ import annotations

import importlib.util
import json
import pathlib
import sys
import time

import jax
import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / 'src'))

from repro.core.finetune import FinetuneConfig as JFinetuneConfig  # noqa: E402
from repro.core.finetune import finetune as jax_finetune  # noqa: E402
from repro.core.pipeline import LuminaConfig as JLuminaConfig  # noqa: E402
from repro.core.pipeline import \
    render_frame_baseline as jax_baseline  # noqa: E402
from repro.data.scenes import structured_scene  # noqa: E402
from repro.data.trajectory import orbit_trajectory  # noqa: E402

from repro_torch import interop  # noqa: E402
from repro_torch.core.finetune import FinetuneConfig, finetune  # noqa: E402
from repro_torch.core.pipeline import (LuminaConfig,  # noqa: E402
                                       render_frame_baseline)
from repro_torch.tools import finetune_3dgs as port_tool  # noqa: E402

SEED, GAUSSIANS, FRAMES, SIZE, CAPACITY, STEPS = 3, 1500, 6, 96, 384, 60


def jax_example():
    """``examples/finetune_3dgs.py`` as a module (``examples/`` is not a
    package)."""
    spec = importlib.util.spec_from_file_location(
        'finetune_3dgs_example', ROOT / 'examples' / 'finetune_3dgs.py')
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_jax(gt_scene, start, cams) -> dict:
    """The example's ``main``, returning its four numbers."""
    ex = jax_example()
    cfg_r = JLuminaConfig(capacity=CAPACITY, use_s2=False, use_rc=False)
    gts = [jax_baseline(gt_scene, c, cfg_r)[0] for c in cams]
    p0, h0 = ex.rc_quality(start, cams, gts)
    fcfg = JFinetuneConfig(scale_alpha=8.0, scale_theta=0.03)
    tuned, _ = jax_finetune(start, cams, gts, fcfg, cfg_r, steps=STEPS,
                            log_every=20)
    p1, h1 = ex.rc_quality(tuned, cams, gts)
    return {'psnr_before': p0, 'hit_before': h0, 'psnr_after': p1,
            'hit_after': h1}


def run_port(gt_scene, start, cams) -> dict:
    """``repro_torch.tools.finetune_3dgs``'s ``main`` on the given scene
    and cameras, returning the same four numbers (and SSIM)."""
    dev = 'cpu'
    cfg_r = LuminaConfig(capacity=CAPACITY, use_s2=False, use_rc=False)
    gts = [render_frame_baseline(gt_scene, c, cfg_r, device=dev)[0]
           for c in cams]
    p0, s0, h0 = port_tool.rc_quality(start, cams, gts, dev)
    fcfg = FinetuneConfig(scale_alpha=8.0, scale_theta=0.03)
    tuned, _ = finetune(start, cams, gts, fcfg, cfg_r, steps=STEPS,
                        log_every=20, device=dev)
    p1, s1, h1 = port_tool.rc_quality(tuned, cams, gts, dev)
    return {'psnr_before': p0, 'hit_before': h0, 'psnr_after': p1,
            'hit_after': h1, 'ssim_before': s0, 'ssim_after': s1}


def to_port_scene(scene):
    return interop.scene_from_numpy(*[np.asarray(x) for x in scene],
                                    device='cpu')


def to_port_cam(c):
    return interop.camera_from_numpy(c.position, c.quat, c.fx, c.fy, c.cx,
                                     c.cy, c.width, c.height, c.near, c.far,
                                     device='cpu')


def main() -> int:
    key = jax.random.PRNGKey(SEED)
    gt_scene = structured_scene(key, GAUSSIANS)
    start = structured_scene(key, GAUSSIANS, large_gaussian_frac=0.25)
    cams = orbit_trajectory(FRAMES, fps=30.0, width=SIZE, height_px=SIZE)
    out = {}
    for name, fn, args in (
            ('jax', run_jax, (gt_scene, start, cams)),
            ('port', run_port, (to_port_scene(gt_scene),
                                to_port_scene(start),
                                [to_port_cam(c) for c in cams]))):
        print(f'--- {name} ---', flush=True)
        t0 = time.perf_counter()
        r = fn(*args)
        r['seconds'] = time.perf_counter() - t0
        r['gain_db'] = r['psnr_after'] - r['psnr_before']
        print(f'{name}: RC-only PSNR {r["psnr_before"]:.4f} -> '
              f'{r["psnr_after"]:.4f} dB (gain {r["gain_db"]:.4f}), hit '
              f'rate {r["hit_before"]:.4f} -> {r["hit_after"]:.4f} '
              f'({r["seconds"]:.1f} s)', flush=True)
        out[name] = r
    out['gain_gap_db'] = out['jax']['gain_db'] - out['port']['gain_db']
    print(f'the port gains {out["gain_gap_db"]:.4f} dB less than JAX')
    print(json.dumps(out))
    return 0


if __name__ == '__main__':
    torch.set_num_threads(4)
    sys.exit(main())
