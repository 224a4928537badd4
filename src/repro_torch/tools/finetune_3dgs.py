"""Cache-aware fine-tuning (paper Sec. 3.3 / Eqn. 4), end to end.

    PYTHONPATH=src python3 -m repro_torch.tools.finetune_3dgs [--device cpu]

Starts from a scene corrupted with oversized Gaussians (the Fig. 13
artifact source), fine-tunes it against rendered targets with the
scale-constrained loss, and prints RC-only rendering quality (PSNR and SSIM
against the targets, the cache hit rate of frames 1-5) before and after.
The sizes are those of the JAX package's ``examples/finetune_3dgs.py``:
1,500 Gaussians, 6 cameras at 96x96 and 30 FPS, capacity 384, 60 steps.
It runs on the card unless ``--device cpu`` is given (about a minute there).
"""
from __future__ import annotations

import argparse
import sys

import torch

from ..core.finetune import FinetuneConfig, finetune
from ..core.metrics import psnr, ssim
from ..core.pipeline import LuminaConfig, LuminSys, render_frame_baseline
from ..data.scenes import structured_scene
from ..data.trajectory import orbit_trajectory

SEED, GAUSSIANS, FRAMES, SIZE, CAPACITY, STEPS = 3, 1500, 6, 96, 384, 60


def rc_quality(scene, cams, gts, device) -> tuple:
    """Mean PSNR and SSIM of RC-only frames against ``gts``, and the mean hit
    rate of frames 1.. (frame 0 starts from a cold cache)."""
    cfg = LuminaConfig(capacity=CAPACITY, use_s2=False, use_rc=True)
    sys_ = LuminSys(scene, cfg, cams[0], device=device)
    ps, ss, hits = [], [], []
    with torch.no_grad():
        for cam, gt in zip(cams, gts):
            img, st = sys_.step(cam)
            ps.append(float(psnr(img, gt)))
            ss.append(float(ssim(img, gt)))
            hits.append(float(st.hit_rate))
    return (sum(ps) / len(ps), sum(ss) / len(ss),
            sum(hits[1:]) / max(len(hits) - 1, 1))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--device', default=None,
                    help="'cpu' for the plain versions (default: the card)")
    args = ap.parse_args(argv)
    dev = args.device
    gt_scene = structured_scene(SEED, GAUSSIANS, device=dev)
    cams = orbit_trajectory(FRAMES, fps=30.0, width=SIZE, height_px=SIZE,
                            device=dev)
    cfg_r = LuminaConfig(capacity=CAPACITY, use_s2=False, use_rc=False)
    gts = [render_frame_baseline(gt_scene, c, cfg_r, device=dev)[0]
           for c in cams]

    start = structured_scene(SEED, GAUSSIANS, large_gaussian_frac=0.25,
                             device=dev)
    p0, s0, h0 = rc_quality(start, cams, gts, dev)
    print(f'before fine-tuning: RC-only PSNR {p0:.2f} dB, SSIM {s0:.4f}, '
          f'hit rate {h0:.2f}')

    fcfg = FinetuneConfig(scale_alpha=8.0, scale_theta=0.03)
    print('fine-tuning with the scale-constrained loss ...')
    tuned, _ = finetune(start, cams, gts, fcfg, cfg_r, steps=STEPS,
                        log_every=20, device=dev)
    p1, s1, h1 = rc_quality(tuned, cams, gts, dev)
    print(f'after  fine-tuning: RC-only PSNR {p1:.2f} dB, SSIM {s1:.4f}, '
          f'hit rate {h1:.2f}')
    return 0


if __name__ == '__main__':
    sys.exit(main())
