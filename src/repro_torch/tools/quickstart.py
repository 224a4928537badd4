"""Quickstart: render a scene with and without Lumina's optimizations.

    PYTHONPATH=src python3 -m repro_torch.tools.quickstart [--device cpu]

Builds a procedural Gaussian scene, flies a VR-style camera orbit, and
renders each frame with S^2 alone and with full Lumina (S^2 + radiance
caching): per frame, PSNR and SSIM against the exact render
(``render_frame_baseline``), the cache hit rate, the share of chunk
iterations saved and whether the frame sorted.  It shades on the kernel
backend, through the rasterize and lookup kernels, so its
``saved_frac`` is one less the chunk iterations of both phases over
those of a walk without the cache (negative where the cache costs more
than it saves), as in the JAX package's ``'pallas'`` backend.  It is
printed as ``chunk iters saved``, not as the JAX example's ``integration
avoided``: that example runs the reference backend, which counts the
Gaussians integrated.
The sizes are those of the JAX package's ``examples/quickstart.py``:
3,000 Gaussians, 9 orbit cameras at 128x128, capacity 1024, window 3.
It runs on the card unless ``--device cpu`` is given (the kernels' plain
versions, which launch nothing; about a minute).  After each variant it
prints the kernel launches of its run (``kernels.LAUNCHES``).
"""
from __future__ import annotations

import argparse
import sys

import torch

from .. import kernels
from ..core.metrics import psnr, ssim
from ..core.pipeline import LuminaConfig, LuminSys, render_frame_baseline
from ..data.scenes import structured_scene
from ..data.trajectory import orbit_trajectory
from ..device import resolve_device

SEED, GAUSSIANS, FRAMES, SIZE, CAPACITY, WINDOW = 0, 3000, 9, 128, 1024, 3
VARIANTS = {'S2-only': False, 'Lumina (S2+RC)': True}   # name -> use_rc


def run_variant(scene, cams, use_rc: bool, *, backend: str = 'kernel',
                device=None) -> list:
    """One variant over ``cams``: a row a frame with ``psnr``, ``ssim``
    (against ``render_frame_baseline``), ``hit_rate``, ``saved_frac`` and
    ``sorted`` (``sorted_this_frame``), each a Python number."""
    cfg = LuminaConfig(capacity=CAPACITY, window=WINDOW, use_rc=use_rc,
                       backend=backend)
    sys_ = LuminSys(scene, cfg, cams[0], device=device)
    rows = []
    with torch.no_grad():
        for cam in cams:
            img, stats = sys_.step(cam)
            exact = render_frame_baseline(scene, cam, cfg, device=device)[0]
            rows.append({'psnr': float(psnr(img, exact)),
                         'ssim': float(ssim(img, exact)),
                         'hit_rate': float(stats.hit_rate),
                         'saved_frac': float(stats.saved_frac),
                         'sorted': int(stats.sorted_this_frame)})
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--device', default=None,
                    help="'cpu' for the plain versions (default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    print(f'building scene ({GAUSSIANS} Gaussians) on {dev} ...')
    scene = structured_scene(SEED, GAUSSIANS, device=dev)
    cams = orbit_trajectory(FRAMES, width=SIZE, height_px=SIZE, device=dev)
    for name, use_rc in VARIANTS.items():
        kernels.reset_launches()
        print(f'\n--- {name} ---')
        for i, r in enumerate(run_variant(scene, cams, use_rc, device=dev)):
            print(f'frame {i}: psnr={r["psnr"]:6.2f} dB  '
                  f'ssim={r["ssim"]:.4f}  hit={r["hit_rate"]:5.2f}  '
                  f'chunk iters saved={r["saved_frac"]:5.2f}  '
                  f'sorted={r["sorted"]}')
        print(f'kernel launches: {kernels.LAUNCHES}')
    return 0


if __name__ == '__main__':
    sys.exit(main())
