"""PSNR of S^2 alone against exact 3DGS at full width, over the
expanded-viewport margin and the per-tile list capacity.

    PYTHONPATH=src python3 -m repro_torch.tools.s2_quality    # one CUDA GPU

It renders the 12 frames of ``chip_smoke.py``'s main path (a 1,000,000-
Gaussian ``structured_scene`` with seed 0, ``orbit_trajectory`` at
1920x1080, window 6) through ``LuminSys(backend='kernel', use_rc=False)``
for each (margin, capacity, max_tiles_per_gaussian) and prints each frame's
PSNR against ``render_frame_baseline`` at the same capacity and footprint
window.  Beside it, per frame: how far the projected means lie from where
the window's sort put them (pixels, 50th/95th/99th percentile over the
Gaussians in view at both poses), and how many of the sort's tile lists are
full.  A margin narrower than that displacement drops Gaussians from the
tiles they moved into; a full list drops the farthest Gaussians.  The last
line is one JSON object with every number printed above it.
"""
from __future__ import annotations

import json
import sys
import time

import torch

from ..configs.lumina_3dgs import CONFIG
from ..core import pipeline as lp
from ..core.metrics import psnr
from ..core.projection import project
from ..core.s2 import predict_window_pose
from ..data.scenes import structured_scene
from ..data.trajectory import orbit_trajectory
from ..kernels import build

GAUSSIANS, WIDTH, HEIGHT, FRAMES, SEED = 1_000_000, 1920, 1080, 12, 0
# (margin px, capacity, max_tiles_per_gaussian); the first is the main path's
# config.  A wider margin needs a wider footprint window, or the d x d tile
# window anchored at the bbox corner cuts the inflated footprint.
VARIANTS = ((4, 1024, 16), (4, 4096, 16), (4, 1024, 64), (16, 1024, 64),
            (32, 1024, 64), (32, 4096, 64))


def _config(margin: int, capacity: int, max_tiles: int, **kw) -> lp.LuminaConfig:
    return lp.LuminaConfig(window=CONFIG.window, margin=margin,
                           capacity=capacity, k_record=CONFIG.k_record,
                           group_tiles=CONFIG.group_tiles,
                           sort_method=CONFIG.sort_method,
                           max_tiles_per_gaussian=max_tiles, **kw)


def displacement(scene, cams, window: int) -> list:
    """Per frame: percentiles (50, 95, 99) of the distance in pixels between
    each Gaussian's projected mean at the frame's pose and at the pose its
    window was sorted for (Gaussians valid at both)."""
    out, sort_proj = [], None
    q = torch.tensor([0.5, 0.95, 0.99], device=scene.device)
    with torch.no_grad():
        for i, cam in enumerate(cams):
            if i % window == 0:
                pred = predict_window_pose(cams[max(i - 1, 0)], cam, i, window)
                sort_proj = project(scene, pred)
            now = project(scene, cam)
            ok = sort_proj.valid & now.valid
            d = (now.mean2d[ok] - sort_proj.mean2d[ok]).norm(dim=1)
            # torch.quantile takes at most 2**24 values: subsample evenly
            d = d[::max(1, d.numel() // (1 << 24) + 1)]
            out.append([float(x) for x in torch.quantile(d, q)])
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print('s2_quality: no CUDA device', file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    build.build_all()
    scene = structured_scene(SEED, GAUSSIANS, device='cuda')
    cams = orbit_trajectory(FRAMES, width=WIDTH, height_px=HEIGHT, device='cuda')
    disp = displacement(scene, cams, CONFIG.window)
    for i, (p50, p95, p99) in enumerate(disp):
        print(f'frame {i:2d}: displacement from the sort pose p50 {p50:.2f} px, '
              f'p95 {p95:.2f} px, p99 {p99:.2f} px', flush=True)

    baselines, result = {}, {'displacement_px_p50_p95_p99': disp, 'variants': []}
    for margin, capacity, max_tiles in VARIANTS:
        t0 = time.perf_counter()
        key = (capacity, max_tiles)
        if key not in baselines:
            cfg_b = _config(CONFIG.margin, capacity, max_tiles)
            baselines[key] = [lp.render_frame_baseline(scene, c, cfg_b,
                                                       device='cuda')[0]
                              for c in cams]
        cfg = _config(margin, capacity, max_tiles, backend='kernel', use_rc=False)
        sys_ = lp.LuminSys(scene, cfg, cams[0], device='cuda')
        dbs, full = [], []
        for i, cam in enumerate(cams):
            image, _ = sys_.step(cam)
            dbs.append(float(psnr(image, baselines[key][i])))
            if i % cfg.window == 0:
                lists = sys_.state.shared.lists
                full.append(int((lists.count >= capacity).sum()))
        row = dict(margin=margin, capacity=capacity,
                   max_tiles_per_gaussian=max_tiles, psnr_db=dbs,
                   sort_tiles_full=full, sort_tiles=int(lists.count.numel()))
        result['variants'].append(row)
        print(f'margin {margin:2d} px, capacity {capacity}, max_tiles '
              f'{max_tiles}: PSNR ' + ' '.join(f'{db:.2f}' for db in dbs)
              + f' dB; full lists per sort {full} of {row["sort_tiles"]}; '
              f'{time.perf_counter() - t0:.1f} s', flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
