"""Fine-tuning at full width on one card: ``chip_smoke.py``'s paper phase at
several learning rates, and a profile of its train step.

    python3 tools/paper_finetune.py [--lr LR ...] [--profile-steps N]

sets up the paper phase as ``chip_smoke.py`` does, with its constants and
functions: targets rendered from the main path's 1,000,000-Gaussian scene
over its 6 cameras at 1920x1080, and the same seed's scene with a quarter
of its Gaussians oversized.  It prints the RC-only quality of that scene
(``chip_smoke.rc_quality_check``: both backends, launch counts, PSNR, SSIM
and hit rate), then for each ``--lr`` (default: the JAX example's 5e-3)
the 12 fine-tuning steps of ``chip_smoke.finetune_run`` with that one
learning rate for every parameter, and the RC-only quality of the tuned
scene.  With ``--profile-steps N`` it then runs N steps at the first lr
under ``torch.profiler``, after one warm-up step, each stage inside a
``record_function`` range (projection, sort, gather, the dense walk's
forward, SSIM, the loss, the backward, Adam), and prints each step's wall
(synchronised), the device-busy share (the device operations' time over
the wall), the kernel launches a step, the stages' host times and device
spans, and the operations that take the most device and host time.  The
last line is one JSON object with the numbers.  It gates only what the two
``chip_smoke`` functions gate.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402


def stages(pkg) -> list:
    """(owner, attribute, range name) of each stage a train step calls."""
    lp = pkg.lp
    return [(lp, 'project', 'project'), (lp, 'sort_scene', 'sort'),
            (lp, 'gather_tile_features', 'gather'),
            (lp, 'rasterize_tiles', 'dense walk forward'),
            (pkg.finetune.metrics, 'ssim', 'ssim'), (pkg.adam, 'step', 'adam')]


def profile(pkg, scene, cam, gt, cfg_r, fcfg, steps: int) -> dict:
    """``steps`` train steps under ``torch.profiler`` after one warm-up."""
    import torch
    ft, adam = pkg.finetune, pkg.adam
    state = adam.init(ft.params_of(scene), fcfg.adam)

    def step():
        nonlocal state
        with torch.profiler.record_function('forward (total_loss)'):
            loss, _ = ft.total_loss(scene, cam, gt, fcfg, cfg_r,
                                    device=cs.DEVICE)
        with torch.profiler.record_function('backward'):
            grads = torch.autograd.grad(loss, ft.params_of(scene))
        _, state, _ = adam.step(ft.params_of(scene), grads, state, fcfg.adam)

    def ranged(label, fn):
        def call(*a, **kw):
            with torch.profiler.record_function(label):
                return fn(*a, **kw)
        return call

    step()
    torch.cuda.synchronize()
    walls = []
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with cs.patched(stages(pkg), ranged), \
            torch.profiler.profile(activities=acts) as prof:
        for _ in range(steps):
            t = time.perf_counter()
            step()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t) * 1e3)
    events = prof.key_averages()
    cuda = torch.autograd.DeviceType.CUDA
    names = {label for _, _, label in stages(pkg)} | {
        'forward (total_loss)', 'backward'}
    # each range appears twice, as a host range and as a device row of the
    # same name spanning its kernels; only the other device rows are work
    device = [e for e in events if e.device_type == cuda and e.key not in names]
    host = [e for e in events if e.device_type != cuda]
    spans = {e.key: e.device_time_total / 1e3 / steps for e in events
             if e.device_type == cuda and e.key in names}
    device_us = sum(e.self_device_time_total for e in device)
    out = {'step_wall_ms': walls,
           'device_busy_share': device_us / (sum(walls) * 1e3),
           'kernel_launches_per_step': sum(
               e.count for e in host if e.key.startswith('cudaLaunchKernel'))
           / steps,
           'device_ops_per_step': sum(e.count for e in device) / steps,
           'stages': {e.key: {'host_ms': e.cpu_time_total / 1e3 / steps,
                              'device_span_ms': spans.get(e.key),
                              'calls': e.count // steps}
                      for e in host if e.key in names}}
    for key, rows, attr in (
            ('top_device_ms', device, 'self_device_time_total'),
            ('top_host_ms', [e for e in host if e.key not in names],
             'self_cpu_time_total')):
        top = sorted(rows, key=lambda e: getattr(e, attr), reverse=True)[:20]
        out[key] = {e.key: [getattr(e, attr) / 1e3 / steps, e.count // steps]
                    for e in top}
    print(f'profile: step wall (ms) {[round(w, 1) for w in walls]}; device '
          f'busy {out["device_busy_share"]:.4f} of the wall; '
          f'{out["kernel_launches_per_step"]:.0f} kernel launches and '
          f'{out["device_ops_per_step"]:.0f} device operations a step',
          flush=True)
    for name, row in out['stages'].items():
        print(f'  stage {name}: {json.dumps(row)}', flush=True)
    for key in ('top_device_ms', 'top_host_ms'):
        print(f'{key} (self ms a step, calls a step):', flush=True)
        for name, (ms, calls) in out[key].items():
            print(f'  {name[:60]:60s} {ms:9.2f} {calls:8d}', flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--lr', type=float, nargs='+', default=[None],
                    help='learning rates (default: the JAX example\'s)')
    ap.add_argument('--profile-steps', type=int, default=0)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print('paper_finetune: no CUDA device', file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pkg = cs.load_package(ROOT / 'src')
    print(f'card: {cs.card_line()}', flush=True)
    pkg.build.build_all()

    scene = pkg.structured_scene(cs.SEED, cs.GAUSSIANS, device=cs.DEVICE)
    cams = pkg.orbit_trajectory(cs.PAPER_FRAMES, fps=cs.PAPER_FPS,
                                width=cs.WIDTH, height_px=cs.HEIGHT,
                                device=cs.DEVICE)
    cfg_r = cs.lumina_config(pkg, use_s2=False, use_rc=False)
    gts = [pkg.lp.render_frame_baseline(scene, c, cfg_r, device=cs.DEVICE)[0]
           for c in cams]
    del scene
    start = pkg.structured_scene(cs.SEED, cs.GAUSSIANS,
                                 large_gaussian_frac=cs.PAPER_LARGE_FRAC,
                                 device=cs.DEVICE)
    quality = ('mean_psnr_db', 'mean_ssim', 'mean_hit_rate_frames_1_on')
    before = cs.rc_quality_check(pkg, 'before fine-tuning', start, cams, gts)
    out = {'card': cs.card_line(),
           'before': {k: before[k] for k in quality}, 'after': {}}
    for lr in args.lr:
        fcfg = cs.paper_finetune_config(pkg, lr)
        t0 = time.perf_counter()
        tuned, rows = cs.finetune_run(pkg, start, cams, gts, cfg_r, fcfg)
        wall = time.perf_counter() - t0
        after = cs.rc_quality_check(pkg, f'after fine-tuning at lr '
                                    f'{fcfg.adam.lr}', tuned, cams, gts)
        out['after'][fcfg.adam.lr] = dict(
            {k: after[k] for k in quality}, finetune_s=wall,
            **{f'{k}_first_last': [rows[0][k], rows[-1][k]]
               for k in ('loss', 'l1', 'dssim', 'l_scale')})
        print(f'lr {fcfg.adam.lr}: ' + json.dumps(out['after'][fcfg.adam.lr]),
              flush=True)
        del tuned
        torch.cuda.empty_cache()
    if args.profile_steps:
        out['profile'] = profile(pkg, start, cams[0], gts[0], cfg_r,
                                 cs.paper_finetune_config(pkg, args.lr[0]),
                                 args.profile_steps)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
