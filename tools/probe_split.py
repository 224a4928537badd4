"""Where the time of the port's LuminCache probe goes, on one card.

    python3 tools/probe_split.py [--src DIR]

runs ``chip_smoke.py``'s main path and its shared serving run through the
``repro_torch`` package under ``DIR`` (default: this checkout's ``src``; a
parent commit's ``src``, unpacked elsewhere, measures the parent), captures
the probe of frame 11 and of serving tick 11, and prints for each one
``probe split`` line of three rounds of medians of 50 (CUDA events):

* ``probe_ms``: the probe as the path calls it (``ops.rc_probe`` for one
  viewer, ``ops.rc_probe_multi`` for the serving tick);
* the parts of the separate route, which every version of the port has:
  the slot-major copy of the ids (``copy_ms``, 0 for one viewer), the
  lookup-only kernel alone and its wrapper (``lookup_kernel_ms``,
  ``lookup_wrapper_ms``) and ``touch_all_groups`` (``touch_ms``);
* where the package fuses the probe (``rcl.rc_probe``), the fused kernel
  alone and its wrapper (``probe_kernel_ms``, ``probe_wrapper_ms``);
* ``rest_ms``: the probe less its device work, that is less the copy, the
  lookup kernel and the touch on the separate route, or less the fused
  kernel where the probe is fused;

then ``chip_smoke.probe_counters``' line.  It checks no result:
``chip_smoke.py`` holds the kernels against their plain versions.
"""
from __future__ import annotations

import argparse
import collections
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402


def probe_split(pkg, call, label: str, rounds: int = 3) -> dict:
    rc, rcl, ops = pkg.ops.rc, pkg.rcl, pkg.ops
    cache, ids, cfg, live = cs.probe_args(pkg, call)
    if ids.shape[0] == 1 and live is None:
        probe = lambda: ops.rc_probe(cache, ids[0], cfg)        # noqa: E731
    else:
        probe = lambda: ops.rc_probe_multi(cache, ids, cfg, live=live)  # noqa: E731
    ids_f = rc.slot_major(ids).contiguous()
    live_f = None if live is None else rc.slot_major(
        rc.viewer_live(live, ids.shape[:3]))
    lookup = lambda: rcl.rc_lookup(cache.tags, cache.values, ids_f, cfg)  # noqa: E731
    hit, _, sidx, way = lookup()
    way, sidx = way.long(), sidx.long()
    fused = None
    if hasattr(rcl, 'rc_probe'):
        fused = lambda: rcl.rc_probe(cache.tags, cache.values, cache.age,  # noqa: E731
                                     cache.clock, ids, cfg, live=live)
    out = collections.defaultdict(list)
    for _ in range(rounds):
        out['probe_ms'].append(cs.time_ms(probe, 50))
        out['copy_ms'].append(cs.time_ms(lambda: rc.slot_major(ids).contiguous(), 50)
                              if ids.shape[0] > 1 else 0.0)
        out['lookup_kernel_ms'].append(cs.kernel_alone(pkg, lookup)[0])
        out['lookup_wrapper_ms'].append(cs.time_ms(lookup, 50))
        out['touch_ms'].append(cs.time_ms(lambda: rc.touch_all_groups(
            cache, ids_f, hit, way, cfg, live=live_f, sidx=sidx), 50))
        if fused is None:
            device = (out['copy_ms'][-1] + out['lookup_kernel_ms'][-1]
                      + out['touch_ms'][-1])
        else:
            out['probe_kernel_ms'].append(cs.kernel_alone(pkg, fused)[0])
            out['probe_wrapper_ms'].append(cs.time_ms(fused, 50))
            device = out['probe_kernel_ms'][-1]
        out['rest_ms'].append(out['probe_ms'][-1] - device)
    print(f'probe split {label} (ms, {rounds} rounds of medians of 50; ids '
          f'{list(ids.shape)}): ' + json.dumps(out), flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--src', type=pathlib.Path, default=ROOT / 'src',
                    help='the directory that holds the repro_torch package')
    opts = ap.parse_args()
    if not (opts.src / 'repro_torch').is_dir():
        print(f'probe_split: {opts.src}/repro_torch not found', file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print('probe_split: no CUDA device', file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    pkg = cs.load_package(opts.src)
    print(f'card: {cs.card_line()}', flush=True)
    pkg.build.build_all()
    scene, cfg, cams, states, _, _ = cs.main_path(pkg)
    last = len(cams) - 1
    calls = cs.capture_inputs(
        pkg, lambda: pkg.lp.render_step(scene, states[last], cams[last], cfg),
        [(pkg.ops, 'rc_probe', 'probe')])
    del states
    capture = {}
    cs.serve_run(pkg, scene, 'kernel', cs.VIEWERS, capture=capture,
                 targets=[(pkg.ops, 'rc_probe_multi', 'probe')])
    for label, call in (('rc_lookup', calls['probe']),
                        ('rc_lookup[serve]', capture['probe'])):
        probe_split(pkg, call, label)
        cs.probe_counters(pkg, call, label)
    return 0


if __name__ == '__main__':
    sys.exit(main())
