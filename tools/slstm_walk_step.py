"""A train step of xlstm-1.3b at its published widths and depth on one
card, for the sLSTM walk's memory and time at one chunk a walk.

    python3 tools/slstm_walk_step.py [--src DIR]

builds the ``repro_torch`` package under ``DIR`` (default: this
checkout's ``src``; a parent commit's ``src``, unpacked elsewhere,
measures the parent) with ``chip_smoke.load_package`` and runs one fixed
case, ``short``, from seed 0 in bfloat16 with remat on, as the config has
it: ``chip_smoke.py``'s LM train phase (b) and (e) for xlstm-1.3b at its
published depth (48 layers) on TRAIN_BATCH x TRAIN_SEQ tokens (8 x 256:
one chunk a walk), through that script's own ``lm_train_fit_and_time``:
three steps on one batch, three timed with CUDA events (median) and one
under ``torch.profiler`` for its kernel launches and kernel time; and
the peak of those steps (``torch.cuda.max_memory_allocated``, and above
the weights, which were all that was held as they began).  The walk of
many chunks, at 4,096 positions, is ``tools/long_train_peak.py``'s
xlstm-1.3b rows.

It prints the card's name and power limit, then one JSON line.  It
checks only that the losses are finite.
"""
from __future__ import annotations

import argparse
import json
import math
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402

ARCH = 'xlstm-1.3b'


def short_case(pkg) -> dict:
    """``chip_smoke.lm_train_fit_and_time`` for ARCH at its published
    depth, and the peak of its steps."""
    import torch
    cfg = pkg.configs.get_config(ARCH)
    torch.cuda.empty_cache()
    model = pkg.registry.init_params(0, cfg, device=cs.DEVICE)
    held = cs.memory_mark()
    out = cs.lm_train_fit_and_time(pkg, model, cs.TRAIN_BATCH, ARCH)
    return {'case': 'short', 'arch': ARCH, 'n_layers': cfg.n_layers,
            'rows': cs.TRAIN_BATCH, 'seq': cs.TRAIN_SEQ,
            'loss': out['fit']['loss'], 'step_ms': out['step']['ms'],
            'device_busy': out['step']['device_busy'],
            'held_bytes': held,
            'peak_bytes': torch.cuda.max_memory_allocated(),
            'peak_above_held_bytes': cs.peak_since(held)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--src', type=pathlib.Path, default=ROOT / 'src')
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print('slstm_walk_step: no CUDA device', file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    pkg = cs.load_package(args.src)
    print(f'card: {cs.card_line()}', flush=True)
    out = short_case(pkg)
    out['src'] = str(args.src)
    out['chunk'] = pkg.xlstm.slstm_chunk(out['seq'])
    print(json.dumps(out), flush=True)
    return 0 if all(math.isfinite(x) for x in out['loss']) else 1


if __name__ == '__main__':
    sys.exit(main())
