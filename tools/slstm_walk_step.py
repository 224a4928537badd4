"""Train steps of xlstm-1.3b at its published widths on one card, for the
sLSTM walk's memory and time.

    python3 tools/slstm_walk_step.py [--src DIR]

builds the ``repro_torch`` package under ``DIR`` (default: this
checkout's ``src``; a parent commit's ``src``, unpacked elsewhere,
measures the parent) with ``chip_smoke.load_package`` and runs two
fixed cases, each from seed 0 in bfloat16 with remat on, as the config
has it:

  * ``short``: ``chip_smoke.py``'s LM train phase (b) and (e) for
    xlstm-1.3b at its published depth (48 layers) on TRAIN_BATCH x
    TRAIN_SEQ tokens (8 x 256: one chunk a walk), through that script's
    own ``lm_train_fit_and_time``: three steps on one batch, three timed
    with CUDA events (median) and one under ``torch.profiler`` for its
    kernel launches and kernel time; and the peak of those steps
    (``torch.cuda.max_memory_allocated``, and above the weights, which
    were all that was held as they began);
  * ``long``: LONG_LAYERS layers (two super-blocks, each with one sLSTM
    block) on LONG_ROWS x LONG_SEQ tokens (16 chunks a walk), one
    ``registry.make_train_step`` step: its loss and grad norm, its
    CUDA-event time and its peak above what was held; LONG_TIMED more
    steps timed (median); then one step under ``torch.profiler``.  At 8
    rows this case ran out of memory on an H100 80GB, in the mLSTM
    blocks' recomputed scans, with or without the chunked walk; out of
    memory fails the run.

It prints the card's name and power limit, then one JSON line a case.
It checks only that the losses and grad norms are finite.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import pathlib
import statistics
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402

ARCH = 'xlstm-1.3b'
LONG_LAYERS, LONG_ROWS, LONG_SEQ, LONG_TIMED = 16, 4, 4096, 2


def cuda_ms(fn) -> tuple:
    """(``fn()``, its CUDA-event milliseconds)."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


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


def long_case(pkg) -> dict:
    """One step of ARCH cut to LONG_LAYERS on LONG_ROWS x LONG_SEQ tokens,
    then LONG_TIMED more timed and one profiled."""
    import torch
    registry = pkg.registry
    cfg = dataclasses.replace(pkg.configs.get_config(ARCH),
                              n_layers=LONG_LAYERS)
    torch.cuda.empty_cache()
    model = registry.init_params(0, cfg, device=cs.DEVICE)
    batch = cs.lm_train_batch(pkg, cfg, 6, LONG_ROWS, LONG_SEQ, cs.DEVICE)
    step_fn, acfg = registry.make_train_step(cfg,
                                             registry.make_ctx(None, cfg))
    state = {'opt': pkg.adam.init(list(model.parameters()), acfg)}

    def step():
        _, state['opt'], m = step_fn(model, state['opt'], batch)
        return m

    held = cs.memory_mark()
    metrics, first_ms = cuda_ms(step)
    out = {'case': 'long', 'arch': ARCH, 'n_layers': LONG_LAYERS,
           'rows': LONG_ROWS, 'seq': LONG_SEQ, 'remat': cfg.remat,
           'loss': float(metrics['loss']),
           'loss_hex': float(metrics['loss']).hex(),
           'grad_norm': float(metrics['grad_norm']),
           'first_step_ms': first_ms, 'held_bytes': held,
           'peak_bytes': torch.cuda.max_memory_allocated(),
           'peak_above_held_bytes': cs.peak_since(held)}
    times = [cuda_ms(step)[1] for _ in range(LONG_TIMED)]
    out['step_ms'] = statistics.median(times)
    out['step_ms_all'] = times
    out['device_busy'] = cs.lm_device_busy(step, 1)
    return out


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
    chunk = (pkg.xlstm.slstm_chunk if hasattr(pkg.xlstm, 'slstm_chunk')
             else lambda s: None)
    ok = True
    for case in (short_case, long_case):
        out = case(pkg)
        out['src'] = str(args.src)
        out['chunk'] = chunk(out['seq'])
        print(json.dumps(out), flush=True)
        losses = out['loss'] if isinstance(out['loss'], list) else [
            out['loss'], out['grad_norm']]
        ok = ok and all(math.isfinite(x) for x in losses)
    return 0 if ok else 1


if __name__ == '__main__':
    sys.exit(main())
