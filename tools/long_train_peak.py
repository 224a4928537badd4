"""Train steps at 4,096 positions of smollm-360m, whisper-base and
zamba2-1.2b at their published widths and depths, and of xlstm-1.3b at
its published widths cut to 16 layers (two super-blocks, each with one
sLSTM block: 16 chunks a walk), on one card, for the memory that the
backward keeps and the time it costs.

    python3 tools/long_train_peak.py [--src DIR]
    python3 tools/long_train_peak.py --predict [--src DIR]

builds the ``repro_torch`` package under ``DIR`` (default: this
checkout's ``src``; a parent commit's ``src``, unpacked elsewhere,
measures the parent) with ``chip_smoke.load_package`` and, for each
config in ARCHS at its row count and depth, from seed 0 in the config's dtype
(bfloat16) with its remat setting, runs ``registry.make_train_step``
once: its loss and grad norm, its CUDA-event time and its peak
(``torch.cuda.max_memory_allocated``, and above what was held as it
began: weights, Adam state, batch); then TIMED more steps timed
(median), then one step under ``torch.profiler`` for its kernel time and
launches.  It prints the card's name and power limit, then one JSON line
a config (``out_of_memory`` where the card ran out, and the next config
runs), and checks only that the losses and grad norms are finite.
The row counts of the first three are the most that the parent of the
chunk loops' checkpoints fits on an H100 80GB by ``--predict``'s count
(with room for the allocator); xlstm-1.3b runs at 4 rows, which the
parent fits, and at 8, which ran out of memory on the parent.

``--predict`` runs on the CPU, nothing computed: the same step on
``meta`` tensors under the op counter (``analysis.op_count``, the dry
run's, no mesh), and prints a JSON line a config with the bytes of what
goes in and the counted peak above it.
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

SEQ, TIMED = 4096, 2
# (config, rows, layers: None for the published depth)
ARCHS = (('smollm-360m', 16, None), ('whisper-base', 2, None),
         ('zamba2-1.2b', 1, None), ('xlstm-1.3b', 4, 16),
         ('xlstm-1.3b', 8, 16))


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


def config(pkg, arch: str, layers):
    cfg = pkg.configs.get_config(arch)
    return cfg if layers is None else dataclasses.replace(cfg,
                                                          n_layers=layers)


def predict(pkg, arch: str, rows: int, layers) -> dict:
    """The step of ``arch`` on ``rows`` x SEQ tokens on ``meta``: the
    bytes of its inputs and the op counter's peak above them."""
    import torch
    from repro_torch.launch.dryrun import _tensor_bytes
    registry = pkg.registry
    cfg = config(pkg, arch, layers)
    params = registry.abstract_params(cfg, 1)
    shape = pkg.ShapeConfig('train', SEQ, rows, 'train')
    batch = registry.input_specs(cfg, shape)
    step_fn, acfg = registry.make_train_step(cfg,
                                             registry.make_ctx(None, cfg))
    opt = pkg.adam.init(list(params.parameters()), acfg)
    counter = pkg.op_count.OpCounter(1, arch)
    with counter:
        step_fn(params, opt, batch)
    args = _tensor_bytes((params, opt, batch))
    return {'arch': arch, 'n_layers': cfg.n_layers, 'rows': rows,
            'seq': SEQ, 'device': 'meta',
            'torch': torch.__version__, 'args_bytes': args,
            'peak_above_args_bytes': counter.counts()['peak_bytes']}


def train_case(pkg, arch: str, rows: int, layers) -> dict:
    """One step of ``arch`` on ``rows`` x SEQ tokens, then TIMED more
    timed and one profiled."""
    import torch
    registry = pkg.registry
    cfg = config(pkg, arch, layers)
    torch.cuda.empty_cache()
    model = registry.init_params(0, cfg, device=cs.DEVICE)
    batch = cs.lm_train_batch(pkg, cfg, 6, rows, SEQ, cs.DEVICE)
    step_fn, acfg = registry.make_train_step(cfg,
                                             registry.make_ctx(None, cfg))
    state = {'opt': pkg.adam.init(list(model.parameters()), acfg)}

    def step():
        _, state['opt'], m = step_fn(model, state['opt'], batch)
        return m

    held = cs.memory_mark()
    metrics, first_ms = cuda_ms(step)
    out = {'arch': arch, 'n_layers': cfg.n_layers, 'rows': rows, 'seq': SEQ,
           'dtype': cfg.dtype, 'remat': cfg.remat,
           'loss': float(metrics['loss']),
           'loss_hex': float(metrics['loss']).hex(),
           'grad_norm': float(metrics['grad_norm']),
           'first_step_ms': first_ms, 'held_bytes': held,
           'peak_bytes': torch.cuda.max_memory_allocated(),
           'peak_above_held_bytes': cs.peak_since(held)}
    times = [cuda_ms(step)[1] for _ in range(TIMED)]
    out['step_ms'] = statistics.median(times)
    out['step_ms_all'] = times
    out['device_busy'] = cs.lm_device_busy(step, 1)
    del model, state, batch
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--src', type=pathlib.Path, default=ROOT / 'src')
    ap.add_argument('--predict', action='store_true',
                    help="count each step's peak on meta tensors (CPU)")
    args = ap.parse_args()
    import torch
    if args.predict:
        torch.set_num_threads(1)
        pkg = cs.load_package(args.src)
        for arch, rows, layers in ARCHS:
            out = predict(pkg, arch, rows, layers)
            out['src'] = str(args.src)
            print(json.dumps(out), flush=True)
        return 0
    if not torch.cuda.is_available():
        print('long_train_peak: no CUDA device', file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    pkg = cs.load_package(args.src)
    print(f'card: {cs.card_line()}', flush=True)
    ok = True
    for arch, rows, layers in ARCHS:
        try:
            out = train_case(pkg, arch, rows, layers)
            ok = ok and all(math.isfinite(out[k])
                            for k in ('loss', 'grad_norm'))
        except torch.cuda.OutOfMemoryError as e:
            # the next config still runs; the exit code says it
            out = {'arch': arch, 'rows': rows, 'seq': SEQ,
                   'out_of_memory': str(e).splitlines()[0]}
            ok = False
        out['src'] = str(args.src)
        print(json.dumps(out), flush=True)
        torch.cuda.empty_cache()
    return 0 if ok else 1


if __name__ == '__main__':
    sys.exit(main())
