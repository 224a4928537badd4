"""Where a train step's host time goes, on one card: the forward and
backward apart from the Adam update, and the host-side operations that
take the most time.

    python3 tools/train_step_split.py [--src DIR] [--archs A ...]

builds the ``repro_torch`` package under ``DIR`` (default: this
checkout's ``src``; a parent commit's ``src``, unpacked elsewhere,
measures the parent) with ``chip_smoke.load_package`` and, for each
config at its published width and depth on ``chip_smoke``'s train shape
(TRAIN_BATCH x TRAIN_SEQ, its seeded batch, seed-0 weights), runs one
step of ``registry.make_train_step``'s body, then TIMED steps, each split
into the forward and backward (``train_loss`` and ``autograd.grad``) and
``adam.step``: for each part the host clock until the call returns
(enqueue) and until the card is done (synced).  Then one step under
``torch.profiler`` (CPU and CUDA): the CUDA runtime calls that block or
allocate (``cudaMalloc``, ``cudaFree``, synchronizations, copies) and
the TOP host-side operations by self CPU time.  One JSON line a config;
it checks nothing.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402

TIMED, TOP = 3, 15
ARCHS = ('xlstm-1.3b', 'granite-moe-1b-a400m', 'smollm-360m')
RUNTIME = ('cudaMalloc', 'cudaFree', 'cudaStreamSynchronize',
           'cudaDeviceSynchronize', 'cudaMemcpyAsync', 'cudaEventSynchronize',
           'cudaStreamWaitEvent')


def clocked(fn) -> tuple:
    """(``fn()``, host ms until it returns, host ms until the card is
    done)."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return out, (t1 - t0) * 1e3, (t2 - t0) * 1e3


def split_case(pkg, arch: str) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile
    registry = pkg.registry
    cfg = pkg.configs.get_config(arch)
    model = registry.init_params(0, cfg, device=cs.DEVICE)
    batch = cs.lm_train_batch(pkg, cfg, 6, cs.TRAIN_BATCH, cs.TRAIN_SEQ,
                              cs.DEVICE)
    ctx = registry.make_ctx(None, cfg)
    mod = registry.module_for(cfg)
    _, acfg = registry.make_train_step(cfg, ctx)
    opt = pkg.adam.init(list(model.parameters()), acfg)
    params = list(model.parameters())

    def fwd_bwd():
        loss = mod.train_loss(model, batch, model.cfg, ctx)
        return loss, torch.autograd.grad(loss, params)

    def update(grads):
        return pkg.adam.step(params, grads, opt, acfg)

    grads = fwd_bwd()[1]
    update(grads)
    parts = {'fwd_bwd': [], 'adam': []}
    for _ in range(TIMED):
        (_, grads), enq, syn = clocked(fwd_bwd)
        parts['fwd_bwd'].append((enq, syn))
        _, enq, syn = clocked(lambda: update(grads))
        parts['adam'].append((enq, syn))
    out = {'arch': arch, 'rows': cs.TRAIN_BATCH, 'seq': cs.TRAIN_SEQ}
    for name, runs in parts.items():
        out[name] = {'enqueue_ms': statistics.median(r[0] for r in runs),
                     'synced_ms': statistics.median(r[1] for r in runs),
                     'synced_ms_all': [r[1] for r in runs]}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        update(fwd_bwd()[1])
        torch.cuda.synchronize()
    events = prof.key_averages()
    out['runtime'] = {e.key: {'count': e.count,
                              'self_cpu_ms': e.self_cpu_time_total / 1e3}
                      for e in events if e.key in RUNTIME}
    top = sorted(events, key=lambda e: -e.self_cpu_time_total)[:TOP]
    out['top_self_cpu_ms'] = {e.key: [e.count,
                                      round(e.self_cpu_time_total / 1e3, 3)]
                              for e in top}
    del model, opt, batch, grads, params
    torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--src', type=pathlib.Path, default=ROOT / 'src')
    ap.add_argument('--archs', nargs='*', default=ARCHS)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print('train_step_split: no CUDA device', file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    pkg = cs.load_package(args.src)
    print(f'card: {cs.card_line()}', flush=True)
    for arch in args.archs:
        print(json.dumps({**split_case(pkg, arch), 'src': str(args.src)}),
              flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
