"""End-to-end LM training example: a right-sized smollm-family model on the
synthetic token stream, AdamW at lr 1e-3 under a warmup-cosine scale (20
steps of warmup), with a checkpoint every 50 steps.

    PYTHONPATH=src python3 -m repro_torch.tools.train_lm [--device cpu]

The sizes are those of the JAX package's ``examples/train_lm.py``: d_model
256 and 4 layers by default (``--d-model 768 --layers 12`` is the ~100M
configuration), vocab 8192, float32, batch 4 x 256, 60 steps.  It runs on
the card unless ``--device cpu`` is given; the checkpoints go under
``build/`` unless ``--ckpt-dir`` says otherwise.
"""
from __future__ import annotations

import argparse
import dataclasses

from ..checkpoint import CheckpointManager
from ..configs import get_config
from ..data.tokens import TokenStream
from ..device import resolve_device
from ..launch.train import train_state
from ..models import registry
from ..optim import adam, schedule

WARMUP = 20


def config(d_model: int, layers: int):
    """The example's smollm-family config at ``d_model`` x ``layers``."""
    return dataclasses.replace(
        get_config('smollm-360m'), n_layers=layers, d_model=d_model,
        n_heads=max(4, d_model // 64), n_kv_heads=max(2, d_model // 128),
        d_ff=int(d_model * 8 / 3) // 64 * 64, head_dim=0, vocab=8192,
        dtype='float32', remat=False)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--steps', type=int, default=60)
    ap.add_argument('--d-model', type=int, default=256)
    ap.add_argument('--layers', type=int, default=4)
    ap.add_argument('--batch', type=int, default=4)
    ap.add_argument('--seq', type=int, default=256)
    ap.add_argument('--ckpt-dir', default='build/train_lm')
    ap.add_argument('--device', default=None,
                    help="'cpu' for the host; the card by default")
    args = ap.parse_args(argv)

    cfg = config(args.d_model, args.layers)
    dev = resolve_device(args.device)
    model = registry.init_params(0, cfg, device=dev)
    n_params = sum(p.numel() for p in model.parameters())
    print(f'model: {cfg.n_layers}L d={cfg.d_model} -> '
          f'{n_params / 1e6:.1f}M params')

    def sched(step):
        return schedule.linear_warmup_cosine(step, warmup_steps=WARMUP,
                                             total_steps=args.steps)

    step, acfg = registry.make_train_step(
        cfg, registry.make_ctx(None, cfg), adam.AdamConfig(lr=1e-3),
        schedule=sched)
    opt = adam.init(list(model.parameters()), acfg)
    stream = TokenStream(seed=0, global_batch=args.batch, seq=args.seq,
                         vocab=cfg.vocab, device=dev)
    mgr = CheckpointManager(args.ckpt_dir, keep=2)
    for i in range(args.steps):
        model, opt, m = step(model, opt, stream.next())
        if i % 10 == 0:
            print(f'step {i:4d}  loss {float(m["loss"]):.4f}')
        if (i + 1) % 50 == 0:
            mgr.save(train_state(model, opt), step=i + 1,
                     extra={'stream': stream.state_dict()})
    mgr.wait()
    print(f'done; checkpoints: {mgr.all_steps()}')


if __name__ == '__main__':
    main()
