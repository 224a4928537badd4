"""How far 1-ulp noise moves an LM's gradients, with and without
``flash_attention``'s bfloat16 roundings, beside a faulty backward.

    python3 tools/lm_grad_flips.py [--arch smollm-360m] [--layers N ...]
                                   [--d-model D] [--seeds 5 6 7]
                                   [--device cpu]

draws ``--arch`` in float32, at its published widths and depth (each
``--layers`` cuts the decoder's depth), or with ``--d-model`` at that width
with 4 q and 2 kv heads, d_ff 2 d_model and vocab 2048, from a generator
seeded 1, and takes the gradients of ``train_loss`` on 1 x 64 tokens
seeded 3 (``chip_smoke.py``'s card-against-CPU batch; whisper's frames
from ``launch.train._frames_for``).  It takes them again with every weight
multiplied by 1 +/- 2^-23 (one float32 ulp, the size of a difference
between two devices' sums, signs drawn from each ``--seeds``), and prints
per depth and seed the loss's relative change and the worst leaf's gap,
over the leaf's largest gradient (``worst_leaf_gap``) and as a relative L2
norm (``worst_leaf_l2``): ``rounded`` as the model runs, ``unrounded``
with ``layers._bf16_dot`` as a plain float32 einsum.  ``control`` is a
fault, on the weights without noise: attention's backward (self and
cross) drops the cotangent of K and V at the middle key position, as a
kernel that skips one row of a tile would.  It runs on the card unless
``--device cpu`` is given, and checks nothing.
"""
from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import pathlib
import sys

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / 'src'))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.tokens import synthetic_batch  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.launch.train import _frames_for  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import registry  # noqa: E402

ROUNDED = L._bf16_dot


def unrounded_dot(eq: str, a, b):
    return torch.einsum(eq, a.float(), b.float())


class _DropMiddleKey(torch.autograd.Function):
    """The identity, whose backward zeroes the cotangent of the middle
    position of axis 1 (the key axis of K and V in ``flash_attention``)."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        g[:, g.shape[1] // 2] = 0
        return g


def faulty_dot(eq: str, a, b):
    return ROUNDED(eq, a, _DropMiddleKey.apply(b))


def grads(model, cfg, batch) -> tuple:
    names, params = zip(*model.named_parameters())
    loss = registry.module_for(cfg).train_loss(model, batch, cfg, None)
    return (float(loss.detach()),
            dict(zip(names, torch.autograd.grad(loss, params))))


def leaf_gaps(g0: dict, g1: dict) -> dict:
    """The worst leaf's gap over its largest gradient and its relative L2
    gap, each with the leaf's name."""
    peak = {k: float((g0[k] - g1[k]).abs().max()
                     / max(float(g0[k].abs().max()), 1e-30)) for k in g0}
    l2 = {k: float((g0[k] - g1[k]).norm() / max(float(g0[k].norm()), 1e-30))
          for k in g0}
    worst, worst_l2 = max(peak, key=peak.get), max(l2, key=l2.get)
    return {'worst_leaf': worst, 'worst_leaf_gap': peak[worst],
            'worst_l2_leaf': worst_l2, 'worst_leaf_l2': l2[worst_l2]}


def noisy_copy(model, dev, seed: int):
    noisy = copy.deepcopy(model)
    gen = torch.Generator(device=dev).manual_seed(seed)
    with torch.no_grad():
        for p in noisy.parameters():
            sign = torch.randn(p.shape, generator=gen, device=dev).sign()
            p.mul_(1 + 2.0 ** -23 * sign)
    return noisy


def config(arch: str, n_layers, d_model):
    cfg = get_config(arch)
    if d_model is not None:
        cfg = cfg.reduced(n_layers=n_layers or cfg.n_layers, d_model=d_model,
                          n_heads=4, n_kv_heads=2, d_ff=2 * d_model,
                          vocab=2048)
    elif n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    return dataclasses.replace(cfg, dtype='float32', remat=False)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument('--arch', default='smollm-360m')
    ap.add_argument('--layers', type=int, nargs='+', default=[None])
    ap.add_argument('--d-model', type=int, default=None)
    ap.add_argument('--seeds', type=int, nargs='+', default=[5, 6, 7])
    ap.add_argument('--device', default=None)
    args = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = resolve_device(args.device)
    try:
        for n in args.layers:
            cfg = config(args.arch, n, args.d_model)
            model = registry.init_params(1, cfg, device=dev)
            batch = synthetic_batch(3, 0, 1, 64, cfg.vocab, device=dev)
            if cfg.family == 'encdec':
                batch['frames'] = _frames_for(cfg, batch['tokens'])
            head = f'{args.arch} {cfg.n_layers} layers'
            for label, dot in (('rounded', ROUNDED),
                               ('unrounded', unrounded_dot)):
                L._bf16_dot = dot
                loss0, g0 = grads(model, cfg, batch)
                for seed in args.seeds:
                    loss1, g1 = grads(noisy_copy(model, dev, seed), cfg,
                                      batch)
                    print(f'{head} {label} seed {seed}: ' + json.dumps(
                        {'loss_rel': abs(loss1 - loss0) / abs(loss0),
                         **leaf_gaps(g0, g1)}), flush=True)
                if label == 'rounded':
                    L._bf16_dot = faulty_dot
                    loss1, g1 = grads(model, cfg, batch)
                    print(f'{head} control: ' + json.dumps(
                        {'loss_rel': abs(loss1 - loss0) / abs(loss0),
                         **leaf_gaps(g0, g1)}), flush=True)
            L._bf16_dot = ROUNDED
    finally:
        L._bf16_dot = ROUNDED


if __name__ == '__main__':
    main()
