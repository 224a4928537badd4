"""LM train driver: any --arch, with checkpoints and auto-resume, as the JAX
package's ``launch.train``.

  data (``TokenStream`` on the device) -> model (``models.registry``) ->
  optimizer (AdamW in place, a warmup-cosine learning-rate scale) ->
  checkpoint manager (async, keep-K, auto-resume) -> straggler detector.

Runs on the card unless ``device`` asks for the CPU; ``full`` keeps the
config's published widths and depth, else it is ``reduced()``.  On a
device ``mesh`` (``launch.mesh``; every rank runs the same program) the
heads are padded to the mesh's ``model`` size and the MoE FFN runs
expert-parallel where the mesh divides it (``models.moe``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \\
        --steps 50 --batch 8 --seq 256 --ckpt-dir build/ckpt --full
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
        --arch smollm-360m --steps 8 --batch 2 --seq 64
    PYTHONPATH=src torchrun --standalone --nproc-per-node 4 \\
        -m repro_torch.launch.train --device cpu --mesh 2,2 \\
        --arch granite-moe-1b-a400m --steps 3 --batch 4 --seq 64
"""
from __future__ import annotations

import argparse
import os
import time

import torch
import torch.distributed as dist

from ..checkpoint import CheckpointManager
from ..configs import get_config
from ..data.tokens import TokenStream
from ..device import resolve_device
from .mesh import make_test_mesh
from ..models import registry
from ..optim import adam, schedule
from ..runtime.straggler import StragglerDetector


def train_state(model, opt_state: adam.AdamState) -> tuple:
    """What a checkpoint holds: the parameters by name (the manager walks
    dicts, not modules) and the optimizer state."""
    return ({k: p.detach() for k, p in model.named_parameters()}, opt_state)


def train(arch: str, *, steps: int = 100, batch: int = 8, seq: int = 256,
          lr: float = 3e-4, warmup: int = 20, ckpt_dir: str = '',
          ckpt_every: int = 50, keep: int = 3, seed: int = 0,
          full: bool = False, mesh=None, log_every: int = 10,
          print_fn=print, device=None):
    """Train ``arch`` for ``steps`` steps of ``batch`` x ``seq`` tokens.
    Returns (model, optimizer state, the loss of every step run).

    With ``ckpt_dir`` it resumes from the newest checkpoint there and saves
    every ``ckpt_every`` steps and at the end (on a mesh every rank holds
    the same state, and rank 0 writes it).  The learning-rate scale
    depends only on (step, ``warmup``, ``steps``): a resumed run sees the
    scales that the interrupted one would have."""
    cfg = get_config(arch)
    if not full:
        cfg = cfg.reduced()
    dev = resolve_device(device)
    ctx = registry.make_ctx(mesh, cfg)
    tp = registry.tp_of(mesh, cfg)

    model = registry.init_params(seed, cfg, tp, device=dev)
    acfg = adam.AdamConfig(lr=lr,
                           state_dtype=getattr(torch, cfg.opt_state_dtype))

    def sched(step):
        return schedule.linear_warmup_cosine(
            step, warmup_steps=warmup, total_steps=steps)

    step_fn, _ = registry.make_train_step(cfg, ctx, acfg, schedule=sched)
    opt_state = adam.init(list(model.parameters()), acfg)

    stream = TokenStream(seed=seed, global_batch=batch, seq=seq,
                         vocab=cfg.vocab, device=dev)
    mgr = CheckpointManager(ckpt_dir, keep=keep) if ckpt_dir else None
    writer = mesh is None or dist.get_rank() == 0
    start = 0
    if mgr is not None:
        restored = mgr.restore_latest(train_state(model, opt_state))
        if restored is not None:
            (named, opt_state), start, extra = restored
            with torch.no_grad():
                for k, p in model.named_parameters():
                    p.copy_(named[k])
            stream.load_state_dict(extra['stream'])
            print_fn(f'resumed from step {start}')

    detector = StragglerDetector(num_hosts=1)
    history = []
    for step in range(start, steps):
        t0 = time.perf_counter()
        b = stream.next()
        if cfg.family == 'encdec':
            b = dict(b, frames=_frames_for(cfg, b['tokens']))
        model, opt_state, metrics = step_fn(model, opt_state, b)
        loss = float(metrics['loss'])
        dt = time.perf_counter() - t0
        detector.observe(0, dt)
        history.append(loss)
        if log_every and step % log_every == 0:
            print_fn(f'step {step:5d}  loss {loss:.4f}  '
                     f'gnorm {float(metrics["grad_norm"]):.3f}  '
                     f'{dt * 1e3:.0f}ms')
        if writer and mgr is not None and ckpt_every and \
                (step + 1) % ckpt_every == 0:
            mgr.save(train_state(model, opt_state), step=step + 1,
                     extra={'stream': stream.state_dict()})
    if writer and mgr is not None:
        mgr.save(train_state(model, opt_state), step=steps,
                 extra={'stream': stream.state_dict()})
        mgr.wait()
    return model, opt_state, history


def _frames_for(cfg, tokens: torch.Tensor) -> torch.Tensor:
    """Stub modality frontend: the token ids hash-embedded as frames
    ``sin(token * (1..d) * 0.01)``, in float32, then the model dtype."""
    d = torch.arange(1, cfg.d_model + 1, dtype=torch.float32,
                     device=tokens.device)
    base = torch.sin(tokens[..., None].float() * d * 0.01)
    return base.to(getattr(torch, cfg.dtype))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--arch', required=True)
    ap.add_argument('--steps', type=int, default=100)
    ap.add_argument('--batch', type=int, default=8)
    ap.add_argument('--seq', type=int, default=256)
    ap.add_argument('--lr', type=float, default=3e-4)
    ap.add_argument('--warmup', type=int, default=20)
    ap.add_argument('--ckpt-dir', default='')
    ap.add_argument('--ckpt-every', type=int, default=50)
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--full', action='store_true',
                    help='published widths and depth; default: reduced')
    ap.add_argument('--device', default=None,
                    help="torch device (default: the card; 'cpu' for the "
                         'plain PyTorch run)')
    ap.add_argument('--mesh', default='',
                    help="'DATA,MODEL': train on a (data, model) mesh of "
                         "the ranks torchrun launched (gloo on the CPU, "
                         'NCCL on the cards)')
    args = ap.parse_args(argv)
    mesh, say = None, print
    if args.mesh:
        mesh = launch_mesh(tuple(int(n) for n in args.mesh.split(',')),
                           args.device)
        if dist.get_rank():
            say = lambda *a, **k: None      # noqa: E731 -- rank 0 prints
    try:
        _, _, history = train(
            args.arch, steps=args.steps, batch=args.batch, seq=args.seq,
            lr=args.lr, warmup=args.warmup, ckpt_dir=args.ckpt_dir,
            ckpt_every=args.ckpt_every, seed=args.seed, full=args.full,
            mesh=mesh, print_fn=say, device=args.device)
    finally:
        if mesh is not None:
            dist.destroy_process_group()
    say(f'final loss {history[-1]:.4f} (from {history[0]:.4f})')


def launch_mesh(shape: tuple, device=None):
    """The (data, model) mesh of a ``torchrun`` launch: the process group
    from its environment (NCCL with each rank on its local card, gloo on
    the CPU), then ``launch.mesh.make_test_mesh``."""
    dev = resolve_device(device)
    if dev.type == 'cuda':
        torch.cuda.set_device(int(os.environ.get('LOCAL_RANK', 0)))
    dist.init_process_group('nccl' if dev.type == 'cuda' else 'gloo')
    return make_test_mesh(shape, device=device)


if __name__ == '__main__':
    main()
