"""Continuous-batching LM token server.

A small but real serving core, as in the JAX package:
  * a queue of synthetic requests;
  * **continuous batching**: a finished request's slot (its rows of the K/V
    cache) is refilled between decode steps;
  * prefill on admit by teacher-forcing the prompt through the batched
    decode step, one token at a time, at the slot's own positions;
  * one batched decode step a tick for all slots, at one position for every
    slot: the largest of the active slots' positions;
  * greedy sampling with a per-request budget of new tokens.

The decode step writes K/V at its position for every row of the batch, so
admitting a request overwrites the prompt K/V of the requests already in
flight, and a slot admitted later skips positions (ROADMAP queue 3).  The
port reproduces this, as it reproduces the reference.  So it does the
reference's partial reset of a reused slot: for the ``ssm`` family the
rows of the state arrays of rank 4 or more (the mLSTM state) are zeroed,
the sLSTM state is not, and a ``hybrid`` slot keeps its Mamba2 state; and
an ``encdec`` slot decodes against the zero cross K/V of
``registry.init_decode_state`` (ROADMAP queue 3).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m \\
        --slots 4 --requests 12 --max-new 16            # on the card
    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m \\
        --device cpu --slots 2 --requests 3 --prompt-len 4 --max-new 4 \\
        --max-seq 32

Every family of ``models.registry`` serves: dense, vlm, moe, encdec, ssm
and hybrid.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional

import torch

from ..configs import get_config
from ..data.tokens import synthetic_tokens
from ..device import resolve_device
from ..models import registry

#: ticks after which a serve loop that has not drained is an error
MAX_TICKS = 10_000


@dataclasses.dataclass
class Request:
    rid: int
    prompt: torch.Tensor       # [len] int32, on the server's device
    max_new: int
    out: list = dataclasses.field(default_factory=list)
    admitted_at: float = 0.0
    done_at: float = 0.0


class Server:
    """Slot-based continuous batching over the registry's decode step.

    Runs on the card unless ``device`` asks for the CPU; the weights are
    random from a generator seeded 0 on that device (``params`` may be
    replaced before serving).  ``full`` keeps the config's published widths,
    else it is ``reduced()``.  On a device ``mesh`` (``launch.mesh``) the
    heads are padded to its ``model`` size and the decode step runs on this
    rank with the mesh in its context; a one-token step is not divisible
    by ``model`` (above 1), so the MoE FFN decodes on its local path, as
    in the JAX package.
    """

    def __init__(self, arch: str, *, slots: int = 4, max_seq: int = 512,
                 full: bool = False, mesh=None, device=None):
        cfg = get_config(arch)
        if not full:
            cfg = cfg.reduced()
        self.cfg = cfg
        self.device = resolve_device(device)
        self.ctx = registry.make_ctx(mesh, cfg)
        tp = registry.tp_of(mesh, cfg)
        self.params = registry.init_params(0, cfg, tp, device=self.device)
        self.slots = slots
        self.max_seq = max_seq

        self.decode_fn = registry.make_decode_step(cfg, self.ctx)
        self.state = registry.init_decode_state(cfg, slots, max_seq, tp,
                                                device=self.device)
        self.slot_req: list[Optional[Request]] = [None] * slots
        self.slot_pos = [0] * slots
        self.cur_tok = torch.zeros((slots, 1), dtype=torch.int32,
                                   device=self.device)

    def admit(self, req: Request, slot: int) -> None:
        """Teacher-force the prompt through the batched decode step at the
        slot's positions 0..len-1 (the other rows feed their current
        token); the last step's argmax is the request's first token."""
        req.admitted_at = time.time()
        self.slot_req[slot] = req
        self.slot_pos[slot] = 0
        if self.cfg.family == 'ssm':
            # the reference's reset: zero this slot's row (axis -4) of each
            # state array of rank >= 4
            for a in self.state.values():
                if a.ndim >= 4:
                    a[..., slot, :, :, :] = 0
        for t in range(req.prompt.shape[0]):
            tok = self.cur_tok.clone()
            tok[slot, 0] = req.prompt[t]
            logits, self.state = self.decode_fn(
                self.params, tok, self.state, self.slot_pos[slot])
            self.slot_pos[slot] += 1
        nxt = int(torch.argmax(logits[slot]))
        self.cur_tok[slot, 0] = nxt
        req.out.append(nxt)

    def step(self) -> list[Request]:
        """One batched decode tick for all slots at the largest active
        position.  Returns the requests that finished on this tick (their
        slots are freed and can be refilled before the next tick)."""
        active = [i for i, r in enumerate(self.slot_req) if r is not None]
        if not active:
            return []
        pos = max(self.slot_pos[i] for i in active)
        logits, self.state = self.decode_fn(
            self.params, self.cur_tok, self.state, pos)
        nxt = torch.argmax(logits, dim=-1)
        finished = []
        for i in active:
            r = self.slot_req[i]
            tok = int(nxt[i])
            r.out.append(tok)
            self.slot_pos[i] = pos + 1
            if len(r.out) >= r.max_new or self.slot_pos[i] >= self.max_seq - 1:
                r.done_at = time.time()
                self.slot_req[i] = None
                finished.append(r)
        self.cur_tok = nxt[:, None].to(torch.int32)
        return finished

    def free_slots(self) -> list[int]:
        return [i for i, r in enumerate(self.slot_req) if r is None]


def synthetic_requests(n_requests: int, prompt_len: int, max_new: int,
                       vocab: int, *, device) -> list[Request]:
    """Request i's prompt is ``synthetic_tokens(7, i, 1, prompt_len,
    vocab)[0]``, as in the JAX package's ``run``."""
    return [Request(rid=i,
                    prompt=synthetic_tokens(7, i, 1, prompt_len, vocab,
                                            device=device)[0],
                    max_new=max_new)
            for i in range(n_requests)]


def drain(server: Server, pending: list[Request]) -> tuple:
    """The serve loop: refill free slots in order, then one tick, until
    every request is done.  Returns (finished requests, ticks)."""
    pending = list(pending)
    done: list[Request] = []
    ticks = 0
    while pending or any(server.slot_req):
        for slot in server.free_slots():
            if not pending:
                break
            server.admit(pending.pop(0), slot)
        done.extend(server.step())
        ticks += 1
        if ticks > MAX_TICKS:
            raise RuntimeError('serve loop did not drain')
    return done, ticks


def run(arch: str, *, slots: int = 4, n_requests: int = 8,
        prompt_len: int = 8, max_new: int = 16, max_seq: int = 256,
        device=None, print_fn=print) -> dict:
    """Serve ``n_requests`` synthetic requests on a reduced ``arch``."""
    server = Server(arch, slots=slots, max_seq=max_seq, device=device)
    pending = synthetic_requests(n_requests, prompt_len, max_new,
                                 server.cfg.vocab, device=server.device)
    t0 = time.time()
    done, ticks = drain(server, pending)
    dt = time.time() - t0
    # tokens actually emitted (requests can stop early at max_seq)
    total_tokens = sum(len(r.out) for r in done)
    stats = {'requests': n_requests, 'completed': len(done), 'ticks': ticks,
             'tokens': total_tokens, 'wall_s': dt,
             'tok_per_s': total_tokens / dt}
    print_fn(f'{arch}: {len(done)}/{n_requests} requests, {ticks} ticks, '
             f'{total_tokens} tokens, {stats["tok_per_s"]:.1f} tok/s '
             f'on {server.device}')
    return stats


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--arch', required=True)
    ap.add_argument('--slots', type=int, default=4)
    ap.add_argument('--requests', type=int, default=8)
    ap.add_argument('--prompt-len', type=int, default=8)
    ap.add_argument('--max-new', type=int, default=16)
    ap.add_argument('--max-seq', type=int, default=256)
    ap.add_argument('--device', default=None,
                    help="'cpu' for the host; the card by default")
    args = ap.parse_args()
    run(args.arch, slots=args.slots, n_requests=args.requests,
        prompt_len=args.prompt_len, max_new=args.max_new,
        max_seq=args.max_seq, device=args.device)


if __name__ == '__main__':
    main()
