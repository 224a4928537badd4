"""Deterministic host-sharded synthetic tokens.

Batch content is a pure function of (seed, step, row, column): a
counter-based hash, not a stateful generator, so a restart resumes with no
drift and hosts never disagree.  Each host makes only its slice of the
global batch (``host_id / num_hosts``), and the slices concatenate to the
single-host batch.  Tokens follow a Markov-like process (half of each
token's entropy comes from its 8-token block), and labels are the next
tokens.

The hash runs in numpy ``uint32`` on the host, where multiplication wraps
as the JAX package's uint32 lanes do; the tokens then move to ``device``
(the card unless the caller asks for the CPU).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import resolve_device

_U32 = 0xFFFFFFFF


def _mix(x: np.ndarray) -> np.ndarray:
    """32-bit counter hash (xxhash-style avalanche) on uint32 arrays."""
    x = x.astype(np.uint32)
    x = (x ^ (x >> np.uint32(16))) * np.uint32(0x7FEB352D)
    x = (x ^ (x >> np.uint32(15))) * np.uint32(0x846CA68B)
    return x ^ (x >> np.uint32(16))


def _tokens_host(seed: int, step: int, batch: int, seq: int, vocab: int,
                 batch_offset: int) -> np.ndarray:
    rows = (np.arange(batch, dtype=np.uint32)[:, None]
            + np.uint32(batch_offset & _U32))
    cols = np.arange(seq, dtype=np.uint32)[None, :]
    stream = _mix(rows * np.uint32(2654435761) + np.uint32(seed & _U32))
    # the step's multiplies wrap in 32 bits, done on Python ints
    base = _mix(stream + cols + np.uint32(int(step) * 0x9E3779B9 & _U32))
    block = _mix(stream + cols // np.uint32(8)
                 + np.uint32(int(step) * 0x85EBCA6B & _U32))
    tok = (base % np.uint32(vocab // 2)
           + block % np.uint32((vocab + 1) // 2))
    return np.minimum(tok, np.uint32(vocab - 1)).astype(np.int32)


def synthetic_tokens(seed: int, step: int, batch: int, seq: int, vocab: int,
                     *, batch_offset: int = 0, device=None) -> torch.Tensor:
    """[batch, seq] int32 tokens, a pure function of (seed, step, row, col)."""
    return torch.from_numpy(_tokens_host(seed, step, batch, seq, vocab,
                                         batch_offset)).to(
        resolve_device(device))


def synthetic_batch(seed: int, step: int, batch: int, seq: int, vocab: int,
                    *, batch_offset: int = 0, device=None) -> dict:
    """{'tokens', 'labels'}: next-token labels."""
    tokens = synthetic_tokens(seed, step, batch, seq + 1, vocab,
                              batch_offset=batch_offset, device=device)
    return {'tokens': tokens[:, :-1], 'labels': tokens[:, 1:]}


@dataclasses.dataclass
class TokenStream:
    """Host-sharded deterministic stream with a checkpointable position."""

    seed: int
    global_batch: int
    seq: int
    vocab: int
    host_id: int = 0
    num_hosts: int = 1
    step: int = 0
    device: object = None

    def __post_init__(self):
        if self.global_batch % self.num_hosts:
            raise ValueError(f'global batch {self.global_batch} does not '
                             f'split over {self.num_hosts} hosts')
        self.local_batch = self.global_batch // self.num_hosts

    def next(self) -> dict:
        batch = synthetic_batch(
            self.seed, self.step, self.local_batch, self.seq, self.vocab,
            batch_offset=self.host_id * self.local_batch, device=self.device)
        self.step += 1
        return batch

    def __iter__(self):
        return self

    def __next__(self):
        return self.next()

    def state_dict(self) -> dict:
        return {'step': self.step, 'seed': self.seed}

    def load_state_dict(self, state: dict) -> None:
        if int(state['seed']) != self.seed:
            raise ValueError('stream seed mismatch')
        self.step = int(state['step'])


def global_batch_view(seed: int, step: int, global_batch: int, seq: int,
                      vocab: int, *, device=None) -> dict:
    """The single-host view of the whole global batch: every host's slice,
    concatenated in host order, equals it."""
    return synthetic_batch(seed, step, global_batch, seq, vocab, device=device)
