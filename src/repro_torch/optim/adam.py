"""AdamW over a sequence of tensors, as the JAX package's ``optim.adam``.

  * optional bf16 first/second moments (``state_dtype``);
  * global-norm gradient clipping;
  * decoupled weight decay;
  * bias correction inside the update: ``(m / c1) / (sqrt(v / c2) + eps)``;
  * a learning-rate scale a step (``lr_scale``, a float or a device
    tensor from ``optim.schedule``), as the LM trainer passes it.

``torch.optim.Adam`` is not used: it places ``eps`` after the bias
correction of ``v`` alone, and its defaults (``b2`` 0.999, no clipping)
differ.  A scene's parameters go in ``FIELDS`` order
(``[getattr(scene, f) for f in FIELDS]``), a model's in
``model.parameters()`` order; the moments follow the same order.

``step`` updates the parameters and the moments in place, one tensor at a
time, and applies the clipping scale to each gradient as it goes: a step
holds no second copy of the gradients or the moments, which a model of
3.7 B parameters with float32 moments would not fit beside on an 80 GB
card.

On DTensor parameters (``registry.shard_step_inputs``) each moment has its
parameter's placements, each gradient is first laid out as its parameter
(a pending sum over the batch axes is reduced there, once), and the
global norm is one replicated scalar over every rank's blocks; the update
of each block stays local and in place.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence

import torch

from ..runtime.sharding import as_dtensor_like, to_replicated


class AdamState(NamedTuple):
    step: torch.Tensor          # 0-d int32
    mu: tuple                   # first moments, one per parameter
    nu: tuple                   # second moments, one per parameter


@dataclasses.dataclass(frozen=True)
class AdamConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0
    clip_norm: Optional[float] = 1.0
    state_dtype: torch.dtype = torch.float32   # torch.bfloat16 to halve the state


def init(params: Sequence[torch.Tensor], cfg: AdamConfig) -> AdamState:
    """Zero moments in ``cfg.state_dtype``, each laid out as its parameter
    (``zeros_like`` keeps a DTensor's placements), and step 0 (of DTensor
    parameters, replicated on their mesh)."""
    zeros = lambda p: torch.zeros_like(p, dtype=cfg.state_dtype,  # noqa: E731
                                       memory_format=torch.contiguous_format)
    return AdamState(
        step=as_dtensor_like(torch.zeros((), dtype=torch.int32,
                                         device=params[0].device), params[0]),
        mu=tuple(zeros(p) for p in params),
        nu=tuple(zeros(p) for p in params))


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """The float32 L2 norm of all ``tensors``; of DTensors, replicated on
    every rank."""
    norm = torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tensors))
    return to_replicated(norm)


def _as_param(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """The gradient ``g`` in the layout of its parameter ``p`` (DTensors:
    a replicated parameter's pending sum is all-reduced, a sharded one's
    reduce-scattered); plain tensors pass unchanged."""
    from torch.distributed.tensor import DTensor
    if not isinstance(g, DTensor) or g.placements == p.placements:
        return g
    return g.redistribute(p.device_mesh, p.placements)


@torch.no_grad()
def step(params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
         state: AdamState, cfg: AdamConfig,
         lr_scale: float | torch.Tensor = 1.0):
    """One AdamW update at ``cfg.lr * lr_scale``.  The parameters and the
    moments of ``state`` are updated in place; returns (params, the state
    with its step advanced, pre-clip global gradient norm)."""
    grads = [_as_param(g, p) for g, p in zip(grads, params)]
    gnorm = global_norm(grads)
    scale = None
    if cfg.clip_norm is not None:
        scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-12),
                            max=1.0)

    count = state.step + 1
    b1, b2 = cfg.b1, cfg.b2
    cf = count.float()
    c1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                      device=cf.device), cf)
    c2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                      device=cf.device), cf)
    lr = cfg.lr * lr_scale

    for p, g, m, v in zip(params, grads, state.mu, state.nu):
        if scale is not None:
            g = g * scale.to(g.dtype)
        g32 = g.float()
        m32 = b1 * m.float() + (1 - b1) * g32
        v32 = b2 * v.float() + (1 - b2) * g32 * g32
        update = (m32 / c1) / (torch.sqrt(v32 / c2) + cfg.eps)
        if cfg.weight_decay:
            update = update + cfg.weight_decay * p.float()
        p.copy_((p.float() - lr * update).to(p.dtype))
        m.copy_(m32)
        v.copy_(v32)
    return params, AdamState(count, state.mu, state.nu), gnorm
