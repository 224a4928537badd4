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
card.  Each tensor is updated in row slices of at most ``SLICE_BYTES`` of
float32 (``_slices``), float32 moments in place, so the update's float32
temporaries are two slices at most (XLA fuses JAX's update into one pass
with none); a tensor under the cap is one slice.  Every element goes
through the operations of the whole-tensor update, in its order, so the
slicing changes no bit.

On DTensor parameters (``registry.shard_step_inputs``) each moment has its
parameter's placements, each gradient is first laid out as its parameter
(a pending sum over the batch axes is reduced there, once), and the
global norm is one replicated scalar over every rank's blocks; the update
runs on each rank's local blocks, in place.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence

import torch

from ..runtime.sharding import as_dtensor_like, to_replicated

SLICE_BYTES = 64 << 20   # float32 bytes of one slice of a tensor's update


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
    every rank.  Each tensor's sum of squares runs whole, so it rounds as
    one reduction; a bfloat16 tensor's float32 copy is squared in place,
    the one temporary of its size."""
    def sum_sq(x):
        x32 = x.float()
        return torch.sum(x32.square_() if x32 is not x else torch.square(x))

    return to_replicated(torch.sqrt(sum(sum_sq(x) for x in tensors)))


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
    # the scalars' local values: each block's update runs on local tensors
    scale, c1, c2, lr = (_local(x) for x in (scale, c1, c2, lr))

    for p, g, m, v in zip(params, grads, state.mu, state.nu):
        if hasattr(p, 'placements'):
            if not (tuple(g.placements) == tuple(m.placements)
                    == tuple(v.placements) == tuple(p.placements)):
                raise ValueError('adam.step takes each moment laid out as '
                                 'its parameter')
            p, g, m, v = (t.to_local() for t in (p, g, m, v))
        gs = None if scale is None else scale.to(g.dtype)
        for idx in _slices(p.shape, SLICE_BYTES):
            _update(p[idx], g[idx], m[idx], v[idx], gs, cfg, c1, c2, lr)
    return params, AdamState(count, state.mu, state.nu), gnorm


def _local(x):
    """A DTensor's local block; anything else (a float, None) as is."""
    return x.to_local() if hasattr(x, 'placements') else x


def _slices(shape, cap: int):
    """Indices that cut a tensor of ``shape`` into slices of leading rows,
    each at most ``cap`` bytes in float32 (a row above the cap is cut the
    same way in turn); a tensor under the cap, a 0-d one too, is the one
    slice ``()``."""
    if len(shape) == 0 or 4 * shape.numel() <= cap:
        yield ()
        return
    row = 4 * shape[1:].numel()
    if row > cap:
        for i in range(shape[0]):
            for idx in _slices(shape[1:], cap):
                yield (i, *idx)
        return
    n = cap // row
    for i in range(0, shape[0], n):
        yield (slice(i, i + n),)


def _update(p, g, m, v, gscale, cfg: AdamConfig, c1, c2, lr):
    """One slice's AdamW update, in place in ``p``, ``m`` and ``v``: the
    operations of JAX's ``upd``, in its order, on float32 temporaries of
    the slice, two with float32 moments (updated in place: ``m.float()``
    is then ``m`` itself), four with bfloat16 ones."""
    b1, b2 = cfg.b1, cfg.b2
    g32 = (g if gscale is None else g * gscale).float()
    m32 = m.float().mul_(b1)
    t = g32 * (1 - b1)
    m32.add_(t)                                    # b1 m + (1 - b1) g
    v32 = v.float().mul_(b2)
    torch.mul(g32, 1 - b2, out=t).mul_(g32)
    v32.add_(t)                                    # b2 v + (1 - b2) g g
    del g32
    u = torch.div(m32, c1)
    u.div_(torch.div(v32, c2, out=t).sqrt_().add_(cfg.eps))
    del t
    if m32 is not m:                               # moments in bfloat16
        m.copy_(m32)
    if v32 is not v:
        v.copy_(v32)
    del m32, v32
    if cfg.weight_decay:
        w = p.float()
        u.add_(w.mul_(cfg.weight_decay) if w is not p
               else w * cfg.weight_decay)
        del w
    p.copy_(torch.sub(p.float(), u.mul_(lr), out=u))
