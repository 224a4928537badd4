"""Layers of the dense LM family: plain functions on tensors.

Conventions, as in the JAX package:
  * activations [batch, seq, d_model]; attention heads [B, S, H, head_dim];
  * a layer's parameters are a mapping of named tensors (a dict, or the
    ``nn.ParameterDict`` that holds them in ``transformer.Transformer``);
  * TP head padding: q heads are padded to the model-axis size with masked
    extra heads, whose outputs are zeroed; kv heads keep their true count
    and ``repeat_kv`` maps q heads onto them by gather.

Initialisation draws from an explicit ``torch.Generator`` on the device the
parameters are made on; the distributions are the JAX package's, the
streams are not.

Partitioning: every function that the JAX package gives a ``ShardCtx``
takes one as ``ctx`` (none: no layout) and calls its layout hooks where
the JAX package does.  On DTensor inputs (``registry.shard_step_inputs``,
``registry.shard_decode_inputs``)
the ops between the hooks run partitioned by DTensor's sharding
propagation.  Where DTensor has no strategy or would mix a plain tensor
into a DTensor op, the layout is explicit:

  * constants (rotary frequencies, the head and vocab masks) are
    DTensors too (``sharding.as_dtensor_like``);
  * the projections out of the residual stream (``project``) and
    ``repeat_kv`` run on each rank's blocks (``local_map``) in a layout
    said in the code: a column-sharded (TP) weight takes its input with
    the sequence gathered, a replicated one keeps the input's shards;
    ``repeat_kv`` gathers the kv heads whole first, unless each block of
    q heads maps into the same block of kv heads (the long-context
    cache's heads over ``model``), where each rank gathers from its own
    block; ``embed`` is
    ``F.embedding``; the projections back into it (``merge``) take the
    weight with its rows sharded as the input's last axis;
  * ``flash_attention`` runs on each rank's block (``attend``): the
    ``bthd`` layout never shards the sequence or ``head_dim``, so each
    (batch, head) block attends alone, as GSPMD keeps the JAX scan local;
  * the decode step's K/V write at ``pos`` (``write_at``) runs on each
    rank's block of a sequence-sharded cache (``local_map``): only the
    rank whose block holds the position writes, in place;
  * the decode attention (``decode_attend``) never gathers the cache's
    sequence: q is laid out with the cache's batch, heads and head_dim,
    each rank scores its block of the sequence masked by global positions
    (``local_map``; ``torch.arange`` would compare local indices), the
    partial scores of a split head_dim (the long-context layout where
    ``model`` does not divide the kv heads) reduced before the mask, and
    the softmax is the flash-decoding combine over the mesh dimension
    that splits the sequence (``model``, or ``data`` in the long-context
    layout), a max and two sums reduced across ranks where they are made
    (``torch.softmax`` on a sharded sequence would gather it); the
    weighted V is a ``local_map`` einsum with a pending sum, its split
    head_dim laid out as heads (``bthd``) before the heads are merged;
  * the unembedding is laid out with its vocab over ``model`` (``ctx.dv``)
    before the logits' matmul, as GSPMD would carry ``btv`` back into it;
  * ``rmsnorm`` over a sharded last axis (an mLSTM's dv) reduces the sum
    of squares across ranks before the division, its weight laid out as
    that axis;
  * an operand gathered whole for several products (``gathered``, or
    ``project``'s own gather with ``regather``: xlstm's mLSTM block) is
    saved for their backward as the rank's block, which the backward
    gathers again once for all of them (``Regather``), in place of the
    gathered whole;
  * ``project_heads`` projects into heads with head_dim over ``model``
    (the ``btdv`` layout), the weight's [D, H, hd] view sliced on each
    rank, where a contiguous column split would cut heads;
  * ``on_rows`` runs a function of each row alone on each rank's rows,
    its other axes and weights whole: the sLSTM walk (no collective in
    its loop), and ops DTensor has no strategy for (``logsigmoid``'s
    backward);
  * ``store`` writes a decode step's new recurrent state into its view of
    the stacked state, each rank its own block;
  * ``chunked_ce_loss`` gathers the sequence of the final states and the
    labels once (``sharding.unshard_dims``) before it slices its chunks,
    takes the log-sum-exp from a max and a sum (``_logsumexp``, reduced
    across ranks; ``torch.logsumexp`` would gather the vocab), picks the
    target's logit by a masked sum over the vocab (a DTensor gather on a
    sharded vocab leaves a masked partial sum that a later op fails to
    reduce, and its backward gathers the gradient whole), and returns the
    loss replicated.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..runtime.sharding import (ShardCtx, as_dtensor_like, axis_placements,
                                local_range, padded_heads, reduce_partials,
                                to_replicated, unshard_dims)

NEG_INF = -1e30      # the masked-score fill of the JAX package
NO_CTX = ShardCtx()  # no mesh: every layout hook passes its input unchanged

# ---------------------------------------------------------------------------
# Basics
# ---------------------------------------------------------------------------


def remat(on: bool, fn, *args):
    """``fn(*args)``; with ``on``, while grad is enabled, its activations
    are recomputed in the backward pass instead of kept (the JAX package's
    ``jax.checkpoint``).  The recompute replays the same operations on the
    same inputs, so it gives the same values and, in the MoE, the same
    routing.  ``fn`` draws no random numbers, so no RNG state is saved."""
    if not (on and torch.is_grad_enabled()):
        return fn(*args)
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False)


def rmsnorm(x: torch.Tensor, w: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm: statistics in float32, the scale applied in the input dtype
    (``x * (rsqrt(var + eps) * w).to(x.dtype)``).  Over a DTensor's
    sharded last axis, the mean square is reduced across ranks and ``w``
    is laid out as that axis."""
    x32 = x.float()
    if any(p.is_shard(x.ndim - 1) for p in getattr(x, 'placements', ())):
        # over a sharded last axis (an mLSTM's dv) the sum of squares is a
        # pending sum across ranks, reduced before the division (a mean
        # would leave a pending average, whose backward DTensor lacks)
        var = reduce_partials(torch.sum(x32 * x32, dim=-1, keepdim=True)
                              ) / x.shape[-1]
        # the weight laid out as that axis (a slice, nothing is sent): the
        # scale that the product saves is then the rank's block, not whole
        pl = axis_placements(x, -1)
        if tuple(pl) != tuple(w.placements):
            w = w.redistribute(w.device_mesh, pl)
    else:
        var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    scale = torch.rsqrt(var + eps)
    return x * (scale * w.float()).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """Rotary embedding in float32, cast once at the end.
    x: [B, S, H, hd], positions: [B, S] (int)."""
    hd = x.shape[-1]
    half = hd // 2
    steps = torch.arange(half, dtype=torch.float32, device=x.device)
    freqs = as_dtensor_like(torch.exp(-math.log(theta) * steps / half),
                            positions)
    ang = positions.float()[..., None] * freqs                   # [B,S,half]
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def normal(gen: torch.Generator, shape, dtype,
           scale: float = 0.02) -> torch.Tensor:
    """``scale`` times a standard normal draw, made in ``dtype`` on
    ``gen``'s device (no float32 copy of a bfloat16 tensor is held); on
    the ``meta`` device, a tensor with no values."""
    meta = gen.device.type == 'meta'     # shapes only (abstract_params)
    return torch.randn(shape, generator=None if meta else gen, dtype=dtype,
                       device=gen.device).mul_(scale)


def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype,
               scale: float = 0.02) -> torch.Tensor:
    return normal(gen, (d_in, d_out), dtype, scale)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

def attention_params(gen: torch.Generator, cfg, dtype, tp: int) -> dict:
    d, hd = cfg.d_model, cfg.resolved_head_dim()
    hp = padded_heads(cfg.n_heads, tp)   # q heads padded; kv heads true
    p = {
        'wq': dense_init(gen, d, hp * hd, dtype),
        'wk': dense_init(gen, d, cfg.n_kv_heads * hd, dtype),
        'wv': dense_init(gen, d, cfg.n_kv_heads * hd, dtype),
        'wo': dense_init(gen, hp * hd, d, dtype,
                         scale=0.02 / math.sqrt(2 * cfg.n_layers)),
    }
    if cfg.qk_norm:
        p['q_norm'] = torch.ones((hd,), dtype=dtype, device=gen.device)
        p['k_norm'] = torch.ones((hd,), dtype=dtype, device=gen.device)
    return p


def _head_mask(hp: int, n_heads: int, dtype, device) -> Optional[torch.Tensor]:
    if hp == n_heads:
        return None
    return (torch.arange(hp, device=device) < n_heads).to(dtype)


def _mask_heads(out: torch.Tensor, n_heads: int) -> torch.Tensor:
    """Zero the padded q heads of ``out`` [B, S, Hp, hd]."""
    mask = _head_mask(out.shape[2], n_heads, out.dtype, out.device)
    if mask is None:
        return out
    return out * as_dtensor_like(mask, out)[None, None, :, None]


class Regather:
    """The backward's gather of a DTensor's block whole again, in the
    layout ``placements`` that its forward gathered it to, for the ops that
    saved the block in place of the gathered value (``Gathered``): made
    once, at the first of their backwards, and kept until the last of them
    (``users``, one a forward) has taken it.  It holds no tensor of the
    forward."""

    def __init__(self, block, placements):
        self.src = (block.device_mesh, tuple(block.placements), block.shape,
                    block.stride())
        self.placements = tuple(placements)
        self.users, self.value = 0, None

    def __call__(self, local: torch.Tensor) -> torch.Tensor:
        from torch.distributed.tensor import DTensor
        if self.value is None:
            mesh, pl, shape, stride = self.src
            self.value = DTensor.from_local(
                local, mesh, pl, run_check=False, shape=shape,
                stride=stride).redistribute(mesh, self.placements).to_local()
        value = self.value
        self.users -= 1
        if self.users <= 0:
            self.value = None
        return value


class Gathered(NamedTuple):
    """A DTensor gathered once for the ops after it (``gathered``):
    ``whole`` feeds them; while grad is on each saves for its backward
    not ``whole`` but ``block`` (the value before the gather: this rank's
    block) and gathers it again through ``regather``."""
    whole: torch.Tensor
    block: torch.Tensor
    regather: Regather


def gathered(x: torch.Tensor, dims):
    """``unshard_dims(x, dims)`` as a ``Gathered``, for ``project`` and
    ``project_heads``; a plain tensor, or one with nothing to gather,
    passes unchanged."""
    whole = unshard_dims(x, dims)
    if whole is x:
        return x
    return Gathered(whole, x, Regather(x, whole.placements))


class _MatmulFromBlock(torch.autograd.Function):
    """``x @ w`` (x [..., K] whole, w [K, N]) that saves, in place of x,
    ``block`` (x's block before its gather) and gathers x again in the
    backward (``regather``).  The product and the gradients are
    ``torch.matmul``'s and autograd's own: x folded to [-1, K] and one
    ``mm``; each gradient the ``mm`` of ``mm_mat1_backward`` and
    ``mm_mat2_backward``, so no bit changes."""

    @staticmethod
    def forward(ctx, x, w, block, regather):
        regather.users += 1
        ctx.regather = regather
        ctx.save_for_backward(block, w)
        return x.reshape(-1, x.shape[-1]).mm(w).view(*x.shape[:-1],
                                                      w.shape[-1])

    @staticmethod
    def backward(ctx, grad):
        block, w = ctx.saved_tensors
        x = ctx.regather(block)
        x2 = x.reshape(-1, x.shape[-1])
        g2 = grad.reshape(-1, grad.shape[-1])
        gx = gw = None
        if ctx.needs_input_grad[0]:
            gx = g2.mm(w.t()).view(x.shape)
        if ctx.needs_input_grad[1]:
            col_major = w.stride(0) == 1 and w.stride(1) == w.shape[0]
            gw = g2.t().mm(x2).t() if col_major else x2.t().mm(g2)
        return gx, gw, None, None


def _on_blocks(fn, x, w, out_pl, in_pl, dx_pl, dw_pl, mesh):
    """``local_map`` of ``fn(x, w, mm)`` on the rank's blocks, ``mm`` its
    matmul: ``torch.matmul``, or for a ``Gathered`` x while grad is on one
    that saves x's block (``_MatmulFromBlock``)."""
    from torch.distributed.tensor.experimental import local_map
    kw = dict(out_placements=out_pl, device_mesh=mesh)
    if not (isinstance(x, Gathered) and torch.is_grad_enabled()):
        whole = x.whole if isinstance(x, Gathered) else x
        return local_map(lambda x, w: fn(x, w, torch.matmul),
                         in_placements=(in_pl, list(w.placements)),
                         in_grad_placements=(dx_pl, dw_pl), **kw)(whole, w)
    g, bl = x, list(x.block.placements)

    def run(x, w, block):
        return fn(x, w, lambda a, b: _MatmulFromBlock.apply(a, b, block,
                                                            g.regather))

    return local_map(run, in_placements=(in_pl, list(w.placements), bl),
                     in_grad_placements=(dx_pl, dw_pl, bl),
                     **kw)(g.whole, w, g.block)


def project(x, *ws: torch.Tensor, regather: bool = False) -> tuple:
    """``x @ w`` for each weight ``w`` [D, F]: the projections out of the
    residual stream.  On DTensors each runs on the rank's blocks
    (``local_map``) with the layout said here, because DTensor's own
    matmul flattens ``x``'s batch and sequence into one axis, which some
    torch versions refuse when both are sharded (``btd``).  On each mesh
    dimension: a weight whose columns are sharded there (TP) takes ``x``
    with that dimension gathered (sequence parallelism's all-gather) and
    gives columns sharded; else the result keeps ``x``'s shard.  The
    gradients are declared to match: a pending sum for ``x`` where the
    columns were split, for ``w`` where ``x`` was.  ``x`` may be a
    ``Gathered``; with ``regather`` the gather that the layout makes is
    one (the backward gathers x's block again, the gathered x is not
    kept)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    src = x
    if isinstance(x, Gathered):
        x = x.whole
    if not isinstance(x, DTensor):
        return tuple(x @ w for w in ws)
    x = reduce_partials(unshard_dims(x, (-1,)))    # the contraction whole
    mesh, n, out, seen = x.device_mesh, x.device_mesh.ndim, [], {}
    for w in ws:
        w = reduce_partials(unshard_dims(w, (0,)))
        tp = [w.placements[i].is_shard(1) for i in range(n)]
        pl = tuple(Replicate() if tp[i] else p
                   for i, p in enumerate(x.placements))
        if pl not in seen:
            if pl == x.placements:
                seen[pl] = src if isinstance(src, Gathered) else x
            elif regather:
                seen[pl] = Gathered(x.redistribute(mesh, pl), x,
                                    Regather(x, pl))
            else:
                seen[pl] = x.redistribute(mesh, pl)
        out_pl = [Shard(x.ndim - 1) if tp[i] else p
                  for i, p in enumerate(pl)]
        dx_pl = [Partial() if tp[i] else p for i, p in enumerate(pl)]
        dw_pl = [Partial() if p.is_shard() else w.placements[i]
                 for i, p in enumerate(pl)]
        out.append(_on_blocks(lambda x, w, mm: mm(x, w), seen[pl], w,
                              out_pl, list(pl), dx_pl, dw_pl, mesh))
    return tuple(out)


def project_heads(x, w: torch.Tensor, n_heads: int,
                  ctx: ShardCtx = NO_CTX) -> torch.Tensor:
    """``x @ w`` as ``n_heads`` heads [B, S, H, hd] of ``w``'s columns.

    On DTensors ``w`` [D, H*hd] is taken whole (FSDP rows gathered) and
    viewed as [D, H, hd] laid out as the values it makes
    (``ShardCtx.head_dim``: hd over ``model``; a slice, nothing is sent),
    and the product runs on each rank's blocks (``local_map``): each head
    comes out with its hd over ``model`` (the ``btdv`` layout), where a
    contiguous block of columns would split the heads themselves when
    ``model`` does not divide H (xlstm's 4 heads on 16 ranks).  The
    gradients are declared: a pending sum for ``x`` where hd is split,
    for ``w`` where ``x``'s rows are.  ``x`` may be a ``Gathered``."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    src = x
    if isinstance(x, Gathered):
        x = x.whole
    if not isinstance(x, DTensor):
        return (x @ w).reshape(*x.shape[:-1], n_heads, -1)
    x = reduce_partials(unshard_dims(x, (-1,)))
    w = reduce_partials(unshard_dims(w, (0, 1)))
    w = ctx.head_dim(w.view(w.shape[0], n_heads, w.shape[1] // n_heads))
    mesh, split = x.device_mesh, [p.is_shard(2) for p in w.placements]
    pl = [Replicate() if split[i] else p for i, p in enumerate(x.placements)]
    out_pl = [Shard(x.ndim) if split[i] else p for i, p in enumerate(pl)]
    if tuple(pl) != tuple(x.placements):
        x = x.redistribute(mesh, pl)
    elif isinstance(src, Gathered) and x is src.whole:
        x = src
    dx_pl = [Partial() if split[i] else p for i, p in enumerate(pl)]
    dw_pl = [Partial() if p.is_shard() else w.placements[i]
             for i, p in enumerate(pl)]

    def heads(x, w, mm):
        return mm(x, w.reshape(w.shape[0], -1)).reshape(*x.shape[:-1],
                                                        n_heads, -1)

    return _on_blocks(heads, x, w, out_pl, pl, dx_pl, dw_pl, mesh)


def on_rows(fn, xs: tuple, ws: tuple = (), n_out: int = 1):
    """``fn(*xs, *ws)`` for an ``fn`` that treats each row (the leading
    axis) of every ``xs`` alone, with their other axes whole, and takes
    the weights ``ws`` whole; ``n_out`` results.  On DTensors, on each
    rank's rows (``local_map``): the other axes and the weights are
    gathered whole first, every result is laid out as the rows (the rest
    whole on each rank), and the weights' gradients are pending sums over
    the ranks that split the rows.  For a recurrence that must run with
    no collective inside (the sLSTM walk), and for ops that DTensor has
    no strategy for (``logsigmoid``'s backward on some torch versions)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    if not isinstance(xs[0], DTensor):
        return fn(*xs, *ws)
    from torch.distributed.tensor.experimental import local_map
    xs = [unshard_dims(x, range(1, x.ndim)) for x in xs]
    pl = list(xs[0].placements)
    if any(tuple(x.placements) != tuple(pl) for x in xs):
        raise ValueError('on_rows takes its inputs with one split of the '
                         f'rows, got {[tuple(x.placements) for x in xs]}')
    mesh = xs[0].device_mesh
    whole = [Replicate()] * mesh.ndim
    ws = [w if tuple(w.placements) == tuple(whole)
          else w.redistribute(mesh, whole) for w in ws]
    w_grad = [Partial() if p.is_shard() else p for p in pl]
    return local_map(fn, out_placements=pl if n_out == 1 else (pl,) * n_out,
                     in_placements=(pl,) * len(xs) + (whole,) * len(ws),
                     in_grad_placements=(pl,) * len(xs) + (w_grad,) * len(ws),
                     device_mesh=mesh)(*xs, *ws)


def store(dst: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """``dst[...] = src`` in place, for a decode step's new state written
    into its view of a stacked state (``state['mlstm'][i, j]``).  On
    DTensors ``src`` is laid out as ``dst`` first (from whole values a
    slice, nothing is sent) and each rank copies its own block, so the
    write lands in the stack's block of that rank."""
    if hasattr(dst, 'placements'):
        if tuple(src.placements) != tuple(dst.placements):
            src = src.redistribute(dst.device_mesh, dst.placements)
        dst.to_local().copy_(src.to_local())
    else:
        dst.copy_(src)
    return dst


def merge(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``h @ w`` for a weight whose rows meet ``h``'s sharded last axis
    (the attention output's ``wo``, the MLP's ``w_down``).  On DTensors
    ``w`` is first laid out with its rows sharded where ``h``'s last axis
    is (a replicated ``dp`` weight is sliced, nothing is sent): DTensor
    records the matmul on the weight as given, so a replicated one would
    make the backward compute ``h``'s whole gradient on every rank."""
    if hasattr(h, 'placements'):
        from torch.distributed.tensor import Shard
        pl = [Shard(0) if hp.is_shard(h.ndim - 1) else wp
              for hp, wp in zip(h.placements, w.placements)]
        if tuple(pl) != tuple(w.placements):
            w = w.redistribute(w.device_mesh, pl)
    return h @ w


def _qkv(p, x, cfg, positions, ctx: ShardCtx = NO_CTX):
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim()
    hp = p['wq'].shape[1] // hd
    q, k, v = project(x, p['wq'], p['wk'], p['wv'])
    q = q.reshape(b, s, hp, hd)
    k = k.reshape(b, s, cfg.n_kv_heads, hd)
    v = v.reshape(b, s, cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        q = rmsnorm(q, p['q_norm'], cfg.norm_eps)
        k = rmsnorm(k, p['k_norm'], cfg.norm_eps)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    return ctx.bthd(q), k, v, hp, hd


def _kv_index(lo: int, hi: int, n_real: int, hkv: int,
              device) -> torch.Tensor:
    """The kv head of each q head ``lo..hi-1`` (``repeat_kv``'s map): real
    q head i takes ``i * Hkv // n_real``, padded ones clamp to the last
    real head's."""
    return (torch.clamp(torch.arange(lo, hi, device=device), max=n_real - 1)
            * hkv // n_real)


def repeat_kv(k: torch.Tensor, hp: int,
              n_heads: Optional[int] = None) -> torch.Tensor:
    """[B, T, Hkv, hd] -> [B, T, Hp, hd]: GQA head-group expansion by gather.

    Real q head i attends kv head ``i * Hkv // n_heads``; padded q heads
    (i >= n_heads, masked downstream) clamp to the last kv head.  On a
    DTensor, on each rank's block (``local_map``): DTensor's strategy for
    the gather's backward (``index_put`` with ``None`` indices) fails on
    some torch versions.  Where the heads are split and each block of q
    heads maps into the same block of kv heads (the long-context cache,
    zamba2's 32 heads on 32), each rank gathers from its own block and the
    q heads come out split as the kv heads; otherwise the kv heads are
    gathered whole first.
    """
    hkv = k.shape[2]
    n_real = n_heads or hp
    if not hasattr(k, 'placements'):
        return k[:, :, _kv_index(0, hp, n_real, hkv, k.device), :]
    from torch.distributed.tensor.experimental import local_map
    n = math.prod(k.device_mesh.size(i)
                  for i, p in enumerate(k.placements) if p.is_shard(2))
    bq, bk = hp // n, hkv // n
    if n > 1 and hp % n == 0 and all(
            b * bk <= j < (b + 1) * bk for b in range(n)
            for j in _kv_index(b * bq, (b + 1) * bq, n_real, hkv,
                               'cpu').tolist()):
        start, _ = local_range(k, 2)
        lo = start // bk * bq
    else:
        k, start, lo, bq = unshard_dims(k, (2,)), 0, 0, hp
    pl = list(k.placements)
    idx = _kv_index(lo, lo + bq, n_real, hkv, k.device)
    idx = idx - start if start else idx       # into the rank's own block
    return local_map(lambda t: t[:, :, idx, :], out_placements=pl,
                     in_placements=(pl,), device_mesh=k.device_mesh)(k)


def _bf16_dot(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``einsum`` of ``a`` and ``b`` rounded to bfloat16, summed in float32
    (products of two bfloat16 values are exact in float32)."""
    return torch.einsum(eq, a.bfloat16().float(), b.bfloat16().float())


def _kv_step(q32, qpos, m, l, acc, k_c, v_c, k_start: int, causal: bool):
    """One kv block of ``flash_attention`` from the carries (m, l, acc):
    the block's scores, its lazy-softmax update and its PV product."""
    sc = _bf16_dot('bqhd,bkhd->bqhk', q32, k_c)
    if causal:
        kpos = k_start + torch.arange(k_c.shape[1], device=q32.device)
        mask = kpos[None, :] > qpos[:, None]                    # [qc, kc]
        sc = torch.where(mask[None, :, None, :], NEG_INF, sc)
    m_new = torch.maximum(m, sc.amax(dim=-1))
    p = torch.exp(sc - m_new[..., None])
    corr = torch.exp(m - m_new)
    l = l * corr + p.sum(dim=-1)
    acc = acc * corr[..., None] + _bf16_dot('bqhk,bkhd->bqhd', p, v_c)
    return m_new, l, acc


def _q_step(q_c, k, v, q_start: int, kc: int, scale: float, causal: bool):
    """One q block of ``flash_attention``: its walk over the kv blocks,
    each kv block under ``remat`` while there are several."""
    b, qc, h, hd = q_c.shape
    nk = k.shape[1] // kc
    dev = q_c.device
    q32 = q_c.float() * scale
    qpos = q_start + torch.arange(qc, device=dev)
    m = torch.full((b, qc, h), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, qc, h), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, qc, h, hd), dtype=torch.float32, device=dev)
    for kj in range(nk):
        m, l, acc = remat(nk > 1, _kv_step, q32, qpos, m, l, acc,
                          k[:, kj * kc:(kj + 1) * kc],
                          v[:, kj * kc:(kj + 1) * kc], kj * kc, causal)
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.to(q_c.dtype)


def flash_attention(q, k, v, *, causal: bool, q_offset=0,
                    q_chunk: int = 512, kv_chunk: int = 1024) -> torch.Tensor:
    """Memory-streamed attention (lazy softmax over KV chunks).

    q: [B, S, H, hd]; k, v: [B, T, H, hd] (already GQA-repeated).  Scores
    exist only per (q_chunk x kv_chunk) block.  ``q_offset``: absolute
    position of q[0].  As in the JAX package, Q x scale and K are rounded to
    bfloat16 for QK, and P and V for PV, with float32 sums, whatever the
    input dtype; the chunk sizes shrink until they divide the lengths.

    While grad is enabled each q block, and inside it each kv block, runs
    under ``remat`` (the JAX package's nested ``jax.checkpoint``): the
    backward keeps each q block's input and, while one q block is
    recomputed, its kv blocks' carries (m, l, acc), and recomputes every
    score and probability block instead of keeping it.  A loop of one
    block runs plain: checkpointed, it would differ in its saved bytes
    by that one block's intermediates at most, which its backward
    recomputes at once, for one more forward.  The recompute replays the
    same operations on the same inputs, so the values and the gradients
    are those of the plain loops.
    """
    s, t = q.shape[1], k.shape[1]
    qc = min(q_chunk, s)
    while s % qc:
        qc -= 1
    kc = min(kv_chunk, t)
    while t % kc:
        kc -= 1
    scale = 1.0 / math.sqrt(q.shape[-1])
    nq = s // qc
    outs = [remat(nq > 1, _q_step, q[:, qi * qc:(qi + 1) * qc], k, v,
                  qi * qc + q_offset, kc, scale, causal)
            for qi in range(nq)]
    return torch.cat(outs, dim=1)


def attend(q, k, v, *, causal: bool) -> torch.Tensor:
    """``flash_attention(q, k, v)``; on DTensors in the ``bthd`` layout,
    on each rank's block (``local_map``): the layout shards only batch and
    heads, so every block's attention is whole, and the result keeps q's
    layout.  Raises on a layout that shards the sequence or ``head_dim``
    (the block's softmax would be partial)."""
    from torch.distributed.tensor import DTensor, Shard
    if not isinstance(q, DTensor):
        return flash_attention(q, k, v, causal=causal)
    from torch.distributed.tensor.experimental import local_map
    pl = tuple(q.placements)
    for t in (q, k, v):
        if tuple(t.placements) != pl or any(
                isinstance(x, Shard) and x.dim in (1, 3) for x in pl):
            raise ValueError(f'attend needs q, k and v in one bthd layout, '
                             f'got {[tuple(t.placements) for t in (q, k, v)]}')
    pl = list(pl)    # a tuple of placements reads as one per output
    return local_map(lambda q, k, v: flash_attention(q, k, v, causal=causal),
                     out_placements=pl, in_placements=(pl, pl, pl),
                     device_mesh=q.device_mesh)(q, k, v)


def attention_train(p, x, cfg, positions, causal: bool = True,
                    ctx: ShardCtx = NO_CTX) -> torch.Tensor:
    """Self-attention over a full sequence (train / prefill / encoder)."""
    q, k, v, hp, hd = _qkv(p, x, cfg, positions, ctx)
    k = ctx.bthd(repeat_kv(k, hp, cfg.n_heads))
    v = ctx.bthd(repeat_kv(v, hp, cfg.n_heads))
    out = ctx.bthd(_mask_heads(attend(q, k, v, causal=causal), cfg.n_heads))
    b, s = x.shape[:2]
    return ctx.btd(merge(out.reshape(b, s, hp * hd), p['wo']))


def attention_prefill(p, x, cfg, positions, ctx: ShardCtx = NO_CTX):
    """Like ``attention_train``, also returning the (k, v) cache
    [B, S, Hkv, hd]."""
    q, k, v, hp, hd = _qkv(p, x, cfg, positions, ctx)
    kr = ctx.bthd(repeat_kv(k, hp, cfg.n_heads))
    vr = ctx.bthd(repeat_kv(v, hp, cfg.n_heads))
    out = _mask_heads(attend(q, kr, vr, causal=True), cfg.n_heads)
    b, s = x.shape[:2]
    y = ctx.btd(merge(out.reshape(b, s, hp * hd), p['wo']))
    return y, (ctx.kv_cache(k), ctx.kv_cache(v))


def write_at(cache: torch.Tensor, new: torch.Tensor, at: int) -> torch.Tensor:
    """``cache[:, at] = new[:, 0]`` in place: cache [B, T, ...], new [B, 1,
    ...], ``at`` a global position.  On DTensors, on each rank's block
    (``local_map``, ``new`` laid out as the cache with its sequence whole):
    the rank whose block of the sequence holds ``at`` writes at ``at -
    start``, the others write nothing.  The write reaches the cache's
    storage, so a view of a stacked cache writes into the stack."""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(cache, DTensor):
        cache[:, at] = new[:, 0]
        return cache
    from torch.distributed.tensor.experimental import local_map
    start, stop = local_range(cache, 1)
    pl = list(cache.placements)
    new_pl = [Replicate() if c.is_shard(1) else c for c in pl]
    if tuple(new.placements) != tuple(new_pl):
        new = new.redistribute(cache.device_mesh, new_pl)

    def write(c, n):
        if start <= at < stop:
            c[:, at - start] = n[:, 0]
        return c

    return local_map(write, out_placements=pl, in_placements=(pl, new_pl),
                     device_mesh=cache.device_mesh)(cache, new)


def _decode_dots(q, kr, scale: float) -> torch.Tensor:
    """float32 scores [B, Hp, 1, T] of q [B, 1, Hp, hd] against kr [B, T,
    Hp, hd], unmasked; ``scale`` is 1 / sqrt(hd) of the whole head."""
    return torch.einsum('bqhd,bkhd->bhqk', q.float() * scale, kr.float())


def _mask_past(sc, pos: int, start: int = 0) -> torch.Tensor:
    """Scores [..., T] holding global positions ``start``.., those after
    ``pos`` at ``NEG_INF``."""
    kpos = torch.arange(start, start + sc.shape[-1], device=sc.device)
    return torch.where(kpos <= pos, sc, NEG_INF)


def _decode_softmax(q, kr, vr, pos: int) -> torch.Tensor:
    """The whole sequence's float32 attention [B, 1, Hp, hd]."""
    sc = _decode_dots(q, kr, 1.0 / math.sqrt(q.shape[-1]))
    w = torch.softmax(_mask_past(sc, pos), dim=-1)
    return torch.einsum('bhqk,bkhd->bqhd', w, vr.float())


def _score_placement(c):
    """The placement of the scores [B, Hp, 1, T] on a mesh dimension where
    the cache [B, T, Hp, hd] has ``c``: batch and heads as the cache's,
    the sequence on the last axis, a pending sum where head_dim is
    split."""
    from torch.distributed.tensor import Partial, Shard
    for cache_dim, score_dim in ((0, 0), (1, 3), (2, 1)):
        if c.is_shard(cache_dim):
            return Shard(score_dim)
    return Partial() if c.is_shard(3) else c


def decode_attend(q, kr, vr, pos: int) -> torch.Tensor:
    """float32 attention [B, 1, Hp, hd] of one query q [B, 1, Hp, hd] over
    kr, vr [B, T, Hp, hd] at positions <= ``pos``.

    On DTensors the cache's sequence is never gathered.  q is laid out
    with the cache's batch, heads and head_dim, its sequence whole.  Where
    the cache's sequence and head_dim are whole on each rank, each rank
    runs the plain softmax on its rows and heads (``local_map``).  Else
    each rank scores its block: a split head_dim makes the scores a
    pending sum, reduced before the mask and the softmax; the mask reads
    global positions.  Over a split sequence (``model`` in the flash-
    decoding layout, ``data`` in the long-context one) the softmax is the
    flash-decoding combine: the max is reduced across ranks, the weights
    exponentiated, their sum and the weighted V summed across ranks and
    divided once.  The result keeps the cache's batch, heads and
    head_dim layout.  Raises on k and v in two layouts."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    if not isinstance(kr, DTensor):
        return _decode_softmax(q, kr, vr, pos)
    from torch.distributed.tensor.experimental import local_map
    mesh, kv_pl = kr.device_mesh, list(kr.placements)
    if tuple(vr.placements) != tuple(kv_pl) or any(c.is_partial()
                                                   for c in kv_pl):
        raise ValueError('decode_attend needs k and v in one layout of '
                         f'shards, got {tuple(kv_pl)} and '
                         f'{tuple(vr.placements)}')
    q_pl = [Replicate() if c.is_shard(1) else c for c in kv_pl]
    if tuple(q.placements) != tuple(q_pl):
        q = q.redistribute(mesh, q_pl)
    split_hd = any(c.is_shard(3) for c in kv_pl)
    if q_pl == kv_pl and not split_hd:    # the sequence whole on each rank
        return local_map(lambda q, k, v: _decode_softmax(q, k, v, pos),
                         out_placements=q_pl, in_placements=(q_pl, kv_pl,
                                                             kv_pl),
                         device_mesh=mesh)(q, kr, vr)
    start, _ = local_range(kr, 1)
    scale = 1.0 / math.sqrt(q.shape[-1])
    # each rank's block of the scores [B, Hp, 1, T]; over a split head_dim
    # partial dot products, summed before the mask and the softmax
    sc = reduce_partials(local_map(
        lambda q, k: _decode_dots(q, k, scale),
        out_placements=[_score_placement(c) for c in kv_pl],
        in_placements=(q_pl, kv_pl), device_mesh=mesh)(q, kr))
    sc_pl = list(sc.placements)
    sc = local_map(lambda s: _mask_past(s, pos, start), out_placements=sc_pl,
                   in_placements=(sc_pl,), device_mesh=mesh)(sc)
    m = reduce_partials(sc.amax(dim=-1, keepdim=True))
    w = torch.exp(sc - m)
    den = reduce_partials(w.sum(dim=-1))                      # [B, Hp, 1]
    o_pl = [Partial() if c.is_shard(1) else c for c in kv_pl]
    num = local_map(lambda w, v: torch.einsum('bhqk,bkhd->bqhd', w,
                                              v.float()),
                    out_placements=o_pl, in_placements=(sc_pl, kv_pl),
                    device_mesh=mesh)(w, vr)
    return reduce_partials(num) / den.transpose(1, 2)[..., None]


def attention_decode(p, x, cfg, cache, pos: int, ctx: ShardCtx = NO_CTX):
    """One-token decode: x [B, 1, D], cache (k, v) [B, T, Hkv, hd], ``pos``
    the position written.

    The new token's k/v are written in place at ``pos`` for every row of
    the batch (``write_at``; a start past the end clamps to the last
    position, as XLA's ``dynamic_update_slice`` does); attention reads
    positions <= ``pos`` (``decode_attend``).  Scores and softmax are
    float32.  Returns (y [B, 1, D], cache).  x and the cache are both
    DTensors (``registry.shard_decode_inputs``) or both plain.
    """
    b = x.shape[0]
    hd = cfg.resolved_head_dim()
    k_cache, v_cache = cache
    if hasattr(x, 'placements') != hasattr(k_cache, 'placements'):
        raise ValueError('attention_decode takes x and the cache both as '
                         'DTensors or both plain')
    positions = torch.full((b,), pos, dtype=torch.int32, device=x.device)
    if hasattr(x, 'placements'):      # each rank makes its rows' block
        positions = as_dtensor_like(positions, x, axis_placements(x, 0))
    q, k_new, v_new, hp, _ = _qkv(p, x, cfg, positions[:, None], ctx)
    at = min(max(pos, 0), k_cache.shape[1] - 1)
    k_cache = ctx.kv_cache(write_at(k_cache, k_new, at))
    v_cache = ctx.kv_cache(write_at(v_cache, v_new, at))

    kr = repeat_kv(k_cache, hp, cfg.n_heads)       # [B, T, Hp, hd]
    vr = repeat_kv(v_cache, hp, cfg.n_heads)
    out = decode_attend(q, kr, vr, pos).to(x.dtype)
    if any(c.is_shard(3) for c in getattr(out, 'placements', ())):
        # a long-context cache's split head_dim laid out as heads before
        # the heads are merged (a reshape would interleave the blocks)
        out = ctx.bthd(out)
    out = _mask_heads(out, cfg.n_heads)
    return ctx.btd(merge(out.reshape(b, 1, hp * hd), p['wo'])), (k_cache,
                                                                  v_cache)


def attention_cross(p, x, cfg, kv, ctx: ShardCtx = NO_CTX) -> torch.Tensor:
    """Cross-attention (the whisper decoder): ``kv`` = (k, v) [B, T, Hkv,
    hd] from the encoder states; no rope, no mask, through
    ``flash_attention`` with its bfloat16 roundings."""
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim()
    hp = p['wq'].shape[1] // hd
    q = ctx.bthd(project(x, p['wq'])[0].reshape(b, s, hp, hd))
    k, v = kv
    kr = ctx.bthd(repeat_kv(k, hp, cfg.n_heads))
    vr = ctx.bthd(repeat_kv(v, hp, cfg.n_heads))
    out = _mask_heads(attend(q, kr, vr, causal=False), cfg.n_heads)
    return ctx.btd(merge(out.reshape(b, s, hp * hd), p['wo']))


def cross_kv(p, enc: torch.Tensor, cfg, ctx: ShardCtx = NO_CTX) -> tuple:
    """The cross-attention k/v [B, T, Hkv, hd] of encoder output ``enc``."""
    b, s, _ = enc.shape
    hd = cfg.resolved_head_dim()
    k, v = project(enc, p['wk'], p['wv'])
    k = k.reshape(b, s, cfg.n_kv_heads, hd)
    v = v.reshape(b, s, cfg.n_kv_heads, hd)
    return ctx.kv_cache(k), ctx.kv_cache(v)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def mlp_params(gen: torch.Generator, cfg, dtype,
               d_ff: Optional[int] = None) -> dict:
    d = cfg.d_model
    f = d_ff or cfg.d_ff
    p = {'w_up': dense_init(gen, d, f, dtype),
         'w_down': dense_init(gen, f, d, dtype,
                              scale=0.02 / math.sqrt(2 * cfg.n_layers))}
    if cfg.act == 'swiglu':
        p['w_gate'] = dense_init(gen, d, f, dtype)
    return p


def mlp(p, x, cfg, ctx: ShardCtx = NO_CTX) -> torch.Tensor:
    names = ('w_up', 'w_gate') if cfg.act == 'swiglu' else ('w_up',)
    up, *gate = (ctx.btf(t) for t in project(x, *(p[n] for n in names)))
    if cfg.act == 'swiglu':
        h = F.silu(gate[0]) * up
    elif cfg.act == 'relu2':           # nemotron squared-ReLU
        h = torch.square(F.relu(up))
    elif cfg.act == 'gelu':            # jax.nn.gelu's default: tanh form
        h = F.gelu(up, approximate='tanh')
    else:
        raise ValueError(cfg.act)
    return ctx.btd(merge(h, p['w_down']))


# ---------------------------------------------------------------------------
# Embedding and logits
# ---------------------------------------------------------------------------

def padded_vocab(cfg, tp: int) -> int:
    """Vocab padded for TP divisibility (pad logits masked)."""
    if tp <= 1:
        return cfg.vocab
    m = 128 * tp // math.gcd(128, tp)
    return (cfg.vocab + m - 1) // m * m


def embed_params(gen: torch.Generator, cfg, dtype, tp: int = 1) -> dict:
    vp = padded_vocab(cfg, tp)
    p = {'embed': normal(gen, (vp, cfg.d_model), dtype),
         'final_norm': torch.ones((cfg.d_model,), dtype=dtype,
                                  device=gen.device)}
    if not cfg.tie_embeddings:
        p['unembed'] = dense_init(gen, cfg.d_model, vp, dtype)
    return p


def embed(p, tokens: torch.Tensor, ctx: ShardCtx = NO_CTX) -> torch.Tensor:
    """The rows of the table for ``tokens`` (``F.embedding``: the same
    gather as indexing, and an op that DTensor lays out on every torch
    version, its backward too)."""
    return ctx.btd(F.embedding(tokens, p['embed']))


def _unembed_matrix(p) -> torch.Tensor:
    return p['unembed'] if 'unembed' in p else p['embed'].T


def _vocab_ids(lg: torch.Tensor) -> torch.Tensor:
    """The vocab ids 0..Vp-1 of ``lg`` [..., Vp], laid out as its vocab
    axis when it is a DTensor (each rank makes its own block)."""
    ids = torch.arange(lg.shape[-1], device=lg.device)
    if not hasattr(lg, 'placements'):
        return ids
    return as_dtensor_like(ids, lg, axis_placements(lg, -1))


def _vocab_mask(lg: torch.Tensor, vocab: int) -> torch.Tensor:
    """``lg`` [..., Vp] with its padded vocab entries at ``NEG_INF``."""
    if lg.shape[-1] == vocab:
        return lg
    return torch.where(_vocab_ids(lg) < vocab, lg, NEG_INF)


def logits(p, x: torch.Tensor, cfg, ctx: ShardCtx = NO_CTX) -> torch.Tensor:
    h = rmsnorm(x, p['final_norm'], cfg.norm_eps)
    return _vocab_mask(ctx.btv(h @ ctx.dv(_unembed_matrix(p))), cfg.vocab)


def _logsumexp(lg: torch.Tensor) -> torch.Tensor:
    """log-sum-exp over the last axis from the max, as ``jax.nn.logsumexp``
    (the max held constant); of a vocab-sharded DTensor, partitioned: a
    max and a sum reduced across ranks, the logits never gathered.  Each
    is reduced where it is made (left pending, DTensor may split it over
    the batch instead, and the gradient then comes back in a layout that
    costs an all-to-all of the logits)."""
    m = reduce_partials(lg.amax(dim=-1, keepdim=True).detach())
    return torch.log(reduce_partials(torch.exp(lg - m).sum(dim=-1))) + m[
        ..., 0]


def _ce_chunk(h_c, w, l_c, vocab: int, ctx: ShardCtx = NO_CTX):
    """The summed negative log-likelihood [] and the count of labels >= 0
    of one chunk: h_c [B, c, D] normed states, w [D, Vp], l_c [B, c]."""
    # the padding is masked out of the partition function
    lg = _vocab_mask(ctx.btv((h_c @ w).float()), vocab)      # [B, c, Vp]
    lse = _logsumexp(lg)
    # the target's logit as the one nonzero term of a sum over the vocab
    # (exact): partitioned on a vocab-sharded DTensor, where a gather's
    # backward would gather the logits' gradient whole.  Its pending sum
    # is reduced at once, so the gradient comes back replicated over the
    # vocab's ranks, not split over the batch
    hit = _vocab_ids(lg) == torch.clamp(l_c, min=0)[..., None]
    tgt = reduce_partials(torch.where(hit, lg, 0.0).sum(dim=-1))
    valid = l_c >= 0
    nll = torch.where(valid, lse - tgt, 0.0)
    return nll.sum(), valid.sum(dtype=torch.int32)


def chunked_ce_loss(p, x: torch.Tensor, labels: torch.Tensor,
                    cfg, ctx: ShardCtx = NO_CTX) -> torch.Tensor:
    """Sequence-chunked cross entropy, the mean over labels >= 0 (-1 is
    ignored).  x [B, S, D] final hidden states, labels [B, S].

    The chunk is ``min(cfg.loss_chunk, S)``, shrunk until it divides S.
    Each chunk's float32 logits [B, c, V] are recomputed in the backward
    pass (``remat``), so the whole [B, S, V] never exists at once."""
    b, s, d = x.shape
    c = min(cfg.loss_chunk, s)
    while s % c:
        c -= 1
    w = ctx.dv(_unembed_matrix(p))
    # the sequence whole on each rank, gathered once for all the chunks
    h = unshard_dims(rmsnorm(x, p['final_norm'], cfg.norm_eps), (1,))
    labels = unshard_dims(labels, (1,))
    nll_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    count = torch.zeros((), dtype=torch.int32, device=x.device)
    for i in range(s // c):
        nll, n = remat(True, _ce_chunk, h[:, i * c:(i + 1) * c], w,
                       labels[:, i * c:(i + 1) * c], cfg.vocab, ctx)
        nll_sum = nll_sum + nll
        count = count + n
    return to_replicated(nll_sum / torch.clamp(count, min=1))
