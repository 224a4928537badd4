"""xLSTM (xlstm-1.3b): mLSTM blocks with interspersed sLSTM blocks.

mLSTM = matrix-memory LSTM == decayed linear attention with a normalizer:
the forward pass uses the chunkwise core of ``linear_scan``, decode its
O(1) recurrent step.  sLSTM = scalar-memory recurrent block (every
``slstm_every``-th block), sequential over time.

As in the JAX package, the exponential input gate with its running-max
stabilizer is replaced by a bounded sigmoid gate, and forget gates are
sigmoid (log a <= 0).

The model is ``n_super`` super-blocks of ``slstm_every - 1`` mLSTM blocks
and one sLSTM block (``blocks.i.mlstm.j`` and ``blocks.i.slstm``).  A
config whose depth ``slstm_every`` does not divide is one stack of mLSTM
blocks (``blocks.i``), which the JAX package can run forward but not
decode.

Every entry point takes the ``ShardCtx`` (``ctx``, none by default) and
calls its hooks where the JAX package's ``xlstm`` does (``btdv`` on the
mLSTM values, ``btd`` on every residual).  On parameters, a batch and a
decode state laid out as DTensors (``registry.shard_step_inputs`` and
``shard_decode_inputs``, recipe ``ssm``) the model runs partitioned:

  * mLSTM: ``u = x @ w_up`` comes out with di over ``model``; it is
    gathered whole once, because the four projections after it contract
    over di (reducing their partial sums instead would move q, k and v
    whole, three times the bytes).  q is projected with its columns split
    and gathered whole; k and v are projected into heads with their hd
    split (``layers.project_heads``: a contiguous split of di would cut
    heads when ``model`` does not divide H), k gathered whole, v left in
    the ``btdv`` layout; the gates are whole.  The chunked scan then runs
    on each rank's block (``linear_scan``), and ``out_norm``'s mean
    square over the split dv is reduced across ranks
    (``layers.rmsnorm``) before the heads are gathered for ``w_down``;
  * sLSTM: ``x @ w_x`` is gathered whole over ``model`` once a block,
    so the recurrence runs on each rank's rows with all of di and the
    replicated ``w_h_blocks``, and its loop of S steps makes no
    collective (the reason for the block-diagonal ``w_h_blocks``);
  * decode: each block's new state is written into its view of the
    stacked state (``layers.store``: each rank its own block), the
    sLSTM's h and c gathered whole for the step.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..runtime.sharding import ShardCtx, unshard_dims
from . import layers as L
from .linear_scan import chunked_linear_attention, linear_attention_step
from .params import LM

UP_FACTOR = 2  # block up-projection factor (xLSTM uses ~2x inner dim)


def _inner(cfg) -> int:
    return UP_FACTOR * cfg.d_model


def mlstm_params(gen: torch.Generator, cfg, dtype) -> dict:
    d = cfg.d_model
    di = _inner(cfg)
    dev = gen.device
    return {
        'ln': torch.ones((d,), dtype=dtype, device=dev),
        'w_up': L.dense_init(gen, d, di, dtype),
        'w_gate': L.dense_init(gen, d, di, dtype),
        'wq': L.dense_init(gen, di, di, dtype),
        'wk': L.dense_init(gen, di, di, dtype),
        'wv': L.dense_init(gen, di, di, dtype),
        'w_if': L.dense_init(gen, di, 2 * cfg.n_heads, dtype),  # i/f gates
        'w_down': L.dense_init(gen, di, d, dtype,
                               scale=0.02 / math.sqrt(2 * cfg.n_layers)),
        'out_norm': torch.ones((di // cfg.n_heads,), dtype=dtype, device=dev),
    }


def slstm_params(gen: torch.Generator, cfg, dtype) -> dict:
    d = cfg.d_model
    di = _inner(cfg)
    h = cfg.n_heads
    hd = di // h
    return {
        'ln': torch.ones((d,), dtype=dtype, device=gen.device),
        'w_x': L.dense_init(gen, d, 4 * di, dtype),   # z, i, f, o pre-acts
        # the recurrent matrix is block-diagonal per head: [H, hd, 4 hd]
        'w_h_blocks': L.normal(gen, (h, hd, 4 * hd), dtype),
        'w_down': L.dense_init(gen, di, d, dtype,
                               scale=0.02 / math.sqrt(2 * cfg.n_layers)),
    }


def _mlstm_gates(gates, n_heads: int, dtype):
    """The log forget gate [B, S, H] (<= 0) and the bounded input gate
    [B, S, H, 1] in ``dtype``, of the gate pre-activations [B, S, 2H]."""
    b, s, _ = gates.shape
    gates = gates.reshape(b, s, 2, n_heads).float()
    log_f = F.logsigmoid(gates[:, :, 0])
    i_gate = torch.sigmoid(gates[:, :, 1])                # bounded input gate
    return log_f, i_gate[..., None].to(dtype)


class _ScaledGate(torch.autograd.Function):
    """``k / scale * gate``, k [B, S, H, hd] and the gate [B, S, H, 1],
    saving for the backward the unscaled k's ``block`` and the gate: the
    backward recomputes ``k / scale`` (on DTensors from the block that
    ``regather`` gathers whole again), where autograd would keep the
    scaled k beside the gated one that the scan keeps.  The gradients are
    autograd's for the two products: ``grad * gate / scale`` for k, and
    ``grad * (k / scale)`` summed over hd for the gate."""

    @staticmethod
    def forward(ctx, k, gate, scale: float, block, regather):
        if regather is not None:
            regather.users += 1
        ctx.scale, ctx.regather = scale, regather
        ctx.save_for_backward(block, gate)
        return k / scale * gate

    @staticmethod
    def backward(ctx, grad):
        block, gate = ctx.saved_tensors
        k = block if ctx.regather is None else ctx.regather(block)
        gk = grad * gate / ctx.scale if ctx.needs_input_grad[0] else None
        gg = ((grad * (k / ctx.scale)).sum(-1, keepdim=True)
              if ctx.needs_input_grad[1] else None)
        return gk, gg, None, None, None


def _scaled_gate(k, gate, scale: float):
    """``k / scale * gate`` (``_ScaledGate`` while grad is on).  ``k`` is
    a plain tensor, or a ``layers.Gathered`` of its heads' hd: the product
    then runs on each rank's rows (``local_map``) with k whole, as the
    gate, and its backward gathers k's block again."""
    if not torch.is_grad_enabled():
        return (k.whole if isinstance(k, L.Gathered) else k) / scale * gate
    if not isinstance(k, L.Gathered):
        return _ScaledGate.apply(k, gate, scale, k, None)
    from torch.distributed.tensor.experimental import local_map
    pl, bl = list(gate.placements), list(k.block.placements)
    return local_map(
        lambda k_, g_, b_: _ScaledGate.apply(k_, g_, scale, b_, k.regather),
        out_placements=pl, in_placements=(pl, pl, bl),
        in_grad_placements=(pl, pl, bl), device_mesh=gate.device_mesh)(
            k.whole, gate, k.block)


def _mlstm_qkvg(p, x, cfg, ctx: ShardCtx = L.NO_CTX):
    b, s, _ = x.shape
    h = cfg.n_heads
    hd = _inner(cfg) // h
    # on DTensors x is gathered over the sequence for w_up and w_gate and
    # u whole once for the four projections that contract over di; each
    # product saves the rank's block and the backward gathers it again
    u, g = L.project(x, p['w_up'], p['w_gate'], regather=True)
    u = L.gathered(u, (1, 2))
    q = unshard_dims(L.project(u, p['wq'])[0], (2,)).reshape(b, s, h, hd)
    k = L.gathered(L.project_heads(u, p['wk'], h, ctx), (3,))
    v = ctx.btdv(L.project_heads(u, p['wv'], h, ctx))
    log_f, i_gate = L.on_rows(
        lambda gates: _mlstm_gates(gates, h, v.dtype),
        (L.project(u, p['w_if'])[0],), n_out=2)
    return q, _scaled_gate(k, i_gate, math.sqrt(hd)), v, F.silu(g), log_f


def _mlstm_out(p, res, y, g, cfg, ctx: ShardCtx = L.NO_CTX):
    """y [B, S, H, hd] (or [B, H, hd] in decode) normed, its heads flattened
    (whole over ``model``), gated by g and projected back."""
    y = unshard_dims(L.rmsnorm(y, p['out_norm'], cfg.norm_eps), (-2, -1))
    y = y.reshape(res.shape[0], res.shape[1], -1)
    if hasattr(y, 'placements'):
        # laid out as g first: the product's backward then hands the
        # reshape a whole gradient (DTensor's own slicing would hand it
        # g's split, which the heads' view cannot take)
        y = y.redistribute(g.device_mesh, g.placements)
    y = y * g
    return ctx.btd(res + ctx.btd(L.merge(y, p['w_down'])))


def mlstm_block(p, x, cfg, ctx: ShardCtx = L.NO_CTX):
    xx = L.rmsnorm(x, p['ln'], cfg.norm_eps)
    q, k, v, g, log_f = _mlstm_qkvg(p, xx, cfg, ctx)
    y, _ = chunked_linear_attention(q, k, v, log_f, normalize=True)
    return _mlstm_out(p, x, y, g, cfg, ctx)


def mlstm_decode(p, x, state, cfg, ctx: ShardCtx = L.NO_CTX):
    """x [B, 1, D]; state [B, H, hd, hd+1].  Returns (y [B, 1, D], new
    state)."""
    xx = L.rmsnorm(x, p['ln'], cfg.norm_eps)
    q, k, v, g, log_f = _mlstm_qkvg(p, xx, cfg, ctx)
    y, state = linear_attention_step(
        state, q[:, 0], k[:, 0], v[:, 0], log_f[:, 0], normalize=True)
    return _mlstm_out(p, x, y, g, cfg, ctx), state


def _slstm_recur(pre_t, h, c, w32, n_heads: int, hd: int):
    """One sLSTM timestep: block-diagonal recurrence and the gates.
    pre_t [B, 4 di], h and c [B, di], w32 [H, hd, 4 hd], all float32."""
    b = h.shape[0]
    rec = torch.einsum('bhd,hde->bhe', h.reshape(b, n_heads, hd), w32)
    # [B, H, 4, hd] -> gate-major [B, 4, H, hd], lined up with w_x's
    # (z, i, f, o) concatenation
    rec = rec.reshape(b, n_heads, 4, hd).transpose(1, 2).reshape(b, -1)
    z, i, f, o = torch.chunk(pre_t + rec, 4, dim=-1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(z)
    h = torch.sigmoid(o) * torch.tanh(c)
    return h, c


def slstm_chunk(s: int) -> int:
    """The steps of one chunk of the sLSTM walk over ``s`` steps: the
    largest divisor of ``s`` that is at most 256 (the JAX package's
    ``w``)."""
    w = 256
    while s % w:
        w -= 1
    return w


def _slstm_walk(pre, h, c, w32, n_heads: int):
    """One chunk of the walk: pre [B, w, 4 di] converted to float32 once,
    its w steps from the carries h and c [B, di] float32.  Returns (the
    h of every step [B, w, di] in pre's dtype, h, c).  The steps take
    their rows by ``unbind``, whose backward stacks the w gradients once
    (a ``select`` a step would write each into a zeroed copy of the
    whole chunk)."""
    hd = h.shape[-1] // n_heads
    hs = []
    for pre_t in pre.float().unbind(1):
        h, c = _slstm_recur(pre_t, h, c, w32, n_heads, hd)
        hs.append(h.to(pre.dtype))
    return torch.stack(hs, dim=1), h, c


def _slstm_scan(pre_x, w_h_blocks, n_heads: int):
    """The recurrence over time from zeroed h and c: pre_x [B, S, 4 di]
    -> the h of every step [B, S, di] in pre_x's dtype, float32 inside.

    As in the JAX package, time is walked in chunks of ``slstm_chunk(S)``
    steps with (h, c) carried between them in float32; while grad is
    enabled and there are several chunks, each is recomputed in the
    backward pass (``L.remat``), so the backward keeps the carries and
    the chunk inputs, not every step's float32 intermediates.  One chunk
    runs plain, as ``flash_attention``'s and ``chunked_linear_attention``'s
    loops of one block do: its checkpoint would save no peak and cost a
    third forward.  The chunks are taken by ``split``, as the steps by
    ``unbind``: the backward then joins their gradients once instead of
    adding a zeroed copy of ``pre_x`` a chunk."""
    b, s, di4 = pre_x.shape
    w = slstm_chunk(s)
    w32 = w_h_blocks.float()
    h = torch.zeros((b, di4 // 4), dtype=torch.float32, device=pre_x.device)
    c = torch.zeros_like(h)
    hs = []
    for chunk in pre_x.split(w, dim=1):
        y, h, c = L.remat(s > w, _slstm_walk, chunk, h, c, w32, n_heads)
        hs.append(y)
    return torch.cat(hs, dim=1)


def slstm_block(p, x, cfg, ctx: ShardCtx = L.NO_CTX):
    """Scalar-memory LSTM over time: a float32 recurrence, one step a
    token, each step's h rounded to the model dtype.  On DTensors
    ``pre_x``'s four gates are gathered whole over ``model`` once, and
    the recurrence runs on each rank's rows (``layers.on_rows``)."""
    xx = L.rmsnorm(x, p['ln'], cfg.norm_eps)
    pre_x = L.project(xx, p['w_x'])[0]        # [B, S, 4 di], model dtype
    hs = L.on_rows(lambda pre, w: _slstm_scan(pre, w, cfg.n_heads),
                   (pre_x,), (p['w_h_blocks'],))
    return ctx.btd(x + ctx.btd(L.merge(hs, p['w_down'])))


def slstm_decode(p, x, state, cfg, ctx: ShardCtx = L.NO_CTX):
    """x [B, 1, D]; state (h, c) [B, di] float32.  On DTensors h and c
    are gathered whole for the step, which runs on each rank's rows; the
    new (h, c) come out whole over ``model``."""
    xx = L.rmsnorm(x, p['ln'], cfg.norm_eps)
    hd = _inner(cfg) // cfg.n_heads

    def recur(pre, h, c, w):
        return _slstm_recur(pre.float(), h, c, w.float(), cfg.n_heads, hd)

    pre = L.project(xx[:, 0], p['w_x'])[0]
    h, c = L.on_rows(recur, (pre, *state), (p['w_h_blocks'],), n_out=2)
    y = ctx.btd(L.merge(h[:, None].to(x.dtype), p['w_down']))
    return ctx.btd(x + y), (h, c)


# ---------------------------------------------------------------------------
# The model: super-blocks of (slstm_every - 1) mLSTM + 1 sLSTM
# ---------------------------------------------------------------------------

def _super(cfg) -> tuple[int, int]:
    """(super-blocks, blocks in each); (1, 0) where there is no clean
    grouping."""
    se = cfg.slstm_every or (cfg.n_layers + 1)
    if cfg.n_layers % se == 0:
        return cfg.n_layers // se, se
    return 1, 0


class XLSTM(LM):
    """``params``: ``{'tok': {...}, 'blocks': [...]}``, each block a
    super-block ``{'mlstm': [se-1 dicts], 'slstm': {...}}`` (or one mLSTM
    dict a layer where the depth does not group)."""

    def _super_block(self, blk, x, ctx: ShardCtx):
        for p_m in blk.mlstm:
            x = mlstm_block(ctx.weights(p_m), x, self.cfg, ctx)
        return slstm_block(ctx.weights(blk.slstm), x, self.cfg, ctx)

    def forward(self, tokens: torch.Tensor,
                ctx: ShardCtx = L.NO_CTX) -> torch.Tensor:
        """tokens [B, S] -> final hidden [B, S, D]; with ``cfg.remat`` each
        super-block's activations are recomputed in the backward pass (as
        in the JAX package, a depth that does not group runs without)."""
        cfg = self.cfg
        x = L.embed(self.tok, tokens, ctx)
        _, se = _super(cfg)
        for blk in self.blocks:
            if se:
                x = L.remat(cfg.remat, self._super_block, blk, x, ctx)
            else:
                x = mlstm_block(ctx.weights(blk), x, cfg, ctx)
        return x

    @torch.no_grad()
    def decode_step(self, token: torch.Tensor, state: dict, pos: int,
                    ctx: ShardCtx = L.NO_CTX):
        """One recurrent step; ``state`` (``init_state``'s) is written in
        place (``layers.store``: on DTensors each rank's block of the
        stack).  The position is carried by the state.  Returns (logits
        [B, V], state)."""
        del pos
        cfg = self.cfg
        if not _super(cfg)[1]:
            raise ValueError(
                f'{cfg.name}: slstm_every={cfg.slstm_every} does not divide '
                f'n_layers={cfg.n_layers}; the reference decodes only '
                'super-blocks of mLSTM blocks and one sLSTM block')
        x = L.embed(self.tok, token, ctx)
        m, sh, sc = state['mlstm'], state['slstm_h'], state['slstm_c']
        for i, blk in enumerate(self.blocks):
            for j, p_m in enumerate(blk.mlstm):
                x, new = mlstm_decode(ctx.weights(p_m), x, m[i, j], cfg, ctx)
                L.store(m[i, j], new)
            x, (h, c) = slstm_decode(ctx.weights(blk.slstm), x,
                                     (sh[i], sc[i]), cfg, ctx)
            L.store(sh[i], h)
            L.store(sc[i], c)
        return self.logits(x, ctx)[:, 0], state


def train_loss(params: XLSTM, batch: dict, cfg,
               ctx: ShardCtx = L.NO_CTX) -> torch.Tensor:
    """The mean next-token cross entropy of ``batch``.  ``cfg`` is the
    model's own."""
    h = params(batch['tokens'], ctx)
    return L.chunked_ce_loss(params.tok, h, batch['labels'], cfg, ctx)


def init_params(gen: torch.Generator, cfg, tp: int = 1) -> XLSTM:
    dtype = getattr(torch, cfg.dtype)
    n_super, se = _super(cfg)
    if se:
        blocks = [{'mlstm': [mlstm_params(gen, cfg, dtype)
                             for _ in range(se - 1)],
                   'slstm': slstm_params(gen, cfg, dtype)}
                  for _ in range(n_super)]
    else:
        blocks = [mlstm_params(gen, cfg, dtype) for _ in range(cfg.n_layers)]
    return XLSTM(cfg, {'tok': L.embed_params(gen, cfg, dtype, tp),
                       'blocks': blocks})


def init_state(cfg, batch: int, *, device) -> dict:
    """The recurrent decode state, O(1) in sequence length: ``mlstm`` [ns,
    se-1, B, H, hd, hd+1], ``slstm_h`` and ``slstm_c`` [ns, B, di], all
    float32 and zeroed."""
    n_super, se = _super(cfg)
    h = cfg.n_heads
    di = _inner(cfg)
    hd = di // h
    f32 = dict(dtype=torch.float32, device=device)
    return {'mlstm': torch.zeros((n_super, max(se - 1, 1), batch, h, hd,
                                  hd + 1), **f32),
            'slstm_h': torch.zeros((n_super, batch, di), **f32),
            'slstm_c': torch.zeros((n_super, batch, di), **f32)}
