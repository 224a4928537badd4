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
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

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


def _mlstm_qkvg(p, x, cfg):
    b, s, _ = x.shape
    h = cfg.n_heads
    hd = _inner(cfg) // h
    u = x @ p['w_up']
    g = F.silu(x @ p['w_gate'])
    q = (u @ p['wq']).reshape(b, s, h, hd)
    k = (u @ p['wk']).reshape(b, s, h, hd) / math.sqrt(hd)
    v = (u @ p['wv']).reshape(b, s, h, hd)
    gates = (u @ p['w_if']).reshape(b, s, 2, h).float()
    log_f = F.logsigmoid(gates[:, :, 0])                  # [B, S, H] <= 0
    i_gate = torch.sigmoid(gates[:, :, 1])                # bounded input gate
    k = k * i_gate[..., None].to(k.dtype)
    return q, k, v, g, log_f


def _mlstm_out(p, res, y, g, cfg):
    y = L.rmsnorm(y, p['out_norm'], cfg.norm_eps)
    y = y.reshape(res.shape[0], res.shape[1], -1) * g
    return res + y @ p['w_down']


def mlstm_block(p, x, cfg):
    xx = L.rmsnorm(x, p['ln'], cfg.norm_eps)
    q, k, v, g, log_f = _mlstm_qkvg(p, xx, cfg)
    y, _ = chunked_linear_attention(q, k, v, log_f, normalize=True)
    return _mlstm_out(p, x, y, g, cfg)


def mlstm_decode(p, x, state, cfg):
    """x [B, 1, D]; state [B, H, hd, hd+1].  Returns (y [B, 1, D], new
    state)."""
    xx = L.rmsnorm(x, p['ln'], cfg.norm_eps)
    q, k, v, g, log_f = _mlstm_qkvg(p, xx, cfg)
    y, state = linear_attention_step(
        state, q[:, 0], k[:, 0], v[:, 0], log_f[:, 0], normalize=True)
    return _mlstm_out(p, x, y, g, cfg), state


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


def slstm_block(p, x, cfg):
    """Scalar-memory LSTM over time: a float32 recurrence, one step a
    token, each step's h rounded to the model dtype."""
    xx = L.rmsnorm(x, p['ln'], cfg.norm_eps)
    b, s, _ = xx.shape
    di = _inner(cfg)
    hd = di // cfg.n_heads
    pre_x = xx @ p['w_x']                     # [B, S, 4 di], model dtype
    w32 = p['w_h_blocks'].float()
    h = torch.zeros((b, di), dtype=torch.float32, device=x.device)
    c = torch.zeros_like(h)
    hs = []
    for t in range(s):
        h, c = _slstm_recur(pre_x[:, t].float(), h, c, w32, cfg.n_heads, hd)
        hs.append(h.to(pre_x.dtype))
    return x + torch.stack(hs, dim=1) @ p['w_down']


def slstm_decode(p, x, state, cfg):
    """x [B, 1, D]; state (h, c) [B, di] float32."""
    xx = L.rmsnorm(x, p['ln'], cfg.norm_eps)
    h, c = state
    pre = (xx[:, 0] @ p['w_x']).float()
    h, c = _slstm_recur(pre, h, c, p['w_h_blocks'].float(), cfg.n_heads,
                        _inner(cfg) // cfg.n_heads)
    return x + h[:, None].to(x.dtype) @ p['w_down'], (h, c)


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

    def _super_block(self, blk, x):
        for p_m in blk.mlstm:
            x = mlstm_block(p_m, x, self.cfg)
        return slstm_block(blk.slstm, x, self.cfg)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens [B, S] -> final hidden [B, S, D]; with ``cfg.remat`` each
        super-block's activations are recomputed in the backward pass (as
        in the JAX package, a depth that does not group runs without)."""
        cfg = self.cfg
        x = L.embed(self.tok, tokens)
        _, se = _super(cfg)
        for blk in self.blocks:
            if se:
                x = L.remat(cfg.remat, self._super_block, blk, x)
            else:
                x = mlstm_block(blk, x, cfg)
        return x

    @torch.no_grad()
    def decode_step(self, token: torch.Tensor, state: dict, pos: int):
        """One recurrent step; ``state`` (``init_state``'s) is written in
        place.  The position is carried by the state.  Returns (logits
        [B, V], state)."""
        del pos
        cfg = self.cfg
        if not _super(cfg)[1]:
            raise ValueError(
                f'{cfg.name}: slstm_every={cfg.slstm_every} does not divide '
                f'n_layers={cfg.n_layers}; the reference decodes only '
                'super-blocks of mLSTM blocks and one sLSTM block')
        x = L.embed(self.tok, token)
        m, sh, sc = state['mlstm'], state['slstm_h'], state['slstm_c']
        for i, blk in enumerate(self.blocks):
            for j, p_m in enumerate(blk.mlstm):
                x, m[i, j] = mlstm_decode(p_m, x, m[i, j], cfg)
            x, (sh[i], sc[i]) = slstm_decode(blk.slstm, x, (sh[i], sc[i]),
                                             cfg)
        return self.logits(x)[:, 0], state


def train_loss(params: XLSTM, batch: dict, cfg, ctx) -> torch.Tensor:
    """The mean next-token cross entropy of ``batch``.  ``cfg`` is the
    model's own."""
    h = params(batch['tokens'])
    return L.chunked_ce_loss(params.tok, h, batch['labels'], cfg)


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
