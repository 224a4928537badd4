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
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..runtime.sharding import padded_heads

NEG_INF = -1e30      # the masked-score fill of the JAX package

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
    (``x * (rsqrt(var + eps) * w).to(x.dtype)``)."""
    x32 = x.float()
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
    freqs = torch.exp(-math.log(theta) * steps / half)
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
    return out * mask[None, None, :, None]


def _qkv(p, x, cfg, positions):
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim()
    hp = p['wq'].shape[1] // hd
    q = (x @ p['wq']).reshape(b, s, hp, hd)
    k = (x @ p['wk']).reshape(b, s, cfg.n_kv_heads, hd)
    v = (x @ p['wv']).reshape(b, s, cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        q = rmsnorm(q, p['q_norm'], cfg.norm_eps)
        k = rmsnorm(k, p['k_norm'], cfg.norm_eps)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    return q, k, v, hp, hd


def repeat_kv(k: torch.Tensor, hp: int,
              n_heads: Optional[int] = None) -> torch.Tensor:
    """[B, T, Hkv, hd] -> [B, T, Hp, hd]: GQA head-group expansion by gather.

    Real q head i attends kv head ``i * Hkv // n_heads``; padded q heads
    (i >= n_heads, masked downstream) clamp to the last kv head.
    """
    hkv = k.shape[2]
    n_real = n_heads or hp
    idx = (torch.clamp(torch.arange(hp, device=k.device), max=n_real - 1)
           * hkv // n_real)
    return k[:, :, idx, :]


def _bf16_dot(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``einsum`` of ``a`` and ``b`` rounded to bfloat16, summed in float32
    (products of two bfloat16 values are exact in float32)."""
    return torch.einsum(eq, a.bfloat16().float(), b.bfloat16().float())


def flash_attention(q, k, v, *, causal: bool, q_offset=0,
                    q_chunk: int = 512, kv_chunk: int = 1024) -> torch.Tensor:
    """Memory-streamed attention (lazy softmax over KV chunks).

    q: [B, S, H, hd]; k, v: [B, T, H, hd] (already GQA-repeated).  Scores
    exist only per (q_chunk x kv_chunk) block.  ``q_offset``: absolute
    position of q[0].  As in the JAX package, Q x scale and K are rounded to
    bfloat16 for QK, and P and V for PV, with float32 sums, whatever the
    input dtype; the chunk sizes shrink until they divide the lengths.
    """
    b, s, h, hd = q.shape
    t = k.shape[1]
    qc = min(q_chunk, s)
    while s % qc:
        qc -= 1
    kc = min(kv_chunk, t)
    while t % kc:
        kc -= 1
    scale = 1.0 / math.sqrt(hd)
    dev = q.device
    outs = []
    for qi in range(s // qc):
        q32 = q[:, qi * qc:(qi + 1) * qc].float() * scale
        qpos = qi * qc + torch.arange(qc, device=dev) + q_offset
        m = torch.full((b, qc, h), NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros((b, qc, h), dtype=torch.float32, device=dev)
        acc = torch.zeros((b, qc, h, hd), dtype=torch.float32, device=dev)
        for kj in range(t // kc):
            k_c = k[:, kj * kc:(kj + 1) * kc]
            v_c = v[:, kj * kc:(kj + 1) * kc]
            sc = _bf16_dot('bqhd,bkhd->bqhk', q32, k_c)
            if causal:
                kpos = kj * kc + torch.arange(kc, device=dev)
                mask = kpos[None, :] > qpos[:, None]            # [qc, kc]
                sc = torch.where(mask[None, :, None, :], NEG_INF, sc)
            m_new = torch.maximum(m, sc.amax(dim=-1))
            p = torch.exp(sc - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + _bf16_dot('bqhk,bkhd->bqhd', p, v_c)
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None]
        outs.append(out.to(q.dtype))
    return torch.cat(outs, dim=1)


def attention_train(p, x, cfg, positions, causal: bool = True) -> torch.Tensor:
    """Self-attention over a full sequence (train / prefill / encoder)."""
    q, k, v, hp, hd = _qkv(p, x, cfg, positions)
    k = repeat_kv(k, hp, cfg.n_heads)
    v = repeat_kv(v, hp, cfg.n_heads)
    out = _mask_heads(flash_attention(q, k, v, causal=causal), cfg.n_heads)
    b, s = x.shape[:2]
    return out.reshape(b, s, hp * hd) @ p['wo']


def attention_prefill(p, x, cfg, positions):
    """Like ``attention_train``, also returning the (k, v) cache
    [B, S, Hkv, hd]."""
    q, k, v, hp, hd = _qkv(p, x, cfg, positions)
    kr = repeat_kv(k, hp, cfg.n_heads)
    vr = repeat_kv(v, hp, cfg.n_heads)
    out = _mask_heads(flash_attention(q, kr, vr, causal=True), cfg.n_heads)
    b, s = x.shape[:2]
    return out.reshape(b, s, hp * hd) @ p['wo'], (k, v)


def attention_decode(p, x, cfg, cache, pos: int):
    """One-token decode: x [B, 1, D], cache (k, v) [B, T, Hkv, hd], ``pos``
    the position written.

    The new token's k/v are written in place at ``pos`` for every row of
    the batch (a start past the end clamps to the last position, as XLA's
    ``dynamic_update_slice`` does); attention reads positions <= ``pos``.
    Scores and softmax are float32.  Returns (y [B, 1, D], cache).
    """
    b = x.shape[0]
    hd = cfg.resolved_head_dim()
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q, k_new, v_new, hp, _ = _qkv(p, x, cfg, positions)
    k_cache, v_cache = cache
    t = k_cache.shape[1]
    at = min(max(pos, 0), t - 1)
    k_cache[:, at] = k_new[:, 0]
    v_cache[:, at] = v_new[:, 0]

    kr = repeat_kv(k_cache, hp, cfg.n_heads)       # [B, T, Hp, hd]
    vr = repeat_kv(v_cache, hp, cfg.n_heads)
    scale = 1.0 / math.sqrt(hd)
    sc = torch.einsum('bqhd,bkhd->bhqk', q.float() * scale, kr.float())
    valid = torch.arange(t, device=x.device)[None, None, None, :] <= pos
    sc = torch.where(valid, sc, NEG_INF)
    w = torch.softmax(sc, dim=-1)
    out = torch.einsum('bhqk,bkhd->bqhd', w, vr.float()).to(x.dtype)
    out = _mask_heads(out, cfg.n_heads)
    return out.reshape(b, 1, hp * hd) @ p['wo'], (k_cache, v_cache)


def attention_cross(p, x, cfg, kv) -> torch.Tensor:
    """Cross-attention (the whisper decoder): ``kv`` = (k, v) [B, T, Hkv,
    hd] from the encoder states; no rope, no mask, through
    ``flash_attention`` with its bfloat16 roundings."""
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim()
    hp = p['wq'].shape[1] // hd
    q = (x @ p['wq']).reshape(b, s, hp, hd)
    k, v = kv
    kr = repeat_kv(k, hp, cfg.n_heads)
    vr = repeat_kv(v, hp, cfg.n_heads)
    out = _mask_heads(flash_attention(q, kr, vr, causal=False), cfg.n_heads)
    return out.reshape(b, s, hp * hd) @ p['wo']


def cross_kv(p, enc: torch.Tensor, cfg) -> tuple:
    """The cross-attention k/v [B, T, Hkv, hd] of encoder output ``enc``."""
    b, s, _ = enc.shape
    hd = cfg.resolved_head_dim()
    k = (enc @ p['wk']).reshape(b, s, cfg.n_kv_heads, hd)
    v = (enc @ p['wv']).reshape(b, s, cfg.n_kv_heads, hd)
    return k, v


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


def mlp(p, x, cfg) -> torch.Tensor:
    up = x @ p['w_up']
    if cfg.act == 'swiglu':
        h = F.silu(x @ p['w_gate']) * up
    elif cfg.act == 'relu2':           # nemotron squared-ReLU
        h = torch.square(F.relu(up))
    elif cfg.act == 'gelu':            # jax.nn.gelu's default: tanh form
        h = F.gelu(up, approximate='tanh')
    else:
        raise ValueError(cfg.act)
    return h @ p['w_down']


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


def embed(p, tokens: torch.Tensor) -> torch.Tensor:
    return p['embed'][tokens]


def _unembed_matrix(p) -> torch.Tensor:
    return p['unembed'] if 'unembed' in p else p['embed'].T


def logits(p, x: torch.Tensor, cfg) -> torch.Tensor:
    h = rmsnorm(x, p['final_norm'], cfg.norm_eps)
    lg = h @ _unembed_matrix(p)
    vp = lg.shape[-1]
    if vp != cfg.vocab:   # mask the vocab padding
        lg = torch.where(torch.arange(vp, device=lg.device) < cfg.vocab,
                         lg, NEG_INF)
    return lg


def _ce_chunk(h_c, w, l_c, vocab: int):
    """The summed negative log-likelihood [] and the count of labels >= 0
    of one chunk: h_c [B, c, D] normed states, w [D, Vp], l_c [B, c]."""
    lg = (h_c @ w).float()                                   # [B, c, Vp]
    vp = lg.shape[-1]
    if vp != vocab:   # mask the vocab padding out of the partition function
        lg = torch.where(torch.arange(vp, device=lg.device) < vocab, lg,
                         NEG_INF)
    lse = torch.logsumexp(lg, dim=-1)
    tgt = torch.gather(lg, -1, torch.clamp(l_c, min=0)[..., None].long())[
        ..., 0]
    valid = l_c >= 0
    nll = torch.where(valid, lse - tgt, 0.0)
    return nll.sum(), valid.sum(dtype=torch.int32)


def chunked_ce_loss(p, x: torch.Tensor, labels: torch.Tensor,
                    cfg) -> torch.Tensor:
    """Sequence-chunked cross entropy, the mean over labels >= 0 (-1 is
    ignored).  x [B, S, D] final hidden states, labels [B, S].

    The chunk is ``min(cfg.loss_chunk, S)``, shrunk until it divides S.
    Each chunk's float32 logits [B, c, V] are recomputed in the backward
    pass (``remat``), so the whole [B, S, V] never exists at once."""
    b, s, d = x.shape
    c = min(cfg.loss_chunk, s)
    while s % c:
        c -= 1
    w = _unembed_matrix(p)
    h = rmsnorm(x, p['final_norm'], cfg.norm_eps)
    nll_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    count = torch.zeros((), dtype=torch.int32, device=x.device)
    for i in range(s // c):
        nll, n = remat(True, _ce_chunk, h[:, i * c:(i + 1) * c], w,
                       labels[:, i * c:(i + 1) * c], cfg.vocab)
        nll_sum = nll_sum + nll
        count = count + n
    return nll_sum / torch.clamp(count, min=1)
