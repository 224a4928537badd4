"""MODEL_FLOPS, the useful work of a step, as the JAX package's
``analysis.flops`` counts it (pure Python, exact).

Dense LM train step: 6*N*D (N = params participating per token, D = tokens);
MoE: 6*N_active*D.  Serve steps (prefill/decode): 2*N(_active)*D plus the
attention KV term where it matters (decode reads the whole cache per token).

These are *model* FLOPs, what a perfectly fused implementation must spend:
over the card's peak rate they give a step's compute bound
(``chip_smoke.py``'s train phase divides the train step's by 989 TFLOP/s).
"""
from __future__ import annotations

from ..configs.base import ModelConfig, ShapeConfig


def param_count(cfg: ModelConfig, *, active_only: bool = False,
                tp: int = 1) -> int:
    """Parameters in one forward pass (active_only: MoE top-k experts only).

    Counts the *unpadded* logical model (padding is waste, not useful work),
    so ``tp`` changes nothing; it is kept for the JAX signature.
    """
    d, f, v = cfg.d_model, cfg.d_ff, cfg.vocab
    hd = cfg.resolved_head_dim()
    hq = cfg.n_heads * hd
    hkv = cfg.n_kv_heads * hd

    def attn():
        return d * hq + 2 * d * hkv + hq * d

    def dense_mlp(ff=None):
        ff = ff or f
        n_mats = 3 if cfg.act == 'swiglu' else 2
        return n_mats * d * ff

    total = v * d  # embedding
    if not cfg.tie_embeddings:
        total += d * v

    if cfg.family in ('dense', 'vlm'):
        total += cfg.n_layers * (attn() + dense_mlp())
    elif cfg.family == 'encdec':
        enc = cfg.enc_layers or cfg.n_layers
        total += enc * (attn() + dense_mlp())
        total += cfg.n_layers * (2 * attn() + dense_mlp())  # self + cross
    elif cfg.family == 'moe':
        n_moe = cfg.n_layers // cfg.moe_every
        n_dense = cfg.n_layers - n_moe
        total += cfg.n_layers * attn()
        total += n_dense * dense_mlp()
        experts = cfg.top_k if active_only else cfg.n_experts
        n_mats = 3 if cfg.act == 'swiglu' else 2
        total += n_moe * (experts * n_mats * d * f + d * cfg.n_experts)
        if cfg.shared_expert:
            total += n_moe * dense_mlp()
    elif cfg.family == 'ssm':
        di = 2 * d
        per_m = d * di * 2 + 3 * di * di + di * 2 * cfg.n_heads + di * d
        per_s = d * 4 * di + di * 4 * di + di * d
        se = cfg.slstm_every or (cfg.n_layers + 1)
        n_s = cfg.n_layers // se if cfg.n_layers % se == 0 else 0
        total += (cfg.n_layers - n_s) * per_m + n_s * per_s
    elif cfg.family == 'hybrid':
        di = 2 * d
        ds = cfg.ssm_state
        h = di // cfg.ssm_head_dim
        per_mamba = d * (2 * di + 2 * ds + h) + di * d
        total += cfg.n_layers * per_mamba
        ae = cfg.attn_every or (cfg.n_layers + 1)
        if len([l for l in range(cfg.n_layers) if (l + 1) % ae == 0]):
            total += attn() + dense_mlp()  # ONE shared block
    else:
        raise ValueError(cfg.family)
    return total


def _attn_flops_per_layer(cfg: ModelConfig, seq: int, batch: int,
                          causal: bool = True) -> float:
    """Score+AV FLOPs of full attention (not counted in 6ND)."""
    hd = cfg.resolved_head_dim()
    h = cfg.n_heads
    pairs = seq * seq * (0.5 if causal else 1.0)
    return batch * h * pairs * hd * 2 * 2  # QK^T + PV, 2 flops/MAC


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """MODEL_FLOPS for one step of (cfg x shape)."""
    b, s = shape.global_batch, shape.seq_len
    n_act = param_count(cfg, active_only=True)

    if shape.kind == 'train':
        # fwd 2ND + bwd 4ND, plus attention quadratic term (x3 for bwd)
        flops = 6.0 * n_act * b * s
        if cfg.family in ('dense', 'vlm', 'moe'):
            flops += 3.0 * cfg.n_layers * _attn_flops_per_layer(cfg, s, b)
        elif cfg.family == 'encdec':
            enc = cfg.enc_layers or cfg.n_layers
            flops += 3.0 * enc * _attn_flops_per_layer(cfg, s, b, causal=False)
            flops += 3.0 * cfg.n_layers * (
                _attn_flops_per_layer(cfg, s, b)
                + _attn_flops_per_layer(cfg, s, b, causal=False))
        elif cfg.family == 'hybrid':
            ae = cfg.attn_every or (cfg.n_layers + 1)
            n_pts = len([l for l in range(cfg.n_layers) if (l + 1) % ae == 0])
            flops += 3.0 * n_pts * _attn_flops_per_layer(cfg, s, b)
        return flops

    if shape.kind == 'prefill':
        flops = 2.0 * n_act * b * s
        if cfg.family in ('dense', 'vlm', 'moe'):
            flops += cfg.n_layers * _attn_flops_per_layer(cfg, s, b)
        elif cfg.family == 'encdec':
            enc = cfg.enc_layers or cfg.n_layers
            flops += enc * _attn_flops_per_layer(cfg, s, b, causal=False)
            flops += cfg.n_layers * (_attn_flops_per_layer(cfg, s, b)
                                     + _attn_flops_per_layer(cfg, s, b,
                                                             causal=False))
        elif cfg.family == 'hybrid':
            ae = cfg.attn_every or (cfg.n_layers + 1)
            n_pts = len([l for l in range(cfg.n_layers) if (l + 1) % ae == 0])
            flops += n_pts * _attn_flops_per_layer(cfg, s, b)
        return flops

    # decode: one token; params read once, KV cache read once per attn layer
    flops = 2.0 * n_act * b
    hd = cfg.resolved_head_dim()
    kv_layers = 0
    if cfg.family in ('dense', 'vlm', 'moe'):
        kv_layers = cfg.n_layers
    elif cfg.family == 'encdec':
        kv_layers = 2 * cfg.n_layers
    elif cfg.family == 'hybrid':
        ae = cfg.attn_every or (cfg.n_layers + 1)
        kv_layers = len([l for l in range(cfg.n_layers) if (l + 1) % ae == 0])
    flops += kv_layers * b * cfg.n_heads * s * hd * 2 * 2
    return flops


def hbm_bytes_decode(cfg: ModelConfig, shape: ShapeConfig,
                     dtype_bytes: int = 2) -> float:
    """Minimum HBM traffic of a decode step: params once + KV cache once."""
    n = param_count(cfg, active_only=True)
    hd = cfg.resolved_head_dim()
    b, s = shape.global_batch, shape.seq_len
    kv_layers = cfg.n_layers if cfg.family in ('dense', 'vlm', 'moe') else 0
    if cfg.family == 'encdec':
        kv_layers = 2 * cfg.n_layers
    if cfg.family == 'hybrid':
        ae = cfg.attn_every or (cfg.n_layers + 1)
        kv_layers = len([l for l in range(cfg.n_layers) if (l + 1) % ae == 0])
    kv = kv_layers * b * s * cfg.n_kv_heads * hd * 2  # k and v
    return (n + kv) * dtype_bytes
