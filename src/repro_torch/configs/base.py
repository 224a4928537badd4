"""Model/arch configuration schema + the shape suite assigned to this paper."""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """One architecture.  Fields cover every family in the assigned pool."""

    name: str
    family: str                 # dense | moe | encdec | vlm | ssm | hybrid
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0           # 0 -> d_model // n_heads

    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    moe_every: int = 1          # MoE layer every k-th layer (maverick: 2)
    shared_expert: bool = False
    capacity_factor: float = 1.25

    # --- enc-dec (whisper) ---
    enc_layers: int = 0

    # --- SSM / hybrid ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_conv: int = 4
    slstm_every: int = 0        # xlstm: every k-th block is sLSTM
    attn_every: int = 0         # zamba2: shared attention block every k layers

    # --- misc architecture switches ---
    act: str = 'swiglu'         # 'swiglu' | 'relu2' (nemotron) | 'gelu' (whisper)
    qk_norm: bool = False       # chameleon
    tie_embeddings: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    dtype: str = 'bfloat16'

    # --- distribution recipe ---
    recipe: str = 'tp'          # 'tp' | 'dp' | 'ep' | 'ssm'
    remat: bool = True          # activation checkpointing over layer scan
    scan_layers: bool = True
    loss_chunk: int = 512       # sequence-chunked cross-entropy
    opt_state_dtype: str = 'float32'   # 'bfloat16' for memory-tight configs

    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def reduced(self, **overrides) -> 'ModelConfig':
        """A small same-family config for CPU smoke tests."""
        small = dict(
            n_layers=min(self.n_layers, 2),
            d_model=min(self.d_model, 128),
            n_heads=min(self.n_heads, 4),
            n_kv_heads=min(self.n_kv_heads, 2),
            d_ff=min(self.d_ff, 256) if self.d_ff else 0,
            vocab=min(self.vocab, 512),
            head_dim=32 if self.resolved_head_dim() > 32 else 0,
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            enc_layers=min(self.enc_layers, 2) if self.enc_layers else 0,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_head_dim=16 if self.ssm_state else self.ssm_head_dim,
            slstm_every=2 if self.slstm_every else 0,
            attn_every=2 if self.attn_every else 0,
            dtype='float32',
            remat=False,
        )
        small.update(overrides)
        return dataclasses.replace(self, **small)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str       # 'train' | 'prefill' | 'decode'


# The four assigned input shapes (identical suite for every LM arch).
SHAPES = {
    'train_4k':    ShapeConfig('train_4k',    4_096,   256, 'train'),
    'prefill_32k': ShapeConfig('prefill_32k', 32_768,  32,  'prefill'),
    'decode_32k':  ShapeConfig('decode_32k',  32_768,  128, 'decode'),
    'long_500k':   ShapeConfig('long_500k',   524_288, 1,   'decode'),
}

# long_500k requires a sub-quadratic attention path: only SSM/hybrid archs
# run it (see DESIGN.md §Arch-applicability for the mandated skip list).
LONG_CONTEXT_FAMILIES = ('ssm', 'hybrid')


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> bool:
    if shape.name == 'long_500k':
        return cfg.family in LONG_CONTEXT_FAMILIES
    return True
