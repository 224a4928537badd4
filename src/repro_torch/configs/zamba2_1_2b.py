"""zamba2-1.2b — Mamba2 backbone + ONE shared attention block applied every
6 layers [arXiv:2411.15242]. ssm_state=64."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name='zamba2-1.2b', family='hybrid',
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab=32000, head_dim=64,
    ssm_state=64, attn_every=6,
    recipe='ssm', remat=True,
)
