"""whisper-base — enc-dec audio backbone; conv/mel frontend is a STUB
(input_specs supplies precomputed frame embeddings) [arXiv:2212.04356]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name='whisper-base', family='encdec',
    n_layers=6, enc_layers=6, d_model=512, n_heads=8, n_kv_heads=8,
    d_ff=2048, vocab=51865,
    act='gelu',
    recipe='dp', remat=True,
)
