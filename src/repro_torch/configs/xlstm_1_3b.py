"""xlstm-1.3b — sLSTM + mLSTM blocks (one sLSTM per 8) [arXiv:2405.04517].
d_ff=0: xLSTM blocks carry their own 2x up-projection instead of an FFN."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name='xlstm-1.3b', family='ssm',
    n_layers=48, d_model=2048, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab=50304,
    slstm_every=8,
    recipe='ssm', remat=True,
)
