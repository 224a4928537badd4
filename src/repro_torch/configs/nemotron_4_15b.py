"""nemotron-4-15b — dense GQA with squared-ReLU MLP [arXiv:2402.16819]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name='nemotron-4-15b', family='dense',
    n_layers=32, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=24576, vocab=256000,
    act='relu2',
    recipe='tp', remat=True,
)
