"""command-r-35b — dense GQA, no-bias [hf:CohereForAI/c4ai-command-r-v01]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name='command-r-35b', family='dense',
    n_layers=40, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=22528, vocab=256000,
    recipe='tp', remat=True,
)
