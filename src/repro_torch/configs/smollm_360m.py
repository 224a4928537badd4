"""smollm-360m — small llama-arch GQA [hf:HuggingFaceTB/SmolLM-360M].

Small model: pure data parallelism (batch over every mesh axis, params
replicated) — TP would waste the mesh on a 360M model.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name='smollm-360m', family='dense',
    n_layers=32, d_model=960, n_heads=15, n_kv_heads=5,
    d_ff=2560, vocab=49152, head_dim=64,
    recipe='dp', remat=True,
)
