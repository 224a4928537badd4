"""llama4-maverick-400b-a17b — interleaved MoE, 128 experts top-1 + shared
expert [hf:meta-llama/Llama-4-*].

moe_every=2 (MoE on alternating layers) is what reconciles the assigned
"48L / 128e / d_ff 8192" line with the 400B-total / 17B-active name:
24 MoE layers x 128 experts x 3 x 5120 x 8192 = 386B routed params (+ dense
layers + shared experts ~= 400B); top-1 + shared expert + dense layers
~= 17B active.  bf16 optimizer state — fp32 moments would not fit
16 GB/chip on the 256-way mesh (see DESIGN.md).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name='llama4-maverick-400b-a17b', family='moe',
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8,
    d_ff=8192, vocab=202048,
    n_experts=128, top_k=1, moe_every=2, shared_expert=True,
    recipe='ep', remat=True, opt_state_dtype='bfloat16',
)
