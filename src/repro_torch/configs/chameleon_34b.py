"""chameleon-34b — early-fusion VLM; VQ image tokens share the 65536 vocab,
so the backbone is a dense GQA transformer with qk-norm [arXiv:2405.09818].
The VQ tokenizer frontend is a stub: input token ids already interleave
text and image tokens."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name='chameleon-34b', family='vlm',
    n_layers=48, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=22016, vocab=65536,
    qk_norm=True,
    recipe='tp', remat=True,
)
