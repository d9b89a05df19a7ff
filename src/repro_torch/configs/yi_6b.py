"""Yi-6B [arXiv:2403.04652; hf].

32L d_model=4096 32H (GQA kv=4) d_ff=11008 vocab=64000. Llama-arch GQA,
full attention (long_500k skipped: quadratic).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="yi-6b",
    family="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=4,
    d_ff=11008,
    vocab_size=64_000,
    rope_theta=5_000_000.0,
    notes="llama-arch GQA, full attention",
)
