"""Mixtral-8x7B [arXiv:2401.04088; hf].

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000, MoE 8 experts
top-2, sliding-window attention 4096. E=8 < 16 -> expert-TP sharding.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=32_000,
    attn_window=4096,
    num_experts=8,
    num_experts_per_tok=2,
    rope_theta=1_000_000.0,
    notes="8e top-2 MoE, SWA 4096",
)
