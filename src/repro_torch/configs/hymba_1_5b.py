"""Hymba-1.5B [arXiv:2411.13676; hf].

32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001, ssm_state=16.
Parallel attention + mamba heads in every block; SWA everywhere except
layers {first, middle, last}; 128 learnable meta tokens act as attention
sinks (mask-level sinks here; see DESIGN.md §deviations).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    num_layers=32,
    d_model=1600,
    num_heads=25,
    num_kv_heads=5,
    d_ff=5504,
    vocab_size=32001,
    attn_window=1024,
    ssm_state=16,
    ssm_conv_width=4,
    ssm_expand=2,
    mamba_heads=25,
    num_meta_tokens=128,
    notes="parallel attn+mamba heads, meta-token sinks, SWA + 3 global",
)
