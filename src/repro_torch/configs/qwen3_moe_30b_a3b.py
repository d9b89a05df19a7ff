"""Qwen3-30B-A3B [hf:Qwen/Qwen3-30B-A3B].

48L d_model=2048 32H (GQA kv=4) d_ff(expert)=768 vocab=151936, MoE 128
experts top-8, qk-norm, full attention. E=128 >= 16 -> expert parallelism
over the model axis.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    head_dim=128,
    d_ff=768,
    moe_d_ff=768,
    vocab_size=151_936,
    num_experts=128,
    num_experts_per_tok=8,
    use_qk_norm=True,
    rope_theta=1_000_000.0,
    notes="128e top-8 MoE, EP sharding",
)
