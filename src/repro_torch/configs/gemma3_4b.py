"""Gemma3-4B [hf:google/gemma-3-4b-pt; unverified].

34L d_model=2560 8H (GQA kv=4) d_ff=10240 vocab=262144. 5:1 local:global
attention (window 1024 local layers, every 6th layer global), qk-norm,
sqrt(d) embedding scaling, 128k context (long_500k runs: SWA-dominant).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-4b",
    family="dense",
    num_layers=34,
    d_model=2560,
    num_heads=8,
    num_kv_heads=4,
    head_dim=256,
    d_ff=10240,
    vocab_size=262_144,
    attn_window=1024,
    global_every=6,           # layers 5, 11, ... are global
    use_qk_norm=True,
    rope_theta=1_000_000.0,
    embed_scale=True,
    tie_embeddings=True,
    notes="5:1 local:global SWA, 128k context",
)
