"""Qwen2-VL-7B backbone [arXiv:2409.12191; hf].

28L d_model=3584 28H (GQA kv=4) d_ff=18944 vocab=152064. M-RoPE with
(t, h, w) = (16, 24, 24) frequency sections over head_dim/2 = 64.
Vision frontend is a STUB per the brief: inputs are precomputed patch
embeddings [B, S, D]; M-RoPE runs with text positions in the dry-run and
with true 3D positions in examples/video_pipeline.py.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-7b",
    family="vlm",
    num_layers=28,
    d_model=3584,
    num_heads=28,
    num_kv_heads=4,
    d_ff=18944,
    vocab_size=152064,
    rope_theta=1_000_000.0,
    mrope_sections=(16, 24, 24),
    embeddings_in=True,
    notes="M-RoPE, dynamic-resolution ViT frontend stubbed",
)
