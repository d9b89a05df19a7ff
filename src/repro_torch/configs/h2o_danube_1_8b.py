"""H2O-Danube-1.8B [arXiv:2401.16818; hf].

24L d_model=2560 32H (GQA kv=8) d_ff=6912 vocab=32000. Llama+Mistral mix
with sliding-window attention (4096).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-1.8b",
    family="dense",
    num_layers=24,
    d_model=2560,
    num_heads=32,
    num_kv_heads=8,
    d_ff=6912,
    vocab_size=32_000,
    attn_window=4096,
    rope_theta=10_000.0,
    notes="llama+mistral mix, SWA 4096",
)
