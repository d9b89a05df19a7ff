"""CodeQwen1.5-7B [hf:Qwen/CodeQwen1.5-7B].

32L d_model=4096 32H (MHA: kv=32) d_ff=13440 vocab=92416. Qwen1.5 arch,
full attention (long_500k skipped: quadratic).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="codeqwen1.5-7b",
    family="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=32,
    d_ff=13440,
    vocab_size=92_416,
    rope_theta=1_000_000.0,
    notes="qwen1.5 arch, MHA (kv=32)",
)
