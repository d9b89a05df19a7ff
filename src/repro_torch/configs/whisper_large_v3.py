"""Whisper-large-v3 backbone [arXiv:2212.04356; unverified].

Enc-dec: 32 encoder + 32 decoder layers, d_model=1280 20H (MHA kv=20)
d_ff=5120 vocab=51866. Conv mel frontend is a STUB (inputs are frame
embeddings). Decoder learned positions: 448 native; longer decode targets
interpolate (documented deviation, needed by decode_32k).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3",
    family="encdec",
    num_layers=32,            # decoder layers
    encoder_layers=32,
    d_model=1280,
    num_heads=20,
    num_kv_heads=20,
    d_ff=5120,
    vocab_size=51_866,
    max_target_positions=448,
    tie_embeddings=True,
    notes="enc-dec; conv frontend stubbed; dec positions 448",
)
