"""xLSTM-350M [arXiv:2405.04517; unverified].

24L d_model=1024 4H vocab=50304. sLSTM + mLSTM blocks at 7:1 (every 8th
layer sLSTM). No attention: O(1) decode state, long_500k runs.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-350m",
    family="ssm",
    num_layers=24,
    d_model=1024,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    ssm_conv_width=4,
    slstm_every=8,            # 7 mLSTM : 1 sLSTM
    tie_embeddings=True,
    notes="mLSTM/sLSTM 7:1; recurrent decode",
)
