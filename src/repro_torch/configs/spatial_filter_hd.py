"""The paper's own configuration: general-purpose 7x7 runtime-coefficient
spatial filter over streaming video.

640x480 (the paper's synthesis target) and 1920x1080 (the paper's HLS
comparison, Table X) are both exercised by benchmarks; this config pins
the defaults. w=7 also serves 5x5/3x3 by zeroing the outer ring (paper
SII).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="spatial-filter-hd",
    family="filter",
    filter_window=7,
    image_h=1080,
    image_w=1920,
    image_c=1,
    dtype="float32",
    notes="the paper's general-purpose 7x7 filter, FullHD stream",
)
