from repro_torch.optim.adamw import AdamWState, adamw_init, adamw_update
from repro_torch.optim.clip import clip_by_global_norm, global_norm
from repro_torch.optim.compression import (compress_tree, int8_ef_compress,
                                           int8_ef_decompress)
from repro_torch.optim.schedule import cosine_warmup

__all__ = ["AdamWState", "adamw_init", "adamw_update", "clip_by_global_norm",
           "compress_tree", "cosine_warmup", "global_norm",
           "int8_ef_compress", "int8_ef_decompress"]
