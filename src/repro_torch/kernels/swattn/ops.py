"""The public banded-attention function: the reference's ``swattn_pallas``
API ([B,S,H,hd] in and out, the default scale 1/sqrt(hd)) over the
kernel wrapper. The kernel reads the model's layout in place and masks
the ragged edge itself, so no transpose and no pad happens here."""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels.swattn import kernel as K


def swattn_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                window: int, scale: Optional[float] = None) -> torch.Tensor:
    """Sliding-window (window>0) or full (window=0) causal attention.

    q: [B,S,H,hd]; k,v: [B,S,KV,hd] (H % KV == 0). Returns [B,S,H,hd].
    The CUDA kernel for CUDA tensors, its plain version for CPU tensors.
    """
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    return K.swattn(q.contiguous(), k.contiguous(), v.contiguous(),
                    window=window, scale=scale)
