"""The public causal depthwise conv: the reference's ``dwconv1d_pallas``
API over the kernel wrapper.

Weight layout: models store depthwise weights as [C, k] (channel-major,
as HF mamba does); the kernel wants [k, C] so that neighbouring threads
read neighbouring channels. The transpose, and the cast of the weights
and bias to x's dtype, happen here, once, at the boundary."""
from __future__ import annotations

import torch

from repro_torch.kernels.dwconv1d import kernel as K


def dwconv1d_cuda(x: torch.Tensor, w_ck: torch.Tensor,
                  b: torch.Tensor) -> torch.Tensor:
    """x: [B,S,C]; w_ck: [C,k]; b: [C]. Causal depthwise conv; the CUDA
    kernel for CUDA tensors, its plain version for CPU tensors."""
    w = w_ck.t().to(x.dtype).contiguous()          # [k, C]
    return K.dwconv1d(x.contiguous(), w, b.to(x.dtype).contiguous())
