"""Banded causal flash attention: the hand-written CUDA kernel
(``kernel.swattn``), its plain version (``ref.swattn_ref``) and the
[B,S,H,hd] API (``ops.swattn_cuda``)."""
from repro_torch.kernels.swattn.kernel import swattn
from repro_torch.kernels.swattn.ops import swattn_cuda
from repro_torch.kernels.swattn.ref import swattn_ref

__all__ = ["swattn", "swattn_cuda", "swattn_ref"]
