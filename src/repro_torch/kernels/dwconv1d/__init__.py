"""Causal depthwise 1D conv: the hand-written CUDA kernel
(``kernel.dwconv1d``), its plain version (``ref.dwconv1d_ref``) and the
[C,k]-weight API (``ops.dwconv1d_cuda``)."""
from repro_torch.kernels.dwconv1d.kernel import dwconv1d
from repro_torch.kernels.dwconv1d.ops import dwconv1d_cuda
from repro_torch.kernels.dwconv1d.ref import dwconv1d_ref

__all__ = ["dwconv1d", "dwconv1d_cuda", "dwconv1d_ref"]
