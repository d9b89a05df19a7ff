"""repro_torch: high-throughput 2D spatial filters (Al-Dujaili & Fahmy,
2017) in PyTorch, with a hand-written CUDA kernel for the NVIDIA H100.

The port of the ``repro`` package (JAX/Pallas, written for the TPU), with
the same layout and names: declare the filter's static structure with
:class:`Filter2D` (+ :class:`BorderSpec` / :class:`RequantSpec`),
``compile`` it for one frame geometry (on the card unless ``device='cpu'``),
and stream frames with runtime-swappable coefficients and gains through
the returned :class:`CompiledFilter`. ``repro_torch.serving`` is the
batched multi-tenant serving layer over the same front door;
``repro_torch.obs`` the event trace and metrics registry.
"""
from repro_torch import obs, serving
from repro_torch.core.border_spec import BorderSpec
from repro_torch.core.pipeline import CompiledFilter, Filter2D
from repro_torch.core.requant import RequantSpec

__all__ = [
    "BorderSpec",
    "CompiledFilter",
    "Filter2D",
    "RequantSpec",
    "obs",
    "serving",
]
