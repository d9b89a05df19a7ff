"""The ``dwconv1d`` kernel wrapper: CUDA on the card, plain torch on the
CPU.

Replaces the TPU kernel ``src/repro/kernels/dwconv1d/kernel.py::dwconv1d``
(``_dwconv1d_kernel``: causal depthwise conv streamed over sequence
chunks with a carried (k−1)×C history) by a kernel written by hand in
CUDA C++ for ``sm_90a``: ``csrc/dwconv1d.cu``, whose header states the
design and what bounds it (HBM bytes).

The interface is the reference kernel's: x [B,S,C], w [k,C] (channels
fast), b [C], all in x's dtype; the result is [B,S,C]. Unlike the
reference, S need not divide by a chunk: there is no padding.

``dwconv1d`` launches the kernel for a CUDA tensor and runs the plain
version :func:`dwconv1d_ref` for a CPU tensor, and only then: there is no
fallback from the card to the plain version. ``dwconv1d.launches`` counts
kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import refuse_grad
from repro_torch.kernels.dwconv1d import _build
from repro_torch.kernels.dwconv1d.ref import dwconv1d_ref

KERNEL_TAPS = (2, 4)                       # the instantiations in csrc/
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _check(x, w, b) -> None:
    if x.ndim != 3 or w.ndim != 2 or b.ndim != 1:
        raise ValueError("x must be [B,S,C], w [k,C] and b [C]; got "
                         f"{tuple(x.shape)}, {tuple(w.shape)}, "
                         f"{tuple(b.shape)}")
    B, S, C = x.shape
    k = w.shape[0]
    if w.shape[1] != C or b.shape[0] != C:
        raise ValueError(f"w must be [k,{C}] and b [{C}]; got "
                         f"{tuple(w.shape)}, {tuple(b.shape)}")
    if k not in KERNEL_TAPS:
        raise ValueError(f"the kernel is built for {KERNEL_TAPS} taps; "
                         f"got k={k}")
    if x.dtype not in _DTYPE_CODE or w.dtype != x.dtype \
            or b.dtype != x.dtype:
        raise TypeError("the kernel takes float32 or bfloat16 x, w, b of "
                        f"one dtype; got {x.dtype}, {w.dtype}, {b.dtype}")
    if w.device != x.device or b.device != x.device:
        raise ValueError("x, w and b must be on one device")
    if not (x.is_contiguous() and w.is_contiguous() and b.is_contiguous()):
        raise ValueError("x, w and b must be contiguous")
    if B > 65535 or (S + 15) // 16 > 65535:
        raise ValueError(f"shape {tuple(x.shape)} exceeds the launch grid")


def dwconv1d(x: torch.Tensor, w: torch.Tensor,
             b: torch.Tensor) -> torch.Tensor:
    """Causal depthwise conv: ``y[t] = b + Σ_d x[t−(k−1)+d]·w[d]``, zero
    history before t = 0 in each batch row. x: [B,S,C]; w: [k,C]; b: [C];
    contiguous, float32 or bfloat16, one dtype. Returns [B,S,C].

    A CUDA tensor launches the kernel on ``torch.cuda.current_stream()``
    (the call returns before the card finishes); a CPU tensor runs
    :func:`dwconv1d_ref`. On either device, an input that needs a gradient
    raises ``NotImplementedError``: there is no backward kernel.
    """
    refuse_grad("dwconv1d", x, w, b)
    if x.device.type == "cpu":
        return dwconv1d_ref(x, w, b)
    if x.device.type != "cuda":
        raise ValueError(f"no dwconv1d for device {x.device}")
    _check(x, w, b)
    B, S, C = x.shape
    y = torch.empty_like(x)
    if y.numel() == 0:
        return y
    lib = _build.load_library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        rc = lib.dwconv1d_launch(x.data_ptr(), w.data_ptr(), b.data_ptr(),
                                 y.data_ptr(), B, S, C, w.shape[0],
                                 _DTYPE_CODE[x.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"dwconv1d launch failed with CUDA error {rc}")
    dwconv1d.launches += 1
    return y


dwconv1d.launches = 0
