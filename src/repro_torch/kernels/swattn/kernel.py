"""The ``swattn`` kernel wrapper: CUDA on the card, plain torch on the CPU.

Replaces the TPU kernel ``src/repro/kernels/swattn/kernel.py::swattn``
(``_swattn_kernel``: banded causal flash attention with an online
softmax, GQA through the kv index map) by kernels written by hand in
CUDA C++ for ``sm_90a``, one per dtype, whose headers state the design
and what bounds them (operations: about 2,500 FLOP per byte at the LM's
shapes):

- bfloat16: ``csrc/swattn_bf16.cu``, on the tensor cores (``wgmma``,
  K/V tiles by TMA into a ring of shared-memory stages);
- float32: ``csrc/swattn.cu``, on the CUDA cores in float32 FMA (tensor
  cores in float32 would be TF32, which the reference does not compute),
  as an SGEMM is built: blocks of 64 queries (:func:`tile_queries`) walk
  the band in 64-key tiles (:func:`tile_keys`); a thread holds 4 rows x 8
  scores and 4 rows x hd/8 output columns in registers (x 4 and hd/16 at
  hd 256, 256 threads), fed by 128-bit shared loads from swizzled or
  padded tiles; K and V stream in turn through two shared stages by
  ``cp.async``; the softmax is one FFMA before ``ex2`` a score, masks only
  the band's edge tiles and rescales O only when a row maximum of the
  warp moves. Bound by instruction issue and latency around the FFMA.

What differs from the reference kernel's interface, on purpose: the
kernel takes the model's [B, S, H, hd] layout as it is (the reference
takes [B·H, Sp, hd] after a transpose and a pad to its block), masks the
ragged edge itself, and returns exactly [B, S, H, hd].

``swattn`` launches the kernel for a CUDA tensor and runs the plain
version :func:`swattn_ref` for a CPU tensor, and only then: there is no
fallback from the card to the plain version. ``swattn.launches`` counts
kernel launches, and ``swattn.dtype_launches`` the same launches by dtype
name (``"float32"``, ``"bfloat16"``).

A ``meta`` tensor (the dry run and the roofline build models on ``meta``)
goes through the operator ``repro_torch::swattn_band``, which exists only
for ``meta``: it returns an empty [B,S,H,hd] in q's dtype, and
``torch.utils.flop_counter`` counts it as the kernel's banded work,
:func:`band_flops` (the plain ``attend`` would count full S x S
products). It launches nothing and counts no launch.
"""
from __future__ import annotations

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import refuse_grad
from repro_torch.kernels.swattn import _build
from repro_torch.kernels.swattn.ref import swattn_ref

HEAD_DIMS = (16, 64, 80, 128, 256)         # the instantiations in csrc/
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_DTYPE_NAME = {torch.float32: "float32", torch.bfloat16: "bfloat16"}
# the launch grid is (H, B, q tiles), and no block holds fewer than 64 rows
_GRID_YZ = 65535
_MIN_TILE_QUERIES = 64


def tile_keys(dtype: torch.dtype) -> int:
    """Keys per K/V tile of the kernel for ``dtype``, as the built library
    reports it (so windows can be placed on the tile's edges)."""
    return _build.load_library().swattn_tile_keys(_DTYPE_CODE[dtype])


def tile_queries(dtype: torch.dtype) -> int:
    """Query rows per block of the float32 kernel, at every head dim, as
    the built library reports it (so S can be placed on the tiles'
    edges); -1 for bfloat16, whose rows depend on the head dim."""
    return _build.load_library().swattn_tile_queries(_DTYPE_CODE[dtype])


def band_flops(q_shape, window: int) -> int:
    """The kernel's operations for q of ``q_shape`` [B,S,H,hd]: QK^T and PV,
    two per multiply-add, over the (query, key) pairs of the causal band
    (key j counts for query i iff ``j <= i`` and, for ``window`` > 0,
    ``i - j < window``) of every head."""
    B, S, H, hd = q_shape
    pairs = (window * (window + 1) // 2 + (S - window) * window
             if 0 < window < S else S * (S + 1) // 2)
    return 4 * hd * pairs * H * B


_LIB = torch.library.Library("repro_torch", "DEF")
_LIB.define("swattn_band(Tensor q, Tensor k, Tensor v, int window, "
            "float scale) -> Tensor")


def _swattn_band_meta(q, k, v, window, scale):
    return torch.empty_like(q)


_LIB.impl("swattn_band", _swattn_band_meta, "Meta")


@register_flop_formula(torch.ops.repro_torch.swattn_band)
def _swattn_band_flops(q_shape, k_shape, v_shape, window, scale, *args,
                       out_shape=None, **kwargs) -> int:
    return band_flops(q_shape, window)


def _check(q, k, v, window: int) -> None:
    if not isinstance(window, int) or window < 0:
        raise ValueError(f"window must be an int >= 0; got {window!r}")
    if q.ndim != 4 or k.ndim != 4:
        raise ValueError("q must be [B,S,H,hd] and k, v [B,S,KV,hd]; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}")
    B, S, H, hd = q.shape
    KV = k.shape[2]
    if (tuple(k.shape) != (B, S, KV, hd) or tuple(v.shape) != tuple(k.shape)
            or KV == 0 or H % KV):
        raise ValueError(f"k and v must be [{B},{S},KV,{hd}] with {H} % KV "
                         f"== 0; got {tuple(k.shape)}, {tuple(v.shape)}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError("the kernel takes float32 or bfloat16 q, k, v of one "
                        f"dtype; got {q.dtype}, {k.dtype}, {v.dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"the kernel is built for head dims {HEAD_DIMS}; "
                         f"got {hd}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k and v must be on one device")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k and v must be contiguous")
    if B > _GRID_YZ or -(-S // _MIN_TILE_QUERIES) > _GRID_YZ:
        raise ValueError(f"shape {tuple(q.shape)} exceeds the launch grid")


def swattn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
           window: int, scale: float) -> torch.Tensor:
    """Banded causal attention. q: [B,S,H,hd]; k, v: [B,S,KV,hd],
    contiguous, float32 or bfloat16. ``window`` > 0: key j counts for
    query i iff ``j <= i`` and ``i - j < window``; 0: full causal.
    Returns [B,S,H,hd] in q's dtype.

    A CUDA tensor launches the kernel on ``torch.cuda.current_stream()``
    (the call returns before the card finishes); a CPU tensor runs
    :func:`swattn_ref`. On either device, an input that needs a gradient
    raises ``NotImplementedError``: there is no backward kernel.
    """
    refuse_grad("swattn", q, k, v)
    if q.device.type == "cpu":
        return swattn_ref(q, k, v, window=window, scale=scale)
    if q.device.type == "meta":
        _check(q, k, v, window)
        return torch.ops.repro_torch.swattn_band(q, k, v, window,
                                                 float(scale))
    if q.device.type != "cuda":
        raise ValueError(f"no swattn for device {q.device}")
    _check(q, k, v, window)
    B, S, H, hd = q.shape
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    # TMA (bfloat16) and cp.async (float32) read from 16-byte aligned
    # bases: a view that starts mid-row of its storage is copied to a fresh
    # allocation first
    q, k, v = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (q, k, v))
    lib = _build.load_library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        rc = lib.swattn_launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                               out.data_ptr(), B, S, H, k.shape[2], hd,
                               window, float(scale), _DTYPE_CODE[q.dtype],
                               stream)
    if rc != 0:
        raise RuntimeError(f"swattn launch failed with CUDA error {rc}")
    swattn.launches += 1
    swattn.dtype_launches[_DTYPE_NAME[q.dtype]] += 1
    return out


swattn.launches = 0
swattn.dtype_launches = dict.fromkeys(_DTYPE_NAME.values(), 0)
