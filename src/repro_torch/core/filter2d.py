"""2D spatial filter forms — the paper's §II as plain torch (the oracle layer).

The paper maps a general `w×w` runtime-coefficient filter onto DSP48E1
blocks in two *forms* and three *adder-tree layouts*. The reference
package keeps one plain version of each form; this module is its torch
twin, in the reference's summation order:

  ``direct``      all w² shifted products stacked, one contraction over
                  the tap axis (the reference's im2row einsum).
  ``transposed``  shift-and-accumulate: a running accumulator over the w²
                  taps in raster order (MAC chains, no tree).
  ``tree``        the w² products reduced pairwise, log2 depth — the
                  paper's **LOG layout**.
  ``compress``    products reduced in groups of 6, then chained — the
                  paper's **DSPCOMP layout**.

These functions are the CPU path of ``execution='core'`` and the oracle
every test holds the CUDA kernel's results against; they never stand in
for the kernel on a CUDA tensor. Float frames compute at their own dtype
with coefficients cast to it, as the reference does. Fixed-point frames
(int8/uint8/int16) take the int32 contract: the reference multiplies and
accumulates in int32 with two's-complement wraparound; here the sum runs
exactly in int64 and wraps to int32 once (the same value: addition and
multiplication commute with reduction mod 2³²).

Layout convention: frames are NHWC ``[B, H, W, C]`` (C=1 for mono), as in
the reference. The forms use no ``F.conv2d``/cuDNN: cuDNN has no integer
convolution and its float32 path runs TF32 by default. The one library
convolution here is the ``'xla'`` baseline (:func:`_filter2d_xla_impl`),
the reference's compiler-inferred yardstick, which works around both.
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import dtypes
from repro_torch.core.border_spec import (BorderSpec, out_shape,
                                          quantize_constant)
from repro_torch.core.borders import extend
from repro_torch.core.filters import decompose_separable
from repro_torch.core.requant import RequantSpec

FORMS = ("direct", "transposed", "tree", "compress")

is_fixed_point = dtypes.is_fixed_point


def wrap_i32(t: torch.Tensor) -> torch.Tensor:
    """int64 values reduced mod 2³² into int32 (two's-complement wrap) —
    what the reference's int32 arithmetic and the kernel's uint32 MAC
    produce."""
    return (((t.to(torch.int64) + 2 ** 31) & 0xFFFFFFFF) - 2 ** 31).to(
        torch.int32)


# ---------------------------------------------------------------------------
# Requantising epilogue (paper §IV: pixels LEAVE at storage width too)
# ---------------------------------------------------------------------------


def resolve_requant(frame_dtype, requant: Optional[RequantSpec],
                    num_filters: int = 1) -> Optional[RequantSpec]:
    """Validate the ``requant`` knob against the frame's datapath.

    ``None`` keeps the wide accumulator on the output bus (int32 for
    fixed-point frames). A :class:`RequantSpec` is only meaningful on the
    fixed-point datapath and its per-filter multiplier/shift tuples, if
    any, must match the bank size.
    """
    if requant is None:
        return None
    if not isinstance(requant, RequantSpec):
        raise TypeError(f"requant must be a core.requant.RequantSpec; got "
                        f"{type(requant).__name__}")
    if not is_fixed_point(frame_dtype):
        raise ValueError(
            "requant is the fixed-point epilogue: frames of dtype "
            f"{dtypes.name(frame_dtype)} accumulate and leave at their "
            "own width; pass requant=None")
    requant.params(num_filters)          # validates per-filter lengths
    return requant


def apply_requant(acc: torch.Tensor, multiplier, shift, *, rounding: str,
                  out_dtype) -> torch.Tensor:
    """The fused scale→round→saturate epilogue on an int32 accumulator.

    The torch twin of ``core.requant.requantize_ref`` with the int32
    semantics of the reference's jnp epilogue: ``acc·multiplier`` and the
    rounding add wrap mod 2³², ``>>`` is the arithmetic (floor) shift, the
    masked remainder decides ties, the ``shift−1`` term clamps at shift 0.
    Values are carried in int64 and wrapped explicitly, so no step relies
    on signed-overflow behaviour. ``multiplier``/``shift`` are ints or
    tensors broadcastable against ``acc``.
    """
    dev = acc.device
    acc = acc.to(torch.int64)
    m = torch.as_tensor(multiplier, dtype=torch.int64, device=dev)
    sh = torch.as_tensor(shift, dtype=torch.int64, device=dev)
    prod = wrap_i32(acc * m).to(torch.int64)
    sh = torch.broadcast_to(sh, prod.shape)
    one = torch.ones_like(sh)
    shm1 = (sh - 1).clamp(min=0)
    if rounding == "truncate":
        q = prod >> sh
    elif rounding == "nearest":
        half = torch.where(sh > 0, one << shm1, torch.zeros_like(sh))
        q = wrap_i32(prod + half).to(torch.int64) >> sh
    elif rounding == "nearest_even":
        base = prod >> sh
        rem = prod & ((one << sh) - 1)
        half = one << shm1
        odd = (base & 1) == 1
        up = (rem > half) | ((rem == half) & odd)
        q = base + ((sh > 0) & up).to(torch.int64)
    else:
        raise ValueError(f"unknown rounding mode {rounding!r}")
    info = np.iinfo(dtypes.name(out_dtype))
    return q.clamp(int(info.min), int(info.max)).to(dtypes.to_torch(out_dtype))


def apply_requant_params(y: torch.Tensor, q_params: torch.Tensor,
                         requant: RequantSpec) -> torch.Tensor:
    """The runtime-gains epilogue: scale/round/saturate ``y`` by the
    ``[1, 2]`` (multiplier, shift) operand under ``requant``'s static half
    (rounding mode + storage dtype). Banks index their ``[N, 2]`` table
    per lane instead."""
    return apply_requant(y, q_params[0, 0], q_params[0, 1],
                         rounding=requant.rounding, out_dtype=requant.dtype)


def _as_nhwc(frame: torch.Tensor) -> Tuple[torch.Tensor, bool, bool]:
    """Accept [H,W], [H,W,C] or [B,H,W,C]; return NHWC + flags to undo."""
    add_c = frame.ndim == 2
    if add_c:
        frame = frame[..., None]
    add_b = frame.ndim == 3
    if add_b:
        frame = frame[None]
    return frame, add_b, add_c


def _un_nhwc(y: torch.Tensor, add_b: bool, add_c: bool) -> torch.Tensor:
    if add_b:
        y = y[0]
    if add_c:
        y = y[..., 0]
    return y


def _shifted(xp: torch.Tensor, i: int, j: int, H: int, W: int
             ) -> torch.Tensor:
    """Window-tap view: xp is the (H+w-1, W+w-1)-extended NHWC frame."""
    return xp[:, i:i + H, j:j + W, :]


def _products(xp, coeffs, H, W):
    """All w² shifted-frame × scalar-coefficient products, raster order."""
    w = coeffs.shape[-1]
    return [_shifted(xp, i, j, H, W) * coeffs[i, j]
            for i in range(w) for j in range(w)]


# ---------------------------------------------------------------------------
# Forms (xp and coeffs already share the accumulation dtype)
# ---------------------------------------------------------------------------


def _direct(xp, coeffs, H, W):
    """All w² shifted planes stacked, contracted over the tap axis."""
    w = coeffs.shape[-1]
    planes = torch.stack(
        [_shifted(xp, i, j, H, W) for i in range(w) for j in range(w)],
        dim=-1)                                   # [B,H,W,C,w²]
    return (planes * coeffs.reshape(-1)).sum(-1, dtype=xp.dtype)


def _transposed(xp, coeffs, H, W):
    """Running-accumulator MAC chain over the w² taps (no patch tensor)."""
    prods = _products(xp, coeffs, H, W)
    acc = prods[0]
    for p in prods[1:]:
        acc = acc + p
    return acc


def _tree(xp, coeffs, H, W):
    """Pairwise (log2-depth) reduction of the w² products — LOG layout."""
    prods = _products(xp, coeffs, H, W)
    while len(prods) > 1:
        nxt = [prods[i] + prods[i + 1] for i in range(0, len(prods) - 1, 2)]
        if len(prods) % 2:
            nxt.append(prods[-1])
        prods = nxt
    return prods[0]


def _compress(xp, coeffs, H, W, group: int = 6):
    """Group-of-6 partial sums, then a final chain — DSPCOMP layout."""
    prods = _products(xp, coeffs, H, W)
    partials = []
    for i in range(0, len(prods), group):
        g = prods[i:i + group]
        s = g[0]
        for t in g[1:]:
            s = s + t
        partials.append(s)
    acc = partials[0]
    for s1 in partials[1:]:
        acc = acc + s1
    return acc


_FORM_FNS = {
    "direct": _direct,
    "transposed": _transposed,
    "tree": _tree,
    "compress": _compress,
}


def _widen(frame: torch.Tensor, *operands):
    """The accumulation dtype: int64 (wrapped to int32 at the end) for
    fixed-point frames, the frame's own dtype for floats."""
    acc = torch.int64 if is_fixed_point(frame.dtype) else frame.dtype
    return (frame.to(acc),) + tuple(torch.as_tensor(o).to(frame.device, acc)
                                    for o in operands)


def _finish(y: torch.Tensor, fixed: bool) -> torch.Tensor:
    return wrap_i32(y) if fixed else y


def _filter2d_impl(frame: torch.Tensor, coeffs, *, form: str,
                   border: BorderSpec, border_constant) -> torch.Tensor:
    """One w×w filter in ``form`` under ``border``; ``border_constant`` is
    already quantized against the storage dtype (quantize_constant), so
    widening before the extension cannot smuggle an unrepresentable c
    into the frame."""
    fixed = is_fixed_point(frame.dtype)
    frame, add_b, add_c = _as_nhwc(frame)
    x, co = _widen(frame, coeffs)
    B, H, W, C = x.shape
    w = co.shape[-1]
    r = (w - 1) // 2
    xp = extend(x, r, border, axes=(1, 2), constant=border_constant)
    Ho, Wo = out_shape(H, W, w, border)
    y = _FORM_FNS[form](xp, co, Ho, Wo)
    return _un_nhwc(_finish(y, fixed), add_b, add_c)


def _filter2d_sep_impl(frame: torch.Tensor, u, v, *, border: BorderSpec,
                       border_constant) -> torch.Tensor:
    """Separable fast path: a w-tap column pass (``v`` along the width)
    then a w-tap row pass (``u`` along the height) — 2w MACs/pixel."""
    fixed = is_fixed_point(frame.dtype)
    frame, add_b, add_c = _as_nhwc(frame)
    x, u, v = _widen(frame, u, v)
    B, H, W, C = x.shape
    w = u.shape[0]
    r = (w - 1) // 2
    xp = extend(x, r, border, axes=(1, 2), constant=border_constant)
    Ho, Wo = out_shape(H, W, w, border)
    h = None                              # horizontal (column) pass
    for j in range(w):
        t = xp[:, :, j:j + Wo, :] * v[j]
        h = t if h is None else h + t
    if fixed:
        h = wrap_i32(h).to(torch.int64)
    y = None                              # vertical (row) pass
    for i in range(w):
        t = h[:, i:i + Ho] * u[i]
        y = t if y is None else y + t
    return _un_nhwc(_finish(y, fixed), add_b, add_c)


def _filter_bank_impl(frame: torch.Tensor, bank, *, border: BorderSpec,
                      border_constant) -> torch.Tensor:
    """N filters over one extension of the frame (the input is gathered
    ONCE for the whole bank); bank axis last: [..., N]."""
    fixed = is_fixed_point(frame.dtype)
    frame_n, add_b, add_c = _as_nhwc(frame)
    x, bk = _widen(frame_n, bank)
    B, H, W, C = x.shape
    w = bk.shape[-1]
    r = (w - 1) // 2
    xp = extend(x, r, border, axes=(1, 2), constant=border_constant)
    Ho, Wo = out_shape(H, W, w, border)
    y = torch.stack([_direct(xp, bk[n], Ho, Wo) for n in range(bk.shape[0])],
                    dim=-1)               # [B,Ho,Wo,C,N]
    y = _un_nhwc(_finish(y, fixed), add_b, False)
    if add_c:
        y = y[..., 0, :]
    return y


def resolve_separable(frame_dtype, coeffs, separable, tol: float = 1e-5):
    """Resolve the ``separable`` knob to ``(u, v)`` or ``None`` (2D path).

    ``separable=False`` never decomposes; ``True`` requires a rank-1
    float filter (raises otherwise); ``"auto"`` decomposes when it can and
    runs the full w² form when it can't (fixed-point frames, non-separable
    filters). An explicit ``separable=(u, v)`` pair always takes the 2w
    path — the only way fixed-point frames get it, and then only with
    *integer* factors whose outer product reproduces ``coeffs`` exactly:
    SVD factors would break bit-exact int32 accumulation. Coefficients
    are always concrete here, so the factor checks always run.
    """
    if separable is False or separable is None:
        return None
    if isinstance(separable, (tuple, list)):
        if len(separable) != 2:
            raise ValueError("separable=(u, v) takes exactly two 1D factors")
        u, v = (torch.as_tensor(np.asarray(a) if not torch.is_tensor(a)
                                else a) for a in separable)
        if u.ndim != 1 or v.ndim != 1 or u.shape != v.shape:
            raise ValueError("separable factors must be same-length 1D "
                             f"arrays; got {tuple(u.shape)} and "
                             f"{tuple(v.shape)}")
        k = np.asarray(coeffs.cpu() if torch.is_tensor(coeffs) else coeffs)
        if dtypes.is_integer(frame_dtype):
            if u.is_floating_point() or v.is_floating_point():
                raise ValueError(
                    "fixed-point frames take the separable path only with "
                    "an exact *integer* rank-1 factorization; got factor "
                    f"dtypes {u.dtype}/{v.dtype}")
            if not np.array_equal(np.outer(u.cpu().numpy(), v.cpu().numpy()),
                                  k):
                raise ValueError(
                    "separable=(u, v) does not factor coeffs exactly; the "
                    "fixed-point path must stay bit-exact with the w² form")
        elif not np.allclose(
                np.outer(u.cpu().double().numpy(), v.cpu().double().numpy()),
                k.astype(np.float64), rtol=1e-4, atol=1e-6):
            raise ValueError(
                "separable=(u, v) does not factor coeffs (outer(u, v) != "
                "coeffs)")
        return u, v
    if separable not in (True, "auto"):
        raise ValueError(
            f"separable must be 'auto', True, False or a (u, v) pair; "
            f"got {separable!r}")
    strict = separable is True
    if dtypes.is_integer(frame_dtype):
        if strict:
            raise NotImplementedError(
                "separable fast path needs an explicit exact integer "
                "factorization for fixed-point frames: pass "
                "separable=(u, v); SVD detection is float-only")
        return None
    k = coeffs.cpu().numpy() if torch.is_tensor(coeffs) else coeffs
    uv = decompose_separable(np.asarray(k), tol=tol)
    if uv is None and strict:
        raise ValueError("separable=True but the filter is not rank-1 "
                         "within tol; use separable='auto' to fall back")
    if uv is None:
        return None
    return torch.from_numpy(uv[0]), torch.from_numpy(uv[1])


def filter2d(frame: torch.Tensor, coeffs, *, form: str = "direct",
             border: BorderSpec = BorderSpec("mirror"),
             separable=False,
             requant: Optional[RequantSpec] = None) -> torch.Tensor:
    """Apply a runtime `w×w` filter to a frame with the plain torch path
    (``execution='core'``) on the frame's own device.

    frame: [H,W] | [H,W,C] | [B,H,W,C]. coeffs: [w,w]. Output keeps the
    frame size unless ``border.policy == 'neglect'`` (shrinks by w−1).
    ``separable`` and ``requant`` as in the reference: ``"auto"``/``True``
    /``(u, v)`` route through two 1D passes; a
    :class:`~repro_torch.core.requant.RequantSpec` narrows fixed-point
    outputs back to storage width.

    Thin wrapper over ``core.pipeline.Filter2D`` — prefer the compiled
    front door (``execution='cuda'`` on the card) for served pipelines.
    """
    from repro_torch.core.pipeline import Filter2D
    if form not in FORMS:
        raise ValueError(f"unknown form {form!r}; choose from {FORMS}")
    frame = torch.as_tensor(frame)
    rq = resolve_requant(frame.dtype, requant)
    uv = resolve_separable(frame.dtype, coeffs, separable)
    window = (int(uv[0].shape[0]) if uv is not None
              else int(np.shape(coeffs)[-1]))
    spec = Filter2D(window=window, form=form, border=border,
                    separable=uv is not None,
                    dtype=dtypes.name(frame.dtype),
                    requant=rq.gain_free() if rq is not None else None)
    cf = spec.compile(frame, "core", device=frame.device)
    return cf(frame, uv if uv is not None else coeffs, gains=rq)


def filter_bank(frame: torch.Tensor, bank, *, form: str = "direct",
                border: BorderSpec = BorderSpec("mirror"),
                requant: Optional[RequantSpec] = None) -> torch.Tensor:
    """Apply N filters in one pass: bank [N,w,w] -> output [..., N], with
    the plain torch path on the frame's device. ``requant`` may carry one
    (multiplier, shift) per filter. Thin wrapper over
    ``core.pipeline.Filter2D`` (``num_filters=N``)."""
    from repro_torch.core.pipeline import Filter2D
    frame = torch.as_tensor(frame)
    n = int(np.shape(bank)[0])
    rq = resolve_requant(frame.dtype, requant, num_filters=n)
    spec = Filter2D(window=int(np.shape(bank)[-1]), form=form, border=border,
                    num_filters=n, dtype=dtypes.name(frame.dtype),
                    requant=rq.gain_free() if rq is not None else None)
    cf = spec.compile(frame, "core", device=frame.device)
    return cf(frame, bank, gains=rq)


# ---------------------------------------------------------------------------
# The library-convolution baseline (the paper's "Vivado HLS" analogue)
# ---------------------------------------------------------------------------


def xla_fixed_convolutions(dtype, w: int) -> int:
    """The float64 convolutions that the ``'xla'`` route needs to compute a
    fixed-point frame of storage ``dtype`` under a w × w int32 window
    exactly: 1 while every sum of w² products stays exact in any order
    (max|x| · 2³¹ · w² <= 2⁵³: int8 to w 181, uint8 to w 127, int16 to
    w 11); 2, the coefficients split in 16-bit halves, while
    max|x| · 2¹⁶ · w² <= 2⁵³ (int16 to w 2047); 0 past that."""
    info = torch.iinfo(dtypes.to_torch(dtype))
    peak = max(-info.min, info.max) * w * w
    for n, coeff_bits in ((1, 31), (2, 16)):
        if peak << coeff_bits <= 1 << 53:
            return n
    return 0


# serialises the save/flip/restore of torch's process-wide cuDNN TF32 flag
_TF32_LOCK = threading.RLock()


@contextlib.contextmanager
def cudnn_without_tf32():
    """cuDNN's float32 convolution without TF32 for the block, whatever
    the caller set; the caller's setting comes back afterwards. The flag
    is process-wide, so blocks on different threads (the serving engine
    runs each wave on its worker thread) take turns: no block restores
    the flag while another's convolution is being dispatched. Other
    threads' float32 cuDNN calls made while a block runs also go without
    TF32."""
    with _TF32_LOCK:
        prev = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = False
        try:
            yield
        finally:
            torch.backends.cudnn.allow_tf32 = prev


def _filter2d_xla_impl(frame: torch.Tensor, coeffs, *,
                       border: BorderSpec) -> torch.Tensor:
    """One depthwise ``F.conv2d`` (``groups=C``) over the frame extended by
    its policy (``neglect`` is not extended) — the library's convolution
    standing where the reference lets XLA infer the structure
    (``lax.conv_general_dilated``), as Vivado HLS does in the paper's
    Table X. The ``constant(c)`` value is quantized against the storage
    dtype first. Float frames convolve at their own dtype with TF32 off.
    Fixed-point frames take the reference's int32 arithmetic through
    float64, which cuDNN and the CPU both convolve, and wrap the exact sum
    to int32. Where one convolution's sums could pass 2⁵³
    (:func:`xla_fixed_convolutions`: int16 past w 11), the int32
    coefficients split as ``hi·2¹⁶ + lo`` with ``lo`` in [0, 2¹⁶), and one
    convolution computes both halves (two filters per channel), whose
    products are at most 2¹⁵ · 2¹⁶ = 2³¹; the halves recombine in int64.
    Only the low 32 bits survive the wrap, so ``hi_sum`` is taken mod 2¹⁶
    before the shift. The requantising epilogue is the pipeline's."""
    qc = quantize_constant(border.constant, frame.dtype)
    fixed = is_fixed_point(frame.dtype)
    x, add_b, add_c = _as_nhwc(frame)
    w = coeffs.shape[-1]
    xp = extend(x, (w - 1) // 2, border, axes=(1, 2), constant=qc)
    cdt = torch.float64 if fixed else x.dtype
    xp = xp.permute(0, 3, 1, 2).to(cdt)              # NCHW view of NHWC
    C = xp.shape[1]
    split = fixed and xla_fixed_convolutions(frame.dtype, w) == 2
    if split:                   # [lo, hi] halves of the int32 coefficients
        c = wrap_i32(torch.as_tensor(coeffs).to(xp.device, torch.int64))
        c = c.to(torch.int64)
        rhs = torch.stack([c & 0xFFFF, c >> 16]).to(cdt)
    else:
        rhs = coeffs.to(xp.device, cdt)[None]
    rhs = rhs.reshape(1, -1, 1, w, w).expand(C, -1, 1, w, w)
    with cudnn_without_tf32():
        y = F.conv2d(xp, rhs.reshape(-1, 1, w, w), groups=C)
    if split:                   # channel c's halves at 2c, 2c + 1
        y = y.to(torch.int64)
        y = ((y[:, 1::2] & 0xFFFF) << 16) + y[:, 0::2]
    if fixed:
        y = wrap_i32(y.to(torch.int64))
    return _un_nhwc(y.permute(0, 2, 3, 1).contiguous(), add_b, add_c)


def filter2d_xla(frame: torch.Tensor, coeffs, border_policy: str = "mirror",
                 *, border: Optional[BorderSpec] = None,
                 requant: Optional[RequantSpec] = None) -> torch.Tensor:
    """The library-convolution baseline executor (paper Table X's Vivado
    HLS analogue) on the frame's device. Pass a full ``BorderSpec`` via
    ``border`` (wins over ``border_policy``) for non-zero constants;
    ``requant`` applies the same fused epilogue contract as
    :func:`filter2d`.

    Thin wrapper over ``core.pipeline.Filter2D`` (``execution='xla'``).
    """
    from repro_torch.core.pipeline import Filter2D
    frame = torch.as_tensor(frame)
    spec_b = border if border is not None else BorderSpec(border_policy)
    rq = resolve_requant(frame.dtype, requant)
    spec = Filter2D(window=int(np.shape(coeffs)[-1]), border=spec_b,
                    dtype=dtypes.name(frame.dtype),
                    requant=rq.gain_free() if rq is not None else None)
    cf = spec.compile(frame, "xla", device=frame.device)
    return cf(frame, coeffs, gains=rq)


# ---------------------------------------------------------------------------
# Accounting (paper Tables II/III analogues)
# ---------------------------------------------------------------------------


def macs_per_pixel(w: int, form: str = "direct",
                   separable: bool = False) -> int:
    """MAC issue count per output pixel (paper Table II analogue).

    All 2D forms issue w² MACs (they differ in reduction shape); the
    separable fast path issues 2w (one w-tap pass per axis)."""
    if separable:
        return 2 * w
    return w * w


def reduction_depth(w: int, form: str) -> int:
    """Adder stages after the multiplies (paper Table I 'stages')."""
    n = w * w
    if form == "direct":
        return 1                      # one contraction over the taps
    if form == "transposed":
        return n - 1                  # chain
    if form == "tree":
        return math.ceil(math.log2(n))
    if form == "compress":
        groups = math.ceil(n / 6)
        return 2 + (groups - 1)       # compress (2) + partial-sum chain
    raise ValueError(form)


def startup_latency_rows(w: int, form: str,
                         separable: bool = False) -> float:
    """Rows that must stream in before the first output row (Table III
    analogue): direct-form needs (w−1)/2 +border rows; transposed/neglect
    needs w−1 (it discards borders, first valid row is row w−1).
    Separability changes the MAC count, not the stencil's vertical
    support, so latency depends only on the form."""
    if form == "transposed":
        return float(w - 1)
    return (w - 1) / 2.0


def hbm_bytes_per_pixel(dtype_bytes: int = 4, extra_passes: int = 0) -> int:
    """Single-pass streaming: in once + out once (+ any extra passes)."""
    return dtype_bytes * (2 + 2 * extra_passes)
