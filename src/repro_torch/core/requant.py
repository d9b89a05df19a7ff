"""Requantisation spec + bit-exact numpy reference (paper §IV, the B-bit bus).

The paper's throughput argument closes only when pixels *leave* the
datapath at storage width too: the MAC tree grows words to the wide
accumulator (int32 here, 48-bit DSP48 there), and a small requantising
stage — multiply, shift, round, saturate — brings them back to B bits
before the output bus. Campos et al. make the same point for
custom-precision pipelines: wordlength management belongs *inside* the
datapath, not in a post-pass. This module is the policy half of that
stage: a hashable :class:`RequantSpec` every entry point eats (a cache-key
field, baked into the ``HaloPlan``), plus the numpy reference the plain
versions and every test pin against.

Pure numpy, like :mod:`repro_torch.core.border_spec`: static planning
(``kernels/filter2d/halo.make_plan``) bakes the spec into the hashable
plan, and the reference must stay runnable anywhere.

The arithmetic contract (shared verbatim by the numpy reference here, the
torch epilogue in ``core.filter2d.apply_requant`` and the fused stage of
the CUDA kernel ``kernels/filter2d/csrc/filter2d_halo_ring.cuh``):

    prod = acc * multiplier          # int32, caller guarantees headroom
    q    = round_<mode>(prod / 2**shift)
    out  = saturate(q, storage_dtype)

``multiplier`` and ``shift`` play the role of the FPGA's output scaler:
the quantised filter gain ``g ≈ multiplier / 2**shift``. The product (and
the half-LSB rounding bias for ``nearest``) must fit int32 — the same
headroom discipline the 48-bit accumulator imposes on the FPGA; the numpy
reference *asserts* it so a test with out-of-contract parameters fails
loudly instead of comparing two wraparounds.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple, Union

import numpy as np

# Rounding modes of the shift stage. ``truncate`` is the arithmetic
# right shift (floor — the free FPGA option: drop wires), ``nearest``
# adds the half LSB first (round half toward +inf — one adder), and
# ``nearest_even`` ties to even (the DSP48 pattern-detect trick; also
# what converging accumulation pipelines want to avoid bias).
ROUNDING_MODES = ("truncate", "nearest", "nearest_even")

# Storage dtypes a requantised stream can leave at (the fixed-point
# storage set of core.filter2d.FIXED_POINT_DTYPES, by name: the spec is
# framework-free and hashable, so dtypes live here as canonical names).
STORAGE_DTYPES = ("int8", "uint8", "int16")

_PerFilter = Union[int, Tuple[int, ...]]


@dataclasses.dataclass(frozen=True)
class RequantSpec:
    """The fused output-scaler policy: ``clamp(round((acc·m) >> s))``.

    ``multiplier``/``shift`` may be a single int (one filter, or one
    scaler shared by a whole bank) or a tuple with one entry per bank
    filter — the per-filter coefficient-file analogue. ``dtype`` is the
    *storage* dtype name the stream leaves at. Hashable: a cache-key
    field, baked into the ``HaloPlan``.
    """

    multiplier: _PerFilter = 1
    shift: _PerFilter = 0
    rounding: str = "nearest"
    dtype: str = "int8"

    def __post_init__(self):
        for field in ("multiplier", "shift"):
            v = getattr(self, field)
            if isinstance(v, (list, tuple, np.ndarray)):
                v = tuple(int(x) for x in np.asarray(v).reshape(-1))
                object.__setattr__(self, field, v)
            else:
                object.__setattr__(self, field, int(v))
        shifts = self.shift if isinstance(self.shift, tuple) else (self.shift,)
        if any(s < 0 or s > 31 for s in shifts):
            raise ValueError(f"requant shift must be in [0, 31]; got "
                             f"{self.shift}")
        mults = (self.multiplier if isinstance(self.multiplier, tuple)
                 else (self.multiplier,))
        if any(abs(m) > 2 ** 31 - 1 for m in mults):
            raise ValueError("requant multiplier must fit int32; got "
                             f"{self.multiplier}")
        if self.rounding not in ROUNDING_MODES:
            raise ValueError(f"unknown rounding mode {self.rounding!r}; "
                             f"choose from {ROUNDING_MODES}")
        name = np.dtype(self.dtype).name
        if name not in STORAGE_DTYPES:
            raise ValueError(f"requant storage dtype must be one of "
                             f"{STORAGE_DTYPES}; got {self.dtype!r}")
        object.__setattr__(self, "dtype", name)

    @property
    def np_dtype(self) -> np.dtype:
        return np.dtype(self.dtype)

    @property
    def dtype_bytes(self) -> int:
        return int(self.np_dtype.itemsize)

    @property
    def num_filters(self) -> int:
        """Per-filter entries carried (1 when scalar — broadcast)."""
        n = 1
        for v in (self.multiplier, self.shift):
            if isinstance(v, tuple):
                if n not in (1, len(v)):
                    raise ValueError("multiplier/shift tuple lengths differ")
                n = len(v)
        return n

    def gain_free(self) -> "RequantSpec":
        """The spec's *static* half: rounding mode and storage dtype, with
        the runtime gains stripped to placeholders (multiplier 1, shift
        0). Pipelines are planned against this — the actual (multiplier,
        shift) table rides every call as a runtime operand of the kernel —
        so swapping gains never rebuilds anything, exactly like swapping
        filter coefficients (paper §I)."""
        return dataclasses.replace(self, multiplier=1, shift=0)

    def params(self, n: int) -> Tuple[Tuple[int, int], ...]:
        """((multiplier, shift), …) broadcast to ``n`` bank filters.

        Scalars AND length-1 tuples broadcast (the same rule
        :attr:`num_filters` applies, so every spec that constructs is
        usable); longer tuples must match the bank size exactly."""
        def bc(v):
            if isinstance(v, tuple):
                if len(v) == 1:
                    return v * n
                if len(v) != n:
                    raise ValueError(
                        f"requant carries {len(v)} per-filter entries for a "
                        f"bank of {n} filters")
                return v
            return (v,) * n
        return tuple(zip(bc(self.multiplier), bc(self.shift)))

    @classmethod
    def unity_gain(cls, coeffs, dtype: str = "int8", *,
                   rounding: str = "nearest",
                   frame_dtype=None) -> "RequantSpec":
        """Derive the unity-gain output scaler from the coefficient sum.

        An integer filter of DC gain ``g = Σ coeffs`` scales a flat input
        by ``g``; the unity-gain epilogue divides it back out:
        ``multiplier / 2**shift ≈ 1 / g``, with the *largest* shift (the
        most fractional precision) whose product still honours the int32
        headroom contract — ``|acc·multiplier| + half-LSB`` must fit
        int32 for the worst-case accumulator ``Σ|coeffs| · max|pixel|``
        (the bound :func:`requantize_ref` asserts). ``frame_dtype`` is
        the *input* storage dtype setting ``max|pixel|`` (defaults to the
        output ``dtype``); coefficients must be integers (the fixed-point
        MAC operand) with a non-zero sum.

        ``coeffs`` may be one ``[w, w]`` filter or an ``[N, w, w]`` bank —
        the bank form returns the per-filter (multiplier, shift) tuples,
        one scaler per coefficient-file lane. Turnkey: with this spec a
        box/gaussian pipeline's int8 output sits at the input's level
        (±1 LSB of rounding), validated bit-exactly against
        :func:`requantize_ref` in the tests.
        """
        k = np.asarray(coeffs)
        if k.dtype.kind not in ("i", "u"):
            raise ValueError(
                "unity_gain derives fixed-point scalers from *integer* "
                f"coefficients; got dtype {k.dtype.name}")
        if k.ndim == 2:
            banks = k[None]
        elif k.ndim == 3:
            banks = k
        else:
            raise ValueError(f"coeffs must be [w, w] or [N, w, w]; got "
                             f"shape {k.shape}")
        in_dt = np.dtype(dtype if frame_dtype is None else frame_dtype)
        if in_dt.kind not in ("i", "u"):
            raise ValueError(f"frame_dtype must be an integer storage "
                             f"dtype; got {in_dt.name}")
        info = np.iinfo(in_dt)
        pix_max = max(abs(int(info.min)), int(info.max))
        lim = 2 ** 31 - 1
        ms, ss = [], []
        for i, kf in enumerate(banks):
            g = int(kf.sum())
            if g == 0:
                raise ValueError(
                    f"filter {i} has zero coefficient sum: a zero-gain "
                    "filter has no unity-gain scaler (pick gains by hand)")
            acc_max = int(np.abs(kf.astype(np.int64)).sum()) * pix_max
            for s in range(31, -1, -1):
                m = int(np.rint(2 ** s / g))
                if m == 0:
                    continue
                bias = (1 << (s - 1)) if (s and rounding == "nearest") else 0
                if abs(m) <= lim and abs(m) * acc_max + bias <= lim:
                    ms.append(m)
                    ss.append(s)
                    break
            else:
                raise ValueError(
                    f"filter {i}: no (multiplier, shift) satisfies the "
                    "int32 headroom contract — the accumulator range "
                    f"Σ|coeffs|·max|pixel| = {acc_max} is too wide")
        if k.ndim == 2:
            return cls(multiplier=ms[0], shift=ss[0], rounding=rounding,
                       dtype=dtype)
        return cls(multiplier=tuple(ms), shift=tuple(ss), rounding=rounding,
                   dtype=dtype)


def round_shift_ref(prod: np.ndarray, shift: int, rounding: str
                    ) -> np.ndarray:
    """``round_<mode>(prod / 2**shift)`` on int64 numpy values.

    The two's-complement identities the torch/kernel twins use verbatim:
    ``>>`` is the arithmetic (floor) shift, ``prod & (2**s - 1)`` the
    non-negative remainder — so ties land exactly where the hardware adder
    puts them, for negative products too.
    """
    prod = np.asarray(prod, np.int64)
    if shift == 0:
        return prod
    if rounding == "truncate":
        return prod >> shift
    half = np.int64(1) << (shift - 1)
    if rounding == "nearest":
        return (prod + half) >> shift
    if rounding == "nearest_even":
        base = prod >> shift
        rem = prod & ((np.int64(1) << shift) - 1)
        up = (rem > half) | ((rem == half) & ((base & 1) == 1))
        return base + up.astype(np.int64)
    raise ValueError(rounding)


def requantize_ref(acc: np.ndarray, spec: RequantSpec, *,
                   filter_index: int = 0) -> np.ndarray:
    """The bit-exact numpy oracle of the fused epilogue.

    ``acc`` is the int32 accumulator plane; the result is the requantised
    storage-dtype plane. Internally int64 so the headroom contract can be
    *asserted* rather than silently wrapped: ``|acc·m| (+ half LSB)`` must
    fit int32, exactly what the in-kernel int32 stage relies on.
    """
    m, s = spec.params(max(filter_index + 1, spec.num_filters))[filter_index]
    acc64 = np.asarray(acc, np.int64)
    prod = acc64 * np.int64(m)
    bias = (np.int64(1) << (s - 1)) if (s and spec.rounding == "nearest") \
        else np.int64(0)
    lim = np.int64(2 ** 31 - 1)
    assert np.abs(prod).max(initial=0) + bias <= lim, (
        "requant headroom violated: |acc * multiplier| (+ rounding bias) "
        "must fit int32 — pick a smaller multiplier or larger shift")
    q = round_shift_ref(prod, s, spec.rounding)
    info = np.iinfo(spec.np_dtype)
    return np.clip(q, info.min, info.max).astype(spec.np_dtype)
