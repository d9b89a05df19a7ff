"""Port vs reference: the strip-scan executor (``execution='streaming'``)
on the CPU — every same-size policy × dtype × window against the
reference's own strip scan, the reference's stream/core parity shapes,
the fixed-point and requant parity tests, the strip height the budget
derives, the refusals, and the schedule itself: one ``filter2d_halo``
call per strip on contiguous windows, never the plain forms."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import filters as r_filters
from repro.core.border_spec import BorderSpec as RBorder
from repro.core.filter2d import filter2d as r_filter2d
from repro.core.pipeline import Filter2D as RFilter2D
from repro.core.requant import RequantSpec as RRequant
from repro.core.streaming import filter2d_streaming as r_streaming
from repro.core.streaming import strip_height_for_vmem as r_strip_height
from repro_torch.convert import from_reference
from repro_torch.core import streaming
from repro_torch.core.border_spec import SAME_SIZE_POLICIES, BorderSpec
from repro_torch.core.filter2d import _FORM_FNS
from repro_torch.core.pipeline import Filter2D
from repro_torch.core.requant import RequantSpec
from repro_torch.core.streaming import filter2d_streaming

from _torch_parity import (DTYPES, assert_match, border_constant, coeffs,
                           frame, is_int, to_jax, to_torch)

ROUNDINGS = ("truncate", "nearest", "nearest_even")


def _both(rspec, x, k, dtype, *, strip_h=None, gains=None, what=""):
    """The reference's streaming executor and the port's on one input."""
    xr = to_jax(x, dtype)
    rcf = rspec.compile(xr, "streaming", strip_h=strip_h)
    ref = rcf(xr, k, gains=gains)
    g = None if gains is None else dataclasses.asdict(gains)
    spec, co, table = from_reference(dataclasses.asdict(rspec), k, g)
    xt = to_torch(x, dtype)
    cf = spec.compile(xt, "streaming", strip_h=strip_h, device="cpu")
    assert cf.strip_h == rcf.strip_h, what
    got = cf(xt, co, gains=table)
    assert_match(got, ref, dtype, f"streaming {what}")
    return cf


@pytest.mark.parametrize("w", [3, 5])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("policy", SAME_SIZE_POLICIES)
def test_streaming_matches_reference(policy, dtype, w, rng):
    """Three strips of 8 rows over [2, 24, 37, 2] frames: the first, an
    interior and the last strip, the wrap prologue, a non-zero constant."""
    x = frame(rng, dtype, (2, 24, 37, 2))
    k = coeffs(rng, dtype, (w, w))
    rq = None
    if is_int(dtype):
        rq = RRequant(multiplier=3, shift=5, rounding=ROUNDINGS[w % 3],
                      dtype=dtype)
    rspec = RFilter2D(window=w, dtype=dtype,
                      border=RBorder(policy, border_constant(dtype)),
                      requant=None if rq is None else rq.gain_free())
    cf = _both(rspec, x, k, dtype, strip_h=8, gains=rq,
               what=f"{policy} {dtype} w{w}")
    assert cf.n_strips == 3


@pytest.mark.parametrize("H,W,strip_h", [
    (70, 300, 7), (70, 300, 14), (70, 300, 70), (129, 260, 43),
    (129, 260, 129), (64, 513, 8), (64, 513, 32)])
def test_stream_small_core_parity(H, W, strip_h, rng):
    """The reference's stream ≡ core shapes (``test_stream_tiling.py``),
    through the strip scan: strips of several heights, one strip (the
    degenerate launch), widths spanning several of the kernel's tiles."""
    x = rng.standard_normal((H, W)).astype(np.float32)
    k = r_filters.gaussian(5)
    ref = r_filter2d(to_jax(x, "float32"), k, border=RBorder("mirror"))
    got = filter2d_streaming(to_torch(x, "float32"), k, strip_h=strip_h)
    assert_match(got, ref, "float32", f"{H}x{W} strip {strip_h}")


@pytest.mark.parametrize("policy", SAME_SIZE_POLICIES)
def test_streaming_executor_int_parity(policy, rng):
    """``test_fixed_point.py::test_streaming_executor_int_parity``: int8
    in, the int32 accumulator out, bit for bit."""
    x = rng.integers(-20, 20, (32, 40)).astype(np.int8)
    k = rng.integers(-4, 5, (3, 3)).astype(np.int32)
    ref = r_streaming(to_jax(x, "int8"), k, strip_h=8,
                      border=RBorder(policy, 2.0))
    got = filter2d_streaming(to_torch(x, "int8"), k, strip_h=8,
                             border=BorderSpec(policy, 2.0))
    assert got.dtype == torch.int32
    assert_match(got, ref, "int8", policy)


@pytest.mark.parametrize("policy", SAME_SIZE_POLICIES)
def test_streaming_executor_requant_parity(policy, rng):
    """``test_requant.py::test_streaming_executor_requant_parity``: each
    emitted strip requantised back to int8."""
    x = rng.integers(-20, 20, (32, 40)).astype(np.int8)
    k = rng.integers(-4, 5, (3, 3)).astype(np.int32)
    kw = dict(multiplier=7, shift=9, rounding="truncate", dtype="int8")
    ref = r_streaming(to_jax(x, "int8"), k, strip_h=8,
                      border=RBorder(policy, 2.0), requant=RRequant(**kw))
    got = filter2d_streaming(to_torch(x, "int8"), k, strip_h=8,
                             border=BorderSpec(policy, 2.0),
                             requant=RequantSpec(**kw))
    assert got.dtype == torch.int8
    assert_match(got, ref, "int8", policy)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8", "int16"])
@pytest.mark.parametrize("shape", [(4, 1440, 1920, 1), (4, 960, 1440, 1),
                                   (1, 4320, 7680, 1), (96, 128),
                                   (60, 90, 3), (2, 33, 77, 5), (7, 9)])
@pytest.mark.parametrize("w", [3, 5, 9])
def test_strip_h_is_the_reference_strip(shape, dtype, w):
    """The derived strip height is the reference's, at its accumulator
    width, over full-size and odd geometry (compile only)."""
    rq = (RRequant(rounding="nearest", dtype="int8") if dtype == "int8"
          else None)
    rspec = RFilter2D(window=w, dtype=dtype, requant=rq)
    spec, _, _ = from_reference(dataclasses.asdict(rspec), np.zeros((w, w)))
    rcf = rspec.compile(shape, "streaming")
    try:
        cf = spec.compile(shape, "streaming", device="cpu")
    except ValueError:           # the reference's scan would assert here
        assert shape[-3 if len(shape) == 4 else 0] < w - 1 or \
            rcf.strip_h < w - 1
        return
    assert cf.strip_h == rcf.strip_h
    # the strip height the reference derives for other budgets is a strip
    # height the port's scan takes, in as many strips
    for budget in (24 * 1024, 2 ** 20):
        H = shape[1] if len(shape) == 4 else shape[0]
        rcf = rspec.compile(shape, "streaming", vmem_budget=budget)
        if rcf.strip_h < w - 1 or H % rcf.strip_h:
            continue
        assert spec.compile(shape, "streaming", strip_h=rcf.strip_h,
                            device="cpu").n_strips == H // rcf.strip_h


@pytest.mark.parametrize("args", [(1920, 1, 5, 8 * 2 ** 20, 4),
                                  (7680, 1, 5, 8 * 2 ** 20, 4),
                                  (1440, 3, 3, 2 ** 20, 1),
                                  (40, 2, 9, 24 * 1024, 2),
                                  (33, 1, 3, 1024, 4)])
def test_strip_height_for_vmem_is_the_reference_rule(args):
    assert streaming.strip_height_for_vmem(*args) == r_strip_height(*args)


def test_auto_budget_streaming_executes_correctly(rng):
    """``test_compiled_filter.py::test_auto_streaming_executes_correctly``:
    the reference's 24 KiB budget forces short strips, and the port's scan
    at that strip height still matches."""
    x = rng.standard_normal((64, 48)).astype(np.float32)
    k = r_filters.gaussian(5)
    rspec = RFilter2D(window=5)
    rcf = rspec.compile((64, 48), "auto", vmem_budget=24 * 1024)
    assert rcf.execution == "streaming"
    cf = Filter2D(window=5).compile((64, 48), "streaming",
                                    strip_h=rcf.strip_h, device="cpu")
    assert cf.strip_h == rcf.strip_h and cf.n_strips > 1
    xt = to_torch(x, "float32")
    assert_match(cf(xt, k), rcf(to_jax(x, "float32"), k), "float32")
    assert_match(cf(xt, k), r_filter2d(to_jax(x, "float32"), k), "float32")


def test_refusals():
    spec = Filter2D(window=5)
    for bad in ("core", "cuda", "xla", "auto"):
        with pytest.raises(ValueError, match="streaming"):
            spec.compile((16, 16), bad, strip_h=8, device="cpu")
    with pytest.raises(ValueError, match="neglect"):
        Filter2D(window=5, border="neglect").compile((16, 16), "streaming",
                                                     device="cpu")
    with pytest.raises(ValueError, match="banks"):
        Filter2D(window=5, num_filters=2).compile((16, 16), "streaming",
                                                  device="cpu")
    with pytest.raises(ValueError, match="separable"):
        Filter2D(window=5, separable=True).compile((16, 16), "streaming",
                                                   device="cpu")
    with pytest.raises(ValueError, match="H % strip_h"):
        spec.compile((18, 16), "streaming", strip_h=8, device="cpu")
    with pytest.raises(ValueError, match="strip_h >= w - 1"):
        spec.compile((18, 16), "streaming", strip_h=3, device="cpu")
    with pytest.raises(ValueError):               # mirror r 2 needs W >= 3
        spec.compile((16, 2), "streaming", strip_h=8, device="cpu")


@pytest.mark.parametrize("policy", ["mirror", "wrap", "constant"])
@pytest.mark.parametrize("strip_h,strips", [(4, 6), (12, 2), (24, 1)])
def test_one_kernel_call_per_strip(policy, strip_h, strips, rng,
                                   monkeypatch):
    """The scan's MAC is the kernel wrapper, once per strip, on contiguous
    (strip_h + 2r) × (W + 2r) windows under one neglect plan (a single
    strip: the frame's own plan); the plain forms never run."""
    calls = []
    real = streaming.filter2d_halo

    def spy(planes, co, plan, **kw):
        assert planes.is_contiguous() and planes.ndim == 3
        calls.append((tuple(planes.shape), plan.policy))
        return real(planes, co, plan, **kw)

    def refuse(*a, **k):
        raise AssertionError("a plain form ran on the streaming path")
    monkeypatch.setattr(streaming, "filter2d_halo", spy)
    for name in list(_FORM_FNS):
        monkeypatch.setitem(_FORM_FNS, name, refuse)
    x = to_torch(frame(rng, "int16", (2, 24, 30, 3)), "int16")
    k = coeffs(rng, "int16", (5, 5))
    cf = Filter2D(window=5, dtype="int16", border=BorderSpec(policy, 9.0)
                  ).compile(x, "streaming", strip_h=strip_h, device="cpu")
    y = cf(x, k)
    assert y.shape == (2, 24, 30, 3) and y.dtype == torch.int32
    if strips > 1:
        assert calls == [((6, strip_h + 4, 34), "neglect")] * strips
    else:
        assert calls == [((6, 24, 30), policy)]
    monkeypatch.undo()
    ref = Filter2D(window=5, dtype="int16", border=BorderSpec(policy, 9.0)
                   ).compile(x, "core", device="cpu")(x, k)
    assert torch.equal(y, ref)


def test_gain_swaps_reuse_the_scan(rng):
    x = to_torch(frame(rng, "uint8", (32, 20)), "uint8")
    k = coeffs(rng, "uint8", (3, 3))
    spec = Filter2D(window=3, dtype="uint8",
                    requant=RequantSpec(rounding="nearest", dtype="uint8"))
    cf = spec.compile(x, "streaming", strip_h=8, device="cpu")
    core = spec.compile(x, "core", device="cpu")
    for gains in ((1, 0), (5, 3), (-7, 11)):
        assert torch.equal(cf(x, k, gains=gains), core(x, k, gains=gains))
    assert cf.cache_size() == 1
