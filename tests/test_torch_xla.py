"""Port vs reference: the library-convolution baseline (``execution='xla'``)
on the CPU — every policy × dtype × window against the reference's
``filter2d_xla``, every layout, the requant epilogue in all roundings,
the int32 overflow edge, the refusals, and the TF32 switch the executor
turns off around its own call and hands back as it found it, also when
two threads call at once."""
import dataclasses
import threading
import time

import numpy as np
import pytest
import torch

from repro.core.border_spec import BorderSpec as RBorder
from repro.core.filter2d import filter2d_xla as r_filter2d_xla
from repro.core.pipeline import Filter2D as RFilter2D
from repro.core.requant import RequantSpec as RRequant
from repro_torch.convert import from_reference
from repro_torch.core import filter2d_xla
from repro_torch.core.border_spec import BorderSpec
from repro_torch.core.filter2d import F as conv_functional
from repro_torch.core.filter2d import xla_fixed_convolutions
from repro_torch.core.pipeline import Filter2D
from repro_torch.core.requant import RequantSpec

from _torch_parity import (DTYPES, POLICIES, assert_match, border_constant,
                           coeffs, frame, to_jax, to_torch)

ROUNDINGS = ("truncate", "nearest", "nearest_even")


def _both(rspec, x, k, dtype, gains=None, what=""):
    xr = to_jax(x, dtype)
    ref = rspec.compile(xr, "xla")(xr, k, gains=gains)
    g = None if gains is None else dataclasses.asdict(gains)
    spec, co, table = from_reference(dataclasses.asdict(rspec), k, g)
    xt = to_torch(x, dtype)
    got = spec.compile(xt, "xla", device="cpu")(xt, co, gains=table)
    assert_match(got, ref, dtype, f"xla {what}")
    return got


@pytest.mark.parametrize("w", [3, 5])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("policy", POLICIES)
def test_xla_matches_reference(policy, dtype, w, rng):
    x = frame(rng, dtype, (2, 17, 23, 2))
    k = coeffs(rng, dtype, (w, w))
    rspec = RFilter2D(window=w, dtype=dtype,
                      border=RBorder(policy, border_constant(dtype)))
    _both(rspec, x, k, dtype, what=f"{policy} {dtype} w{w}")


@pytest.mark.parametrize("shape", [(18, 23), (18, 23, 3), (2, 18, 23, 2)])
@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_xla_layouts(shape, dtype, rng):
    x = frame(rng, dtype, shape)
    k = coeffs(rng, dtype, (5, 5))
    _both(RFilter2D(window=5, dtype=dtype, border=RBorder("mirror_dup")),
          x, k, dtype, what=str(shape))


@pytest.mark.parametrize("rounding", ROUNDINGS)
@pytest.mark.parametrize("dtype", ["int8", "uint8", "int16"])
@pytest.mark.parametrize("policy", ["mirror", "wrap", "constant"])
def test_xla_requant(policy, dtype, rounding, rng):
    """The pipeline's epilogue after the convolution, gains as operands
    (``test_requant.py``'s contract on the xla executor)."""
    x = frame(rng, dtype, (20, 26))
    k = coeffs(rng, dtype, (3, 3))
    rq = RRequant(multiplier=5, shift=7, rounding=rounding, dtype=dtype)
    rspec = RFilter2D(window=3, dtype=dtype, requant=rq.gain_free(),
                      border=RBorder(policy, border_constant(dtype)))
    got = _both(rspec, x, k, dtype, gains=rq, what=rounding)
    assert got.dtype == getattr(torch, dtype)


@pytest.mark.parametrize("w", [7, 9, 11, 13, 15])
def test_xla_overflow_edge(w):
    """All-max int16 frames under coefficients of 2²⁰ overflow the int32
    accumulator; the split float64 convolutions are exact and wrap to the
    reference's int32 sum, bit for bit (w 13 and 15 lie past the single
    float64 convolution's exact range)."""
    x = np.full((2, 40, 70), 32767, np.int16)
    k = np.full((w, w), 1 << 20, np.int32)
    k[0, 0] = -(1 << 31)                          # the most negative tap too
    rspec = RFilter2D(window=w, dtype="int16", border=RBorder("duplicate"))
    got = _both(rspec, x, k, "int16", what=f"overflow w{w}")
    core = Filter2D(window=w, dtype="int16", border="duplicate").compile(
        got.shape, "core", device="cpu")(to_torch(x, "int16"), k)
    assert torch.equal(got, core)
    assert got.dtype == torch.int32 and int(got.abs().max()) > 2 ** 30


@pytest.mark.parametrize("w", [13, 15])
@pytest.mark.parametrize("dtype", ["int8", "int16"])
@pytest.mark.parametrize("policy", ["mirror", "wrap", "constant"])
def test_xla_wide_fixed_point_windows(policy, dtype, w, rng):
    """Windows past w 11, with coefficients over the whole int32 range (the
    high halves of the split carry signal), against the reference's
    ``filter2d_xla``: bit for bit."""
    x = frame(rng, dtype, (2, 19, 24, 2))
    k = rng.integers(-2 ** 31, 2 ** 31, (w, w)).astype(np.int32)
    rspec = RFilter2D(window=w, dtype=dtype,
                      border=RBorder(policy, border_constant(dtype)))
    got = _both(rspec, x, k, dtype, what=f"{policy} {dtype} w{w}")
    core = Filter2D(window=w, dtype=dtype,
                    border=BorderSpec(policy, border_constant(dtype))
                    ).compile(got.shape, "core", device="cpu")
    assert torch.equal(got, core(to_torch(x, dtype), k))


@pytest.mark.parametrize("dtype,w,n", [
    ("int8", 3, 1), ("int8", 181, 1), ("int8", 183, 2), ("uint8", 127, 1),
    ("uint8", 129, 2), ("int16", 11, 1), ("int16", 13, 2),
    ("int16", 2047, 2), ("int16", 2049, 0)])
def test_xla_fixed_point_convolution_count(dtype, w, n):
    """One float64 convolution while max|x| · 2³¹ · w² <= 2⁵³, the split
    halves while max|x| · 2¹⁶ · w² <= 2⁵³, none past that."""
    assert xla_fixed_convolutions(dtype, w) == n


@pytest.mark.parametrize("dtype,w,split", [
    ("int8", 3, False), ("int8", 15, False), ("uint8", 15, False),
    ("int16", 11, False), ("int16", 13, True)])
def test_xla_splits_only_where_one_convolution_is_inexact(dtype, w, split,
                                                         rng, monkeypatch):
    """The route is chosen from the storage dtype and w: one filter per
    channel where one float64 convolution is exact, two (the coefficient
    halves) only where it is not; bit for bit with 'core' either way."""
    filters = []
    real = conv_functional.conv2d

    def spy(x, weight, **kw):
        filters.append(weight.shape[0] // x.shape[1])
        return real(x, weight, **kw)
    monkeypatch.setattr(conv_functional, "conv2d", spy)
    x = to_torch(frame(rng, dtype, (2, 18, 21, 3)), dtype)
    k = rng.integers(-2 ** 31, 2 ** 31, (w, w)).astype(np.int32)
    spec = Filter2D(window=w, dtype=dtype, border="mirror_dup")
    got = spec.compile(x, "xla", device="cpu")(x, k)
    assert filters == [2 if split else 1]
    assert torch.equal(got, spec.compile(x, "core", device="cpu")(x, k))


@pytest.mark.parametrize("policy", ["mirror", "constant", "neglect"])
def test_public_wrapper(policy, rng):
    x = frame(rng, "float32", (20, 26))
    k = coeffs(rng, "float32", (5, 5))
    ref = r_filter2d_xla(to_jax(x, "float32"), k,
                         border=RBorder(policy, 1.5))
    got = filter2d_xla(to_torch(x, "float32"), k,
                       border=BorderSpec(policy, 1.5))
    assert_match(got, ref, "float32", policy)
    if policy != "constant":                  # the border_policy shorthand
        assert_match(filter2d_xla(to_torch(x, "float32"), k, policy), ref,
                     "float32", policy)
    xi = frame(rng, "uint8", (20, 26))
    ki = coeffs(rng, "uint8", (3, 3))
    rq = dict(multiplier=3, shift=4, rounding="nearest", dtype="uint8")
    assert_match(filter2d_xla(to_torch(xi, "uint8"), ki, policy,
                              requant=RequantSpec(**rq)),
                 r_filter2d_xla(to_jax(xi, "uint8"), ki, policy,
                                requant=RRequant(**rq)), "uint8", policy)


@pytest.mark.parametrize("before", [True, False])
def test_tf32_off_during_the_call_and_restored(before, rng, monkeypatch):
    seen = []
    real = conv_functional.conv2d

    def spy(*a, **kw):
        seen.append(torch.backends.cudnn.allow_tf32)
        return real(*a, **kw)
    monkeypatch.setattr(conv_functional, "conv2d", spy)
    prev = torch.backends.cudnn.allow_tf32
    try:
        torch.backends.cudnn.allow_tf32 = before
        x = to_torch(frame(rng, "float32", (12, 14)), "float32")
        cf = Filter2D(window=3).compile(x, "xla", device="cpu")
        cf(x, np.ones((3, 3), np.float32))
        assert seen == [False]
        assert torch.backends.cudnn.allow_tf32 is before

        def boom(*a, **kw):
            raise RuntimeError("conv failed")
        monkeypatch.setattr(conv_functional, "conv2d", boom)
        with pytest.raises(RuntimeError, match="conv failed"):
            cf(x, np.ones((3, 3), np.float32))
        assert torch.backends.cudnn.allow_tf32 is before
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def test_tf32_switch_holds_across_threads(rng, monkeypatch):
    """Two threads run an 'xla' pipeline at once (as two serving engines'
    workers would) while the caller has TF32 on: each convolution runs
    with TF32 off from dispatch to return, the convolutions take turns,
    and the caller's setting is back once both are done."""
    seen, active, peak = [], [0], [0]
    real = conv_functional.conv2d
    guard = threading.Lock()

    def spy(*a, **kw):
        with guard:
            active[0] += 1
            peak[0] = max(peak[0], active[0])
        seen.append(torch.backends.cudnn.allow_tf32)
        time.sleep(0.05)                 # hold the call open for the other
        seen.append(torch.backends.cudnn.allow_tf32)
        with guard:
            active[0] -= 1
        return real(*a, **kw)
    monkeypatch.setattr(conv_functional, "conv2d", spy)
    prev = torch.backends.cudnn.allow_tf32
    try:
        torch.backends.cudnn.allow_tf32 = True
        x = to_torch(frame(rng, "float32", (12, 14)), "float32")
        cf = Filter2D(window=3).compile(x, "xla", device="cpu")
        k = np.ones((3, 3), np.float32)
        start = threading.Barrier(2)
        out, errors = [], []

        def run():
            try:
                start.wait()
                out.append(cf(x, k))
            except Exception as e:       # surfaced by the assert below
                errors.append(e)
        threads = [threading.Thread(target=run) for _ in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not errors and len(out) == 2
        assert seen == [False] * 4 and peak[0] == 1
        assert torch.backends.cudnn.allow_tf32 is True
        torch.testing.assert_close(out[0], out[1], rtol=0, atol=0)
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def test_refusals_and_selection():
    with pytest.raises(ValueError, match="banks"):
        Filter2D(window=3, num_filters=2).compile((8, 8), "xla",
                                                  device="cpu")
    with pytest.raises(ValueError, match="separable"):
        Filter2D(window=3, separable=True).compile((8, 8), "xla",
                                                   device="cpu")
    with pytest.raises(ValueError, match="w² < 2²²"):
        Filter2D(window=2049, dtype="int16").compile((32, 32), "xla",
                                                     device="cpu")
    for dtype in ("int16", "float32"):
        assert Filter2D(window=13, dtype=dtype).compile(
            (32, 32), "xla", device="cpu").execution == "xla"
    cf = Filter2D(window=3).compile((8, 8), "xla", device="cpu")
    assert cf.execution == "xla" and cf.selection[0] == "explicit"
    assert Filter2D(window=3).compile((8, 8), device="cpu").execution == \
        "core"                                   # 'auto' never picks it
