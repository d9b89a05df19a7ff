"""Port vs reference: the separable fast path, filter banks, the fused
requant epilogue in all three roundings, and the int32 wraparound edge —
each through the port's plain forms (``core``) and its kernel path
(``cuda``, the kernel's plain version on a CPU tensor)."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import filters as r_filters
from repro.core.border_spec import BorderSpec as RBorder
from repro.core.pipeline import Filter2D as RFilter2D
from repro.core.requant import RequantSpec as RRequant
from repro.core.requant import requantize_ref
from repro_torch.convert import from_reference
from repro_torch.core.filter2d import apply_requant
from repro_torch.core.requant import RequantSpec

from _torch_parity import (DTYPES, INT_DTYPES, POLICIES, assert_match,
                           border_constant, coeffs, frame, to_jax, to_torch)

ROUNDINGS = ("truncate", "nearest", "nearest_even")


def _both(rspec, x, k, dtype, gains=None, what=""):
    """Run the reference core executor and both port executors."""
    xr = to_jax(x, dtype)
    ref = rspec.compile(xr, "core")(xr, k, gains=gains)
    g = None if gains is None else dataclasses.asdict(gains)
    spec, co, table = from_reference(dataclasses.asdict(rspec), k, g)
    xt = to_torch(x, dtype)
    for execution in ("core", "cuda"):
        cf = spec.compile(xt, execution, device="cpu")
        got = cf(xt, co, gains=table)
        assert_match(got, ref, dtype, f"{execution} {what}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("policy", POLICIES)
def test_separable_float(policy, dtype, rng):
    x = frame(rng, dtype, (15, 22))
    u, v = r_filters.decompose_separable(r_filters.gaussian(5))
    rspec = RFilter2D(window=5, separable=True, dtype=dtype,
                      border=RBorder(policy, border_constant(dtype)))
    _both(rspec, x, (u, v), dtype, what=f"separable {policy}")


@pytest.mark.parametrize("dtype", INT_DTYPES)
@pytest.mark.parametrize("policy", POLICIES)
def test_separable_integer_factors(policy, dtype, rng):
    x = frame(rng, dtype, (15, 22))
    u = rng.integers(-5, 6, 3).astype(np.int32)
    v = rng.integers(-5, 6, 3).astype(np.int32)
    rspec = RFilter2D(window=3, separable=True, dtype=dtype,
                      border=RBorder(policy, border_constant(dtype)))
    _both(rspec, x, (u, v), dtype, what=f"int separable {policy}")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("policy", POLICIES)
def test_bank(policy, dtype, rng):
    x = frame(rng, dtype, (14, 19))
    k = coeffs(rng, dtype, (3, 3, 3))
    rspec = RFilter2D(window=3, num_filters=3, dtype=dtype,
                      border=RBorder(policy, border_constant(dtype)))
    _both(rspec, x, k, dtype, what=f"bank {policy}")


@pytest.mark.parametrize("rounding", ROUNDINGS)
@pytest.mark.parametrize("dtype", INT_DTYPES)
@pytest.mark.parametrize("policy", ["mirror", "constant", "neglect"])
def test_requant_single(policy, dtype, rounding, rng):
    x = frame(rng, dtype, (16, 20))
    k = coeffs(rng, dtype, (3, 3))
    k[1, 1] = 40                          # non-zero gain
    rq = RRequant.unity_gain(k, dtype, rounding=rounding)
    rspec = RFilter2D(window=3, dtype=dtype, requant=rq.gain_free(),
                      border=RBorder(policy, border_constant(dtype)))
    _both(rspec, x, k, dtype, gains=rq, what=f"requant {rounding}")


@pytest.mark.parametrize("rounding", ROUNDINGS)
@pytest.mark.parametrize("dtype", INT_DTYPES)
def test_requant_bank_per_filter(dtype, rounding, rng):
    x = frame(rng, dtype, (16, 20))
    k = coeffs(rng, dtype, (4, 3, 3))
    k[:, 1, 1] = [30, 40, 50, 60]
    rq = RRequant.unity_gain(k, dtype, rounding=rounding)
    rspec = RFilter2D(window=3, num_filters=4, dtype=dtype,
                      requant=rq.gain_free(), border=RBorder("wrap"))
    _both(rspec, x, k, dtype, gains=rq, what=f"bank requant {rounding}")


def test_gain_and_coefficient_swaps_reuse_one_variant(rng):
    """Swapping coefficients and gains builds nothing: one kernel variant."""
    x = frame(rng, "int8", (16, 20))
    xt = to_torch(x, "int8")
    rq = RequantSpec(multiplier=5, shift=3, rounding="nearest_even",
                     dtype="int8")
    for execution in ("core", "cuda"):
        spec, _, _ = from_reference(dataclasses.asdict(RFilter2D(
            window=3, dtype="int8", requant=RRequant(
                5, 3, "nearest_even", "int8").gain_free())), np.zeros((3, 3)))
        cf = spec.compile(xt, execution, device="cpu")
        for m, s in [(5, 3), (-7, 1), (1, 0)]:
            k = coeffs(rng, "int8", (3, 3))
            got = cf(xt, k, gains=np.array([m, s]))
            xr = to_jax(x, "int8")
            rref = RFilter2D(window=3, dtype="int8", requant=RRequant(
                rounding="nearest_even", dtype="int8")).compile(xr, "core")
            ref = rref(xr, k, gains=RRequant(m, s, "nearest_even", "int8"))
            assert_match(got, ref, "int8", f"{execution} swap {m},{s}")
        assert cf.cache_size() == 1


@pytest.mark.parametrize("dtype", INT_DTYPES)
def test_all_max_overflow_wraps_like_the_reference(dtype):
    """Every product at its maximum: the int32 MAC wraps mod 2^32 exactly
    as the reference's int32 arithmetic does."""
    info = np.iinfo(dtype)
    x = np.full((12, 15), info.max, dtype)
    k = np.full((5, 5), 2 ** 24 + 7, np.int32)
    rspec = RFilter2D(window=5, dtype=dtype, border=RBorder("duplicate"))
    _both(rspec, x, k, dtype, what="all-max")
    rq = RRequant(multiplier=3, shift=5, rounding="nearest", dtype=dtype)
    rspec = RFilter2D(window=5, dtype=dtype, requant=rq.gain_free(),
                      border=RBorder("duplicate"))
    _both(rspec, x, k, dtype, gains=rq, what="all-max requant")


@pytest.mark.parametrize("rounding", ROUNDINGS)
@pytest.mark.parametrize("dtype", INT_DTYPES)
def test_apply_requant_matches_requantize_ref(dtype, rounding, rng):
    acc = rng.integers(-2 ** 22, 2 ** 22, (9, 11)).astype(np.int32)
    acc.flat[:6] = [0, 1, -1, 2, -2, 2 ** 21]
    for m, s in [(1, 0), (1, 1), (3, 2), (-5, 4), (77, 9), (1, 31)]:
        rq = RRequant(multiplier=m, shift=s, rounding=rounding, dtype=dtype)
        ref = requantize_ref(acc, rq)
        got = apply_requant(torch.from_numpy(acc), m, s, rounding=rounding,
                            out_dtype=dtype)
        np.testing.assert_array_equal(got.numpy(), ref)


def test_requant_rejects_float_frames():
    from repro_torch.core.pipeline import Filter2D
    with pytest.raises(ValueError):
        Filter2D(window=3, dtype="float32", requant=RequantSpec())
    with pytest.raises(ValueError):
        from_reference(dataclasses.asdict(RFilter2D(window=3)),
                       np.ones((3, 3)), gains=np.array([1, 0]))


def test_separable_integer_needs_exact_factors(rng):
    from repro_torch.core.filter2d import resolve_separable
    k = np.outer([1, 2, 1], [1, 0, -1]).astype(np.int32)
    with pytest.raises(ValueError):
        resolve_separable(torch.int8, k, (np.array([1.0, 2, 1]),
                                          np.array([1.0, 0, -1])))
    with pytest.raises(ValueError):
        resolve_separable(torch.int8, k + 1, (np.array([1, 2, 1]),
                                              np.array([1, 0, -1])))
    with pytest.raises(NotImplementedError):
        resolve_separable(torch.int8, k, True)
    u, v = resolve_separable(torch.float32, r_filters.gaussian(5), "auto")
    np.testing.assert_allclose(np.outer(u, v), r_filters.gaussian(5),
                               atol=1e-6)
    assert resolve_separable(torch.float32, r_filters.laplacian(), "auto") \
        is None
