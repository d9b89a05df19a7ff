"""Shared helpers of the ``tests/test_torch_*.py`` parity suites: inputs
made with numpy from a seeded generator, handed to the reference (JAX,
on the CPU) and to the port (torch, ``device='cpu'``), and the stated
tolerances: integers bit-exact; float32 within rtol=atol=3e-4 (the
reference suite's kernel tolerance, tests/test_halo_engine.py); bfloat16
within 3e-2 (tests/test_kernels.py), with normalised coefficients as the
reference's own bfloat16 tests use — the reference accumulates bfloat16
at bfloat16, the port's kernel path in float32."""
import jax.numpy as jnp
import numpy as np
import torch

POLICIES = ("neglect", "constant", "wrap", "duplicate", "mirror_dup",
            "mirror")
FORMS = ("direct", "transposed", "tree", "compress")
DTYPES = ("float32", "bfloat16", "int8", "uint8", "int16")
INT_DTYPES = ("int8", "uint8", "int16")
TOL = {"float32": 3e-4, "bfloat16": 3e-2}


def is_int(dtype: str) -> bool:
    return dtype in INT_DTYPES


def border_constant(dtype: str) -> float:
    """A non-zero constant; out of range for int8/uint8 (saturates)."""
    return -300.0 if is_int(dtype) else 3.7


def frame(rng, dtype: str, shape):
    """numpy frame: float32 values for float dtypes (cast on each side),
    the full integer range for fixed-point dtypes."""
    if is_int(dtype):
        info = np.iinfo(dtype)
        return rng.integers(info.min, int(info.max) + 1, shape).astype(dtype)
    return rng.standard_normal(shape).astype(np.float32)


def coeffs(rng, dtype: str, shape):
    if is_int(dtype):
        return rng.integers(-9, 10, shape).astype(np.int32)
    k = rng.standard_normal(shape).astype(np.float32)
    if dtype == "bfloat16":               # unit L1 norm per filter
        k /= np.abs(k).sum(axis=(-2, -1), keepdims=True)
    return k


def to_jax(x: np.ndarray, dtype: str):
    return jnp.asarray(x).astype(jnp.dtype(dtype))


def to_torch(x: np.ndarray, dtype: str) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x)).to(getattr(torch, dtype))


def assert_match(got: torch.Tensor, ref, dtype: str, what: str = ""):
    ref = np.asarray(ref.astype(jnp.float32) if dtype == "bfloat16" else ref)
    g = got.float().numpy() if got.dtype == torch.bfloat16 else got.numpy()
    assert g.shape == ref.shape, (what, g.shape, ref.shape)
    if is_int(dtype):
        assert g.dtype == ref.dtype, (what, g.dtype, ref.dtype)
        np.testing.assert_array_equal(g, ref, err_msg=what)
    else:
        np.testing.assert_allclose(g, ref, rtol=TOL[dtype], atol=TOL[dtype],
                                   err_msg=what)
