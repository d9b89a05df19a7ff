"""Shared helpers of the ``tests/test_torch_*.py`` parity suites: inputs
made with numpy from a seeded generator, handed to the reference (JAX,
on the CPU) and to the port (torch, ``device='cpu'``), and the stated
tolerances: integers bit-exact; float32 within rtol=atol=3e-4 (the
reference suite's kernel tolerance, tests/test_halo_engine.py); bfloat16
within 3e-2 (tests/test_kernels.py), with normalised coefficients as the
reference's own bfloat16 tests use — the reference accumulates bfloat16
at bfloat16, the port's kernel path in float32.

``reference_init_params`` draws the reference's parameters with the same
values in every process (see its docstring)."""
import zlib

import jax
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


def reference_init_params(specs, key, dtype=None):
    """The reference's ``init_params`` (src/repro/models/module.py:81-94):
    the leaves in sorted path order, each drawn by the reference's own
    ``init_leaf`` and cast to ``dtype`` where floating, but each keyed by
    ``zlib.crc32`` of its path where the reference folds in ``hash()`` of
    it. ``hash`` of a string changes with ``PYTHONHASHSEED``, so the
    reference's own draw gives other weights in every process; this one
    gives the reference's distributions, the same in every process. A
    bundle's ``init_params(key)`` is ``reference_init_params(rb.specs,
    key, jnp.float32)``. Pure in ``key``, so it can be jitted."""
    from repro.models import module as r_module
    out = {}
    for path, spec in sorted(r_module.tree_paths(specs).items()):
        sub = jax.random.fold_in(
            key, zlib.crc32("/".join(path).encode()) % (2 ** 31))
        leaf = r_module.init_leaf(spec, sub)
        if dtype is not None and jnp.issubdtype(leaf.dtype, jnp.floating):
            leaf = leaf.astype(dtype)
        d = out
        for seg in path[:-1]:
            d = d.setdefault(seg, {})
        d[path[-1]] = leaf
    return out


def reference_bundle_params(rb, key, jit: bool = False):
    """``rb.init_params(key)`` of a reference bundle through
    ``reference_init_params`` (float32, as the bundle's default), jitted
    where ``jit`` (eager init compiles once per leaf)."""
    def draw(k):
        return reference_init_params(rb.specs, k, jnp.float32)
    return jax.jit(draw)(key) if jit else draw(key)
