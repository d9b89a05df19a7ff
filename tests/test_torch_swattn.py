"""The port's banded attention held against the reference's on the same
numpy inputs: ``swattn_cuda`` (on CPU tensors, the kernel's plain
version) against the reference's Pallas kernel ``swattn_pallas`` run in
interpret mode and against its dense oracle ``swattn_ref``. float32
within rtol=atol=3e-4; bfloat16 within 3e-2 (the kernel rounds p to
bfloat16 before the PV product, kernels/swattn/kernel.py:65)."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.swattn import swattn_pallas
from repro.kernels.swattn import swattn_ref as jax_swattn_ref
from repro_torch.kernels.swattn import kernel as K
from repro_torch.kernels.swattn import swattn_cuda, swattn_ref

from _torch_parity import TOL, to_jax, to_torch

HEADS = [(4, 4), (4, 1), (8, 2)]


def _qkv(rng, B, S, H, KV, hd):
    return (rng.standard_normal((B, S, H, hd)).astype(np.float32),
            rng.standard_normal((B, S, KV, hd)).astype(np.float32),
            rng.standard_normal((B, S, KV, hd)).astype(np.float32))


def _close(got: torch.Tensor, ref, dtype: str, what: str):
    ref = np.asarray(jnp.asarray(ref).astype(jnp.float32))
    g = got.float().numpy()
    assert g.shape == ref.shape, (what, g.shape, ref.shape)
    np.testing.assert_allclose(g, ref, rtol=TOL[dtype], atol=TOL[dtype],
                               err_msg=what)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd", [16, 80])
@pytest.mark.parametrize("H,KV", HEADS)
@pytest.mark.parametrize("S", [16, 37, 64])
@pytest.mark.parametrize("window", [0, 8, 20])
def test_swattn_matches_pallas_and_oracle(window, S, H, KV, hd, dtype, rng):
    q, k, v = _qkv(rng, 2, S, H, KV, hd)
    got = swattn_cuda(to_torch(q, dtype), to_torch(k, dtype),
                      to_torch(v, dtype), window=window)
    assert got.dtype == getattr(torch, dtype)
    jq, jk, jv = (to_jax(a, dtype) for a in (q, k, v))
    pallas = swattn_pallas(jq, jk, jv, window=window, interpret=True)
    oracle = jax_swattn_ref(jq, jk, jv, window=window,
                            scale=1.0 / math.sqrt(hd))
    case = f"w{window} S{S} H{H}/{KV} hd{hd} {dtype}"
    _close(got, pallas, dtype, "pallas " + case)
    _close(got, oracle, dtype, "oracle " + case)


@pytest.mark.parametrize("window", [0, 5, 64])
def test_plain_version_matches_oracle_with_explicit_scale(window, rng):
    """The plain version's own arithmetic (row max, p rounded to v's
    dtype) against the oracle in float32, with an explicit scale, over a
    window as wide as the sequence."""
    q, k, v = _qkv(rng, 3, 50, 6, 3, 32)
    got = swattn_ref(*(torch.from_numpy(a) for a in (q, k, v)),
                     window=window, scale=0.3)
    ref = jax_swattn_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         window=window, scale=0.3)
    _close(got, ref, "float32", f"w{window}")


def test_window_at_least_s_is_full_causal(rng):
    q, k, v = (torch.from_numpy(a) for a in _qkv(rng, 2, 33, 4, 2, 16))
    full = swattn_cuda(q, k, v, window=0)
    torch.testing.assert_close(swattn_cuda(q, k, v, window=33), full)
    torch.testing.assert_close(swattn_cuda(q, k, v, window=500), full)


def test_cpu_wrapper_is_the_plain_version(rng):
    q, k, v = (torch.from_numpy(a) for a in _qkv(rng, 2, 20, 4, 1, 16))
    before = K.swattn.launches
    got = K.swattn(q, k, v, window=6, scale=0.25)
    assert K.swattn.launches == before
    assert torch.equal(got, swattn_ref(q, k, v, window=6, scale=0.25))
