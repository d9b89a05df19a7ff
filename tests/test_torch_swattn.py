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


@pytest.mark.parametrize("scale", [-0.3, 0.0])
def test_plain_version_matches_oracle_at_negative_and_zero_scale(scale, rng):
    """The scales the card's float32 kernel takes another route for (a
    negative one negates its Q tile): the plain version it is held to on
    the card agrees with the oracle there."""
    q, k, v = _qkv(rng, 2, 40, 4, 2, 16)
    for window in (0, 7):
        got = swattn_ref(*(torch.from_numpy(a) for a in (q, k, v)),
                         window=window, scale=scale)
        ref = jax_swattn_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             window=window, scale=scale)
        _close(got, ref, "float32", f"scale {scale} w{window}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cpu_wrapper_counts_no_launch_of_either_dtype(dtype, rng):
    dt = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(a).to(dt)
               for a in _qkv(rng, 1, 12, 2, 1, 16))
    before = K.swattn.launches, dict(K.swattn.dtype_launches)
    K.swattn(q, k, v, window=0, scale=0.25)
    assert sorted(before[1]) == ["bfloat16", "float32"]
    assert (K.swattn.launches, K.swattn.dtype_launches) == before


def test_wrapper_checks_the_launch_grid():
    """The grid is (H, B, q tiles of at least 64 rows): B and ceil(S / 64)
    are at most 65535, H is not bounded by it."""
    def check(B, S, H, KV=1, hd=16):
        q = torch.empty((B, S, H, hd), device="meta")
        kv = torch.empty((B, S, KV, hd), device="meta")
        K._check(q, kv, kv, 0)
    check(1, 64 * 65535, 1)
    check(65535, 1, 1)
    check(1, 1, 70000)
    for B, S in ((1, 64 * 65535 + 1), (65536, 1)):
        with pytest.raises(ValueError, match="launch grid"):
            check(B, S, 1)
