"""The port's causal depthwise conv held against the reference's on the
same numpy inputs: ``dwconv1d_cuda`` (models' [C,k] weights; on CPU
tensors, the kernel's plain version) against ``dwconv1d_pallas`` in
interpret mode, and the kernel-level [k,C] API against the reference's
oracle ``dwconv1d_ref``. float32 within rtol=atol=3e-4; bfloat16 within
3e-2 (the reference accumulates at bfloat16 and may keep float32
intermediates inside its fused loop)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.dwconv1d import dwconv1d_pallas
from repro.kernels.dwconv1d import dwconv1d_ref as jax_dwconv1d_ref
from repro.models.layers import dwconv1d as jax_layer_dwconv1d
from repro_torch.kernels.dwconv1d import kernel as K
from repro_torch.kernels.dwconv1d import dwconv1d_cuda, dwconv1d_ref
from repro_torch.models.layers import dwconv1d as layer_dwconv1d

from _torch_parity import TOL, to_jax, to_torch


def _close(got: torch.Tensor, ref, dtype: str, what: str = ""):
    ref = np.asarray(jnp.asarray(ref).astype(jnp.float32))
    g = got.float().numpy()
    assert g.shape == ref.shape, (what, g.shape, ref.shape)
    np.testing.assert_allclose(g, ref, rtol=TOL[dtype], atol=TOL[dtype],
                               err_msg=what)


def _inputs(rng, B, S, C, k):
    x = rng.standard_normal((B, S, C)).astype(np.float32)
    w_ck = (rng.standard_normal((C, k)) / k).astype(np.float32)
    b = rng.standard_normal(C).astype(np.float32)
    return x, w_ck, b


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("B,S,C", [(2, 37, 130), (1, 16, 64), (3, 5, 8)])
def test_dwconv1d_matches_pallas(B, S, C, k, dtype, rng):
    x, w_ck, b = _inputs(rng, B, S, C, k)
    got = dwconv1d_cuda(to_torch(x, dtype), torch.from_numpy(w_ck),
                        torch.from_numpy(b))
    assert got.dtype == getattr(torch, dtype) and got.shape == (B, S, C)
    ref = dwconv1d_pallas(to_jax(x, dtype), jnp.asarray(w_ck),
                          jnp.asarray(b), interpret=True)
    _close(got, ref, dtype, f"[{B},{S},{C}] k{k} {dtype}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k", [1, 3, 4])
def test_kernel_api_matches_oracle(k, dtype, rng):
    """[k,C] weights in x's dtype, as the kernel takes them."""
    x, w_ck, b = _inputs(rng, 2, 29, 48, k)
    w_kc = np.ascontiguousarray(w_ck.T)
    got = K.dwconv1d(to_torch(x, dtype), to_torch(w_kc, dtype),
                     to_torch(b, dtype))
    ref = jax_dwconv1d_ref(to_jax(x, dtype), to_jax(w_kc, dtype),
                           to_jax(b, dtype))
    _close(got, ref, dtype, f"k{k} {dtype}")


def test_weight_layout_is_transposed_at_the_boundary(rng):
    """[C,k] model weights: the API and the plain layer agree exactly in
    float32 with the kernel-level [k,C] call."""
    x, w_ck, b = _inputs(rng, 2, 21, 12, 4)
    xt, wt, bt = (torch.from_numpy(a) for a in (x, w_ck, b))
    api = dwconv1d_cuda(xt, wt, bt)
    assert torch.equal(api, dwconv1d_ref(xt, wt.t().contiguous(), bt))
    layer, state = layer_dwconv1d(xt, {"w": wt, "b": bt})
    torch.testing.assert_close(api, layer, rtol=1e-6, atol=1e-6)
    ref_y, ref_state = jax_layer_dwconv1d(jnp.asarray(x),
                                          {"w": jnp.asarray(w_ck),
                                           "b": jnp.asarray(b)})
    _close(layer, ref_y, "float32")
    _close(state, ref_state, "float32")


def test_cpu_wrapper_is_the_plain_version(rng):
    x, w_ck, b = (torch.from_numpy(a) for a in _inputs(rng, 2, 9, 5, 3))
    w = w_ck.t().contiguous()
    before = K.dwconv1d.launches
    got = K.dwconv1d(x, w, b)
    assert K.dwconv1d.launches == before
    assert torch.equal(got, dwconv1d_ref(x, w, b))
