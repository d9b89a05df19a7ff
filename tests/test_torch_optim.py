"""The port's optimiser pieces held against the reference's on the same
numpy inputs: the learning-rate schedule, the global norm and its clip,
AdamW over several steps, and the int8 error-feedback compression.

Tolerances: the schedule within relative 1e-6 (both in float32; the
cosine of two libraries may differ in the last bit); the global norm and
the clipped leaves within rtol=1e-6 (float32 sums in another order);
AdamW parameters and moments within rtol=atol=1e-6 over five steps (the
same operations in float32, each rounding in the reference's order);
the int8 ``q`` bit-equal, its scale and residual within rtol=1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw_init as r_adamw_init
from repro.optim import adamw_update as r_adamw_update
from repro.optim import clip_by_global_norm as r_clip
from repro.optim import cosine_warmup as r_cosine_warmup
from repro.optim import global_norm as r_global_norm
from repro.optim import int8_ef_compress as r_compress
from repro.optim import int8_ef_decompress as r_decompress
from repro.optim.compression import compress_tree as r_compress_tree
from repro_torch.convert import opt_state_from_reference, opt_state_to_numpy
from repro_torch.optim import (AdamWState, adamw_init, adamw_update,
                               clip_by_global_norm, compress_tree,
                               cosine_warmup, global_norm, int8_ef_compress,
                               int8_ef_decompress)


def _tree(rng, scale=1.0):
    return {"a": (rng.standard_normal((4, 3)) * scale).astype(np.float32),
            "b": {"c": (rng.standard_normal(5) * scale).astype(np.float32),
                  "d": (rng.standard_normal((2, 2, 3)) * scale)
                  .astype(np.float32)}}


def _torch(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def _np(tree):
    return jax.tree.map(lambda t: t.numpy() if torch.is_tensor(t)
                        else np.asarray(t), tree)


@pytest.mark.parametrize("warmup,total,min_ratio", [
    (10, 100, 0.1), (1, 50, 0.0), (0, 20, 0.3), (100, 10_000, 0.1)])
def test_cosine_warmup_matches_reference(warmup, total, min_ratio):
    for step in [0, 1, 2, warmup - 1, warmup, warmup + 1, total // 2,
                 total - 1, total, total + 7]:
        if step < 0:
            continue
        got = cosine_warmup(step, peak_lr=3e-4, warmup_steps=warmup,
                            total_steps=total, min_ratio=min_ratio)
        want = float(r_cosine_warmup(step, peak_lr=3e-4,
                                     warmup_steps=warmup, total_steps=total,
                                     min_ratio=min_ratio))
        assert isinstance(got, float)
        assert got == pytest.approx(want, rel=1e-6, abs=0.0), step


@pytest.mark.parametrize("scale", [1e-3, 1.0, 10.0])
def test_global_norm_and_clip_match_reference(scale, rng):
    tree = _tree(rng, scale)
    want_n = float(r_global_norm(jax.tree.map(jnp.asarray, tree)))
    got_n = global_norm(_torch(tree))
    assert got_n.dtype == torch.float32 and got_n.ndim == 0
    np.testing.assert_allclose(float(got_n), want_n, rtol=1e-6)
    r_tree, r_n = r_clip(jax.tree.map(jnp.asarray, tree), 1.0)
    t = _torch(tree)
    got, n = clip_by_global_norm(t, 1.0)
    assert got is t                                # in place
    np.testing.assert_allclose(float(n), float(r_n), rtol=1e-6)
    for a, b in zip(jax.tree.leaves(_np(got)), jax.tree.leaves(r_tree)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-6, atol=0)
    if scale < 1:                                  # under the limit: as is
        for a, b in zip(jax.tree.leaves(_np(got)), jax.tree.leaves(tree)):
            np.testing.assert_array_equal(a, b)


def test_global_norm_of_a_large_leaf_is_accurate():
    """2^24 float32 values (an LM's embedding gradient has 82M): the sum
    of squares stays within 1e-6 of float64, where torch's CPU
    ``vector_norm`` reads 6.5e-4 low at this size."""
    x = torch.randn(1 << 24, generator=torch.Generator().manual_seed(0))
    want = float(x.double().square().sum().sqrt())
    assert float(global_norm({"x": x})) == pytest.approx(want, rel=1e-6)


def test_clip_keeps_a_bfloat16_leaf_bfloat16(rng):
    x = rng.standard_normal(64).astype(np.float32) * 3
    want, _ = r_clip({"x": jnp.asarray(x, jnp.bfloat16)}, 1.0)
    got, _ = clip_by_global_norm(
        {"x": torch.from_numpy(x).to(torch.bfloat16)}, 1.0)
    assert got["x"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["x"].float().numpy(),
                                  np.asarray(want["x"], np.float32))


@pytest.mark.parametrize("wd", [0.0, 0.1])
def test_adamw_matches_reference_over_steps(wd, rng):
    params = _tree(rng)
    r_p = jax.tree.map(jnp.asarray, params)
    r_st = r_adamw_init(r_p)
    p = _torch(params)
    st = adamw_init(p)
    assert int(st.step) == 0 and st.step.dtype == torch.int32
    assert st.step.device.type == "cpu"
    for i in range(5):
        g = _tree(rng, 0.1)
        lr = cosine_warmup(i + 1, peak_lr=1e-2, warmup_steps=2,
                           total_steps=10)
        r_p, r_st = r_adamw_update(r_p, jax.tree.map(jnp.asarray, g), r_st,
                                   lr=jnp.float32(lr), weight_decay=wd)
        got_p, st = adamw_update(p, _torch(g), st, lr=lr, weight_decay=wd)
        assert got_p is p                          # in place
        assert int(st.step) == int(r_st.step) == i + 1
        for mine, theirs in [(p, r_p), (st.m, r_st.m), (st.v, r_st.v)]:
            for a, b in zip(jax.tree.leaves(_np(mine)),
                            jax.tree.leaves(theirs)):
                np.testing.assert_allclose(a, np.asarray(b), rtol=1e-6,
                                           atol=1e-6)


def test_adamw_state_round_trips_with_the_reference(rng):
    params = _tree(rng)
    r_st = r_adamw_update(jax.tree.map(jnp.asarray, params),
                          jax.tree.map(jnp.asarray, _tree(rng)),
                          r_adamw_init(jax.tree.map(jnp.asarray, params)),
                          lr=1e-2)[1]
    st = opt_state_from_reference(jax.tree.map(np.asarray, r_st),
                                  device="cpu")
    assert isinstance(st, AdamWState) and int(st.step) == 1
    assert st.step.dtype == torch.int32
    back = opt_state_to_numpy(st)
    assert back.step.dtype == np.int32 and back.step.shape == ()
    rebuilt = type(r_st)(*back)
    for a, b in zip(jax.tree.leaves(rebuilt), jax.tree.leaves(r_st)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_int8_ef_q_is_bit_equal(rng):
    g = (rng.standard_normal((33, 17)) * 0.05).astype(np.float32)
    err = np.zeros_like(g)
    t_err = torch.from_numpy(err.copy())
    for _ in range(4):                             # error feedback carried
        rq, rs, err = r_compress(jnp.asarray(g), jnp.asarray(err))
        q, s, t_err = int8_ef_compress(torch.from_numpy(g), t_err)
        assert q.dtype == torch.int8
        np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
        np.testing.assert_allclose(float(s), float(rs), rtol=1e-6)
        np.testing.assert_allclose(t_err.numpy(), np.asarray(err),
                                   rtol=1e-6, atol=1e-9)
        np.testing.assert_allclose(int8_ef_decompress(q, s).numpy(),
                                   np.asarray(r_decompress(rq, rs)),
                                   rtol=1e-6)
        g = (rng.standard_normal((33, 17)) * 0.05).astype(np.float32)


def test_int8_ef_ties_round_half_to_even():
    """Values on the half steps round to even in both packages."""
    g = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 126.5], np.float32)
    rq, _, _ = r_compress(jnp.asarray(g), jnp.zeros_like(jnp.asarray(g)))
    q, _, _ = int8_ef_compress(torch.from_numpy(g), torch.zeros(7))
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))


def test_compress_tree_matches_reference(rng):
    grads = _tree(rng, 0.1)
    errs = jax.tree.map(np.zeros_like, grads)
    rq, rs, re = r_compress_tree(jax.tree.map(jnp.asarray, grads),
                                 jax.tree.map(jnp.asarray, errs))
    q, s, e = compress_tree(_torch(grads), _torch(errs))
    assert jax.tree.structure(_np(q)) == jax.tree.structure(rq)
    for a, b in zip(jax.tree.leaves(_np(q)), jax.tree.leaves(rq)):
        np.testing.assert_array_equal(a, np.asarray(b))
    for mine, theirs in [(s, rs), (e, re)]:
        for a, b in zip(jax.tree.leaves(_np(mine)), jax.tree.leaves(theirs)):
            np.testing.assert_allclose(a, np.asarray(b), rtol=1e-6,
                                       atol=1e-9)
