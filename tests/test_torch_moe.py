"""The port's MoE block and M-RoPE held against the reference's on the same
numpy inputs: ``capacity``, ``route``, ``dispatch_indices`` and
``moe_block`` (``repro.models.moe``), ``mrope_cos_sin`` and
``text_mrope_positions`` (``repro.models.rope``).

Tolerances: routing indices, keep masks and capacities exactly; the
router's weights and aux loss within 1e-6 (both float32 softmaxes over the
same logits); ``moe_block`` within rtol=atol=1e-5 in float32 (the same
products summed in other orders); M-RoPE's cos/sin within 1e-6.

The cases that matter beyond random routing: assignments dropped at the
published capacity factor, the last expert overfilled (the sentinel write
at slot E·C − 1 erases its last kept token's output in the reference,
ROADMAP R3, and the port must give the same result), exact ties in the
router's scores (``jax.lax.top_k`` takes the lower index), and the decode
grouping (S = 1: the batch routed as one group).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as r_moe
from repro.models import rope as r_rope
from repro_torch.convert import params_from_reference
from repro_torch.models import moe, rope

from _torch_parity import reference_init_params

IDX_TOL = 1e-6
BLOCK_TOL = 1e-5
D, F = 16, 24


@pytest.mark.parametrize("T,E,k,cf", [(64, 8, 2, 1.25), (7, 4, 2, 1.0),
                                      (1, 128, 8, 1.25), (4096, 128, 8, 1.25),
                                      (6176, 8, 2, 4.0), (3, 8, 2, 0.5)])
def test_capacity_matches_reference(T, E, k, cf):
    assert moe.capacity(T, E, k, cf) == r_moe.capacity(T, E, k, cf)


def _router(rng, E, tied=False):
    w = rng.standard_normal((D, E)).astype(np.float32)
    if tied:                          # pairs of equal columns: exact ties
        w[:, 1::2] = w[:, 0::2]
    return w


@pytest.mark.parametrize("tied", [False, True])
@pytest.mark.parametrize("E,k", [(8, 2), (4, 1), (16, 8)])
def test_route_matches_reference(E, k, tied, rng):
    x = rng.standard_normal((40, D)).astype(np.float32)
    w = _router(rng, E, tied)
    rw, ri, raux = r_moe.route(jnp.asarray(x), jnp.asarray(w), k)
    gw, gi, gaux = moe.route(torch.from_numpy(x), torch.from_numpy(w), k)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(ri))
    np.testing.assert_allclose(gw.numpy(), np.asarray(rw), rtol=IDX_TOL,
                               atol=IDX_TOL)
    np.testing.assert_allclose(float(gaux), float(raux), rtol=IDX_TOL,
                               atol=IDX_TOL)
    if tied:                          # each tie broke to the lower index
        for row in np.asarray(ri):
            for j, e in enumerate(row):
                if e % 2 == 1 and e - 1 not in row[:j]:
                    raise AssertionError(f"odd expert {e} before its twin")


def test_route_batched_rows_equal_one_row_at_a_time(rng):
    x = rng.standard_normal((3, 20, D)).astype(np.float32)
    w = torch.from_numpy(_router(rng, 8))
    bw, bi, baux = moe.route(torch.from_numpy(x), w, 2)
    for r in range(3):
        gw, gi, gaux = moe.route(torch.from_numpy(x[r]), w, 2)
        assert torch.equal(bi[r], gi) and torch.equal(bw[r], gw)
        assert torch.equal(baux[r], gaux)


@pytest.mark.parametrize("case", ["random", "overfull", "all_last",
                                  "probe"])
def test_dispatch_indices_match_reference(case, rng):
    E, T, k = 4, 12, 2
    if case == "random":
        top_i = rng.integers(0, E, (T, k))
        cap = 8
    elif case == "overfull":          # expert 0 over capacity, drops
        top_i = rng.integers(0, E, (T, k))
        top_i[:, 0] = 0
        cap = 8
    elif case == "all_last":          # every assignment to expert E-1
        top_i = np.full((T, k), E - 1)
        cap = 8
    else:                             # the probe: E 4, C 2, k 1, all to 3
        top_i = np.full((T, 1), 3)
        cap = 2
    top_i = top_i.astype(np.int32)
    rslot, rkeep = r_moe.dispatch_indices(jnp.asarray(top_i), E, cap, T)
    slot, keep = moe.dispatch_indices(torch.from_numpy(top_i).long(), E, cap,
                                      T)
    np.testing.assert_array_equal(slot.numpy(), np.asarray(rslot))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(rkeep))
    if case == "probe":
        assert keep.numpy().astype(int).tolist() == [1, 1] + [0] * 10


def test_sentinel_slot_keeps_the_last_write_as_the_reference_does():
    """The reference's scatter (moe.py:87-89) at E 4, C 2, all 12 tokens
    to expert 3: the dropped assignments' sentinel 12 lands on slot 7
    after token 1's write, so sel is [12 12 12 12 12 12 0 12]; the port's
    dispatch gives the same rows."""
    E, cap, T, k = 4, 2, 12, 1
    top_i = np.full((T, k), 3, np.int32)
    rslot, rkeep = r_moe.dispatch_indices(jnp.asarray(top_i), E, cap, T)
    tok = jnp.repeat(jnp.arange(T, dtype=jnp.int32), k)
    rsel = jnp.full((E * cap,), T, jnp.int32).at[
        jnp.where(rkeep, rslot, E * cap - 1)].set(jnp.where(rkeep, tok, T))
    assert np.asarray(rsel).tolist() == [12] * 6 + [0, 12]
    slot, keep = moe.dispatch_indices(torch.from_numpy(top_i).long(), E, cap,
                                      T)
    sel = moe.dispatch_rows(slot[None], keep[None], E, cap, T, k)
    assert sel[0].tolist() == np.asarray(rsel).tolist()


def _block_params(rng, E, router):
    """The reference's moe params (its own init), the router replaced by
    unit-variance columns so routing is decisive ('random'), pairs of
    equal columns ('tied'), or one that sends every (non-negative) token
    first to expert E - 1 and second to expert 0 ('last')."""
    specs = r_moe.moe_specs(D, F, E, expert_tp=E < 16)
    rparams = dict(jax.tree.map(np.asarray, reference_init_params(
        specs, jax.random.key(int(rng.integers(1 << 30))))))
    if router == "last":
        w = np.zeros((D, E), np.float32)
        w[:, E - 1] = 4.0
        w[:, 0] = 1.0
    else:
        w = _router(rng, E, tied=router == "tied")
    rparams["router"] = w
    return rparams


CASES = {
    # name: (B, S, E, k, capacity factor, router, assignments dropped?)
    "published_drops": (2, 96, 8, 2, 1.25, "random", True),
    "no_drops": (2, 40, 8, 2, 4.0, "random", False),
    "top1_drops": (3, 33, 4, 1, 0.5, "random", True),
    "last_expert_overfull": (2, 24, 4, 2, 1.0, "last", True),
    "tied_scores": (2, 30, 8, 2, 1.25, "tied", None),
    "decode_group": (1, 5, 8, 2, 1.25, "random", False),
    "one_token": (4, 1, 16, 8, 1.25, "random", False),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_moe_block_matches_reference(case, rng):
    B, S, E, k, cf, router, drops = CASES[case]
    rparams = _block_params(rng, E, router)
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    if router == "last":
        x = np.abs(x)
    ry, raux = r_moe.moe_block(jnp.asarray(x), jax.tree.map(jnp.asarray,
                                                            rparams),
                               num_experts=E, k=k, capacity_factor=cf)
    params = params_from_reference(rparams, device="cpu")
    y, aux = moe.moe_block(torch.from_numpy(x), params, num_experts=E, k=k,
                           capacity_factor=cf)
    assert y.shape == (B, S, D) and y.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), np.asarray(ry), rtol=BLOCK_TOL,
                               atol=BLOCK_TOL)
    np.testing.assert_allclose(float(aux), float(raux), rtol=IDX_TOL,
                               atol=IDX_TOL)
    _, idx, _ = moe.route(torch.from_numpy(x), params["router"], k)
    _, keep = moe.dispatch_indices(idx, E, moe.capacity(S, E, k, cf), S)
    if drops is not None:
        assert bool((~keep).any()) == drops
    cap = moe.capacity(S, E, k, cf)
    if case == "last_expert_overfull":
        # expert E-1 is full: its last kept token (rank cap - 1 in
        # assignment order) lost that expert's output to the sentinel,
        # while the one before it kept it
        _, idx, _ = moe.route(torch.from_numpy(x), params["router"], k)
        assert bool((idx[..., 0] == E - 1).all())
        assert S > cap
        w = moe.route(torch.from_numpy(x), params["router"], k)[0]
        for b in range(B):
            t_lost, t_kept = cap - 1, cap - 2
            # without the expert-E-1 share only expert idx[.,1]'s remains
            solo = _expert_out(params, x[b, t_lost], int(idx[b, t_lost, 1]))
            np.testing.assert_allclose(
                y[b, t_lost].numpy(), (w[b, t_lost, 1] * solo).numpy(),
                rtol=BLOCK_TOL, atol=BLOCK_TOL)
            both = (w[b, t_kept, 0] * _expert_out(params, x[b, t_kept], E - 1)
                    + w[b, t_kept, 1] * _expert_out(
                        params, x[b, t_kept], int(idx[b, t_kept, 1])))
            np.testing.assert_allclose(y[b, t_kept].numpy(), both.numpy(),
                                       rtol=BLOCK_TOL, atol=BLOCK_TOL)


def _expert_out(params, x, e):
    xt = torch.from_numpy(np.ascontiguousarray(x))
    h = xt @ params["wi"][e]
    g = xt @ params["wg"][e]
    return (torch.nn.functional.silu(g) * h) @ params["wo"][e]


def test_moe_block_gradients_match_reference(rng):
    """d(sum(y * c) + aux) / d(x, params) at the published capacity, with
    drops: the weights' gradient through the renormalised top k, the aux
    loss's through the mean probabilities."""
    B, S, E, k = 2, 96, 8, 2
    rparams = _block_params(rng, E, "random")
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    c = rng.standard_normal((B, S, D)).astype(np.float32)

    def r_f(x_, p_):
        y, aux = r_moe.moe_block(x_, p_, num_experts=E, k=k)
        return jnp.sum(y * c) + aux
    rg = jax.grad(r_f, argnums=(0, 1))(jnp.asarray(x),
                                       jax.tree.map(jnp.asarray, rparams))
    params = params_from_reference(rparams, device="cpu")
    xt = torch.from_numpy(x).requires_grad_(True)
    for t in params.values():
        t.requires_grad_(True)
    _, idx, _ = moe.route(xt, params["router"], k)
    assert bool((~moe.dispatch_indices(idx, E, moe.capacity(S, E, k, 1.25),
                                       S)[1]).any())
    y, aux = moe.moe_block(xt, params, num_experts=E, k=k)
    ((y * torch.from_numpy(c)).sum() + aux).backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(rg[0]),
                               rtol=BLOCK_TOL, atol=BLOCK_TOL)
    for name, t in params.items():
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(rg[1][name]),
                                   rtol=1e-4, atol=BLOCK_TOL, err_msg=name)


# -- M-RoPE -------------------------------------------------------------------

@pytest.mark.parametrize("hd,sections", [(16, (2, 3, 3)), (128, (16, 24, 24))])
@pytest.mark.parametrize("lead", [(), (2,)])
def test_mrope_cos_sin_matches_reference(hd, sections, lead, rng):
    """Three distinct position streams (t, h, w), as vision tokens have."""
    pos = rng.integers(0, 5000, (3,) + lead + (19,)).astype(np.int32)
    rc, rs = r_rope.mrope_cos_sin(jnp.asarray(pos), hd, 1e6, sections)
    c, s = rope.mrope_cos_sin(torch.from_numpy(pos), hd, 1e6, sections)
    assert c.shape == lead + (19, hd // 2) and c.dtype == torch.float32
    np.testing.assert_allclose(c.numpy(), np.asarray(rc), rtol=IDX_TOL,
                               atol=IDX_TOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(rs), rtol=IDX_TOL,
                               atol=IDX_TOL)


def test_text_mrope_reduces_to_rope(rng):
    pos = torch.from_numpy(rng.integers(0, 300, (2, 11)).astype(np.int32))
    p3 = rope.text_mrope_positions(pos)
    np.testing.assert_array_equal(
        p3.numpy(), np.asarray(r_rope.text_mrope_positions(
            jnp.asarray(pos.numpy()))))
    c, s = rope.mrope_cos_sin(p3, 16, 1e4, (2, 3, 3))
    rc, rs = rope.rope_cos_sin(pos, 16, 1e4)
    assert torch.equal(c, rc) and torch.equal(s, rs)
    with pytest.raises(ValueError, match="sum"):
        rope.mrope_cos_sin(p3, 16, 1e4, (2, 3, 4))
