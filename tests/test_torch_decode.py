"""The port's LM serving path held against the reference's on the same
state: the KV cache writes (contiguous, ring, sink slots, int8 values),
decode attention, the mamba streaming state, the cache trees, and
``prefill`` / ``decode_step`` of tiny h2o-danube (window 8: the prompt of
24 takes the ring's eviction write), yi-6b (full attention), hymba
(meta-token sinks, mamba state), mixtral and qwen3-moe (the moe kind; a
decode step routes the batch as one group), gemma3 (local and global
stages, embedding scale, tied head), qwen2-vl (embeddings in, M-RoPE)
and codeqwen (MHA). Parameters and caches are carried across
with ``repro_torch.convert``; inputs are drawn with numpy.

Tolerances: cache writes are copies and int8 quantisation divides in
float32 on both sides, so every cache leaf is compared bit for bit. One
attention or mamba layer in float32 within rtol=atol=1e-5 (the same
operations, summed in another order). Model logits within rtol=atol=3e-4
after prefill and 5e-4 after decode steps, the reference's own
prefill→decode tolerances (tests/test_consistency.py); the float cache
leaves a model writes within 3e-4, their positions exactly.
"""
import dataclasses
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import SHAPES as R_SHAPES
from repro.configs.base import RunConfig as RRunConfig
from repro.configs.base import SINGLE_POD
from repro.configs.tiny import tiny_of as r_tiny_of
from repro.models import attention as r_attn
from repro.models import layers as r_layers
from repro.models import registry as r_registry
from repro.models import ssm as r_ssm
from repro.models import transformer as r_tfm
from repro_torch.configs.base import SHAPES, RunConfig
from repro_torch.configs.tiny import tiny_of
from repro_torch.convert import (caches_from_reference, caches_to_numpy,
                                 params_from_reference)
from repro_torch.models import attention as attn
from repro_torch.models import layers, registry, ssm, transformer

from _torch_parity import reference_bundle_params, reference_init_params

ARCHS = ["h2o_danube_1_8b", "yi_6b", "hymba_1_5b", "mixtral_8x7b",
         "qwen3_moe_30b_a3b", "gemma3_4b", "qwen2_vl_7b", "codeqwen15_7b"]
S = 24                                    # the prompt (tests/test_consistency)
LAYER_TOL = 1e-5
PREFILL_TOL, DECODE_TOL = 3e-4, 5e-4


def _np(tree):
    """A reference tree (or the port's, via caches_to_numpy) as float32 /
    int numpy."""
    def f(x):
        a = np.asarray(x)
        return a.astype(np.float32) if a.dtype.name == "bfloat16" else a
    return jax.tree.map(f, tree)


def _assert_tree(got, want, tol=0.0, what=""):
    """Same structure; integer leaves exactly, float leaves within tol
    (0: bit for bit)."""
    got, want = _np(got), _np(want)
    gl, gs = jax.tree.flatten(got)
    wl, ws = jax.tree.flatten(want)
    assert gs == ws, (what, gs, ws)
    for i, (g, w) in enumerate(zip(gl, wl)):
        assert g.shape == w.shape and g.dtype == w.dtype, (what, i, g.shape,
                                                           w.shape, g.dtype,
                                                           w.dtype)
        if tol and np.issubdtype(w.dtype, np.floating):
            np.testing.assert_allclose(g, w, rtol=tol, atol=tol,
                                       err_msg=f"{what} leaf {i}")
        else:
            np.testing.assert_array_equal(g, w, err_msg=f"{what} leaf {i}")


# -- write_cache ---------------------------------------------------------------

B, KV, HD, WIN = 2, 2, 4, 6


def _kv(rng, n):
    return [rng.standard_normal((B, n, KV, HD)).astype(np.float32)
            for _ in range(2)]


def _writes(case, sinks):
    """(cur, chunk length) of each write: the history, then the write under
    test. Cache length WIN + sinks."""
    L = WIN + sinks
    return {"decode": [(0, L + 5), (L + 5, 1), (L + 6, 1)],
            "short_prefill": [(0, 3), (3, 2)],
            "eviction": [(0, L + 7)]}[case]


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("sinks", [0, 2])
@pytest.mark.parametrize("case", ["decode", "short_prefill", "eviction"])
def test_write_cache_matches_reference(case, sinks, int8, rng):
    dt = "int8" if int8 else "float32"
    L = WIN + sinks
    ref = r_attn.init_cache(B, L, KV, HD, jnp.dtype(dt))
    got = attn.init_cache(B, L, KV, HD, getattr(torch, dt), device="cpu")
    _assert_tree(caches_to_numpy(got), ref, what="init")
    for cur, n in _writes(case, sinks):
        k, v = _kv(rng, n)
        pos = np.arange(cur, cur + n, dtype=np.int32)
        ref = r_attn.write_cache(ref, jnp.asarray(k), jnp.asarray(v),
                                 jnp.asarray(cur, jnp.int32),
                                 pos_new=jnp.asarray(pos), sinks=sinks)
        out = attn.write_cache(got, torch.from_numpy(k), torch.from_numpy(v),
                               cur, pos_new=torch.from_numpy(pos),
                               sinks=sinks)
        assert out is got                         # written in place
        _assert_tree(caches_to_numpy(got), ref, what=f"{case} cur {cur}")
    live = caches_to_numpy(got)["pos"]
    for slot, p in enumerate(live):               # the slot invariant
        if p >= 0:
            assert attn.ring_slot(int(p), L, sinks) == slot


@pytest.mark.parametrize("sinks", [0, 2])
def test_wrapping_chunk_refused_where_the_reference_clamps(sinks, rng):
    """A short chunk that would run past the last slot: the reference's
    dynamic_update_slice moves its start back (the chunk lands on slots
    its positions do not own); the port refuses it."""
    L = WIN + sinks
    cur, n = L - 2, 4                          # slots L-2, L-1, then wrap
    k, v = _kv(rng, n)
    pos = np.arange(cur, cur + n, dtype=np.int32)
    ref = r_attn.write_cache(r_attn.init_cache(B, L, KV, HD, jnp.float32),
                             jnp.asarray(k), jnp.asarray(v),
                             jnp.asarray(cur, jnp.int32),
                             pos_new=jnp.asarray(pos), sinks=sinks)
    np.testing.assert_array_equal(np.asarray(ref["pos"])[L - n:], pos)
    assert attn.ring_slot(cur, L, sinks) != L - n     # the clamp moved it
    cache = attn.init_cache(B, L, KV, HD, torch.float32, device="cpu")
    with pytest.raises(ValueError, match="wrap"):
        attn.write_cache(cache, torch.from_numpy(k), torch.from_numpy(v),
                         cur, pos_new=torch.from_numpy(pos), sinks=sinks)
    assert bool((cache["pos"] == attn.PAD_POS).all())   # nothing written


def test_quantize_kv_rounds_half_to_even():
    """Values that land exactly on .5 steps after the division."""
    x = np.array([[[[127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 63.5, -127.0]]]],
                 np.float32)
    rq, rs = r_attn.quantize_kv(jnp.asarray(x))
    q, s = attn.quantize_kv(torch.from_numpy(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(rs))
    assert q.numpy().ravel().tolist() == [127, 0, 2, 2, 0, -2, 64, -127]


# -- decode_attend --------------------------------------------------------------

@pytest.mark.parametrize("window,sinks", [(0, 0), (WIN, 0), (WIN, 2)])
@pytest.mark.parametrize("dt", ["float32", "int8"])
def test_decode_attend_matches_reference(dt, window, sinks, rng):
    H = 4
    L = WIN + sinks if window else 20
    total = L + 5 if window else 13              # ring stages have evicted
    k, v = _kv(rng, total)
    pos = np.arange(total, dtype=np.int32)
    ref = r_attn.write_cache(r_attn.init_cache(B, L, KV, HD, jnp.dtype(dt)),
                             jnp.asarray(k), jnp.asarray(v),
                             jnp.asarray(0, jnp.int32),
                             pos_new=jnp.asarray(pos), sinks=sinks)
    cache = caches_from_reference(jax.tree.map(np.asarray, ref),
                                  device="cpu")
    q = rng.standard_normal((B, 1, H, HD)).astype(np.float32)
    q_pos = np.full((B, 1), total - 1, np.int32)
    want = r_attn.decode_attend(jnp.asarray(q), ref, H, window=window,
                                q_pos=jnp.asarray(q_pos), sinks=sinks)
    got = attn.decode_attend(torch.from_numpy(q), cache, H, window=window,
                             q_pos=torch.from_numpy(q_pos), sinks=sinks)
    assert got.shape == (B, 1, H, HD)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=LAYER_TOL, atol=LAYER_TOL)
    # q_pos defaults to the newest cached position in both
    want = r_attn.decode_attend(jnp.asarray(q), ref, H, window=window,
                                sinks=sinks)
    got = attn.decode_attend(torch.from_numpy(q), cache, H, window=window,
                             sinks=sinks)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=LAYER_TOL, atol=LAYER_TOL)


# -- the mamba streaming state ---------------------------------------------------

def _mamba(seed=3):
    rmc = dataclasses.replace(r_tiny_of("hymba_1_5b"), num_meta_tokens=0,
                              ssd_chunk=8)
    mc = dataclasses.replace(tiny_of("hymba_1_5b"), num_meta_tokens=0,
                             ssd_chunk=8)
    rspecs = r_ssm.mamba_specs(rmc.d_model, expand=rmc.ssm_expand,
                               heads=rmc.mamba_heads, state=rmc.ssm_state,
                               conv_width=rmc.ssm_conv_width)
    rparams = reference_init_params(rspecs, jax.random.key(seed))
    return rmc, mc, rparams, params_from_reference(
        jax.tree.map(np.asarray, rparams), device="cpu")


def test_dwconv1d_with_state_matches_reference(rng):
    _, _, rparams, params = _mamba()
    conv, rconv = params["conv"], rparams["conv"]
    C = conv["w"].shape[0]
    state = rng.standard_normal((2, 3, C)).astype(np.float32)
    for n in (5, 1, 2):                        # longer than k-1, then shorter
        x = rng.standard_normal((2, n, C)).astype(np.float32)
        ry, rstate = r_layers.dwconv1d(jnp.asarray(x), rconv,
                                       jnp.asarray(state))
        y, new = layers.dwconv1d(torch.from_numpy(x), conv,
                                 torch.from_numpy(state))
        np.testing.assert_allclose(y.numpy(), np.asarray(ry), rtol=LAYER_TOL,
                                   atol=LAYER_TOL)
        np.testing.assert_array_equal(new.numpy(), np.asarray(rstate))
        state = new.numpy()


def test_ssd_step_matches_reference(rng):
    Bb, H, dh, N = 2, 4, 8, 4
    x = rng.standard_normal((Bb, H, dh)).astype(np.float32)
    dt = np.abs(rng.standard_normal((Bb, H))).astype(np.float32)
    A = -np.abs(rng.standard_normal(H)).astype(np.float32)
    Bm, Cm = (rng.standard_normal((Bb, N)).astype(np.float32)
              for _ in range(2))
    h = rng.standard_normal((Bb, H, dh, N)).astype(np.float32)
    ry, rh = r_ssm.ssd_step(*(jnp.asarray(a) for a in (x, dt, A, Bm, Cm, h)))
    y, h2 = ssm.ssd_step(*(torch.from_numpy(a) for a in (x, dt, A, Bm, Cm, h)))
    np.testing.assert_allclose(y.numpy(), np.asarray(ry), rtol=LAYER_TOL,
                               atol=LAYER_TOL)
    np.testing.assert_allclose(h2.numpy(), np.asarray(rh), rtol=LAYER_TOL,
                               atol=LAYER_TOL)


def test_mamba_block_streams_like_the_reference(rng):
    """A chunked prefill of 16 (two SSD chunks) from the zero state, then
    single steps through ssd_step, the state carried by both."""
    rmc, mc, rparams, params = _mamba()
    rstate = jax.tree.map(np.asarray, r_ssm.mamba_state_init(rmc, 2))
    state = ssm.mamba_state_init(mc, 2, device="cpu")
    _assert_tree(caches_to_numpy(state), rstate, what="init")
    for n in (16, 1, 1, 1):
        x = rng.standard_normal((2, n, mc.d_model)).astype(np.float32)
        ry, rstate = r_ssm.mamba_block(jnp.asarray(x), rparams, rmc,
                                       state_in=rstate)
        y, state = ssm.mamba_block(torch.from_numpy(x), params, mc,
                                   state_in=state)
        np.testing.assert_allclose(y.numpy(), np.asarray(ry), rtol=LAYER_TOL,
                                   atol=LAYER_TOL)
        _assert_tree(caches_to_numpy(state), rstate, tol=LAYER_TOL,
                     what=f"state after {n}")
    with pytest.raises(ValueError, match="stateless"):
        ssm.mamba_block(torch.from_numpy(x), params, mc, state_in=state,
                        use_pallas_conv=True)


# -- cache trees -----------------------------------------------------------------

@pytest.mark.parametrize("kv", ["", "int8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_init_trees_equal_reference(arch, dtype, kv):
    rmc = dataclasses.replace(r_tiny_of(arch), dtype=dtype, kv_cache_dtype=kv)
    mc = dataclasses.replace(tiny_of(arch), dtype=dtype, kv_cache_dtype=kv)
    seq = 40                       # past hymba's ring of 8 + 4 sinks
    ref = jax.tree.map(np.asarray, r_tfm.cache_init(rmc, 2, seq))
    got = transformer.cache_init(mc, 2, seq, device="cpu")
    assert len(got) == len(ref) == len(transformer.make_stages(mc))
    _assert_tree(caches_to_numpy(got), ref, what=arch)
    want_dt = {"int8": torch.int8, "": getattr(torch, dtype)}[kv]
    for c in got:
        c = c["attn"] if "attn" in c else c
        assert c["k"].dtype == want_dt and c["pos"].dtype == torch.int32


# -- prefill / decode_step -----------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _ref_params(arch):
    """The reference's parameters for tiny ``arch`` (the same for every
    field the tests replace), made once: eager init compiles per leaf."""
    rb = r_registry.build(RRunConfig(model=r_tiny_of(arch),
                                     shape=R_SHAPES["prefill_32k"],
                                     mesh=SINGLE_POD))
    return reference_bundle_params(rb, jax.random.key(1), jit=True)


@functools.lru_cache(maxsize=None)
def _bundles(arch, **fields):
    """(reference bundle, its params, port bundle, the same params) for
    tiny ``arch`` with ``fields`` replaced, serving prompts up to S + 8;
    made once per worker, so the tests share the reference's compiles."""
    rmc = dataclasses.replace(r_tiny_of(arch), **fields)
    sh = dataclasses.replace(R_SHAPES["prefill_32k"], seq_len=S + 8,
                             global_batch=2)
    rb = r_registry.build(RRunConfig(model=rmc, shape=sh, mesh=SINGLE_POD))
    rparams = _ref_params(arch)
    # jit: one compile per call's shapes, where eager JAX compiles each
    # layer scan on every call
    rb = types.SimpleNamespace(prefill=jax.jit(rb.prefill),
                               decode_step=jax.jit(rb.decode_step),
                               train_forward=jax.jit(rb.train_forward))
    mc = dataclasses.replace(tiny_of(arch), **fields)
    b = registry.build(RunConfig(model=mc, shape=dataclasses.replace(
        SHAPES["prefill_32k"], seq_len=S + 8, global_batch=2)), device="cpu")
    params = params_from_reference(jax.tree.map(np.asarray, rparams),
                                   device="cpu")
    return rb, rparams, b, params


def _inputs(rng, mc, n: int) -> np.ndarray:
    """Two streams of ``n`` inputs: tokens, or float32 embeddings [2, n,
    D] for the stub-frontend configs (``embeddings_in``)."""
    if mc.embeddings_in:
        return rng.standard_normal((2, n, mc.d_model)).astype(np.float32)
    return rng.integers(0, 255, (2, n)).astype(np.int32)


def _no_drops(arch) -> dict:
    """For the moe configs, the capacity factor E / k, at which no
    assignment drops: a decode step routes the batch as one group and the
    teacher-forced forward each row as one, and the reference's drops
    depend on the group's size."""
    mc = tiny_of(arch)
    if mc.family != "moe":
        return {}
    return {"capacity_factor": mc.num_experts / mc.num_experts_per_tok}


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch, rng):
    """Prefill, then three decode steps, each against the reference's on
    the same parameters, logits and caches after every call."""
    rb, rparams, b, params = _bundles(arch)
    M = b.cfg.model.num_meta_tokens
    toks = _inputs(rng, b.cfg.model, S + 3)
    rlast, rcaches = rb.prefill(rparams, {"inputs": jnp.asarray(toks[:, :S])})
    last, caches = b.prefill(params, {"inputs": torch.from_numpy(toks[:, :S])})
    np.testing.assert_allclose(last.numpy(), np.asarray(rlast),
                               rtol=PREFILL_TOL, atol=PREFILL_TOL)
    _assert_tree(caches_to_numpy(caches), rcaches, tol=PREFILL_TOL,
                 what="prefill")
    for i in range(3):
        cur = S + M + i
        inp = toks[:, S + i:S + i + 1]
        rstep, rcaches = rb.decode_step(rparams, jnp.asarray(inp), rcaches,
                                        jnp.asarray(cur, jnp.int32))
        step, out = b.decode_step(params, torch.from_numpy(inp), caches, cur)
        assert out is caches                       # written in place
        np.testing.assert_allclose(step.numpy(), np.asarray(rstep),
                                   rtol=DECODE_TOL, atol=DECODE_TOL)
        _assert_tree(caches_to_numpy(caches), rcaches, tol=DECODE_TOL,
                     what=f"decode {i}")


@pytest.mark.parametrize("arch", ARCHS)
def test_caches_carried_from_the_reference(arch, rng):
    """decode_step on the reference's own prefill caches, carried across
    by convert.caches_from_reference."""
    rb, rparams, b, params = _bundles(arch)
    M = b.cfg.model.num_meta_tokens
    toks = _inputs(rng, b.cfg.model, S + 1)
    _, rcaches = rb.prefill(rparams, {"inputs": jnp.asarray(toks[:, :S])})
    caches = caches_from_reference(jax.tree.map(np.asarray, rcaches),
                                   device="cpu")
    _assert_tree(caches_to_numpy(caches), rcaches, what="carried")
    inp = toks[:, S:]
    rstep, _ = rb.decode_step(rparams, jnp.asarray(inp), rcaches,
                              jnp.asarray(S + M, jnp.int32))
    step, _ = b.decode_step(params, torch.from_numpy(inp), caches, S + M)
    np.testing.assert_allclose(step.numpy(), np.asarray(rstep),
                               rtol=DECODE_TOL, atol=DECODE_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_decode_equals_teacher_forcing(arch, rng):
    """Eight greedy steps (the reference's test_multi_token_greedy_decode):
    each step's logits equal the teacher-forced forward over the prompt
    and the generated tokens, and so do its tokens. An embeddings-in
    config is fed the next of a drawn sequence of embeddings in place of
    its argmax. The moe configs at the capacity factor E / k."""
    rb, rparams, b, params = _bundles(arch, **_no_drops(arch))
    mc = b.cfg.model
    M = mc.num_meta_tokens
    feed = torch.from_numpy(_inputs(rng, mc, 15))
    prompt = feed[:, :8]
    last, caches = b.prefill(params, {"inputs": prompt})
    logits, fed = [last], []
    for i in range(7):
        nxt = (feed[:, 8 + i:9 + i] if mc.embeddings_in
               else logits[-1].argmax(-1)[:, None])
        fed.append(nxt)
        step, caches = b.decode_step(params, nxt, caches, 8 + M + i)
        logits.append(step)
    seq = torch.cat([prompt] + fed, dim=1)
    oracle, _ = b.train_forward(params, {"inputs": seq})
    for i, lg in enumerate(logits):
        np.testing.assert_allclose(lg.numpy(), oracle[:, 7 + i].numpy(),
                                   rtol=DECODE_TOL, atol=DECODE_TOL)
        assert torch.equal(lg.argmax(-1), oracle[:, 7 + i].argmax(-1)), i
    # and the reference's forward over the same sequence
    rlogits, _ = rb.train_forward(rparams, {"inputs": jnp.asarray(seq.numpy())})
    np.testing.assert_allclose(oracle.numpy(), np.asarray(rlogits),
                               rtol=PREFILL_TOL, atol=PREFILL_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_kernel_gate(arch, rng, monkeypatch):
    """With use_pallas_attn, prefill calls the swattn wrapper once per
    layer (never with sinks: hymba's meta tokens bar it, as in the
    reference) and decode never does; the logits equal the reference's
    plain-attention prefill and decode."""
    calls = []
    real = transformer.swattn_cuda

    def counting(q, k, v, *, window, scale):
        calls.append(q.shape[1])
        return real(q, k, v, window=window, scale=scale)
    monkeypatch.setattr(transformer, "swattn_cuda", counting)
    rb, rparams, b, params = _bundles(arch, use_pallas_attn=True)
    mc = b.cfg.model
    toks = _inputs(rng, mc, S + 1)
    rlast, rcaches = rb.prefill(rparams, {"inputs": jnp.asarray(toks[:, :S])})
    last, caches = b.prefill(params, {"inputs": torch.from_numpy(toks[:, :S])})
    want = 0 if mc.num_meta_tokens else mc.num_layers
    assert calls == [S] * want
    np.testing.assert_allclose(last.numpy(), np.asarray(rlast),
                               rtol=PREFILL_TOL, atol=PREFILL_TOL)
    cur = S + mc.num_meta_tokens
    rstep, _ = rb.decode_step(rparams, jnp.asarray(toks[:, S:]), rcaches,
                              jnp.asarray(cur, jnp.int32))
    step, _ = b.decode_step(params, torch.from_numpy(toks[:, S:]), caches, cur)
    assert len(calls) == want                       # none in decode
    np.testing.assert_allclose(step.numpy(), np.asarray(rstep),
                               rtol=DECODE_TOL, atol=DECODE_TOL)


@pytest.mark.parametrize("arch", ["h2o_danube_1_8b", "yi_6b"])
def test_int8_kv_decode_close_to_float(arch, rng):
    """int8 KV against the float cache, the reference's bar
    (tests/test_quantization.py: max |Δ| / max |logit| < 0.05), and the
    port's int8 decode against the reference's int8 decode."""
    toks = rng.integers(0, 255, (2, S + 1)).astype(np.int32)
    outs = {}
    for kv in ("", "int8"):
        rb, rparams, b, params = _bundles(arch, kv_cache_dtype=kv)
        _, caches = b.prefill(params, {"inputs": torch.from_numpy(toks[:, :S])})
        step, caches = b.decode_step(params, torch.from_numpy(toks[:, S:]),
                                     caches, S)
        outs[kv] = step.numpy()
    rel = np.abs(outs["int8"] - outs[""]).max() / np.abs(outs[""]).max()
    assert rel < 0.05, rel
    _, rcaches = rb.prefill(rparams, {"inputs": jnp.asarray(toks[:, :S])})
    rstep, rcaches = rb.decode_step(rparams, jnp.asarray(toks[:, S:]), rcaches,
                                    jnp.asarray(S, jnp.int32))
    np.testing.assert_allclose(outs["int8"], np.asarray(rstep),
                               rtol=DECODE_TOL, atol=DECODE_TOL)
    assert caches[0]["k"].dtype == torch.int8


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hymba_train_forward_matches_reference(dtype, rng):
    """The hymba kind (attention ∥ mamba, meta tokens) cache-less. float32
    within 3e-4 (tests/test_torch_lm.py). bfloat16: the two packages round
    in different places, and here each lands about 3.5e-2 (relative L2)
    from the float32 logits; the port is held to relative L2 4e-2 against
    the reference's bfloat16 logits (the port's bfloat16 LM limit,
    chip_smoke.py's LM_TOL) and to no more than 1.25x the reference's own
    distance from the float32 logits."""
    toks = rng.integers(0, 255, (2, 40)).astype(np.int32)
    out = {}
    for dt in {"float32", dtype}:
        rb, rparams, b, params = _bundles("hymba_1_5b", dtype=dt)
        ref, _ = rb.train_forward(rparams, {"inputs": jnp.asarray(toks)})
        got, _ = b.train_forward(params, {"inputs": torch.from_numpy(toks)})
        assert got.shape == (2, 40, 256) and got.dtype == getattr(torch, dt)
        out[dt] = (got.float().numpy(), np.asarray(ref.astype(jnp.float32)))
    got, ref = out[dtype]
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, rtol=3e-4, atol=3e-4)
        return
    f32 = out["float32"][1]

    def rel(a, b):
        return np.linalg.norm(a - b) / np.linalg.norm(b)
    assert rel(got, ref) <= 4e-2, rel(got, ref)
    assert rel(got, f32) <= 1.25 * rel(ref, f32), (rel(got, f32),
                                                   rel(ref, f32))


def test_embed_gathers_before_it_casts(rng):
    """Casting the gathered rows equals gathering from the cast table, bit
    for bit (the cast is element by element)."""
    table = torch.from_numpy(rng.standard_normal((300, 16))
                             .astype(np.float32))
    toks = torch.from_numpy(rng.integers(0, 300, (3, 7)))
    for dt in (torch.bfloat16, torch.float32):
        got = layers.embed(toks, {"table": table}, dt)
        assert got.dtype == dt
        assert torch.equal(got, table.to(dt)[toks])


def test_decode_step_takes_cur_as_an_int(rng):
    mc = tiny_of("yi_6b")
    b = registry.build(RunConfig(model=mc, shape=SHAPES["train_4k"]),
                       device="cpu")
    params = b.init_params(torch.Generator().manual_seed(2))
    caches = b.cache_init(1, 16)
    with pytest.raises(TypeError):
        b.decode_step(params, torch.zeros((1, 1), dtype=torch.long), caches,
                      3.0)
