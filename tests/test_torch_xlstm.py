"""The port's recurrent layer kinds held against the reference's on the
same state: xLSTM's mLSTM (parallel, chunkwise, the recurrent step, the
block) and sLSTM (the scan, the block), the reference's own equivalences
run on the port, the tiny xlstm and a ``stage_override`` mamba stack
through ``train_forward``, ``prefill`` + 20 ``decode_step`` calls and
``loss_fn``'s gradients, and the configs of the slice (xlstm-350m,
whisper-large-v3, spatial-filter-hd) with ``supported_shapes``.
Parameters and states are carried across with ``repro_torch.convert``;
inputs are drawn with numpy from a seeded generator.

Tolerances: one layer in float32 within rtol=atol=1e-5 (the same
operations summed in other orders). In bfloat16, outputs and states
within relative L2 3e-2 (the repo's bfloat16 tolerance,
tests/_torch_parity.py, taken over the whole tensor): eager torch rounds
every operation's result to bfloat16 where XLA keeps float32 inside its
fusions, and the exponential gates turn a gate pre-activation one
bfloat16 step apart into a few per cent on single elements, so no
element-wise bound holds between the two packages in bfloat16. Whole
models: logits within 3e-4 after prefill and 5e-4 after decode steps
(the reference's own prefill→decode tolerances,
tests/test_consistency.py), the caches through
``convert.caches_to_numpy`` to the same; gradients within
``tests/test_torch_train.py``'s limits (loss relative 1e-5, gradients
relative L2 1e-4).
"""
import dataclasses
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ARCH_IDS as R_ARCH_IDS
from repro.configs.base import PAPER_ARCH as R_PAPER_ARCH
from repro.configs.base import SHAPES as R_SHAPES
from repro.configs.base import RunConfig as RRunConfig
from repro.configs.base import SINGLE_POD
from repro.configs.base import get_model_config as r_get_model_config
from repro.configs.base import supported_shapes as r_supported_shapes
from repro.configs.tiny import tiny_of as r_tiny_of
from repro.models import module as r_module
from repro.models import registry as r_registry
from repro.models import transformer as r_tfm
from repro.models import xlstm as r_xlstm
from repro_torch.configs import (ARCH_IDS, PAPER_ARCH, SHAPES, RunConfig,
                                 get_model_config, supported_shapes)
from repro_torch.configs.tiny import tiny_of
from repro_torch.convert import (caches_from_reference, caches_to_numpy,
                                 params_from_reference)
from repro_torch.models import module, registry, transformer, xlstm

from _torch_parity import reference_bundle_params, reference_init_params

LAYER_TOL = 1e-5
BF16_TOL = 3e-2
PREFILL_TOL, DECODE_TOL = 3e-4, 5e-4
LOSS_TOL, L2_TOL = 1e-5, 1e-4
B, H, DH = 2, 4, 16
# the mamba kind as a stack of its own, at tiny hymba's widths (the
# reference's mamba specs take heads = mamba_heads or 8; tiny hymba's 4)
MAMBA = {"stage_override": (("mamba", 0, 2),), "num_layers": 2,
         "num_meta_tokens": 0}
MODELS = {"xlstm": ("xlstm_350m", {}), "mamba": ("hymba_1_5b", MAMBA)}


def _np(x) -> np.ndarray:
    a = np.asarray(x.detach().float() if isinstance(x, torch.Tensor) else x)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _close(got, want, tol=LAYER_TOL, what=""):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol,
                               err_msg=what)


def _rel_l2(got, want) -> float:
    got = np.asarray(_np(got), np.float64)
    want = np.asarray(_np(want), np.float64)
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


def _match(got, want, dtype: str, what=""):
    """float32 element-wise within LAYER_TOL; bfloat16 in relative L2
    within BF16_TOL."""
    if dtype == "float32":
        _close(got, want, LAYER_TOL, what)
    else:
        assert np.isfinite(_np(got)).all(), what
        assert _rel_l2(got, want) <= BF16_TOL, (what, _rel_l2(got, want))


def _pair(x: np.ndarray, dtype: str):
    """The same array as a JAX and a torch tensor in ``dtype``."""
    return (jnp.asarray(x).astype(jnp.dtype(dtype)),
            torch.from_numpy(np.ascontiguousarray(x)).to(getattr(torch,
                                                                 dtype)))


def _qkvif(rng, S: int, dtype: str = "float32"):
    """mLSTM inputs: q, k, v [B,S,H,DH] and the gate pre-activations i, f
    [B,S,H] (f biased open, as trained forget gates are)."""
    arrs = [rng.standard_normal((B, S, H, DH)).astype(np.float32)
            for _ in range(3)]
    arrs.append(rng.standard_normal((B, S, H)).astype(np.float32))
    arrs.append((rng.standard_normal((B, S, H)) + 2.0).astype(np.float32))
    pairs = [_pair(a, dtype) for a in arrs]
    return [p_[0] for p_ in pairs], [p_[1] for p_ in pairs]


def _state(rng, dtype_m=np.float32):
    """A non-trivial mLSTM carry (C, n, m): the memory after some
    history."""
    C = rng.standard_normal((B, H, DH, DH)).astype(np.float32) * 0.1
    n = rng.standard_normal((B, H, DH)).astype(np.float32) * 0.1
    m = rng.standard_normal((B, H)).astype(dtype_m)
    return ((jnp.asarray(C), jnp.asarray(n), jnp.asarray(m)),
            (torch.from_numpy(C), torch.from_numpy(n), torch.from_numpy(m)))


# -- configs -------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCH_IDS + [PAPER_ARCH])
def test_configs_equal_reference(arch):
    assert ARCH_IDS == R_ARCH_IDS and PAPER_ARCH == R_PAPER_ARCH
    mc, rmc = get_model_config(arch), r_get_model_config(arch)
    assert dataclasses.asdict(mc) == dataclasses.asdict(rmc)
    assert mc.param_count() == rmc.param_count()
    assert supported_shapes(mc) == r_supported_shapes(rmc)
    assert supported_shapes(tiny_of(arch) if arch in ARCH_IDS else mc) == \
        r_supported_shapes(r_tiny_of(arch) if arch in ARCH_IDS else rmc)


def test_xlstm_stages_and_specs_equal_reference():
    for mc, rmc in ((get_model_config("xlstm_350m"),
                     r_get_model_config("xlstm_350m")),
                    (tiny_of("xlstm_350m"), r_tiny_of("xlstm_350m")),
                    (dataclasses.replace(tiny_of("hymba_1_5b"), **MAMBA),
                     dataclasses.replace(r_tiny_of("hymba_1_5b"), **MAMBA))):
        assert [dataclasses.astuple(s) for s in transformer.make_stages(mc)] \
            == [dataclasses.astuple(s) for s in r_tfm.make_stages(rmc)]
        specs = module.tree_paths(transformer.model_specs(mc))
        rspecs = r_module.tree_paths(r_tfm.model_specs(rmc))
        assert sorted(specs) == sorted(rspecs)
        for path, s in specs.items():
            r = rspecs[path]
            assert (s.shape, s.axes, s.init, s.scale) == \
                (r.shape, r.axes, r.init, r.scale), path
    stages = transformer.make_stages(get_model_config("xlstm_350m"))
    assert [(s.kind, s.count) for s in stages] == [("mlstm", 7),
                                                   ("slstm", 1)] * 3


# -- mLSTM ---------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlstm_parallel_matches_reference(dtype, rng):
    rin, tin = _qkvif(rng, 24, dtype)
    _match(xlstm._mlstm_parallel(*tin), r_xlstm._mlstm_parallel(*rin),
           dtype)


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("chunk", [8, 16, 64])
def test_mlstm_chunkwise_matches_reference(chunk, with_state, rng):
    rin, tin = _qkvif(rng, 64)
    rst, tst = _state(rng) if with_state else (None, None)
    ry, rfin = r_xlstm.mlstm_chunkwise(*rin, chunk=chunk, state=rst)
    y, fin = xlstm.mlstm_chunkwise(*tin, chunk=chunk, state=tst)
    _close(y, ry, what="y")
    assert isinstance(fin, tuple) and len(fin) == 3
    for g, r, name in zip(fin, rfin, "Cnm"):
        assert g.dtype == torch.float32
        _close(g, r, what=name)


def test_mlstm_chunkwise_refuses_a_ragged_chunk(rng):
    _, tin = _qkvif(rng, 24)
    with pytest.raises(ValueError, match="chunks of 16"):
        xlstm.mlstm_chunkwise(*tin, chunk=16)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlstm_step_matches_reference(dtype, rng):
    rin, tin = _qkvif(rng, 1, dtype)
    rst, tst = _state(rng)
    ry, rnew = r_xlstm._mlstm_step(*(a[:, 0] for a in rin), rst)
    y, new = xlstm._mlstm_step(*(a[:, 0] for a in tin), tst)
    assert y.dtype == torch.float32                 # not cast back
    _match(y, ry, dtype)
    for g, r in zip(new, rnew):
        _match(g, r, dtype)


def test_mlstm_chunkwise_equals_parallel(rng):
    """The reference's own oracle (chunkwise from the empty state equals
    the parallel form), run on the port."""
    _, tin = _qkvif(rng, 64)
    par = xlstm._mlstm_parallel(*tin)
    for chunk in (8, 16, 64):
        y, _ = xlstm.mlstm_chunkwise(*tin, chunk=chunk)
        torch.testing.assert_close(y, par, rtol=1e-4, atol=1e-4)


def test_mlstm_chunkwise_state_equals_step_replay(rng):
    """The chunkwise carry after S tokens equals S recurrent steps from
    the empty state, and so do the outputs (the states interchange)."""
    _, tin = _qkvif(rng, 32)
    y, fin = xlstm.mlstm_chunkwise(*tin, chunk=8)
    st = xlstm._mlstm_zero(B, H, DH, "cpu")
    ys = []
    for t in range(32):
        yt, st = xlstm._mlstm_step(*(a[:, t] for a in tin), st)
        ys.append(yt)
    torch.testing.assert_close(torch.stack(ys, dim=1), y, rtol=1e-4,
                               atol=1e-4)
    # C and n in the stabilised domain: compare them at a common m
    for got, want in ((st[0] * torch.exp(st[2])[..., None, None],
                       fin[0] * torch.exp(fin[2])[..., None, None]),
                      (st[1] * torch.exp(st[2])[..., None],
                       fin[1] * torch.exp(fin[2])[..., None])):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


# -- sLSTM ---------------------------------------------------------------------


def _slstm_inputs(rng, S: int, d: int = 32, heads: int = 4):
    g = rng.standard_normal((B, S, 4 * d)).astype(np.float32)
    r = (rng.standard_normal((heads, 4, d // heads, d // heads)) * 0.3
         ).astype(np.float32)
    b = rng.standard_normal(4 * d).astype(np.float32) * 0.1
    return g, r, b


@pytest.mark.parametrize("with_state", [False, True])
def test_slstm_scan_matches_reference(with_state, rng):
    g, r, b = _slstm_inputs(rng, 24)
    state = None
    if with_state:
        state = [rng.standard_normal((B, 32)).astype(np.float32)
                 for _ in range(4)]
        state[1] = np.abs(state[1]) + 1.0                  # n > 0
    rhs, rfin = r_xlstm.slstm_scan(
        jnp.asarray(g), jnp.asarray(r), jnp.asarray(b), 4,
        None if state is None else tuple(jnp.asarray(s) for s in state))
    hs, fin = xlstm.slstm_scan(
        torch.from_numpy(g), torch.from_numpy(r), torch.from_numpy(b), 4,
        None if state is None else tuple(torch.from_numpy(s)
                                         for s in state))
    _close(hs, rhs, what="hs")
    assert isinstance(fin, tuple) and len(fin) == 4
    for got, want, name in zip(fin, rfin, "cnhm"):
        assert got.shape == (B, 32) and got.dtype == torch.float32
        _close(got, want, what=name)


def test_slstm_scan_continues_from_its_state(rng):
    """The reference's continuation property on the port: one scan over
    S equals a scan over the first part and one over the rest from its
    final state."""
    g, r, b = (torch.from_numpy(a) for a in _slstm_inputs(rng, 24))
    hs, fin = xlstm.slstm_scan(g, r, b, 4)
    h1, s1 = xlstm.slstm_scan(g[:, :10], r, b, 4)
    h2, s2 = xlstm.slstm_scan(g[:, 10:], r, b, 4, s1)
    torch.testing.assert_close(torch.cat([h1, h2], dim=1), hs, rtol=0,
                               atol=0)
    for a, c in zip(s2, fin):
        torch.testing.assert_close(a, c, rtol=0, atol=0)


def test_slstm_initial_state_is_the_references():
    """n starts at one and m at zero, each [B, d] (the reference's code,
    not its docstring's [B, heads])."""
    mc = tiny_of("xlstm_350m")
    st = xlstm.slstm_state_init(mc, 3, device="cpu")
    rst = r_xlstm.slstm_state_init(r_tiny_of("xlstm_350m"), 3)
    for got, want in zip(st["slstm"], rst["slstm"]):
        assert tuple(got.shape) == want.shape == (3, mc.d_model)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert st["conv"].shape == rst["conv"].shape
    mst = xlstm.mlstm_state_init(mc, 3, device="cpu")
    rmst = r_xlstm.mlstm_state_init(r_tiny_of("xlstm_350m"), 3)
    for got, want in zip(mst["mlstm"], rmst["mlstm"]):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert float(mst["mlstm"][2][0, 0]) == float(np.float32(xlstm.NEG_INF))


# -- the blocks ----------------------------------------------------------------


def _block(kind: str, dtype: str, S: int, rng, with_state: bool, seed=3):
    """(port out, reference out) of one mLSTM / sLSTM block at tiny
    xlstm's widths on the same parameters, input and (optional) state."""
    rmc = dataclasses.replace(r_tiny_of("xlstm_350m"), dtype=dtype)
    mc = dataclasses.replace(tiny_of("xlstm_350m"), dtype=dtype)
    spec_fn = {"mlstm": r_xlstm.mlstm_specs, "slstm": r_xlstm.slstm_specs}
    rparams = reference_init_params(
        spec_fn[kind](rmc.d_model, heads=rmc.num_heads,
                      conv_width=rmc.ssm_conv_width), jax.random.key(seed))
    # open the mLSTM gates a little (pre-activations of order one): at the
    # spec's "small" init every gate sits near sigmoid(0). At 20 times the
    # init the exponential gates carry float32 summation order to 3.7e-5
    # on outputs of about 2 (the CPU's reading), past LAYER_TOL.
    rparams = jax.tree.map(lambda a: a * 5 if a.ndim >= 2 and
                           a.shape[-1] == rmc.num_heads else a, rparams)
    params = params_from_reference(jax.tree.map(np.asarray, rparams),
                                   device="cpu")
    x = rng.standard_normal((B, S, mc.d_model)).astype(np.float32)
    rx, tx = _pair(x, dtype)
    rstate = tstate = None
    if with_state:
        init = {"mlstm": r_xlstm.mlstm_state_init,
                "slstm": r_xlstm.slstm_state_init}[kind]
        # a state from a first chunk of 8 tokens
        x0 = rng.standard_normal((B, 8, mc.d_model)).astype(np.float32)
        rfun = {"mlstm": r_xlstm.mlstm_block,
                "slstm": r_xlstm.slstm_block}[kind]
        _, rstate = rfun(_pair(x0, dtype)[0], rparams, rmc,
                         state_in=init(rmc, B))
        tstate = caches_from_reference(jax.tree.map(np.asarray, rstate),
                                       device="cpu")
        tstate["conv"] = tstate["conv"].to(getattr(torch, dtype))
    rfun = {"mlstm": r_xlstm.mlstm_block, "slstm": r_xlstm.slstm_block}[kind]
    tfun = {"mlstm": xlstm.mlstm_block, "slstm": xlstm.slstm_block}[kind]
    ry, rnew = rfun(rx, rparams, rmc, state_in=rstate)
    y, new = tfun(tx, params, mc, state_in=tstate)
    assert y.dtype == getattr(torch, dtype) and y.shape == x.shape
    return (y, new), (ry, rnew)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("S", [1, 24, 48])
def test_mlstm_block_matches_reference(S, with_state, dtype, rng):
    (y, new), (ry, rnew) = _block("mlstm", dtype, S, rng, with_state)
    _match(y, ry, dtype, "y")
    _match(new["conv"], rnew["conv"], dtype, "conv")
    if not with_state:
        assert new["mlstm"] is None and rnew["mlstm"] is None
    else:
        for g, r, name in zip(new["mlstm"], rnew["mlstm"], "Cnm"):
            _match(g, r, dtype, name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("S", [1, 24])
def test_slstm_block_matches_reference(S, with_state, dtype, rng):
    (y, new), (ry, rnew) = _block("slstm", dtype, S, rng, with_state)
    _match(y, ry, dtype, "y")
    _match(new["conv"], rnew["conv"], dtype, "conv")
    for g, r, name in zip(new["slstm"], rnew["slstm"], "cnhm"):
        _match(g, r, dtype, name)


def test_mlstm_block_chunk_rule(rng, monkeypatch):
    """256 where it divides S, else gcd(S, 256), and S itself when that
    is under 16 (the reference's rule)."""
    seen = []
    real = xlstm.mlstm_chunkwise

    def recording(*a, chunk, **kw):
        seen.append(chunk)
        return real(*a, chunk=chunk, **kw)
    monkeypatch.setattr(xlstm, "mlstm_chunkwise", recording)
    mc = tiny_of("xlstm_350m")
    params = module.init_params(
        xlstm.mlstm_specs(mc.d_model, heads=mc.num_heads),
        torch.Generator().manual_seed(0))
    for S in (512, 96, 40, 7):
        xlstm.mlstm_block(torch.zeros(1, S, mc.d_model), params, mc)
    assert seen == [256, 32, 40, 7]


# -- whole models --------------------------------------------------------------

S = 24


@functools.lru_cache(maxsize=None)
def _bundles(model: str, dtype: str = "float32"):
    """(reference bundle with jitted entry points, its params, the port's
    bundle, the same params), tiny, serving up to S + 24 tokens."""
    arch, fields = MODELS[model]
    fields = {**fields, "dtype": dtype}
    sh = dict(seq_len=S + 24, global_batch=2)
    rb = r_registry.build(RRunConfig(
        model=dataclasses.replace(r_tiny_of(arch), **fields),
        shape=dataclasses.replace(R_SHAPES["prefill_32k"], **sh),
        mesh=SINGLE_POD))
    rparams = reference_bundle_params(rb, jax.random.key(1), jit=True)
    rb = types.SimpleNamespace(prefill=jax.jit(rb.prefill),
                               decode_step=jax.jit(rb.decode_step),
                               train_forward=jax.jit(rb.train_forward))
    b = registry.build(RunConfig(
        model=dataclasses.replace(tiny_of(arch), **fields),
        shape=dataclasses.replace(SHAPES["prefill_32k"], **sh)),
        device="cpu")
    params = params_from_reference(jax.tree.map(np.asarray, rparams),
                                   device="cpu")
    return rb, rparams, b, params


def _assert_caches(got, want, tol, what=""):
    """The port's caches (through caches_to_numpy) against the
    reference's: the same tree, tuple leaves included; floats within
    ``tol``."""
    got = caches_to_numpy(got)
    want = jax.tree.map(lambda a: _np(a), want)
    assert jax.tree.structure(got) == jax.tree.structure(want), what
    for i, (g, w) in enumerate(zip(jax.tree.leaves(got),
                                   jax.tree.leaves(want))):
        assert g.shape == w.shape and g.dtype == w.dtype, (what, i)
        np.testing.assert_allclose(g, w, rtol=tol, atol=tol,
                                   err_msg=f"{what} leaf {i}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("model", sorted(MODELS))
def test_train_forward_matches_reference(model, dtype, rng):
    rb, rparams, b, params = _bundles(model, dtype)
    toks = rng.integers(0, 255, (2, 40)).astype(np.int32)
    ref, raux = rb.train_forward(rparams, {"inputs": jnp.asarray(toks)})
    got, aux = b.train_forward(params, {"inputs": torch.from_numpy(toks)})
    assert float(aux) == float(raux) == 0.0
    if dtype == "float32":
        _close(got, ref, PREFILL_TOL)
    else:
        _match(got, ref, dtype)


@pytest.mark.parametrize("model", sorted(MODELS))
def test_prefill_and_decode_match_reference(model, rng):
    """Prefill of S tokens, then 20 decode steps, each against the
    reference's on the same parameters: the logits and every cache leaf
    (mLSTM's (C, n, m), sLSTM's (c, n, h, m), the conv and ssm states)
    after every call, written in place."""
    rb, rparams, b, params = _bundles(model)
    toks = rng.integers(0, 255, (2, S + 20)).astype(np.int32)
    rlast, rcaches = rb.prefill(rparams, {"inputs": jnp.asarray(toks[:, :S])})
    last, caches = b.prefill(params, {"inputs": torch.from_numpy(toks[:, :S])})
    _close(last, rlast, PREFILL_TOL)
    _assert_caches(caches, rcaches, PREFILL_TOL, "prefill")
    for i in range(20):
        inp = toks[:, S + i:S + i + 1]
        rstep, rcaches = rb.decode_step(rparams, jnp.asarray(inp), rcaches,
                                        jnp.asarray(S + i, jnp.int32))
        step, out = b.decode_step(params, torch.from_numpy(inp), caches,
                                  S + i)
        assert out is caches
        _close(step, rstep, DECODE_TOL, f"step {i}")
        _assert_caches(caches, rcaches, DECODE_TOL, f"step {i}")


@pytest.mark.parametrize("model", sorted(MODELS))
def test_caches_carried_from_the_reference(model, rng):
    rb, rparams, b, params = _bundles(model)
    toks = rng.integers(0, 255, (2, S + 1)).astype(np.int32)
    _, rcaches = rb.prefill(rparams, {"inputs": jnp.asarray(toks[:, :S])})
    caches = caches_from_reference(jax.tree.map(np.asarray, rcaches),
                                   device="cpu")
    _assert_caches(caches, rcaches, 0.0, "carried")
    rstep, _ = rb.decode_step(rparams, jnp.asarray(toks[:, S:]), rcaches,
                              jnp.asarray(S, jnp.int32))
    step, _ = b.decode_step(params, torch.from_numpy(toks[:, S:]), caches, S)
    _close(step, rstep, DECODE_TOL)


@pytest.mark.parametrize("model", sorted(MODELS))
def test_greedy_decode_equals_teacher_forcing(model, rng):
    """Eight greedy steps against the port's own forward over prompt +
    generated tokens. The forward's mLSTM chunks differ from the
    prefill's (S = 15 takes one chunk of 15), as in the reference."""
    _, _, b, params = _bundles(model)
    prompt = torch.from_numpy(rng.integers(0, 255, (2, 8)))
    last, caches = b.prefill(params, {"inputs": prompt})
    logits, fed = [last], []
    for i in range(7):
        fed.append(logits[-1].argmax(-1)[:, None])
        step, caches = b.decode_step(params, fed[-1], caches, 8 + i)
        logits.append(step)
    oracle, _ = b.train_forward(params,
                                {"inputs": torch.cat([prompt] + fed, dim=1)})
    for i, lg in enumerate(logits):
        _close(lg, oracle[:, 7 + i], DECODE_TOL, f"row {i}")
        assert torch.equal(lg.argmax(-1), oracle[:, 7 + i].argmax(-1)), i


def test_cache_trees_equal_reference():
    for model in MODELS:
        arch, fields = MODELS[model]
        mc = dataclasses.replace(tiny_of(arch), **fields)
        rmc = dataclasses.replace(r_tiny_of(arch), **fields)
        got = transformer.cache_init(mc, 2, 32, device="cpu")
        _assert_caches(got, r_tfm.cache_init(rmc, 2, 32), 0.0, model)


# -- gradients -----------------------------------------------------------------

SEQ, BATCH, CHUNK = 32, 4, 16


def _train_rcs(model: str):
    from repro.configs.base import TrainConfig as RTrainConfig
    from repro_torch.configs import TrainConfig
    arch, fields = MODELS[model]
    sh = dict(seq_len=SEQ, global_batch=BATCH)
    tc = dict(total_steps=10, warmup_steps=2, loss_chunk=CHUNK)
    rrc = RRunConfig(model=dataclasses.replace(r_tiny_of(arch), **fields),
                     shape=dataclasses.replace(R_SHAPES["train_4k"], **sh),
                     mesh=SINGLE_POD, train=RTrainConfig(**tc))
    rc = RunConfig(model=dataclasses.replace(tiny_of(arch), **fields),
                   shape=dataclasses.replace(SHAPES["train_4k"], **sh),
                   train=TrainConfig(**tc))
    return rrc, rc


@functools.lru_cache(maxsize=None)
def _ref_value_and_grad(model: str):
    from repro.data import make_train_batch as r_make_train_batch
    rrc, _ = _train_rcs(model)
    rb = r_registry.build(rrc)
    params = jax.tree.map(np.asarray,
                          reference_bundle_params(rb, jax.random.key(11)))
    f = jax.jit(jax.value_and_grad(
        lambda p_, b_: rb.loss_fn(p_, b_, loss_chunk=CHUNK), has_aux=True))
    (loss, (_, denom)), grads = f(params, r_make_train_batch(rrc, 0))
    return params, float(loss), float(denom), jax.tree.map(np.asarray, grads)


@pytest.mark.parametrize("policy", ["none", "full", "dots"])
@pytest.mark.parametrize("model", sorted(MODELS))
def test_loss_fn_grads_match_reference(model, policy):
    """``loss_fn``'s gradients against ``jax.grad`` of the reference's,
    tests/test_torch_train.py's limits, under the remat policies."""
    from repro_torch.data import make_train_batch
    rparams, r_val, r_den, r_g = _ref_value_and_grad(model)
    _, rc = _train_rcs(model)
    b = registry.build(rc, device="cpu")
    params = params_from_reference(rparams, device="cpu")
    for x in module.tree_leaves(params):
        x.requires_grad_(True)
    loss, (aux, denom) = b.loss_fn(params, make_train_batch(rc, 0, "cpu"),
                                   remat_policy=policy, loss_chunk=CHUNK)
    loss.backward()
    assert float(denom) == r_den == BATCH * SEQ and float(aux) == 0.0
    np.testing.assert_allclose(float(loss), r_val, rtol=LOSS_TOL)
    g = jax.tree.map(lambda t: t.grad.numpy(), params)
    for path, leaf in jax.tree_util.tree_leaves_with_path(g):
        ref = functools.reduce(lambda t, k: t[k.key], path, r_g)
        assert _rel_l2(leaf, ref) <= L2_TOL, path


def test_published_xlstm_parameter_count():
    """xlstm-350m's spec tree: 21 mLSTM and 3 sLSTM layers at d 1024
    (d_in 2048, 4 heads of 512), the tied table, as the reference's."""
    mc = get_model_config("xlstm_350m")
    n = module.count_params(transformer.model_specs(mc))
    assert n == r_module.count_params(r_tfm.model_specs(
        r_get_model_config("xlstm_350m")))
    d, d_in, f = 1024, 2048, int(1024 * 4 / 3) // 2 * 2
    mlstm = (d * 2 * d_in + 5 * d_in + 4 * d_in * d_in + 2 * d_in * 4
             + d_in + d_in * d + d)
    slstm = (5 * d + 4 * d * d + 4 * 4 * 256 * 256 + 4 * d + d
             + 3 * d * f + d)
    assert n == 50304 * d + 21 * mlstm + 3 * slstm + d
    assert n == 564_911_104
