"""The port's encoder-decoder (whisper) held against the reference's on
the same state: the layers it adds (``layer_norm``, the GELU ``mlp2``,
the sinusoidal encoder positions, the decoder's learned positions below,
at and past their table), the tiny whisper through ``train_forward``,
``prefill`` + 20 ``decode_step`` calls (the tiny ring of 16 slots wraps,
and the positions pass the 16 learned ones), the caches carried both
ways, ``loss_fn``'s gradients, three ``make_train_step`` steps with
microbatches, and the launcher. Parameters and caches are carried across
with ``repro_torch.convert``; inputs are drawn with numpy from a seeded
generator.

Tolerances: one layer in float32 within rtol=atol=1e-5 (the same
operations in other orders). In bfloat16 within relative L2 3e-2, the
repo's bfloat16 tolerance (tests/_torch_parity.py) over the whole tensor:
eager torch rounds each operation to bfloat16 where XLA keeps float32
inside its fusions. The sinusoidal table at the published encoder length
(1500 x 1280) within 2e-4: the two libraries' float32 ``exp`` differ by
one step on 43 of 640 rates, and a position p turns that into an angle
p times one step apart (1499 x 2^-23 = 1.8e-4). Whole models: logits
within 3e-4 after prefill and 5e-4 after decode steps (the reference's
tests/test_consistency.py), caches to the same; gradients and the train
step within tests/test_torch_train.py's limits (loss relative 1e-5,
gradients and parameters relative L2 1e-4).
"""
import dataclasses
import functools
import os
import subprocess
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import SHAPES as R_SHAPES
from repro.configs.base import RunConfig as RRunConfig
from repro.configs.base import SINGLE_POD
from repro.configs.base import TrainConfig as RTrainConfig
from repro.configs.base import get_model_config as r_get_model_config
from repro.configs.tiny import tiny_of as r_tiny_of
from repro.data import make_train_batch as r_make_train_batch
from repro.models import layers as r_layers
from repro.models import module as r_module
from repro.models import registry as r_registry
from repro.models import rope as r_rope
from repro.models import whisper as r_whisper
from repro.optim import adamw_init as r_adamw_init
from repro.training.step import make_train_step as r_make_train_step
from repro_torch.configs import (SHAPES, RunConfig, TrainConfig,
                                 get_model_config)
from repro_torch.configs.tiny import tiny_of
from repro_torch.convert import (caches_from_reference, caches_to_numpy,
                                 opt_state_to_numpy, params_from_reference,
                                 params_to_numpy)
from repro_torch.data import make_train_batch
from repro_torch.models import layers, module, registry, rope, whisper
from repro_torch.optim import adamw_init
from repro_torch.training.step import make_train_step

ROOT = Path(__file__).resolve().parents[1]
ARCH = "whisper_large_v3"
LAYER_TOL, BF16_TOL = 1e-5, 3e-2
PREFILL_TOL, DECODE_TOL = 3e-4, 5e-4
LOSS_TOL, L2_TOL = 1e-5, 1e-4


def _np(x) -> np.ndarray:
    a = np.asarray(x.detach().float() if isinstance(x, torch.Tensor) else x)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _rel_l2(got, want) -> float:
    got = np.asarray(_np(got), np.float64)
    want = np.asarray(_np(want), np.float64)
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


def _match(got, want, dtype: str = "float32", tol=LAYER_TOL, what=""):
    """float32 element-wise within ``tol``; bfloat16 in relative L2
    within BF16_TOL."""
    assert tuple(got.shape) == tuple(np.shape(want)), what
    if dtype == "float32":
        np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol,
                                   err_msg=what)
    else:
        assert np.isfinite(_np(got)).all(), what
        assert _rel_l2(got, want) <= BF16_TOL, (what, _rel_l2(got, want))


def _pair(x: np.ndarray, dtype: str):
    return (jnp.asarray(x).astype(jnp.dtype(dtype)),
            torch.from_numpy(np.ascontiguousarray(x)).to(getattr(torch,
                                                                 dtype)))


# -- layers --------------------------------------------------------------------


def _ln_params(rng, d):
    p_ = {"scale": rng.standard_normal(d).astype(np.float32),
          "bias": rng.standard_normal(d).astype(np.float32)}
    return ({k: jnp.asarray(v) for k, v in p_.items()},
            {k: torch.from_numpy(v) for k, v in p_.items()})


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_matches_reference(dtype, rng):
    """The biased variance (ddof 0), not torch.var's default."""
    x = (rng.standard_normal((2, 7, 48)) * 3 + 1).astype(np.float32)
    rp, tp = _ln_params(rng, 48)
    rx, tx = _pair(x, dtype)
    got = layers.layer_norm(tx, tp)
    assert got.dtype == getattr(torch, dtype)
    _match(got, r_layers.layer_norm(rx, rp), dtype)
    # linspace(-3, 3, 7): variance 4 (ddof 0), not 4.67
    line = torch.linspace(-3, 3, 7)[None]
    y = layers.layer_norm(line, {"scale": torch.ones(7),
                                 "bias": torch.zeros(7)})
    torch.testing.assert_close(y, line / (4.0 + 1e-5) ** 0.5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlp2_matches_reference(dtype, rng):
    """The tanh GELU (jax.nn.gelu's default), with both biases."""
    rparams = r_module.init_params(r_layers.mlp2_specs(32, 64),
                                   jax.random.key(2))
    rparams = {k: v + 0.1 for k, v in rparams.items()}    # non-zero biases
    params = params_from_reference(jax.tree.map(np.asarray, rparams),
                                   device="cpu")
    x = (rng.standard_normal((2, 5, 32)) * 3).astype(np.float32)
    rx, tx = _pair(x, dtype)
    _match(layers.mlp2(tx, params), r_layers.mlp2(rx, rparams), dtype)
    # at x = -3 the tanh and erf GELUs differ by 4e-4
    g = layers.mlp2(torch.full((1, 1, 1), -3.0),
                    {"wi": torch.ones(1, 1), "bi": torch.zeros(1),
                     "wo": torch.ones(1, 1), "bo": torch.zeros(1)})
    np.testing.assert_allclose(float(g), float(jax.nn.gelu(-3.0)),
                               rtol=LAYER_TOL, atol=LAYER_TOL)


@pytest.mark.parametrize("length,d", [(1, 8), (7, 16), (64, 64), (32, 1280)])
def test_sinusoidal_embedding_matches_reference(length, d):
    got = rope.sinusoidal_embedding(length, d, device="cpu")
    want = r_rope.sinusoidal_embedding(length, d)
    _match(got, want)
    # [sin, cos] halves: position 0 reads zeros then ones
    np.testing.assert_array_equal(got[0].numpy(),
                                  np.r_[np.zeros(d // 2), np.ones(d // 2)])


def test_sinusoidal_embedding_at_the_encoder_length():
    got = rope.sinusoidal_embedding(1500, 1280, torch.bfloat16, device="cpu")
    want = r_rope.sinusoidal_embedding(1500, 1280, jnp.float32)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(
        rope.sinusoidal_embedding(1500, 1280, device="cpu").numpy(),
        np.asarray(want), rtol=0, atol=2e-4)
    _match(got, want.astype(jnp.bfloat16), "bfloat16")


@pytest.mark.parametrize("case", ["below", "at_and_past", "decode_at_P",
                                  "decode_past_P", "decode_far_past_P"])
def test_dec_positions_embed_matches_reference(case, rng):
    """Positions below P index the table; any at or past P interpolate by
    the call's largest position (the reference's global max), so one
    decode position past P reads the last row."""
    P, D = 16, 8
    table = rng.standard_normal((P, D)).astype(np.float32)
    pos = {"below": np.arange(12)[None].repeat(2, 0),
           "at_and_past": np.arange(40)[None].repeat(2, 0),
           "decode_at_P": np.full((2, 1), P),
           "decode_past_P": np.full((2, 1), P + 3),
           "decode_far_past_P": np.full((2, 1), 500)}[case].astype(np.int32)
    mc = dataclasses.replace(tiny_of(ARCH), max_target_positions=P)
    got = whisper._dec_positions_embed({"dec_pos": torch.from_numpy(table)},
                                       torch.from_numpy(pos), mc,
                                       torch.float32)
    want = r_whisper._dec_positions_embed({"dec_pos": jnp.asarray(table)},
                                          jnp.asarray(pos), mc, jnp.float32)
    _match(got, want)
    if case.startswith("decode_"):
        np.testing.assert_array_equal(got.numpy()[:, 0],
                                      table[[P - 1, P - 1]])


# -- the model -----------------------------------------------------------------

S_ENC, T0, STEPS = 32, 4, 20


@functools.lru_cache(maxsize=None)
def _bundles(dtype: str = "float32"):
    """(reference bundle with jitted entry points, its params, the port's
    bundle, the same params) of tiny whisper (2 + 2 layers, 16 decoder
    positions)."""
    sh = dict(seq_len=S_ENC, global_batch=2)
    rb = r_registry.build(RRunConfig(
        model=dataclasses.replace(r_tiny_of(ARCH), dtype=dtype),
        shape=dataclasses.replace(R_SHAPES["prefill_32k"], **sh),
        mesh=SINGLE_POD))
    rparams = jax.jit(rb.init_params)(jax.random.key(1))
    rb = types.SimpleNamespace(prefill=jax.jit(rb.prefill),
                               decode_step=jax.jit(rb.decode_step),
                               train_forward=jax.jit(rb.train_forward))
    b = registry.build(RunConfig(
        model=dataclasses.replace(tiny_of(ARCH), dtype=dtype),
        shape=dataclasses.replace(SHAPES["prefill_32k"], **sh)),
        device="cpu")
    params = params_from_reference(jax.tree.map(np.asarray, rparams),
                                   device="cpu")
    return rb, rparams, b, params


def _batch(rng, T: int, d: int = 64):
    return {"frames": rng.standard_normal((2, S_ENC, d)).astype(np.float32),
            "dec_tokens": rng.integers(0, 255, (2, T)).astype(np.int32)}


def _assert_caches(got, want, tol, what=""):
    got = caches_to_numpy(got)
    want = jax.tree.map(_np, want)
    assert jax.tree.structure(got) == jax.tree.structure(want), what
    for i, (g, w) in enumerate(zip(jax.tree.leaves(got),
                                   jax.tree.leaves(want))):
        assert g.shape == w.shape and g.dtype == w.dtype, (what, i)
        np.testing.assert_allclose(g, w, rtol=tol, atol=tol,
                                   err_msg=f"{what} leaf {i}")


@pytest.mark.parametrize("tiny", [False, True])
def test_spec_tree_equals_reference(tiny):
    mc = tiny_of(ARCH) if tiny else get_model_config(ARCH)
    rmc = r_tiny_of(ARCH) if tiny else r_get_model_config(ARCH)
    specs = module.tree_paths(whisper.model_specs(mc))
    rspecs = r_module.tree_paths(r_whisper.model_specs(rmc))
    assert sorted(specs) == sorted(rspecs)
    for path, s in specs.items():
        r = rspecs[path]
        assert (s.shape, s.axes, s.init, s.scale) == \
            (r.shape, r.axes, r.init, r.scale), path
    assert module.count_params(whisper.model_specs(mc)) == \
        r_module.count_params(r_whisper.model_specs(rmc))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_forward_matches_reference(dtype, rng):
    rb, rparams, b, params = _bundles(dtype)
    batch = _batch(rng, 16)
    ref, raux = rb.train_forward(rparams, jax.tree.map(jnp.asarray, batch))
    got, aux = b.train_forward(params, {k: torch.from_numpy(v)
                                        for k, v in batch.items()})
    assert float(aux) == float(raux) == 0.0
    assert got.dtype == getattr(torch, dtype)
    _match(got, ref, dtype, PREFILL_TOL)


def test_encode_and_cross_kv_match_reference(rng):
    _, rparams, b, params = _bundles()
    mc = b.cfg.model
    frames = rng.standard_normal((2, S_ENC, 64)).astype(np.float32)
    renc = r_whisper.encode(rparams, jnp.asarray(frames), mc)
    enc = whisper.encode(params, torch.from_numpy(frames), mc)
    _match(enc, renc, tol=PREFILL_TOL)
    rx = r_whisper.cross_kv(rparams, renc, mc)
    x = whisper.cross_kv(params, enc, mc)
    for k in ("k", "v"):
        assert tuple(x[k].shape) == (mc.num_layers, 2, S_ENC,
                                     mc.num_kv_heads, 16)
        _match(x[k], rx[k], tol=PREFILL_TOL)


def test_prefill_and_decode_match_reference(rng):
    """Prefill of a 4-token prompt, then 20 decode steps against the
    reference's: the tiny ring of 16 slots wraps, and positions 16..23
    read the last learned position, as the reference's decode_step does.
    The logits and both caches after every call; the self ring written
    in place, the cross cache read as the prefill left it."""
    rb, rparams, b, params = _bundles()
    batch = _batch(rng, T0 + STEPS)
    prompt = {"frames": batch["frames"],
              "dec_tokens": batch["dec_tokens"][:, :T0]}
    rlast, rcaches = rb.prefill(rparams, jax.tree.map(jnp.asarray, prompt))
    last, caches = b.prefill(params, {k: torch.from_numpy(v)
                                      for k, v in prompt.items()})
    _match(last, rlast, tol=PREFILL_TOL)
    _assert_caches(caches, rcaches, PREFILL_TOL, "prefill")
    cross = caches["cross"]["k"].clone()
    for i in range(STEPS):
        cur = T0 + i
        inp = batch["dec_tokens"][:, cur:cur + 1]
        rstep, rcaches = rb.decode_step(rparams, jnp.asarray(inp), rcaches,
                                        jnp.asarray(cur, jnp.int32))
        step, out = b.decode_step(params, torch.from_numpy(inp), caches, cur)
        assert out is caches
        _match(step, rstep, tol=DECODE_TOL, what=f"step {i}")
        _assert_caches(caches, rcaches, DECODE_TOL, f"step {i}")
    assert torch.equal(caches["cross"]["k"], cross)
    assert int(caches["self"]["pos"].max()) == T0 + STEPS - 1 > 16


def test_caches_carried_from_the_reference(rng):
    rb, rparams, b, params = _bundles()
    batch = _batch(rng, T0 + 1)
    prompt = {"frames": batch["frames"],
              "dec_tokens": batch["dec_tokens"][:, :T0]}
    _, rcaches = rb.prefill(rparams, jax.tree.map(jnp.asarray, prompt))
    caches = caches_from_reference(jax.tree.map(np.asarray, rcaches),
                                   device="cpu")
    _assert_caches(caches, rcaches, 0.0, "carried")
    inp = batch["dec_tokens"][:, T0:]
    rstep, _ = rb.decode_step(rparams, jnp.asarray(inp), rcaches,
                              jnp.asarray(T0, jnp.int32))
    step, _ = b.decode_step(params, torch.from_numpy(inp), caches, T0)
    _match(step, rstep, tol=DECODE_TOL)


def test_greedy_decode_equals_teacher_forcing(rng):
    """Greedy steps within the learned positions equal the port's own
    teacher-forced forward over prompt + generated tokens."""
    _, _, b, params = _bundles()
    batch = _batch(rng, T0)
    frames = torch.from_numpy(batch["frames"])
    prompt = torch.from_numpy(batch["dec_tokens"])
    last, caches = b.prefill(params, {"frames": frames, "dec_tokens": prompt})
    logits, fed = [last], []
    for i in range(16 - T0):                   # up to position 15 < P
        fed.append(logits[-1].argmax(-1)[:, None])
        step, caches = b.decode_step(params, fed[-1], caches, T0 + i)
        logits.append(step)
    oracle, _ = b.train_forward(params, {
        "frames": frames, "dec_tokens": torch.cat([prompt] + fed, dim=1)})
    for i, lg in enumerate(logits):
        _match(lg, oracle[:, T0 - 1 + i].numpy(), tol=DECODE_TOL,
               what=f"row {i}")


def test_cache_init_is_the_concrete_twin_of_the_reference(rng):
    _, _, b, _ = _bundles()
    mc = b.cfg.model
    caches = b.cache_init(2, S_ENC)
    want = {"self": r_whisper.self_cache_init(mc, 2),
            "cross": r_whisper.xkv_abstract(mc, 2, S_ENC)}
    got = caches_to_numpy(caches)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert g.shape == w.shape and g.dtype == w.dtype
    np.testing.assert_array_equal(got["self"]["pos"],
                                  np.asarray(want["self"]["pos"]))
    with pytest.raises(TypeError, match="device"):
        whisper.self_cache_init(mc, 2)


# -- training ------------------------------------------------------------------

SEQ, BATCH = 32, 4


def _train_rcs(microbatch: int = 0):
    sh = dict(seq_len=SEQ, global_batch=BATCH)
    tc = dict(total_steps=10, warmup_steps=2, microbatch=microbatch)
    rrc = RRunConfig(model=r_tiny_of(ARCH),
                     shape=dataclasses.replace(R_SHAPES["train_4k"], **sh),
                     mesh=SINGLE_POD,
                     train=RTrainConfig(remat_policy="none", **tc))
    rc = RunConfig(model=tiny_of(ARCH),
                   shape=dataclasses.replace(SHAPES["train_4k"], **sh),
                   train=TrainConfig(remat_policy="full", **tc))
    return rrc, rc


@functools.lru_cache(maxsize=None)
def _ref_params():
    rb = r_registry.build(_train_rcs()[0])
    return jax.tree.map(np.asarray, rb.init_params(jax.random.key(11)))


@functools.lru_cache(maxsize=None)
def _ref_value_and_grad():
    rrc, _ = _train_rcs()
    rb = r_registry.build(rrc)
    f = jax.jit(jax.value_and_grad(rb.loss_fn, has_aux=True))
    (loss, (aux, denom)), grads = f(_ref_params(), r_make_train_batch(rrc, 0))
    return float(loss), float(denom), jax.tree.map(np.asarray, grads)


@pytest.mark.parametrize("policy", ["none", "full", "dots"])
def test_loss_fn_grads_match_reference(policy):
    """``loss_fn`` (``ce_loss`` over the whole logit plane, aux 0) and
    its gradients against ``jax.grad`` of the reference's."""
    r_val, r_den, r_g = _ref_value_and_grad()
    _, rc = _train_rcs()
    b = registry.build(rc, device="cpu")
    params = params_from_reference(_ref_params(), device="cpu")
    for x in module.tree_leaves(params):
        x.requires_grad_(True)
    batch = make_train_batch(rc, 0, "cpu")
    assert sorted(batch) == ["dec_tokens", "frames", "labels"]
    loss, (aux, denom) = b.loss_fn(params, batch, remat_policy=policy)
    loss.backward()
    assert float(denom) == r_den == BATCH * 16 and float(aux) == 0.0
    np.testing.assert_allclose(float(loss), r_val, rtol=LOSS_TOL)
    g = jax.tree.map(lambda t: t.grad.numpy(), params)
    for path, leaf in jax.tree_util.tree_leaves_with_path(g):
        ref = functools.reduce(lambda t, k: t[k.key], path, r_g)
        assert _rel_l2(leaf, ref) <= L2_TOL, path


def test_train_step_with_microbatches_matches_reference():
    """Three ``make_train_step`` steps, two microbatches each (every
    batch key sliced: frames, dec_tokens, labels), against the
    reference's jitted step."""
    rrc, rc = _train_rcs(microbatch=2)
    step = jax.jit(r_make_train_step(r_registry.build(rrc), rrc))
    rparams = jax.tree.map(jnp.asarray, _ref_params())
    ropt = r_adamw_init(rparams)
    params = params_from_reference(_ref_params(), device="cpu")
    opt = adamw_init(params)
    tstep = make_train_step(registry.build(rc, device="cpu"), rc)
    for i in range(3):
        rparams, ropt, rm = step(rparams, ropt, r_make_train_batch(rrc, i))
        params, opt, m = tstep(params, opt, make_train_batch(rc, i, "cpu"))
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(m[k]), float(rm[k]),
                                       rtol=LOSS_TOL, err_msg=k)
    got = params_to_numpy(params)
    want = jax.tree.map(np.asarray, rparams)
    num = sum(float(np.sum((a.astype(np.float64) - w) ** 2))
              for a, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)))
    den = sum(float(np.sum(np.asarray(w, np.float64) ** 2))
              for w in jax.tree.leaves(want))
    assert (num / den) ** 0.5 <= L2_TOL
    assert int(opt_state_to_numpy(opt).step) == 3


@pytest.mark.parametrize("arch", ["whisper_large_v3", "xlstm_350m"])
def test_launcher_trains_tiny_on_the_cpu(arch, tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", arch,
         "--tiny", "--steps", "2", "--seq", "32", "--batch", "4",
         "--microbatch", "2", "--device", "cpu", "--ckpt-dir",
         str(tmp_path), "--ckpt-every", "2"],
        env=env, capture_output=True, text=True, timeout=240, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    last = out.stdout.strip().splitlines()[-1]
    assert last.startswith("[train] done: 2 steps, final loss ")
    assert os.listdir(tmp_path) == ["step_00000002"]
