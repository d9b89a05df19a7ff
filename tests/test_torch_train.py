"""The port's training path held against the reference's on the same
state: the loss (``ce_loss``, ``chunked_ce_from_hidden``), the model's
``loss_fn`` and its gradients under every remat policy, ``make_train_step``
over three steps, the synthetic data, the kernel gates' refusal of a
gradient, and the launcher. Parameters are the reference's
``init_params`` output carried across with ``repro_torch.convert``;
inputs are drawn with numpy or made by both packages' ``make_train_batch``.

Tolerances (float32 on both sides): losses within relative 1e-5;
gradients, parameters and the AdamW moments within relative L2 1e-4 (the
same operations summed in other orders: the CPU reads 5e-7 on the
gradients of one loss, 2e-5 on hymba's dt_bias, the worst leaf). The
loss's own values and gradients within rtol=atol=1e-5. The moe kind's aux
loss (Switch load balance, in the total with weight 0.01) within relative
1e-5, as the loss. Data bit-equal. One jitted reference per arch and step
configuration is reused.
"""
import dataclasses
import functools
import os
import subprocess
import sys
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
from repro.configs.tiny import tiny_of as r_tiny_of
from repro.data import SyntheticFrames as RSyntheticFrames
from repro.data import make_train_batch as r_make_train_batch
from repro.data import video_stream as r_video_stream
from repro.kernels.dwconv1d.ops import dwconv1d_pallas
from repro.kernels.swattn.ops import swattn_pallas
from repro.models import registry as r_registry
from repro.optim import adamw_init as r_adamw_init
from repro.training import loss as r_loss
from repro.training.step import make_train_step as r_make_train_step
from repro_torch.configs.base import SHAPES, RunConfig, TrainConfig
from repro_torch.configs.tiny import tiny_of
from repro_torch.convert import (opt_state_to_numpy, params_from_reference,
                                 params_to_numpy)
from repro_torch.data import SyntheticFrames, make_train_batch, video_stream
from repro_torch.kernels.dwconv1d import dwconv1d_cuda
from repro_torch.kernels.dwconv1d import kernel as DW
from repro_torch.kernels.swattn import swattn_cuda
from repro_torch.kernels.swattn import kernel as SW
from repro_torch.models import registry, transformer
from repro_torch.models.module import tree_leaves
from repro_torch.optim import adamw_init
from repro_torch.training import loss as t_loss
from repro_torch.training.step import make_grad_fn, make_train_step

from _torch_parity import reference_bundle_params

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ["h2o_danube_1_8b", "yi_6b", "hymba_1_5b", "mixtral_8x7b",
         "qwen3_moe_30b_a3b", "gemma3_4b", "qwen2_vl_7b", "codeqwen15_7b"]
POLICIES = ["none", "full", "dots", "dots_with_no_batch"]
MOE_ARCHS = ("mixtral_8x7b", "qwen3_moe_30b_a3b")
S, B, CHUNK = 32, 4, 16
LOSS_TOL = 1e-5
L2_TOL = 1e-4


def _rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


def _tree_rel_l2(got, want) -> float:
    """Relative L2 over every leaf of two matching numpy trees."""
    g, w = jax.tree.leaves(got), jax.tree.leaves(want)
    assert len(g) == len(w)
    num = sum(float(np.sum((np.asarray(a, np.float64)
                            - np.asarray(b, np.float64)) ** 2))
              for a, b in zip(g, w))
    den = sum(float(np.sum(np.asarray(b, np.float64) ** 2)) for b in w)
    return (num / den) ** 0.5


def _rc(arch, *, microbatch=0, **mc_fields):
    """(reference RunConfig, port RunConfig) of the tiny ``arch``. The
    port rematerialises every layer (the default policy, 'full'); the
    reference, whose policies change what backward keeps and not the
    values, saves everything ('none': its quickest to compile)."""
    sh = dict(seq_len=S, global_batch=B)
    tc = dict(total_steps=10, warmup_steps=2, microbatch=microbatch,
              loss_chunk=CHUNK)
    rrc = RRunConfig(model=dataclasses.replace(r_tiny_of(arch), **mc_fields),
                     shape=dataclasses.replace(R_SHAPES["train_4k"], **sh),
                     mesh=SINGLE_POD,
                     train=RTrainConfig(remat_policy="none", **tc))
    rc = RunConfig(model=dataclasses.replace(tiny_of(arch), **mc_fields),
                   shape=dataclasses.replace(SHAPES["train_4k"], **sh),
                   train=TrainConfig(remat_policy="full", **tc))
    return rrc, rc


@functools.lru_cache(maxsize=None)
def _ref_params(arch, tied=False):
    rrc, _ = _rc(arch, tie_embeddings=tied)
    rb = r_registry.build(rrc)
    return jax.tree.map(np.asarray,
                        reference_bundle_params(rb, jax.random.key(11)))


@functools.lru_cache(maxsize=None)
def _ref_value_and_grad(arch, tied=False):
    """The reference's loss and float32 gradients on batch 0 (its own
    jitted ``jax.value_and_grad`` of ``loss_fn``)."""
    rrc, _ = _rc(arch, tie_embeddings=tied)
    rb = r_registry.build(rrc)
    f = jax.jit(jax.value_and_grad(
        lambda p, b: rb.loss_fn(p, b, loss_chunk=CHUNK), has_aux=True))
    (loss, (aux, denom)), grads = f(_ref_params(arch, tied),
                                    r_make_train_batch(rrc, 0))
    return (float(loss), float(denom), jax.tree.map(np.asarray, grads),
            float(aux))


# -- the loss ----------------------------------------------------------------


def _labels(rng, shape, V, ignore_every=0):
    lab = rng.integers(0, V, shape).astype(np.int32)
    if ignore_every:
        lab.reshape(-1)[::ignore_every] = r_loss.IGNORE
    return lab


@pytest.mark.parametrize("z_loss", [0.0, 1e-3])
@pytest.mark.parametrize("ignore_every", [0, 3])
def test_ce_loss_matches_reference(ignore_every, z_loss, rng):
    logits = rng.standard_normal((2, 7, 11)).astype(np.float32) * 3
    lab = _labels(rng, (2, 7), 11, ignore_every)

    def r_f(x):
        return r_loss.ce_loss(x, jnp.asarray(lab), z_loss)
    (r_val, r_den), r_g = jax.value_and_grad(r_f, has_aux=True)(
        jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_(True)
    val, den = t_loss.ce_loss(x, torch.from_numpy(lab), z_loss)
    val.backward()
    assert float(den) == float(r_den)
    np.testing.assert_allclose(float(val), float(r_val), rtol=LOSS_TOL)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(r_g), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("S_,chunk", [(16, 4), (16, 16), (15, 4)])
@pytest.mark.parametrize("z_loss", [0.0, 1e-3])
@pytest.mark.parametrize("tied", [False, True])
def test_chunked_ce_matches_reference(tied, z_loss, S_, chunk, rng):
    """Tied ([V, D]) and untied ([D, V]) heads, z-loss, ignored labels,
    and S % chunk != 0 (the unchunked fallback): value and the gradients
    of hidden and head."""
    D, V = 8, 13
    h = rng.standard_normal((2, S_, D)).astype(np.float32)
    w = rng.standard_normal((V, D) if tied else (D, V)).astype(np.float32)
    lab = _labels(rng, (2, S_), V, ignore_every=5)

    def r_f(h_, w_):
        return r_loss.chunked_ce_from_hidden(
            h_, w_, jnp.asarray(lab), chunk=chunk, z_loss=z_loss,
            transpose_head=tied)
    (r_val, r_den), (r_gh, r_gw) = jax.value_and_grad(
        r_f, argnums=(0, 1), has_aux=True)(jnp.asarray(h), jnp.asarray(w))
    th = torch.from_numpy(h).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    val, den = t_loss.chunked_ce_from_hidden(
        th, tw, torch.from_numpy(lab), chunk=chunk, z_loss=z_loss,
        transpose_head=tied)
    val.backward()
    assert float(den) == float(r_den)
    np.testing.assert_allclose(float(val), float(r_val), rtol=LOSS_TOL)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(r_gh), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(r_gw), rtol=1e-5,
                               atol=1e-5)


# -- loss_fn and its gradients ------------------------------------------------


def _port_loss_and_grads(arch, policy, tied=False):
    """(loss, label count, gradients as numpy, aux loss) of the port's
    loss_fn on the reference's parameters and batch 0."""
    _, rc = _rc(arch, tie_embeddings=tied)
    b = registry.build(rc, device="cpu")
    params = params_from_reference(_ref_params(arch, tied), device="cpu")
    for x in tree_leaves(params):
        x.requires_grad_(True)
    loss, (aux, denom) = b.loss_fn(params, make_train_batch(rc, 0, "cpu"),
                                   remat_policy=policy, loss_chunk=CHUNK)
    loss.backward()
    assert (float(aux) == 0.0) == (rc.model.family != "moe")
    # a leaf the loss does not read (qwen2-vl's embedding table: its
    # inputs are embeddings) has no .grad; jax.grad gives it zeros
    grads = jax.tree.map(lambda t: np.zeros(t.shape, np.float32)
                         if t.grad is None else t.grad.numpy(), params)
    return float(loss), float(denom), grads, float(aux)


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_fn_and_grads_match_reference(arch, policy):
    """Every remat policy against the reference's jitted value_and_grad
    (its policies change what backward keeps, not the values)."""
    r_val, r_den, r_g, r_aux = _ref_value_and_grad(arch)
    val, den, g, aux = _port_loss_and_grads(arch, policy)
    assert den == r_den == B * S
    np.testing.assert_allclose(val, r_val, rtol=LOSS_TOL)
    np.testing.assert_allclose(aux, r_aux, rtol=LOSS_TOL)
    assert _tree_rel_l2(g, r_g) <= L2_TOL
    for path, leaf in jax.tree_util.tree_leaves_with_path(g):
        ref = functools.reduce(lambda t, k: t[k.key], path, r_g)
        assert _rel_l2(leaf, ref) <= L2_TOL, path


def test_loss_fn_tied_head_matches_reference():
    r_val, _, r_g, _ = _ref_value_and_grad("h2o_danube_1_8b", tied=True)
    val, _, g, _ = _port_loss_and_grads("h2o_danube_1_8b", "none", tied=True)
    assert "head" not in g
    np.testing.assert_allclose(val, r_val, rtol=LOSS_TOL)
    assert _tree_rel_l2(g, r_g) <= L2_TOL


@pytest.mark.parametrize("policy,calls", [("none", 1), ("full", 2),
                                          ("dots", 2),
                                          ("dots_with_no_batch", 2)])
def test_remat_recomputes_each_layer(policy, calls, monkeypatch):
    """A checkpointed layer runs again in backward; 'none' runs once."""
    _, rc = _rc("yi_6b")
    b = registry.build(rc, device="cpu")
    params = b.init_params(torch.Generator().manual_seed(0))
    seen = []
    real = transformer.BLOCKS["dense"]

    def counted(*a, **kw):
        seen.append(1)
        return real(*a, **kw)
    monkeypatch.setitem(transformer.BLOCKS, "dense", counted)
    for x in tree_leaves(params):
        x.requires_grad_(True)
    loss, _ = b.loss_fn(params, make_train_batch(rc, 0, "cpu"),
                        remat_policy=policy)
    loss.backward()
    assert len(seen) == calls * rc.model.num_layers


def test_unknown_remat_policy_is_refused():
    _, rc = _rc("yi_6b")
    b = registry.build(rc, device="cpu")
    params = b.init_params(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="offload"):
        b.loss_fn(params, make_train_batch(rc, 0, "cpu"),
                  remat_policy="offload")


def test_meta_tokens_are_dropped_before_the_loss():
    """hymba's meta tokens prepend M positions; the loss counts S labels."""
    _, rc = _rc("hymba_1_5b")
    assert rc.model.num_meta_tokens == 4
    _, den, g, _ = _port_loss_and_grads("hymba_1_5b", "none")
    assert den == B * S
    assert np.abs(g["meta_tokens"]).sum() > 0


# -- make_train_step ---------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _ref_steps(arch, microbatch, n=3):
    """The reference's jitted train step from ``_ref_params``: the
    metrics of each step and the state after ``n``."""
    rrc, _ = _rc(arch, microbatch=microbatch)
    rb = r_registry.build(rrc)
    step = jax.jit(r_make_train_step(rb, rrc))
    params = jax.tree.map(jnp.asarray, _ref_params(arch))
    opt = r_adamw_init(params)
    metrics = []
    for i in range(n):
        params, opt, m = step(params, opt, r_make_train_batch(rrc, i))
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, jax.tree.map(np.asarray, (params, opt))


@pytest.mark.parametrize("arch,microbatch", [("h2o_danube_1_8b", 0),
                                             ("h2o_danube_1_8b", 2),
                                             ("yi_6b", 2),
                                             ("mixtral_8x7b", 2),
                                             ("qwen3_moe_30b_a3b", 0),
                                             ("gemma3_4b", 0),
                                             ("qwen2_vl_7b", 2),
                                             ("codeqwen15_7b", 0)])
def test_train_step_matches_reference(arch, microbatch):
    r_metrics, (r_params, r_opt) = _ref_steps(arch, microbatch)
    _, rc = _rc(arch, microbatch=microbatch)
    b = registry.build(rc, device="cpu")
    params = params_from_reference(_ref_params(arch), device="cpu")
    opt = adamw_init(params)
    step = make_train_step(b, rc)
    for i, rm in enumerate(r_metrics):
        params, opt, m = step(params, opt, make_train_batch(rc, i, "cpu"))
        assert m["step"] == rm["step"] == i + 1
        assert m["lr"] == pytest.approx(rm["lr"], rel=1e-6)
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(m[k]), rm[k], rtol=LOSS_TOL,
                                       err_msg=k)
        np.testing.assert_allclose(float(m["aux_loss"]), rm["aux_loss"],
                                   rtol=LOSS_TOL, err_msg="aux_loss")
        assert (rm["aux_loss"] == 0.0) == (arch not in MOE_ARCHS)
    assert all(not x.requires_grad for x in tree_leaves(params))
    got_opt = opt_state_to_numpy(opt)
    assert int(got_opt.step) == int(r_opt.step) == 3
    assert _tree_rel_l2(params_to_numpy(params), r_params) <= L2_TOL
    # the moments carry every step's clipped gradients
    assert _tree_rel_l2(got_opt.m, r_opt.m) <= L2_TOL
    assert _tree_rel_l2(got_opt.v, r_opt.v) <= L2_TOL
    # the parameters moved: a step that skipped the update would not pass
    moved = jax.tree.map(lambda a, b_: a - b_, params_to_numpy(params),
                         _ref_params(arch))
    r_moved = jax.tree.map(lambda a, b_: a - b_, r_params, _ref_params(arch))
    assert _tree_rel_l2(moved, r_moved) <= 1e-2


def test_grad_fn_accumulates_every_microbatch():
    """Two microbatches of 2 rows give the gradient of the whole batch
    (the mean of the two), and the loss is the microbatches' mean."""
    grads, losses = {}, {}
    for mb in (0, 2):
        _, rc = _rc("yi_6b", microbatch=mb)
        b = registry.build(rc, device="cpu")
        params = b.init_params(torch.Generator().manual_seed(0))
        loss, _ = make_grad_fn(b, rc)(params, make_train_batch(rc, 0, "cpu"))
        losses[mb] = float(loss)
        grads[mb] = jax.tree.map(lambda t: t.grad.numpy(), params)
    np.testing.assert_allclose(losses[2], losses[0], rtol=LOSS_TOL)
    assert _tree_rel_l2(grads[2], grads[0]) <= 1e-5


# -- synthetic data ----------------------------------------------------------


@pytest.mark.parametrize("arch,fields", [
    ("yi_6b", {}), ("hymba_1_5b", {}), ("yi_6b", {"embeddings_in": True}),
    ("yi_6b", {"family": "encdec", "max_target_positions": 16})])
@pytest.mark.parametrize("step", [0, 5])
def test_make_train_batch_is_bit_equal(arch, fields, step):
    rrc, rc = _rc(arch, **fields)
    ref = r_make_train_batch(rrc, step)
    got = make_train_batch(rc, step, "cpu")
    assert sorted(got) == sorted(ref)
    for k, v in got.items():
        r = np.asarray(ref[k])
        assert v.dtype == torch.from_numpy(r).dtype, k
        np.testing.assert_array_equal(v.numpy(), r, err_msg=k)


def test_synthetic_frames_are_bit_equal():
    for h, w, c, seed in [(5, 7, 1, 0), (16, 33, 3, 4)]:
        for i in (0, 3):
            np.testing.assert_array_equal(
                SyntheticFrames(h, w, c, seed).frame_np(i),
                RSyntheticFrames(h, w, c, seed).frame_np(i))
        ours, theirs = video_stream(h, w, c, seed), r_video_stream(h, w, c,
                                                                   seed)
        for _ in range(3):
            np.testing.assert_array_equal(next(ours), next(theirs))


# -- the kernel gates refuse a gradient ---------------------------------------


def test_swattn_gradient_is_refused_as_in_the_reference(rng):
    q = rng.standard_normal((1, 16, 2, 16)).astype(np.float32)
    kv = rng.standard_normal((1, 16, 1, 16)).astype(np.float32)
    with pytest.raises(AssertionError):        # the reference: no VJP
        jax.grad(lambda q_: swattn_pallas(
            q_, jnp.asarray(kv), jnp.asarray(kv), window=4).sum())(
                jnp.asarray(q))
    before = SW.swattn.launches
    tq = torch.from_numpy(q).requires_grad_(True)
    tkv = torch.from_numpy(kv)
    with pytest.raises(NotImplementedError, match="no backward kernel"):
        swattn_cuda(tq, tkv, tkv, window=4)
    with pytest.raises(NotImplementedError, match="no backward kernel"):
        swattn_cuda(tq.detach(), tkv.requires_grad_(True), tkv, window=4)
    with torch.no_grad():                      # no gradient asked: fine
        swattn_cuda(tq, tkv, tkv, window=4)
    assert SW.swattn.launches == before


def test_dwconv1d_gradient_is_refused_as_in_the_reference(rng):
    x = rng.standard_normal((1, 16, 6)).astype(np.float32)
    w = rng.standard_normal((6, 4)).astype(np.float32)
    b = np.zeros(6, np.float32)
    with pytest.raises(AssertionError):        # the reference: no VJP
        jax.grad(lambda x_: dwconv1d_pallas(
            x_, jnp.asarray(w), jnp.asarray(b), chunk=8).sum())(
                jnp.asarray(x))
    tx = torch.from_numpy(x)
    before = DW.dwconv1d.launches
    for args in [(tx.clone().requires_grad_(True), torch.from_numpy(w)),
                 (tx, torch.from_numpy(w).requires_grad_(True))]:
        with pytest.raises(NotImplementedError, match="no backward kernel"):
            dwconv1d_cuda(*args, torch.from_numpy(b))
    assert DW.dwconv1d.launches == before


def test_training_through_the_kernel_gate_is_refused():
    """``use_pallas_attn=True`` under a gradient raises; the config's own
    setting (off) trains, with no kernel launch."""
    _, rc = _rc("yi_6b", use_pallas_attn=True)
    b = registry.build(rc, device="cpu")
    params = b.init_params(torch.Generator().manual_seed(0))
    batch = make_train_batch(rc, 0, "cpu")
    with pytest.raises(NotImplementedError, match="no backward kernel"):
        make_grad_fn(b, rc)(params, batch)
    assert all(not x.requires_grad for x in tree_leaves(params))
    _, rc = _rc("yi_6b")
    assert not rc.model.use_pallas_attn
    b = registry.build(rc, device="cpu")
    before = SW.swattn.launches, DW.dwconv1d.launches
    make_train_step(b, rc)(params, adamw_init(params), batch)
    assert (SW.swattn.launches, DW.dwconv1d.launches) == before


# -- the launcher ------------------------------------------------------------


def _launch(*args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *args], env=env,
        capture_output=True, text=True, timeout=240, cwd=ROOT)


def test_launcher_trains_tiny_on_the_cpu(tmp_path):
    out = _launch("--arch", "h2o_danube_1_8b", "--tiny", "--steps", "3",
                  "--seq", "32", "--batch", "4", "--microbatch", "2",
                  "--device", "cpu", "--ckpt-dir", str(tmp_path),
                  "--ckpt-every", "2")
    assert out.returncode == 0, out.stderr
    last = out.stdout.strip().splitlines()[-1]
    assert last.startswith("[train] done: 3 steps, final loss ")
    assert sorted(os.listdir(tmp_path)) == ["step_00000002", "step_00000003"]


@pytest.mark.parametrize("flags", [["--mesh", "1x1"],
                                   ["--grad-compression", "int8_ef"]])
def test_launcher_refuses_what_waits_for_sharding(flags, capsys):
    """``--mesh`` alone goes to ``train_loop(mesh=)``, which no longer
    waits for the SPMD half of the sharding port: it trains (against the
    reference: tests/test_torch_spmd.py); ``int8_ef`` without a mesh is
    an error, as the reference's ``assert`` is (the int8-EF path itself:
    tests/test_torch_dp.py)."""
    from repro_torch.launch import train
    argv = ["--arch", "yi_6b", "--tiny", "--steps", "1", "--device", "cpu",
            *flags]
    if "--mesh" in flags:
        train.main(argv)
        assert capsys.readouterr().out.strip().splitlines()[-1].startswith(
            "[train] done: 1 steps, final loss ")
        return
    with pytest.raises(SystemExit) as exc:
        train.main(argv)
    assert exc.value.code != 0
    assert "int8_ef needs --mesh" in capsys.readouterr().err
