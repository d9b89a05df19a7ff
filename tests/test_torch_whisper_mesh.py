"""Whisper on a mesh: its heads, MLP columns and vocabulary split over
'model', and its self and cross caches along their sequence
(``whisper.tp_plan``), in the mesh train step (``training/spmd.py``),
the mesh prefill and the decode step (``sharding/serve.py``), held
against the unsplit port and the reference.

The blocks, on a tensor-parallel group of two CPU members (a (data 2,
model 2) mesh's), the weights the members' regions of the plan
(``tp.Parts``), against the unsplit port function and the reference's on
the same seeded numpy inputs: the ungated ``mlp2`` with nonzero biases
(``bo`` added once, after the sum); the encoder's non-causal and the
decoder's causal self-attention split by heads; the cross-attention
split by heads against each member's cross K/V; and one query's
cross-attention over two halves of the frames (``decode_partial`` with
``causal=False``), combined, against ``attend`` over every frame.

The slice, against the reference's ``shd=ctx`` runs on ``AxisType.Auto``
host meshes (ROADMAP R2), as ``tests/test_torch_tp.py`` and
``tests/test_torch_serve_mesh.py`` run theirs, in subprocesses side by
side. The weights are ``_torch_parity.reference_init_params`` with the
MLP biases drawn nonzero (``mlp2_specs`` draws them as zeros, where a
bias added once per member would not show), written out for the port.
Tiny whisper (2 + 2 layers, 4 heads, 256 tokens) and a variant whose
heads (5) and vocabulary (257) do not divide 'model' (only the MLP
splits, as whisper-large-v3's 20 heads and 51,866 tokens on 16):

- ``train_loop(mesh=)``, 3 steps: on (data 2, model 2), on (pod 2, data
  2, model 2), at remat 'full' in microbatches of 2, and the variant;
- a prefill (16 frames, a 14-token prompt: its keys fill both members'
  blocks of the 16-slot ring) and 4 decode steps fed the same tokens
  (positions 14 … 17: the ring wraps, its writes cross the blocks' edge),
  the caches put on the decode profile's placement between the calls as
  the reference's are: on (pod 2, data 2, model 2), (data 2, model 2)
  and the variant.

The flops. Each coordinate's ``coord_flops`` against the dot flops of
the reference's compiled per-device HLO of the same cell
(``test_torch_roofline``'s ``hlo_matmul_flops``), tiny whisper: the
train step on (data 2, model 2), the prefill and the decode step on
(pod 2, data 2, model 2). Train and prefill are equal. Decode is equal
after one difference by design (``_by_design``), per coordinate, n = 2
members, rows = its rank's, per layer: a member with a block of the
caches projects the token's query and its out-projection whole, for
the self-attention and the cross-attention alike, where XLA splits
those four projections over the members (the weights are stored split
over heads; the self-attention's keys and values it computes whole on
every device, as the port does): (1 − 1/n) x 2 x rows x D x 4 H x hd.
The dry run's probe counts the first coordinate's. The variant's
per-device HLO count is not held: XLA partitions the products whose
heads and vocabulary do not divide in its own way.

The moves: the prefill's ``all_reduced`` and ``exchanged`` bytes (each
member's cross K/V to the members whose frames they fill, each prompt
key and value to the members whose ring slots they fill) and the decode
step's ``all_reduced`` (the combines of both attentions) against
``roofline.collective_bytes``.

Controls that must fail (``chip_smoke.py``'s phases 16 (e) and 18 (e)
run them on the card): ``bo`` added on every member; the cross cache's
blocks in reversed 'model' order; one member's cross-attention partial
dropped from the combine.

Tolerances: as ``tests/test_torch_tp.py`` and
``tests/test_torch_serve_mesh.py``: a block within rtol = atol = 1e-5 of
the unsplit port's and of the reference's; the train step's loss and
grad norm within relative 1e-5, every parameter and moment within 1e-4
absolute after 3 steps; every logit and cache leaf within rtol = atol =
1e-5, positions equal; flops exactly.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as r_attn
from repro.models import layers as r_layers
from repro_torch.configs.base import SHAPES, RunConfig, TrainConfig, resolve
from repro_torch.configs.tiny import tiny_of
from repro_torch.launch import dryrun
from repro_torch.launch import roofline as R
from repro_torch.models import attention as attn
from repro_torch.models import layers, registry, whisper
from repro_torch.sharding import fsdp, serve
from repro_torch.sharding import tp as tp_mod
from repro_torch.sharding.mesh import make_mesh
from repro_torch.sharding.placement import shard_tree
from repro_torch.sharding.rules import make_ctx
from repro_torch.training import spmd
from repro_torch.training.trainer import train_loop

import test_torch_serve_mesh as SM
import test_torch_spmd as TS
import test_torch_tp as TT

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
HERE = os.path.dirname(__file__)
ARCH = "whisper_large_v3"
TOL = 1e-5
SEQ, B, STEPS = 16, 4, TS.STEPS
PROMPT, DECODE = 14, 4
XLA_FLAGS = TS.XLA_FLAGS
VARIANTS = {"tiny": {},
            "odd": {"num_heads": 5, "num_kv_heads": 5, "vocab_size": 257}}
MESHES = {"dm": ((2, 2), ("data", "model")),
          "pdm": ((2, 2, 2), ("pod", "data", "model"))}
# case -> (variant, mesh, remat, microbatch)
TRAIN = {"tiny-dm": ("tiny", "dm", "none", 0),
         "tiny-pdm": ("tiny", "pdm", "none", 0),
         "tiny-full-mb": ("tiny", "dm", "full", 2),
         "odd-dm": ("odd", "dm", "none", 0)}
# case -> (variant, mesh)
SERVE = {"tiny-pdm": ("tiny", "pdm"), "tiny-dm": ("tiny", "dm"),
         "odd-pdm": ("odd", "pdm")}
# (kind, mesh) of the flops cells, tiny whisper
FLOPS = [("train", "dm"), ("prefill", "pdm"), ("decode", "pdm")]
KIND_SHAPE = {"train": "train_4k", "prefill": "prefill_32k",
              "decode": "decode_32k"}
# the reference's runs, one subprocess a part, side by side
PARTS = {"a": [("train", c) for c in ("tiny-dm", "tiny-full-mb")],
         "b": [("train", c) for c in ("tiny-pdm", "odd-dm")],
         "c": [("serve", c) for c in SERVE] + [("flops", f"{k}/{m}")
                                               for k, m in FLOPS]}

REFERENCE = """
import dataclasses, json, os, re, sys, zlib
sys.path[:0] = [%r, %r]
import numpy as np, jax, jax.numpy as jnp
from _torch_parity import reference_init_params
from repro.configs.base import RunConfig, SHAPES, SINGLE_POD, TrainConfig
from repro.configs.tiny import tiny_of
from repro.launch import dryrun
from repro.models import module, registry
from repro.sharding import rules
from repro.training import trainer
(VARIANTS, MESHES, TRAIN, SERVE, PARTS, KIND_SHAPE, SEQ, B, STEPS, PROMPT,
 DECODE) = %r, %r, %r, %r, %r, %r, %r, %r, %r, %r, %r
out, part = sys.argv[1], sys.argv[2]
%s
AUTO = jax.sharding.AxisType.Auto

def mesh_of(name):
    shape, axes = MESHES[name]
    return jax.make_mesh(shape, axes,
                         devices=jax.devices()[:int(np.prod(shape))],
                         axis_types=(AUTO,) * len(shape))

def biased(params, key):
    for stack in ("encoder", "decoder"):
        for b in ("bi", "bo"):
            leaf = params[stack]["mlp"][b]
            k = jax.random.fold_in(
                key, zlib.crc32(f"{stack}/{b}".encode()) %% (2 ** 31))
            params[stack]["mlp"][b] = leaf + 0.5 * jax.random.normal(
                k, leaf.shape, leaf.dtype)
    return params

build = registry.build
def build_fixed(rc):
    rb = build(rc)
    draw = jax.jit(lambda k: biased(
        reference_init_params(rb.specs, k, jnp.float32), k))
    return dataclasses.replace(rb, init_params=lambda k, dtype=None: draw(k))
trainer.registry.build = build_fixed

def rc_of(variant, shape, remat="none", mb=0):
    return RunConfig(
        model=dataclasses.replace(tiny_of("whisper_large_v3"),
                                  **VARIANTS[variant]),
        mesh=SINGLE_POD,
        shape=dataclasses.replace(SHAPES[shape], seq_len=SEQ,
                                  global_batch=B),
        train=TrainConfig(total_steps=50, warmup_steps=2,
                          remat_policy=remat, microbatch=mb))

def named(params, prefix=()):
    return {"/".join(prefix + p): np.asarray(v)
            for p, v in module.tree_paths(params).items()}

def walk(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from walk(tree[k], prefix + (str(k),))
    else:
        yield "/".join(prefix), np.asarray(tree)

res = {"train": {}, "flops": {}}
for what, case in PARTS[part]:
    if what == "train":
        variant, m, remat, mb = TRAIN[case]
        rc = rc_of(variant, "train_4k", remat, mb)
        rep = trainer.train_loop(rc, num_steps=STEPS, mesh=mesh_of(m),
                                 ckpt_dir=os.path.join(out, case),
                                 ckpt_every=STEPS, log_every=0,
                                 log_fn=lambda *x: None)
        res["train"][case] = rep.final_metrics
        np.savez(os.path.join(out, case + ".init.npz"), **named(
            build_fixed(rc).init_params(jax.random.key(rc.train.seed))))
    elif what == "serve":
        variant, m = SERVE[case]
        mesh = mesh_of(m)
        rc = rc_of(variant, "prefill_32k")
        mc = rc.model
        rb = build_fixed(rc)
        params = rb.init_params(jax.random.key(3))
        rng = np.random.default_rng(5)
        got = named(params, ("params",))
        got["frames"] = rng.standard_normal(
            (B, SEQ, mc.d_model)).astype(np.float32)
        got["toks"] = rng.integers(0, mc.vocab_size,
                                   (B, PROMPT)).astype(np.int32)
        got["steps"] = rng.integers(0, mc.vocab_size,
                                    (B, DECODE)).astype(np.int32)
        tctx = rules.make_ctx(mesh, "train")
        dctx = rules.make_ctx(mesh, "decode")
        batch = {"frames": got["frames"], "dec_tokens": got["toks"]}
        with mesh:
            bsh = dryrun.batch_shardings(
                {k: jax.ShapeDtypeStruct(v.shape, v.dtype)
                 for k, v in batch.items()}, tctx)
            pre = jax.jit(lambda p, b: rb.prefill(p, b, shd=tctx),
                          in_shardings=(tctx.spec_tree_shardings(rb.specs),
                                        bsh))
            logits, caches = pre(params, batch)
            got["prefill"] = np.asarray(logits)
            csh = dryrun.tree_shardings(rb.cache_abstract(B, SEQ),
                                        rb.cache_axes(), dctx)
            caches = jax.device_put(caches, csh)
            ish = dryrun.batch_shardings(
                {"inputs": jax.ShapeDtypeStruct((B, 1), jnp.int32)}, dctx)
            rep = jax.sharding.NamedSharding(mesh,
                                             jax.sharding.PartitionSpec())
            dec = jax.jit(lambda p, x, c, cur: rb.decode_step(
                p, x["inputs"], c, cur, shd=dctx),
                in_shardings=(dctx.spec_tree_shardings(rb.specs), ish, csh,
                              rep))
            for s in range(DECODE):
                lg, caches = dec(params, {"inputs": got["steps"][:, s:s + 1]},
                                 caches, jnp.int32(PROMPT + s))
                caches = jax.device_put(caches, csh)
                got[f"step{s}"] = np.asarray(lg)
        for path, v in walk(caches):
            got["cache/" + path] = v
        np.savez(os.path.join(out, case + ".serve.npz"), **got)
    else:
        kind, m = case.split("/")
        rc = rc_of("tiny", KIND_SHAPE[kind])
        lowered, _ = dryrun.build_lowered(rc, mesh_of(m), kind)
        res["flops"][case] = hlo_matmul_flops(lowered.compile().as_text())
with open(os.path.join(out, part + ".json"), "w") as f:
    json.dump(res, f)
"""


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's runs, one subprocess a part: (the output
    directory, the train steps' metrics by case, the flops by cell)."""
    out = tmp_path_factory.mktemp("whisper_mesh")
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS=XLA_FLAGS)
    script = textwrap.dedent(REFERENCE) % (
        SRC, HERE, VARIANTS, MESHES, TRAIN, SERVE, PARTS, KIND_SHAPE, SEQ, B,
        STEPS, PROMPT, DECODE, TT._hlo_source())
    procs = {p: subprocess.Popen([sys.executable, "-c", script, str(out), p],
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True, env=env)
             for p in PARTS}
    metrics, flops = {}, {}
    for p, proc in procs.items():
        o, e = proc.communicate(timeout=600)
        assert proc.returncode == 0, f"{p}:\nstdout:\n{o}\nstderr:\n{e[-4000:]}"
        with open(out / f"{p}.json") as f:
            got = json.load(f)
        metrics.update(got["train"])
        flops.update(got["flops"])
    return out, metrics, flops


def _model(variant="tiny"):
    return dataclasses.replace(tiny_of(ARCH), **VARIANTS[variant])


def _rc(variant, kind, remat="none", mb=0):
    return RunConfig(model=_model(variant),
                     shape=dataclasses.replace(SHAPES[KIND_SHAPE[kind]],
                                               seq_len=SEQ, global_batch=B),
                     train=TrainConfig(total_steps=50, warmup_steps=2,
                                       remat_policy=remat, microbatch=mb))


def _mesh(name, device="cpu"):
    shape, axes = MESHES[name]
    return make_mesh(shape, axes, [device] * int(np.prod(shape)))


def _close(got, want, tol=TOL, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol, err_msg=what)


# -- the blocks ------------------------------------------------------------------

def _group(profile="train"):
    return tp_mod.TP(make_ctx(_mesh("dm"), profile), ["cpu", "cpu"])


def test_split_mlp2_adds_its_output_bias_once(rng):
    """``wi`` and ``bi`` by columns, ``wo`` by rows, the members'
    products summed and ``bo`` added once after the sum; nonzero biases;
    outputs and gradients against the unsplit port and the reference."""
    D, F = 64, 128
    w = TT._leaves(rng, {"wi": (D, F), "bi": (F,), "wo": (F, D), "bo": (D,)})
    x = torch.from_numpy(rng.standard_normal((2, 8, D)).astype(
        np.float32)).requires_grad_()
    tp = _group()
    plan = layers.mlp_plan(tp, F, gated=False)
    assert set(plan) == {"wi", "bi", "wo"}
    assert plan["bi"] == [(slice(0, 64),), (slice(64, 128),)]
    two = layers.mlp2(x, TT._split(w, plan), tp=tp)
    one = layers.mlp2(x, w)
    ts = [x] + list(w.values())
    TT._close(two.detach(), one.detach())
    for a, b in zip(TT._grads(two, ts), TT._grads(one, ts), strict=True):
        TT._close(a, b)
    want = r_layers.mlp2(jnp.asarray(x.detach().numpy()),
                         {k: jnp.asarray(v.detach().numpy())
                          for k, v in w.items()})
    TT._close(two.detach(), want)


def _attn_inputs(rng, cfg, S=8):
    H, Kv, hd, D = (cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim(),
                    cfg.d_model)
    specs = attn.attn_specs(D, H, Kv, hd)
    w = TT._leaves(rng, {k: s.shape for k, s in specs.items()})
    x = torch.from_numpy(rng.standard_normal((2, S, D)).astype(
        np.float32)).requires_grad_()
    pos = torch.arange(S, dtype=torch.int32)[None].expand(2, S)
    return w, x, pos


def _reference_attention(w, h, q_pos, kv_pos, causal, k_in=None):
    """The reference's attention of the normed ``h`` (its own keys and
    values, or ``k_in``'s: the encoder states the cross K/V project)."""
    j = {k: jnp.asarray(v.detach().numpy()) for k, v in w.items()}
    hj = jnp.asarray(h.detach().numpy())
    q = jnp.einsum("bsd,dhk->bshk", hj, j["wq"])
    src = hj if k_in is None else jnp.asarray(k_in.detach().numpy())
    k = jnp.einsum("bsd,dhk->bshk", src, j["wk"])
    v = jnp.einsum("bsd,dhk->bshk", src, j["wv"])
    H = q.shape[2]
    o = r_attn.attend(q, r_attn.repeat_kv(k, H), r_attn.repeat_kv(v, H),
                      jnp.asarray(q_pos.numpy()), jnp.asarray(kv_pos.numpy()),
                      causal=causal)
    return r_attn.out_project(o, j)


@pytest.mark.parametrize("causal", [False, True])
def test_split_self_attention(causal, rng):
    """The encoder's (non-causal) and the decoder's (causal)
    self-attention split by heads: each member its query heads and the
    key/value heads they read, its rows of the out-projection; summed."""
    cfg = _model()
    w, x, pos = _attn_inputs(rng, cfg)
    tp = _group()
    plan = attn.tp_plan(tp, cfg.num_heads, cfg.num_kv_heads, False)
    assert plan["wq"][1] == (slice(None), slice(2, 4), slice(None))
    ctx = {"pos": pos, "tp": tp, "at": [pos, pos]}
    two = whisper._self_part(TT._split(w, plan), x, ctx, cfg, causal)
    one = whisper._self_part(w, x, {"pos": pos}, cfg, causal)
    ts = [x] + list(w.values())
    TT._close(two.detach(), one.detach())
    for a, b in zip(TT._grads(two, ts), TT._grads(one, ts), strict=True):
        TT._close(a, b)
    TT._close(two.detach(), _reference_attention(w, x, pos, pos, causal))


def test_split_cross_attention(rng):
    """The cross-attention split by heads: each member's query heads
    against its cross K/V (``cross_kv``: its key/value heads over every
    frame), the out-projections summed; gradients into the encoder
    states through each member's K/V."""
    cfg = _model()
    w, x, pos = _attn_inputs(rng, cfg, S=4)
    enc = torch.from_numpy(rng.standard_normal((2, 12, cfg.d_model)).astype(
        np.float32)).requires_grad_()
    enc_pos = torch.arange(12, dtype=torch.int32)[None].expand(2, 12)
    tp = _group()
    plan = attn.tp_plan(tp, cfg.num_heads, cfg.num_kv_heads, False)
    split = TT._split(w, plan)
    k, v = whisper._cross_kv_layer({"wk": split["wk"], "wv": split["wv"]},
                                   enc, tp, {})
    assert k.members == [0, 1] and k[1].shape == (2, 12, 2, 16)
    ctx = {"tp": tp, "cross": {"k": k, "v": v}, "at": [pos, pos],
           "enc_at": [enc_pos, enc_pos]}
    two = whisper._cross_part(split, x, ctx, cfg)
    k1, v1 = whisper._cross_kv_layer({"wk": w["wk"], "wv": w["wv"]}, enc)
    one = whisper._cross_part(w, x, {"tp": None, "cross": {"k": k1, "v": v1},
                                     "pos": pos, "enc_pos": enc_pos}, cfg)
    ts = [x, enc] + list(w.values())
    TT._close(two.detach(), one.detach())
    for a, b in zip(TT._grads(two, ts), TT._grads(one, ts), strict=True):
        TT._close(a, b)
    TT._close(two.detach(),
              _reference_attention(w, x, pos, enc_pos, False, k_in=enc))


def test_cross_partials_combine_to_attend(rng):
    """One query a row over two halves of the frames: each half's
    ``decode_partial(causal=False)`` (no mask: every frame attended),
    combined (``TP.combine``) and summed, equals ``attend`` over every
    frame, and the reference's."""
    Bq, H, hd, S = 2, 4, 16, 12
    q = torch.from_numpy(rng.standard_normal((Bq, 1, H, hd)).astype(
        np.float32))
    k = torch.from_numpy(rng.standard_normal((Bq, S, H, hd)).astype(
        np.float32))
    v = torch.from_numpy(rng.standard_normal((Bq, S, H, hd)).astype(
        np.float32))
    q_pos = torch.full((Bq, 1), 40, dtype=torch.int32)
    kv_pos = torch.arange(S, dtype=torch.int32)[None].expand(Bq, S)
    want = attn.attend(q, k, v, q_pos, kv_pos, causal=False)
    tp = _group("decode")
    halves = [{"k": k[:, :5], "v": v[:, :5]}, {"k": k[:, 5:], "v": v[:, 5:]}]
    parts = [attn.decode_partial(q, h, scale=hd ** -0.5, causal=False)
             for h in halves]
    got = sum(tp.combine(parts, [0, 1])).reshape(Bq, 1, H, hd)
    _close(got, want)
    ref = r_attn.attend(*(jnp.asarray(t.numpy()) for t in (q, k, v, q_pos,
                                                            kv_pos)),
                        causal=False)
    _close(got, ref)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_the_plan_follows_the_constraints(variant):
    """Under ``train``: the heads of all three attentions, both MLPs
    (``bo`` whole) and the tied table by vocabulary where they divide
    'model' (the variant's 5 heads and 257 tokens do not: only the MLP
    splits); under ``decode``: each member with a block of the ring or
    the frames reads that attention whole, the MLP and vocabulary split
    as under ``train``."""
    rc = _rc(variant, "prefill")
    mesh = _mesh("dm", "meta")
    train = spmd.tp_plan(rc, make_ctx(mesh, "train"))
    decode = spmd.tp_plan(rc, make_ctx(mesh, "decode"))
    mlp = {(s, "mlp", k) for s in ("encoder", "decoder")
           for k in ("wi", "bi", "wo")}
    heads = {(s, a, k) for s, a in (("encoder", "attn"),
                                    ("decoder", "self_attn"),
                                    ("decoder", "cross_attn"))
             for k in ("wq", "wk", "wv", "wo")}
    if variant == "tiny":
        assert set(train) == mlp | heads | {("embed", "table")}
        assert train[("decoder", "cross_attn", "wk")][1] == (
            slice(None), slice(None), slice(2, 4), slice(None))
        assert train[("embed", "table")][1] == (slice(128, 256),
                                                slice(None))
    else:
        assert set(train) == mlp
    whole = [(slice(None),) * 4] * 2
    for a in ("self_attn", "cross_attn"):
        for k in ("wq", "wk", "wv", "wo"):
            assert decode[("decoder", a, k)] == whole
    assert not any(p[:2] == ("encoder", "attn") for p in decode)
    assert decode[("decoder", "mlp", "bi")] == [
        (slice(None), slice(0, 64)), (slice(None), slice(64, 128))]
    assert ("decoder", "mlp", "bo") not in decode
    assert (("embed", "table") in decode) == (variant == "tiny")


# -- the slice -----------------------------------------------------------------

@pytest.mark.parametrize("case", list(TRAIN))
def test_train_loop_matches_the_references(ref, case, tmp_path):
    out, metrics, _ = ref
    variant, m, remat, mb = TRAIN[case]
    rc = _rc(variant, "train", remat, mb)
    mesh = _mesh(m)
    assert spmd.tp_plan(rc, make_ctx(mesh, "train")) is not None
    rep = train_loop(rc, num_steps=STEPS, mesh=mesh, log_every=0,
                     params=TS._init(out / f"{case}.init.npz"),
                     ckpt_dir=str(tmp_path), ckpt_every=STEPS)
    assert rep.steps_run == STEPS
    TS._compare((out, metrics), case, rep, tmp_path)


def _serve_run(case, z, count_flops=False, mesh=None):
    """The port's mesh prefill and decode steps of a serving case from
    the reference's weights and inputs: (prefill, decode, rows, caches)."""
    variant, m = SERVE[case]
    rc = _rc(variant, "prefill")
    bundle = registry.build(rc, device="cpu")
    mesh = mesh or _mesh(m)
    tctx, dctx = make_ctx(mesh, "train"), make_ctx(mesh, "decode")
    placed = shard_tree(SM._params(z), tctx.spec_tree_shardings(bundle.specs))
    pre = serve.make_spmd_prefill(bundle, rc, tctx, count_flops)
    dec = serve.make_spmd_decode_step(bundle, rc, dctx, count_flops)
    steps = z["steps"]
    logits, caches = pre(placed, {
        "frames": torch.from_numpy(z["frames"]),
        "dec_tokens": torch.from_numpy(z["toks"])})
    rows = [logits]
    for s in range(steps.shape[1]):
        lg, caches = dec(placed, torch.from_numpy(steps[:, s:s + 1]), caches,
                         PROMPT + s)
        rows.append(lg)
    return pre, dec, rows, caches


@pytest.mark.parametrize("case", list(SERVE))
def test_mesh_serving_matches_the_reference(ref, case):
    out, _, _ = ref
    with np.load(out / f"{case}.serve.npz") as z:
        want = {k: z[k] for k in z.files}
        _, _, rows, caches = _serve_run(case, z)
    _close(rows[0], want["prefill"], what="prefill")
    for s in range(DECODE):
        _close(rows[s + 1], want[f"step{s}"], what=f"step {s}")
    got = dict(SM._walk(caches))
    assert {"cache/" + k for k in got} == {k for k in want
                                           if k.startswith("cache/")}
    for path, x in got.items():
        g, w = x.gather("cpu").numpy(), want["cache/" + path]
        assert g.shape == w.shape and g.dtype == w.dtype, path
        if np.issubdtype(g.dtype, np.floating):
            _close(g, w, what=path)
        else:
            np.testing.assert_array_equal(g, w, err_msg=path)


def _by_design(kind, rows):
    """The port's flops beyond XLA's per device (module note), for one
    coordinate."""
    if kind != "decode":
        return 0
    mc, n = _model(), 2
    return (mc.num_layers * (n - 1) * 2 * rows * mc.d_model * 4
            * mc.num_heads * mc.resolved_head_dim() // n)


@pytest.mark.parametrize("kind,mesh", FLOPS)
def test_every_coordinate_computes_the_references_per_device_flops(
        ref, kind, mesh):
    rc = _rc("tiny", kind)
    m = _mesh(mesh)
    ranks = len(spmd.rank_coords(m, spmd.dp_axes(make_ctx(m, "train"))))
    if kind == "train":
        got = _train_step(rc, m).coord_flops
    else:
        bundle = registry.build(rc, device="cpu")
        params = bundle.init_params(torch.Generator().manual_seed(0))
        placed = shard_tree(params, make_ctx(m, "train").spec_tree_shardings(
            bundle.specs))
        rng = np.random.default_rng(0)
        batch = {"frames": torch.from_numpy(rng.standard_normal(
            (B, SEQ, rc.model.d_model)).astype(np.float32)),
            "dec_tokens": torch.from_numpy(rng.integers(0, 256, (B, 8)))}
        pre = serve.make_spmd_prefill(bundle, rc, make_ctx(m, "train"),
                                      count_flops=True)
        _, caches = pre(placed, batch)
        if kind == "prefill":
            got = pre.coord_flops
        else:
            dec = serve.make_spmd_decode_step(bundle, rc,
                                              make_ctx(m, "decode"),
                                              count_flops=True)
            dec(placed, torch.zeros((B, 1), dtype=torch.long), caches, 8)
            got = dec.coord_flops
    want = ref[2][f"{kind}/{mesh}"]
    assert len(got) == m.size and len(set(got.values())) == 1
    for c, f in got.items():
        assert f > 0
        assert f - _by_design(kind, B // ranks) == want, (c, f, want)
    # the dry run's probe: the first coordinate's count, on meta
    cell = R.count_cell(rc, _mesh(mesh, "meta"), kind, cut=False)
    assert cell["flops"] == got[(0,) * len(m.shape)]


def _train_step(rc, mesh):
    """One counted mesh train step of ``rc`` on ``mesh``."""
    from repro_torch.data import make_train_batch
    from repro_torch.optim import adamw_init
    ctx = make_ctx(mesh, "train")
    bundle = registry.build(rc, device="cpu")
    params = shard_tree(bundle.init_params(torch.Generator().manual_seed(0)),
                        ctx.spec_tree_shardings(bundle.specs))
    bs = {k: ctx.sharding(s.shape, ("act_batch",) + (None,) * (s.ndim - 1))
          for k, s in bundle.input_specs("train").items()}
    step = spmd.make_spmd_train_step(bundle, rc, ctx, count_flops=True)
    step(params, adamw_init(params), make_train_batch(rc, 0, "cpu", mesh, bs))
    return step


# -- the moves, the gathered peak and the controls ------------------------------

def _weights(rc, seed=0):
    """The port's weights for ``rc``, the MLP biases nonzero."""
    bundle = registry.build(rc, device="cpu")
    params = bundle.init_params(torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 1)
    for stack in ("encoder", "decoder"):
        for b in ("bi", "bo"):
            leaf = params[stack]["mlp"][b]
            params[stack]["mlp"][b] = 0.5 * torch.randn(leaf.shape,
                                                        generator=g)
    return bundle, params


def _inputs(mc, seed=3):
    rng = np.random.default_rng(seed)
    batch = {"frames": torch.from_numpy(rng.standard_normal(
        (B, SEQ, mc.d_model)).astype(np.float32)),
        "dec_tokens": torch.from_numpy(rng.integers(0, mc.vocab_size,
                                                    (B, PROMPT)))}
    steps = torch.from_numpy(rng.integers(0, mc.vocab_size, (B, DECODE)))
    return batch, steps


def _one_device(bundle, params, batch, steps):
    logits, caches = bundle.prefill(params, batch)
    rows = [logits]
    for s in range(steps.shape[1]):
        lg, caches = bundle.decode_step(params, steps[:, s:s + 1], caches,
                                        PROMPT + s)
        rows.append(lg)
    return rows, caches


def _on_mesh(rc, bundle, params, batch, steps, mesh):
    tctx, dctx = make_ctx(mesh, "train"), make_ctx(mesh, "decode")
    placed = shard_tree(params, tctx.spec_tree_shardings(bundle.specs))
    pre = serve.make_spmd_prefill(bundle, rc, tctx)
    dec = serve.make_spmd_decode_step(bundle, rc, dctx)
    logits, caches = pre(placed, batch)
    rows = [logits]
    for s in range(steps.shape[1]):
        lg, caches = dec(placed, steps[:, s:s + 1], caches, PROMPT + s)
        rows.append(lg)
    return pre, dec, rows, caches


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_moves_equal_the_rooflines(kind):
    """Tiny whisper on (data 2, model 2) of CPU entries: the call's
    ``all_reduced`` bytes (the split blocks' sums; to decode, both
    attentions' combines) and, to prefill, its ``exchanged`` bytes (each
    member's cross K/V to the members whose frames they fill, the
    prompt's keys and values to the members whose ring slots they fill)
    against the roofline's all-reduce (x 2 on the wire) and all-to-all,
    per computing coordinate; the weights gathered, with the logits'
    blocks, against its all-gather."""
    rc = _rc("tiny", "prefill")
    bundle, params = _weights(rc)
    batch, steps = _inputs(rc.model)
    # the dry run's cells: an 8-token prompt, a step at position S - 1
    batch["dec_tokens"] = batch["dec_tokens"][:, :8]
    pre, dec, _, _ = _on_mesh(rc, bundle, params, batch, steps[:, :1],
                              _mesh("dm"))
    t = (pre if kind == "prefill" else dec).traffic
    reduced = t["all_reduced"].local
    assert t["all_reduced"].moved == 0 and reduced > 0
    got = R.collective_bytes(rc, _mesh("dm", "meta"), kind)
    n = got["ranks"]
    assert n == 4
    assert got["by_kind"]["all-reduce"] == 2 * reduced / n
    if kind == "prefill":
        assert t["exchanged"].local > 0
        assert got["by_kind"]["all-to-all"] == t["exchanged"].local / n
    assert got["by_kind"]["all-gather"] == (
        t["gathered"].local + t["logits"].local) / n


def test_gathered_peak_is_the_plans_weights():
    """Forward only: a coordinate holds its regions of one layer and of
    the leaves outside the stacks, under each profile's plan, less than a
    rank computing alone."""
    rc = _rc("tiny", "prefill")
    bundle, params = _weights(rc)
    batch, steps = _inputs(rc.model)
    mesh = _mesh("dm")
    pre, dec, _, _ = _on_mesh(rc, bundle, params, batch, steps[:, :1], mesh)
    for fn, prof in ((pre, "train"), (dec, "decode")):
        plan = spmd.tp_plan(rc, make_ctx(mesh, prof))
        assert fn.gathered_peak == fsdp.peak_bytes(bundle.specs, plan=plan,
                                                   grads=False)
        assert fn.gathered_peak < fsdp.peak_bytes(bundle.specs, grads=False)


def _worst(rows, caches, want_rows, want_caches):
    return SM._worst(rows, caches, want_rows, want_caches)


def _bias_every_member(monkeypatch):
    """``bo`` added inside each member's part (and not after the sum)."""
    def mlp2(x, params, act=layers._gelu_tanh, tp=None):
        if not isinstance(params["wi"], tp_mod.Parts):
            return layers.mlp2(x, params, act)
        bo = params["bo"].to(x.dtype)
        return tp.run(x, params["wi"].members, lambda m, xm: (
            layers._mlp2_columns(xm, tp_mod.at(params, m), act) + bo))
    monkeypatch.setattr(whisper, "mlp2", mlp2)


def _reversed_cross(monkeypatch):
    """The cross cache's blocks in reversed 'model' order: each member
    holds its mirror's storage under its own frames."""
    keep = serve._Rank.kv

    def kv(rank, tree, axes):
        got = keep(rank, tree, axes)
        if "pos" in tree:
            return got
        ms = list(got.blocks)
        return attn.KVBlocks(dict(zip(ms, [got.blocks[m]
                                           for m in reversed(ms)])),
                             got.spans, got.length)
    monkeypatch.setattr(serve._Rank, "kv", kv)


def _dropped_cross(monkeypatch):
    """The second member's cross-attention partial dropped from every
    combine (its maxima -inf: the combine scales it to nothing)."""
    keep = attn.decode_partial
    calls = [0]

    def partial(q, cache, *, causal=True, **kw):
        mx, l_, o = keep(q, cache, causal=causal, **kw)
        if causal:
            return mx, l_, o
        calls[0] += 1
        if calls[0] % 2:
            return mx, l_, o
        return (torch.full_like(mx, attn.NEG_INF), torch.zeros_like(l_),
                torch.zeros_like(o))
    monkeypatch.setattr(attn, "decode_partial", partial)


CONTROLS = {"bo-every-member": _bias_every_member,
            "reversed-cross-blocks": _reversed_cross,
            "dropped-cross-partial": _dropped_cross}


def test_the_mesh_serves_as_one_device_does():
    """Tiny whisper on (data 2, model 2) of CPU entries against the port
    on one device, the ring wrapping across both members' blocks: every
    row and cache leaf within 1e-5 (the sound run the controls depart
    from)."""
    rc = _rc("tiny", "prefill")
    bundle, params = _weights(rc)
    batch, steps = _inputs(rc.model)
    want_rows, want_caches = _one_device(bundle, params, batch, steps)
    _, _, rows, caches = _on_mesh(rc, bundle, params, batch, steps,
                                  _mesh("dm"))
    assert _worst(rows, caches, want_rows, want_caches) <= TOL


@pytest.mark.parametrize("control", list(CONTROLS))
def test_controls_fail(monkeypatch, control):
    """``chip_smoke.py``'s phase 18 (e) controls, on the CPU: each must
    take the mesh's logits or caches beyond the check's limit."""
    rc = _rc("tiny", "prefill")
    bundle, params = _weights(rc)
    batch, steps = _inputs(rc.model)
    want_rows, want_caches = _one_device(bundle, params, batch, steps)
    CONTROLS[control](monkeypatch)
    _, _, rows, caches = _on_mesh(rc, bundle, params, batch, steps,
                                  _mesh("dm"))
    assert _worst(rows, caches, want_rows, want_caches) > TOL


def test_the_bias_control_fails_the_train_step(monkeypatch):
    """Phase 16 (e)'s control on the CPU: ``bo`` added on every member
    takes the mesh train step's loss away from one device's."""
    rc = _rc("tiny", "train")
    _, params = _weights(rc)

    def run(mesh=None):
        from repro_torch.models.module import tree_map
        return train_loop(rc, num_steps=1, mesh=mesh, log_every=0,
                          device="cpu", params=tree_map(
                              lambda t: t.clone(), params)).final_metrics
    one, two = run(), run(_mesh("dm"))
    assert abs(two["loss"] - one["loss"]) <= TS.METRIC_TOL * one["loss"]
    _bias_every_member(monkeypatch)
    bad = run(_mesh("dm"))
    assert abs(bad["loss"] - one["loss"]) > 10 * TS.METRIC_TOL * one["loss"]


# -- the production cells ------------------------------------------------------

@pytest.mark.parametrize("shape", list(KIND_SHAPE.values()))
def test_production_cells_split_over_model(shape):
    """whisper-large-v3 on 16 x 16 (``meta``): every cell's 'model' group
    computes, a device's matmul flops fall below a rank computing alone
    (the parent's figure), most to decode (its ring and cross cache split
    16 ways), and the cell fits."""
    rep = dryrun.run_cell(ARCH, shape, False)
    mesh = make_mesh((16, 1), ("data", "model"), ["meta"] * 16)
    alone = dryrun.run_cell(ARCH, shape, False, rc=resolve(ARCH, shape),
                            mesh=mesh)
    assert rep["tp_members"] == 16 and alone["tp_members"] == 1
    ratio = rep["matmul_flops_per_device"] / alone["matmul_flops_per_device"]
    assert ratio < (0.25 if shape == "decode_32k" else 1.0), ratio
    assert rep["fits"] is True and rep["all_reduced_bytes_per_device"] > 0
