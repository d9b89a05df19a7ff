"""Tensor parallelism over 'model' in the mesh train step
(``sharding/tp.py``, ``training/spmd.py``), held against the unsplit
port and the reference.

The blocks. Each split block runs on a tensor-parallel group of two CPU
members, the group of a (data 2, model 2) mesh's train profile, its
weights the members' regions of the step's plan (``tp.Parts``), against
the unsplit port function and the reference's function on the same
seeded numpy inputs: attention with its key/value heads split (kv 2),
replicated (kv 1, the GQA group of a member's heads taken from the
replicated weights) and straddling (12 heads over 3 key/value heads:
a member's heads read two of them unevenly), with and without qk-norm;
the gated MLP; the vocabulary-parallel CE with and without z-loss, with
``IGNORE`` labels, tied and untied heads, chunked and the S % chunk
fallback; the embedding lookup split by vocabulary; the MoE block with
its experts split and with expert-TP (3 experts: each expert's columns
split), at a capacity factor that drops assignments (the sentinel slot,
ROADMAP R3).

The slice. ``train_loop(mesh=)`` on (data 2, model 2) against the
reference's ``train_loop(mesh=)`` on ``AxisType.Auto`` host meshes, as
``tests/test_torch_spmd.py`` runs it (one subprocess), 3 steps:
key/value heads split (tiny yi-6b at kv 2, and at remat 'full' in
microbatches of 2); expert-TP (tiny qwen3-moe at 3 experts); experts
split in storage too (``moe_force_ep``); a tied head with z-loss and a
loss chunk that does not divide the sequence (tiny gemma3-4b).

The flops. Each coordinate's ``step.coord_flops`` on (data 2, model 2)
against the dot flops of the reference's compiled per-device HLO of the
same step on the same mesh (``tests/test_torch_roofline.py``'s
``hlo_matmul_flops``), for tiny yi-6b (kv 1 and kv 2) and qwen3-moe. They
are equal after three differences by design, each added exactly
(``_by_design``), per coordinate, n = 2 members, T = its rows x sequence
tokens, per layer where it applies:

- the loss chunk's head projection runs again in backward
  (``chunked_ce_from_hidden`` checkpoints each chunk; the reference's
  scan saves it), as ``tests/test_torch_roofline.py`` names it: one more
  of the member's vocabulary block, 2 x T x D x V / n;
- where the key/value heads do not split over 'model' (kv 1), XLA splits
  the contraction over the model dim D of the K and V projections'
  forward and weight gradient over the members (a partial sum each),
  where a port member runs them whole for the key/value heads its query
  heads read: (1 - 1/n) x 2 (K, V) x 2 (forward, weight gradient) x
  2 x T x D x hd a layer;
- likewise the router (moe): (1 - 1/n) x 2 x 2 x T x D x E a layer.

The coordinates' counts are equal to one another, and the dry run's
probe (``launch/dryrun.py``, one coordinate on ``meta``) counts the
first coordinate's.

The moves: the step's ``all_reduced`` bytes (the members' parts of the
group's sums) against ``roofline.collective_bytes``' all-reduce (x 2 on
the wire), for the kv-split and the tied configs.

Tolerances: as ``tests/test_torch_spmd.py``, float32 loss, aux loss and
grad norm within relative 1e-5 and every parameter and moment within 1e-4
absolute after 3 steps; a block's outputs and gradients within
rtol = atol = 1e-5 of the unsplit port's and of the reference's (the
same products summed in another order, as ``tests/test_torch_moe.py``);
an embedding lookup exactly; flops exactly.
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

from repro.configs import tiny as r_tiny
from repro.models import layers as r_layers
from repro.models import moe as r_moe
from repro.models import transformer as r_tfm
from repro.training import loss as r_loss
from repro_torch.configs.base import SHAPES, RunConfig, TrainConfig
from repro_torch.configs.tiny import tiny_of
from repro_torch.data import make_train_batch
from repro_torch.launch import dryrun
from repro_torch.launch import roofline as R
from repro_torch.models import attention as attn
from repro_torch.models import layers, moe, registry
from repro_torch.models import transformer as tfm
from repro_torch.models.module import tree_leaves
from repro_torch.optim import adamw_init
from repro_torch.sharding.mesh import make_mesh
from repro_torch.sharding.placement import shard_tree
from repro_torch.sharding.rules import make_ctx
from repro_torch.sharding.tp import TP, Parts
from repro_torch.training import loss as p_loss
from repro_torch.training import spmd
from repro_torch.training.loss import IGNORE
from repro_torch.training.trainer import train_loop

import test_torch_roofline as TR
import test_torch_spmd as TS

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
HERE = os.path.dirname(__file__)
BLOCK_TOL = 1e-5
METRIC_TOL = TS.METRIC_TOL
PARAM_TOL = TS.PARAM_TOL
STEPS = TS.STEPS
SEQ = 16
XLA_FLAGS = TS.XLA_FLAGS

# case -> (arch, model overrides, batch, microbatch, remat, z_loss, chunk)
CASES = {
    "kv-split": ("yi_6b", {"num_kv_heads": 2}, 4, 0, "none", 0.0, SEQ),
    "kv-split-full-mb": ("yi_6b", {"num_kv_heads": 2}, 4, 2, "full", 0.0,
                         SEQ),
    "expert-tp": ("qwen3_moe_30b_a3b", {"num_experts": 3}, 4, 0, "none",
                  0.0, SEQ),
    "experts-ep": ("qwen3_moe_30b_a3b", {"moe_force_ep": True}, 4, 0,
                   "none", 0.0, SEQ),
    "tied-z-fallback": ("gemma3_4b", {}, 4, 0, "none", 1e-4, 5),
}
# (arch, overrides) of the flops cases
FLOPS = [("yi_6b", {}), ("yi_6b", {"num_kv_heads": 2}),
         ("qwen3_moe_30b_a3b", {})]


def _key(arch, over):
    return arch + json.dumps(over, sort_keys=True)


REFERENCE = """
import dataclasses, json, os, re, sys
sys.path[:0] = [%r, %r]
import numpy as np, jax, jax.numpy as jnp
from _torch_parity import reference_init_params
from repro.configs.base import RunConfig, SHAPES, SINGLE_POD, TrainConfig
from repro.configs.tiny import tiny_of
from repro.launch import dryrun
from repro.models import module, registry
from repro.training import trainer
CASES, FLOPS, SEQ, STEPS = %r, %r, %r, %r
out = sys.argv[1]
build = registry.build
def build_fixed(rc):
    rb = build(rc)
    draw = jax.jit(lambda k: reference_init_params(rb.specs, k, jnp.float32))
    return dataclasses.replace(rb, init_params=lambda k, dtype=None: draw(k))
trainer.registry.build = build_fixed
AUTO = jax.sharding.AxisType.Auto
mesh = jax.make_mesh((2, 2), ("data", "model"), devices=jax.devices()[:4],
                     axis_types=(AUTO,) * 2)
def rc_of(arch, over, batch, mb, remat, z, chunk):
    return RunConfig(model=dataclasses.replace(tiny_of(arch), **over),
                     shape=dataclasses.replace(SHAPES["train_4k"],
                                               seq_len=SEQ,
                                               global_batch=batch),
                     mesh=SINGLE_POD,
                     train=TrainConfig(total_steps=50, warmup_steps=2,
                                       loss_chunk=chunk, z_loss=z,
                                       remat_policy=remat, microbatch=mb))
%s
res = {"metrics": {}, "flops": {}}
for case, (arch, over, batch, mb, remat, z, chunk) in CASES.items():
    rc = rc_of(arch, over, batch, mb, remat, z, chunk)
    rep = trainer.train_loop(rc, num_steps=STEPS, mesh=mesh,
                             ckpt_dir=os.path.join(out, case),
                             ckpt_every=STEPS, log_every=0,
                             log_fn=lambda *x: None)
    res["metrics"][case] = rep.final_metrics
    params = build_fixed(rc).init_params(jax.random.key(rc.train.seed))
    np.savez(os.path.join(out, case + ".init.npz"), **{
        "/".join(p): np.asarray(v)
        for p, v in module.tree_paths(params).items()})
for arch, over in FLOPS:
    rc = rc_of(arch, over, 4, 0, "none", 0.0, SEQ)
    lowered, _ = dryrun.build_lowered(rc, mesh, "train")
    key = arch + json.dumps(over, sort_keys=True)
    res["flops"][key] = hlo_matmul_flops(lowered.compile().as_text())
with open(os.path.join(out, "ref.json"), "w") as f:
    json.dump(res, f)
"""


def _hlo_source() -> str:
    """``hlo_matmul_flops`` and its patterns, as the roofline test's
    reference script defines them."""
    src = TR.REFERENCE
    return src[src.index("HEAD = re.compile"):src.index(
        'out = {"lowerings"')]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's runs and lowerings, in one subprocess."""
    out = tmp_path_factory.mktemp("tp")
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS=XLA_FLAGS)
    script = textwrap.dedent(REFERENCE) % (SRC, HERE, CASES, FLOPS, SEQ,
                                           STEPS, _hlo_source())
    p = subprocess.run([sys.executable, "-c", script, str(out)],
                       capture_output=True, text=True, env=env, timeout=600)
    assert p.returncode == 0, f"stdout:\n{p.stdout}\nstderr:\n{p.stderr}"
    with open(out / "ref.json") as f:
        return out, json.load(f)


# -- the blocks ------------------------------------------------------------------

def _group():
    """A (data 2, model 2) mesh's train profile, and one rank's group of
    its two 'model' coordinates, both on the CPU."""
    ctx = make_ctx(make_mesh((2, 2), ("data", "model"), ["cpu"] * 4),
                   "train")
    return TP(ctx, ["cpu", "cpu"])


def _parts(w: torch.Tensor, regions) -> Parts:
    return Parts([None if ix is None else w[ix] for ix in regions], regions)


def _split(tree, plan):
    return {k: _parts(v, plan[k]) if k in plan else v
            for k, v in tree.items()}


def _leaves(rng, shapes):
    return {k: torch.from_numpy(
        (rng.standard_normal(s) * 0.2).astype(np.float32)).requires_grad_()
        for k, s in shapes.items()}


def _grads(out, tensors):
    seed = torch.from_numpy(np.random.default_rng(7).standard_normal(
        tuple(out.shape)).astype(np.float32))
    return torch.autograd.grad((out * seed).sum(), tensors)


def _close(got, want, tol=BLOCK_TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=tol, atol=tol)


def _cfgs(arch, **over):
    return (dataclasses.replace(tiny_of(arch), **over),
            dataclasses.replace(r_tiny.tiny_of(arch), **over))


ATTN_CASES = {"kv-split": ("yi_6b", {"num_kv_heads": 2}),
              "kv-replicated": ("yi_6b", {}),
              "kv-straddling": ("yi_6b", {"num_heads": 12, "num_kv_heads": 3,
                                          "head_dim": 8, "d_model": 48}),
              "qk-norm": ("qwen3_moe_30b_a3b", {})}


@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_split_attention(case, rng):
    """The heads split over the members: each its query heads and the
    key/value heads they read, its rows of the out-projection; summed."""
    arch, over = ATTN_CASES[case]
    cfg, rcfg = _cfgs(arch, **over)
    H, Kv, hd, D = (cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim(),
                    cfg.d_model)
    B, S = 2, 8
    specs = attn.attn_specs(D, H, Kv, hd, cfg.use_qk_norm)
    w = _leaves(rng, {k: s.shape for k, s in specs.items()})
    if cfg.use_qk_norm:
        w["q_norm"] = (1.0 + w["q_norm"]).detach().requires_grad_()
        w["k_norm"] = (1.0 + w["k_norm"]).detach().requires_grad_()
    ln = torch.ones(D)
    x = torch.from_numpy(rng.standard_normal((B, S, D)).astype(
        np.float32)).requires_grad_()
    pos = torch.arange(S, dtype=torch.int32)[None].expand(B, S)
    cs = tfm._positions_cos_sin(cfg, pos)
    tp = _group()
    plan = attn.tp_plan(tp, H, Kv, cfg.use_qk_norm)
    assert set(plan) >= {"wq", "wk", "wv", "wo"}
    kv_of = [plan["wk"][m][1] for m in range(2)]
    if case == "kv-split":
        assert kv_of == [slice(0, 1), slice(1, 2)]
    if case == "kv-replicated":
        assert kv_of == [slice(0, 1), slice(0, 1)]
    if case == "kv-straddling":         # heads 0-5 and 6-11, 4 a group
        assert kv_of == [slice(0, 2), slice(1, 3)]
    one = tfm._attention_part({"ln1": {"scale": ln}, "attn": w}, x, cs, pos,
                              cfg, 0)
    two = tfm._attention_part({"ln1": {"scale": ln}, "attn": _split(w, plan)},
                              x, cs, pos, cfg, 0, tp=tp,
                              pos=[(cs, pos)] * 2)
    ts = [x] + list(w.values())
    _close(two.detach(), one.detach())
    for a, b in zip(_grads(two, ts), _grads(one, ts), strict=True):
        _close(a, b)
    lp = {"ln1": {"scale": jnp.asarray(ln.numpy())},
          "attn": {k: jnp.asarray(v.detach().numpy()) for k, v in w.items()}}
    rcs = r_tfm._positions_cos_sin(rcfg, jnp.asarray(pos.numpy()))
    want, _ = r_tfm._attention_part(lp, jnp.asarray(x.detach().numpy()), rcs,
                                    jnp.asarray(pos.numpy()), rcfg, None, 0)
    _close(two.detach(), want)


def test_split_mlp(rng):
    """The MLP's up and gate projections by columns, the down
    projection by rows, summed."""
    D, F = 64, 128
    w = _leaves(rng, {"wi": (D, F), "wg": (D, F), "wo": (F, D)})
    x = torch.from_numpy(rng.standard_normal((2, 8, D)).astype(
        np.float32)).requires_grad_()
    tp = _group()
    plan = layers.mlp_plan(tp, F)
    assert plan["wi"][1] == (slice(None), slice(64, 128))
    two = layers.mlp(x, _split(w, plan), tp=tp)
    one = layers.mlp(x, w)
    ts = [x] + list(w.values())
    _close(two.detach(), one.detach())
    for a, b in zip(_grads(two, ts), _grads(one, ts), strict=True):
        _close(a, b)
    want = r_layers.mlp(jnp.asarray(x.detach().numpy()),
                        {k: jnp.asarray(v.detach().numpy())
                         for k, v in w.items()})
    _close(two.detach(), want)


def test_split_embedding(rng):
    """Each member looks up its vocabulary rows; every row comes from one
    member, so the sum is the lookup exactly."""
    V, D = 256, 16
    table = _leaves(rng, {"t": (V, D)})["t"]
    tok = torch.from_numpy(rng.integers(0, V, (2, 8)))
    tp = _group()
    plan = [(slice(0, 128), slice(None)), (slice(128, 256), slice(None))]
    assert layers.tp_vocab(tp, V) == [(0, slice(0, 128)),
                                      (1, slice(128, 256))]
    two = layers.embed(tok, {"table": _parts(table, plan)}, torch.float32,
                       tp)
    one = layers.embed(tok, {"table": table}, torch.float32)
    assert torch.equal(two, one)
    g2, = _grads(two, [table])
    g1, = _grads(one, [table])
    assert torch.equal(g2, g1)
    want = r_layers.embed(jnp.asarray(tok.numpy()),
                          {"table": jnp.asarray(table.detach().numpy())},
                          jnp.float32)
    np.testing.assert_array_equal(two.detach().numpy(), np.asarray(want))


@pytest.mark.parametrize("tied", [False, True])
@pytest.mark.parametrize("z_loss", [0.0, 1e-3])
@pytest.mark.parametrize("chunk", [8, 5])
def test_vocabulary_parallel_ce(tied, z_loss, chunk, rng):
    """Each member projects its vocabulary block; the row maxima and the
    sums of exponentials are reduced over the members, the target's logit
    comes from the member that holds it, the z-loss squares the global
    log-sum-exp; labels ``IGNORE`` in part; chunk 5 does not divide the
    sequence (the fallback)."""
    B, S, D, V = 2, 16, 32, 256
    h = torch.from_numpy(rng.standard_normal((B, S, D)).astype(
        np.float32)).requires_grad_()
    shape = (V, D) if tied else (D, V)
    w = _leaves(rng, {"w": shape})["w"]
    labels = torch.from_numpy(rng.integers(0, V, (B, S)))
    labels[0, :3] = IGNORE
    labels[1, 7] = IGNORE
    tp = _group()
    blocks = layers.tp_vocab(tp, V)
    plan = [None, None]
    for m, vs in blocks:
        plan[m] = (vs, slice(None)) if tied else (slice(None), vs)
    kw = dict(chunk=chunk, z_loss=z_loss, transpose_head=tied)
    two, d2 = p_loss.chunked_ce_from_hidden(h, _parts(w, plan), labels,
                                            tp=tp, **kw)
    one, d1 = p_loss.chunked_ce_from_hidden(h, w, labels, **kw)
    assert float(d2) == float(d1)
    _close(two.detach(), one.detach())
    for a, b in zip(torch.autograd.grad(two, [h, w]),
                    torch.autograd.grad(one, [h, w]), strict=True):
        _close(a, b)
    want, _ = r_loss.chunked_ce_from_hidden(
        jnp.asarray(h.detach().numpy()), jnp.asarray(w.detach().numpy()),
        jnp.asarray(labels.numpy()), **kw)
    _close(two.detach(), want)


@pytest.mark.parametrize("E,split", [(8, "experts"), (3, "columns")])
@pytest.mark.parametrize("cf", [1.25, 0.5])
def test_split_moe(E, split, cf, rng):
    """Each member routes the rows itself and runs its experts (8 over
    2) or, expert-TP, its columns of every expert (3 experts: they do not
    split); the shares summed after the combine. Capacity factor 0.5
    drops assignments, and the sentinel slot's write (R3) is the same in
    every member's dispatch."""
    B, S, D, F, k = 2, 16, 16, 24, 2
    w = _leaves(rng, {"router": (D, E), "wi": (E, D, F), "wg": (E, D, F),
                      "wo": (E, F, D)})
    x = torch.from_numpy(rng.standard_normal((B, S, D)).astype(
        np.float32)).requires_grad_()
    tp = _group()
    plan = moe.tp_plan(tp, E, F)
    if split == "experts":
        assert plan["wi"][1] == (slice(4, 8), slice(None), slice(0, 24))
    else:
        assert plan["wi"][1] == (slice(0, 3), slice(None), slice(12, 24))
    kw = dict(num_experts=E, k=k, capacity_factor=cf)
    y2, a2 = moe.moe_block(x, _split(w, plan), tp=tp, **kw)
    y1, a1 = moe.moe_block(x, w, **kw)
    _close(y2.detach(), y1.detach())
    assert float(a2) == float(a1)
    ts = [x] + list(w.values())
    for a, b in zip(_grads(y2 + a2, ts), _grads(y1 + a1, ts), strict=True):
        _close(a, b)
    want, waux = r_moe.moe_block(jnp.asarray(x.detach().numpy()),
                                 {n: jnp.asarray(v.detach().numpy())
                                  for n, v in w.items()}, **kw)
    _close(y2.detach(), want)
    _close(a2.detach(), waux)


def test_the_split_is_resolved_from_the_constraints():
    """``ShardingCtx.tp_blocks``: the constraint's ``pspec`` on the
    group's axes, its drops included and not recorded; the group kept
    where the profile splits the sequence over 'model' (``train_sp``,
    ``kv_seq``), none under ``dp_only``; ``constrain`` still raises,
    naming the mesh step."""
    mesh = make_mesh((2, 2), ("data", "model"), ["meta"] * 4)
    ctx = make_ctx(mesh, "train")
    assert ctx.tp_axes() == ("model",) and ctx.tp_size() == 2
    b = ctx.tp_blocks((4, 16, 6, 8), ("act_batch", None, "act_heads", None))
    assert [x[2] for x in b] == [slice(0, 3), slice(3, 6)]
    assert all(x[0] == slice(0, 4) for x in b)   # the rows: the step's
    # 3 experts do not divide 2: the split falls to the experts' columns
    b = ctx.tp_blocks((1, 3, 8, 10), ("act_batch", "act_experts", None,
                                      "act_mlp"))
    assert [x[1] for x in b] == [slice(0, 3)] * 2
    assert [x[3] for x in b] == [slice(0, 5), slice(5, 10)]
    b = ctx.tp_blocks((1, 1, 5), ("act_batch", None, "act_mlp"))
    assert b[0] == b[1] and TP.members(b) == [0]
    assert ctx.dropped == []
    assert make_ctx(mesh, "train_sp").tp_axes() == ("model",)
    assert make_ctx(mesh, "kv_seq").tp_axes() == ("model",)
    assert make_ctx(mesh, "dp_only").tp_axes() == ()
    with pytest.raises(NotImplementedError, match="training/spmd.py"):
        ctx.constrain(torch.zeros(2), "act_batch")
    # every data-parallel rank's group, its own coordinate first
    assert spmd.group_coords(mesh, (1, 0), ("model",)) == [(1, 0), (1, 1)]


# -- the slice -----------------------------------------------------------------

def _rc(arch, over, batch=4, mb=0, remat="none", z=0.0, chunk=SEQ):
    return RunConfig(model=dataclasses.replace(tiny_of(arch), **over),
                     shape=dataclasses.replace(SHAPES["train_4k"],
                                               seq_len=SEQ,
                                               global_batch=batch),
                     train=TrainConfig(total_steps=50, warmup_steps=2,
                                       loss_chunk=chunk, z_loss=z,
                                       remat_policy=remat, microbatch=mb))


@pytest.mark.parametrize("case", list(CASES))
def test_train_loop_with_tensor_parallelism_matches_the_references(
        ref, case, tmp_path):
    out, res = ref
    arch, over, batch, mb, remat, z, chunk = CASES[case]
    rc = _rc(arch, over, batch, mb, remat, z, chunk)
    mesh = make_mesh((2, 2), ("data", "model"), ["cpu"] * 4)
    assert spmd.tp_plan(rc, make_ctx(mesh, "train")) is not None
    rep = train_loop(rc, num_steps=STEPS, mesh=mesh, log_every=0,
                     params=TS._init(out / f"{case}.init.npz"),
                     ckpt_dir=str(tmp_path), ckpt_every=STEPS)
    assert rep.steps_run == STEPS
    TS._compare((out, res["metrics"]), case, rep, tmp_path)


def _step(rc, count_flops=False):
    mesh = make_mesh((2, 2), ("data", "model"), ["cpu"] * 4)
    ctx = make_ctx(mesh, "train")
    bundle = registry.build(rc, device="cpu")
    params = shard_tree(bundle.init_params(torch.Generator().manual_seed(0)),
                        ctx.spec_tree_shardings(bundle.specs))
    bs = {k: ctx.sharding(s.shape, ("act_batch",) + (None,) * (s.ndim - 1))
          for k, s in bundle.input_specs("train").items()}
    step = spmd.make_spmd_train_step(bundle, rc, ctx, count_flops)
    step(params, adamw_init(params), make_train_batch(rc, 0, "cpu", mesh, bs))
    return step


def _by_design(rc):
    """The port's flops beyond XLA's per device, by design (module
    note), for one coordinate of a (data 2, model 2) mesh."""
    mc, n = rc.model, 2
    T = rc.shape.global_batch // 2 * rc.shape.seq_len
    D, hd = mc.d_model, mc.resolved_head_dim()
    extra = 2 * T * D * mc.vocab_size // n
    per_layer = 0
    if mc.num_kv_heads % n:
        reads = 1       # each member's heads read one key/value head here
        per_layer += (n - 1) * 2 * 2 * 2 * T * D * reads * hd // n
    if mc.family == "moe":
        per_layer += (n - 1) * 2 * 2 * T * D * mc.num_experts // n
    return extra + mc.num_layers * per_layer


@pytest.mark.parametrize("arch,over", FLOPS)
def test_every_coordinate_computes_the_references_per_device_flops(
        ref, arch, over):
    rc = _rc(arch, over)
    step = _step(rc, count_flops=True)
    got = step.coord_flops
    want = ref[1]["flops"][_key(arch, over)]
    assert len(got) == 4 and len(set(got.values())) == 1
    for c, f in got.items():
        assert f > 0
        assert f - _by_design(rc) == want, (c, f, want)
    # the dry run's probe: the first coordinate's count, on meta
    cell = R.count_cell(rc, make_mesh((2, 2), ("data", "model"),
                                      ["meta"] * 4), "train", cut=False)
    assert cell["flops"] == got[(0, 0)]


def test_without_a_model_axis_no_coordinate_splits():
    """On (data 2) each rank computes alone: the flops of (data 2, model
    2)'s two members together, less what they repeat, and no sums."""
    rc = _rc("yi_6b", {"num_kv_heads": 2})
    mesh = make_mesh((2,), ("data",), ["cpu"] * 2)
    ctx = make_ctx(mesh, "train")
    assert spmd.tp_plan(rc, ctx) is None
    bundle = registry.build(rc, device="cpu")
    params = shard_tree(bundle.init_params(torch.Generator().manual_seed(0)),
                        ctx.spec_tree_shardings(bundle.specs))
    bs = {k: ctx.sharding(s.shape, ("act_batch",) + (None,) * (s.ndim - 1))
          for k, s in bundle.input_specs("train").items()}
    step = spmd.make_spmd_train_step(bundle, rc, ctx, count_flops=True)
    step(params, adamw_init(params), make_train_batch(rc, 0, "cpu", mesh, bs))
    split = _step(rc, count_flops=True).coord_flops
    assert step.coord_flops[(0,)] == split[(0, 0)] + split[(0, 1)]
    assert step.traffic["all_reduced"].local == 0


@pytest.mark.parametrize("case", ["kv-split", "tied-z-fallback"])
def test_all_reduced_bytes_equal_the_rooflines(case):
    arch, over, batch, mb, remat, z, chunk = CASES[case]
    rc = _rc(arch, over, batch, mb, remat, z, chunk)
    step = _step(rc)
    t = step.traffic["all_reduced"]
    assert t.moved == 0 and t.local > 0
    got = R.collective_bytes(rc, make_mesh((2, 2), ("data", "model"),
                                           ["meta"] * 4), "train")
    assert got["ranks"] == 4
    assert got["by_kind"]["all-reduce"] == 2 * t.local / 4
    rep = dryrun.run_cell(arch, "train_4k", False, rc=rc, mesh=make_mesh(
        (2, 2), ("data", "model"), ["meta"] * 4))
    assert rep["tp_members"] == 2
    # the probe's body: one rank's rows, averaged over its two members
    assert rep["all_reduced_bytes_per_device"] == t.local / 4


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_recomputation_started_on_the_ranks_own_card(monkeypatch, remat):
    """Where the members are distinct cards, each split region the remat
    checkpoint recomputes ends in ``tp._Recompute``, whose backward
    recomputes the region first on the rank's own card's thread. Forced
    here on CPU members, the step is the same, and the mark ran."""
    from repro_torch.sharding import tp as tp_mod
    rc = _rc("yi_6b", {"num_kv_heads": 2}, remat=remat, chunk=8)

    def run():
        mesh = make_mesh((2, 2), ("data", "model"), ["cpu"] * 4)
        ctx = make_ctx(mesh, "train")
        bundle = registry.build(rc, device="cpu")
        params = shard_tree(
            bundle.init_params(torch.Generator().manual_seed(0)),
            ctx.spec_tree_shardings(bundle.specs))
        bs = {k: ctx.sharding(s.shape, ("act_batch",) + (None,) * (
            s.ndim - 1)) for k, s in bundle.input_specs("train").items()}
        step = spmd.make_spmd_train_step(bundle, rc, ctx)
        _, _, m = step(params, adamw_init(params),
                       make_train_batch(rc, 0, "cpu", mesh, bs))
        return step, m, [x.gather("cpu") for x in tree_leaves(params)]

    plain, m0, p0 = run()
    ran = []

    def first(tp, x):
        ran.append(x.requires_grad)
        return tp_mod._Recompute.apply(x) if x.requires_grad else x
    monkeypatch.setattr(tp_mod.TP, "recomputed_first", first)
    marked, m1, p1 = run()
    assert any(ran)
    for k in ("loss", "grad_norm"):
        assert float(m1[k]) == float(m0[k])
    for a, b in zip(p1, p0, strict=True):
        assert torch.equal(a, b)
    assert marked.gathered_peak == plain.gathered_peak
    for k in ("all_reduced", "gathered", "reduce_scattered"):
        assert marked.traffic[k].local == plain.traffic[k].local


def test_gathered_peak_keeps_the_model_blocks():
    """A coordinate holds its region of each split leaf: less than a rank
    that gathers every leaf whole."""
    from repro_torch.sharding import fsdp
    rc = _rc("yi_6b", {"num_kv_heads": 2})
    step = _step(rc)
    specs = registry.build(rc, device="meta").specs
    plan = spmd.tp_plan(rc, make_ctx(make_mesh(
        (2, 2), ("data", "model"), ["meta"] * 4), "train"))
    assert step.gathered_peak == fsdp.peak_bytes(specs, plan=plan)
    assert step.gathered_peak < fsdp.peak_bytes(specs)
    leaves = tree_leaves(specs)
    assert len(leaves) > len(plan)
