"""The recurrent layers split over 'model' (``act_ssm``) in the mesh train
step, prefill and decode step, held against the unsplit port and the
reference.

The blocks. Each split block runs on a tensor-parallel group of two CPU
members, the group of a (data 2, model 2) mesh's train profile, its
weights the members' regions of the plan (``tp.Parts``), against the
unsplit port function and the reference's function on the same seeded
numpy inputs, values and gradients, and streaming from a state (a
prompt, then one step) where the block keeps one: mamba (tiny hymba's:
two heads a member), mamba at 3 heads of 64 channels over two members
of 96 (the blocks cut the middle head, whose two parts scan as heads of
their own width), the mLSTM in its chunkwise form and its step (heads
split), the mLSTM at one head (its memory whole on the first member,
the projections split), and the sLSTM (its scan by heads, its FFN by
columns).

The slice. ``train_loop(mesh=)`` on (data 2, model 2) against the
reference's ``train_loop(mesh=)`` on ``AxisType.Auto`` host meshes, as
``tests/test_torch_tp.py`` runs it (one subprocess), 3 steps: tiny hymba
and tiny xlstm (2 mLSTM + 2 sLSTM layers), and tiny xlstm at remat
'full' in microbatches of 2. Serving: ``make_spmd_prefill`` and 4 steps
of ``make_spmd_decode_step`` against the reference's ``shd=ctx`` prefill
(train profile) and decode step (decode profile) on the same mesh, the
caches placed by ``cache_axes`` between them: last logits, every step's
logits and every cache leaf (the conv states on their members' blocks,
the whole states put together).

The flops. Each coordinate's ``coord_flops`` against the dot flops of
the reference's compiled per-device HLO of the same step
(``tests/test_torch_roofline.py``'s ``hlo_matmul_flops``), train and
prefill, both archs. They are equal after these differences by design,
each added exactly (``_by_design``), per coordinate, n = 2 members,
rows = 2 a rank, S its sequence (hymba's meta tokens included), T =
rows x S, per layer of the kind named:

- the loss chunk's head projection runs again in backward (train; as
  ``tests/test_torch_tp.py``): 2 x rows x 16 x D x V / n;
- mLSTM: XLA projects its storage block of ``up_proj``'s columns, the
  unread second half included (2 d_in / n of them; member 1's block is
  all of that half), where a member projects its d_in / n channels:
  2 x T x D x d_in / n less, in forward, and in train again for the
  input's and the weight's gradients (x 3);
- mLSTM, train: the reference's chunk scan runs the backward of the
  memory's update (C, n) at the chunk's end, which training never reads
  (one chunk at S 16): 2 x T x (H / n) x dh x (dh + 1) less;
- sLSTM, train: the reference's scan takes the gradient of its zero
  initial state through the first step's recurrence: 2 x rows x 4 x
  (d / n) x dh less;
- mamba (hymba), XLA's storage block of ``in_proj``'s columns,
  (2 d_in + 2N + H) / n, against a member's x and z channels and the
  whole B, C, dt tail: 2 x T x D x (2N + H) x (1 - 1/n) more (x 3 to
  train);
- mamba: XLA splits the contraction over the state N of the chunk's
  C·Bᵀ product (and its two gradients), which every member computes
  whole: (1 - 1/n) x 2 x rows x S x S x N more (x 3 to train);
- mamba, train: the reference's SSD scan runs dots the port's autograd
  does not (one chunk): the carry's product with its zero initial state
  and its gradient's contractions over dh, 2 x T x (H / n) x dh x N, and
  over the heads of the decay-masked scores' gradient, 2 x rows x S x S
  x H / n, and four contractions of its 3-operand einsums' gradients
  over dh or N that torch takes as elementwise products, 4 x 2 x T x
  (H / n) x N: less;
- hymba's attention, one key/value head (as ``tests/test_torch_tp.py``):
  XLA splits the K and V projections' contraction over D, (1 - 1/n) x
  2 (K, V) x 2 x T x D x hd more in forward and, to train, again for the
  weight gradient.

The coordinates' counts are equal to one another, and the dry run's
probe counts the first coordinate's.

The moves: the train step's ``all_reduced`` bytes against
``roofline.collective_bytes``' all-reduce (x 2 on the wire) for tiny
xlstm, and the ``states`` bytes (the sLSTM's hidden states put together)
within its all-gather.

The controls of ``chip_smoke.py``'s phases 16 (f) and 18 (f) fail here
too: the norms' mean square from a member's own channels, one member's
``out_proj`` / ``down_proj`` partial dropped, the conv-state blocks
written in reversed 'model' order.

Tolerances: as ``tests/test_torch_tp.py``, float32 loss and grad norm
within relative 1e-5 and every parameter and moment within 1e-4 after 3
steps; a block's outputs and states within rtol = atol = 1e-5 of the
unsplit port's and of the reference's, its gradients within relative L2
1e-4 of the unsplit port's (``tests/test_torch_xlstm.py``'s limit for the
recurrent layers' gradients: the mLSTM's exponential gates take the
members' partial products, summed in another order, to 1e-4 relative
in a few elements of its gate weights' gradient); serving logits and
cache leaves within 1e-5; flops exactly.
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
from repro.models import ssm as r_ssm
from repro.models import xlstm as r_xlstm
from repro_torch.configs.base import SHAPES, RunConfig, TrainConfig
from repro_torch.configs.tiny import tiny_of
from repro_torch.data import make_train_batch
from repro_torch.launch import roofline as R
from repro_torch.models import registry, ssm, xlstm
from repro_torch.models import transformer as tfm
from repro_torch.models.module import tree_paths
from repro_torch.optim import adamw_init
from repro_torch.sharding import serve
from repro_torch.sharding import tp as tp_mod
from repro_torch.sharding.mesh import make_mesh
from repro_torch.sharding.placement import shard_tree
from repro_torch.sharding.rules import make_ctx
from repro_torch.sharding.tp import TP, Parts, take_region
from repro_torch.training import spmd
from repro_torch.training.trainer import train_loop

import test_torch_spmd as TS
import test_torch_tp as TT

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
HERE = os.path.dirname(__file__)
TOL = 1e-5
GRAD_L2_TOL = 1e-4          # tests/test_torch_xlstm.py's L2_TOL
STEPS = TS.STEPS
SEQ = 16
DECODE_STEPS = 4
B = 4
ARCHS = {"hymba": "hymba_1_5b", "xlstm": "xlstm_350m"}
# case -> (arch, batch, microbatch, remat)
CASES = {"hymba": ("hymba_1_5b", 4, 0, "none"),
         "xlstm": ("xlstm_350m", 4, 0, "none"),
         "xlstm-full-mb": ("xlstm_350m", 4, 2, "full")}

REFERENCE = """
import dataclasses, json, os, re, sys
sys.path[:0] = [%r, %r]
import numpy as np, jax, jax.numpy as jnp
from _torch_parity import reference_init_params
from repro.configs.base import RunConfig, SHAPES, SINGLE_POD, TrainConfig
from repro.configs.tiny import tiny_of
from repro.launch import dryrun
from repro.models import module, registry
from repro.sharding import rules
from repro.training import trainer
CASES, ARCHS, SEQ, STEPS, B, DSTEPS = %r, %r, %r, %r, %r, %r
out, part = sys.argv[1], sys.argv[2]
build = registry.build
def build_fixed(rc):
    rb = build(rc)
    draw = jax.jit(lambda k: reference_init_params(rb.specs, k, jnp.float32))
    return dataclasses.replace(rb, init_params=lambda k, dtype=None: draw(k))
trainer.registry.build = build_fixed
AUTO = jax.sharding.AxisType.Auto
mesh = jax.make_mesh((2, 2), ("data", "model"), devices=jax.devices()[:4],
                     axis_types=(AUTO,) * 2)
def rc_of(arch, batch, mb, remat, shape="train_4k"):
    return RunConfig(model=tiny_of(arch),
                     shape=dataclasses.replace(SHAPES[shape], seq_len=SEQ,
                                               global_batch=batch),
                     mesh=SINGLE_POD,
                     train=TrainConfig(total_steps=50, warmup_steps=2,
                                       loss_chunk=SEQ, remat_policy=remat,
                                       microbatch=mb))
%s
def walk(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from walk(tree[k], prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from walk(v, prefix + (str(i),))
    else:
        yield "/".join(prefix), np.asarray(tree)
res = {"metrics": {}, "flops": {}}
if part == "train":
    for case, (arch, batch, mb, remat) in CASES.items():
        rc = rc_of(arch, batch, mb, remat)
        rep = trainer.train_loop(rc, num_steps=STEPS, mesh=mesh,
                                 ckpt_dir=os.path.join(out, case),
                                 ckpt_every=STEPS, log_every=0,
                                 log_fn=lambda *x: None)
        res["metrics"][case] = rep.final_metrics
        params = build_fixed(rc).init_params(jax.random.key(rc.train.seed))
        np.savez(os.path.join(out, case + ".init.npz"), **{
            "/".join(p): np.asarray(v)
            for p, v in module.tree_paths(params).items()})
    for name, arch in ARCHS.items():
        for kind in ("train", "prefill"):
            rc = rc_of(arch, B, 0, "none",
                       "train_4k" if kind == "train" else "prefill_32k")
            lowered, _ = dryrun.build_lowered(rc, mesh, kind)
            res["flops"][name + "/" + kind] = hlo_matmul_flops(
                lowered.compile().as_text())
else:
    name = part
    rc = rc_of(ARCHS[name], B, 0, "none", "prefill_32k")
    rb = registry.build(rc)
    params = jax.jit(lambda k: reference_init_params(
        rb.specs, k, jnp.float32))(jax.random.key(3))
    rng = np.random.default_rng(5)
    P = SEQ - DSTEPS - rc.model.num_meta_tokens
    toks = rng.integers(0, rc.model.vocab_size, (B, P)).astype(np.int32)
    steps = rng.integers(0, rc.model.vocab_size, (B, DSTEPS)).astype(np.int32)
    M = rc.model.num_meta_tokens
    tctx = rules.make_ctx(mesh, "train")
    dctx = rules.make_ctx(mesh, "decode")
    got = {"/".join(("params",) + p): np.asarray(v)
           for p, v in module.tree_paths(params).items()}
    got["toks"], got["steps"] = toks, steps
    with mesh:
        bsh = dryrun.batch_shardings(
            {"inputs": jax.ShapeDtypeStruct((B, P), jnp.int32)}, tctx)
        pre = jax.jit(lambda p, b: rb.prefill(p, b, shd=tctx),
                      in_shardings=(tctx.spec_tree_shardings(rb.specs), bsh))
        logits, caches = pre(params, {"inputs": toks})
        got["prefill"] = np.asarray(logits)
        cab = rb.cache_abstract(B, SEQ)
        csh = dryrun.tree_shardings(cab, rb.cache_axes(), dctx)
        caches = jax.device_put(caches, csh)
        ish = dryrun.batch_shardings(
            {"inputs": jax.ShapeDtypeStruct((B, 1), jnp.int32)}, dctx)
        rep = jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec())
        dec = jax.jit(lambda p, x, c, cur: rb.decode_step(
            p, x["inputs"], c, cur, shd=dctx),
            in_shardings=(dctx.spec_tree_shardings(rb.specs), ish, csh, rep))
        for s in range(DSTEPS):
            lg, caches = dec(params, {"inputs": steps[:, s:s + 1]}, caches,
                             jnp.int32(P + M + s))
            caches = jax.device_put(caches, csh)
            got[f"step{s}"] = np.asarray(lg)
        for path, v in walk(caches):
            got["cache/" + path] = v
    np.savez(os.path.join(out, name + ".npz"), **got)
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
    """The reference's runs and lowerings, in three subprocesses side by
    side: the train steps and the lowerings, and each arch's serving."""
    out = tmp_path_factory.mktemp("ssm_mesh")
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS=TS.XLA_FLAGS)
    script = textwrap.dedent(REFERENCE) % (SRC, HERE, CASES, ARCHS, SEQ,
                                           STEPS, B, DECODE_STEPS,
                                           TT._hlo_source())
    parts = ["train"] + list(ARCHS)
    procs = [subprocess.Popen([sys.executable, "-c", script, str(out), p],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env) for p in parts]
    res = {"metrics": {}, "flops": {}}
    for p, proc in zip(parts, procs):
        o, e = proc.communicate(timeout=900)
        assert proc.returncode == 0, f"stdout:\n{o}\nstderr:\n{e[-4000:]}"
        with open(out / f"{p}.json") as f:
            got = json.load(f)
        for k in res:
            res[k].update(got[k])
    return out, res


# -- the blocks ------------------------------------------------------------------

def _group():
    """One rank's group of a (data 2, model 2) mesh's train profile, its
    two 'model' coordinates both on the CPU."""
    ctx = make_ctx(make_mesh((2, 2), ("data", "model"), ["cpu"] * 4),
                   "train")
    return TP(ctx, ["cpu", "cpu"])


def _weights(rng, specs):
    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        return torch.from_numpy((rng.standard_normal(t.shape) * 0.2).astype(
            np.float32)).requires_grad_()
    return walk(specs)


def _split(tree, plan, path=()):
    if isinstance(tree, dict):
        return {k: _split(v, plan, path + (k,)) for k, v in tree.items()}
    p = plan.get(path)
    if p is None:
        return tree
    return Parts([None if ix is None else take_region(tree, ix) for ix in p],
                 p)


def _jax(tree):
    if isinstance(tree, dict):
        return {k: _jax(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_jax(v) for v in tree)
    return jnp.asarray(tree.detach().numpy())


def _close(got, want, tol=TOL, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol, err_msg=what)


def _conv_parts(conv, channels):
    """A conv state [B, k-1, C] as the members' blocks of its channels."""
    regions = [(slice(None), slice(None), c) for c in channels]
    return Parts([conv[r].clone() for r in regions], regions)


def _leaves(tree):
    return list(tree_paths(tree).values())


# (arch, config overrides, block)
BLOCKS = {
    "mamba": ("hymba_1_5b", {}, "mamba"),
    "mamba-cut-head": ("hymba_1_5b", {"ssm_expand": 3, "mamba_heads": 3},
                       "mamba"),
    "mlstm": ("xlstm_350m", {}, "mlstm"),
    "mlstm-one-head": ("xlstm_350m", {"num_heads": 1}, "mlstm"),
    "slstm": ("xlstm_350m", {}, "slstm"),
}


def _block_setup(case, rng):
    arch, over, kind = BLOCKS[case]
    cfg = dataclasses.replace(tiny_of(arch), **over)
    rcfg = dataclasses.replace(r_tiny.tiny_of(arch), **over)
    D = cfg.d_model
    tp = _group()
    if kind == "mamba":
        specs = ssm.mamba_specs(D, expand=cfg.ssm_expand,
                                heads=cfg.mamba_heads, state=cfg.ssm_state,
                                conv_width=cfg.ssm_conv_width)
        plan = ssm.tp_plan(tp, cfg)
    elif kind == "mlstm":
        specs = xlstm.mlstm_specs(D, heads=cfg.num_heads,
                                  conv_width=cfg.ssm_conv_width)
        plan = xlstm.mlstm_plan(tp, cfg)
    else:
        specs = xlstm.slstm_specs(D, heads=cfg.num_heads,
                                  conv_width=cfg.ssm_conv_width)
        plan = xlstm.slstm_plan(tp, cfg)
    return cfg, rcfg, kind, tp, _weights(rng, specs), plan


def _fns(kind):
    return {"mamba": (ssm.mamba_block, r_ssm.mamba_block,
                      ssm.mamba_state_init),
            "mlstm": (xlstm.mlstm_block, r_xlstm.mlstm_block,
                      xlstm.mlstm_state_init),
            "slstm": (xlstm.slstm_block, r_xlstm.slstm_block,
                      xlstm.slstm_state_init)}[kind]


@pytest.mark.parametrize("case", list(BLOCKS))
def test_split_block(case, rng):
    """Outputs and gradients of the split block against the unsplit port
    and the reference, from no state (training)."""
    cfg, rcfg, kind, tp, w, plan = _block_setup(case, rng)
    port, ref_fn, _ = _fns(kind)
    if case == "mamba-cut-head":        # 96 channels a member, heads of 64
        assert [plan[("norm",)][m][0] for m in range(2)] == [
            slice(0, 96), slice(96, 192)]
        assert ssm.head_runs(slice(96, 192), 64) == [(0, 32, 1, 1, 32),
                                                     (32, 96, 2, 1, 64)]
    if case == "mlstm":
        assert plan[("norm",)] == [(slice(0, 64),), (slice(64, 128),)]
    if case == "mlstm-one-head":        # the memory whole on member 0
        assert ("norm",) not in plan and ("wq",) in plan
    if case == "slstm":
        assert plan[("r",)][1][0] == slice(2, 4)
        assert plan[("w_in",)][1][1] == (slice(32, 64), slice(96, 128),
                                         slice(160, 192), slice(224, 256))
        assert plan[("ffn", "wi")][1] == (slice(None), slice(42, 84))
    x = torch.from_numpy(rng.standard_normal((2, SEQ, cfg.d_model)).astype(
        np.float32)).requires_grad_()
    two, _ = port(x, _split(w, plan), cfg, tp=tp)
    one, _ = port(x, w, cfg)
    _close(two.detach(), one.detach())
    ts = [x] + _leaves(w)
    seed = torch.from_numpy(np.random.default_rng(7).standard_normal(
        tuple(one.shape)).astype(np.float32))
    for a, b in zip(torch.autograd.grad((two * seed).sum(), ts),
                    torch.autograd.grad((one * seed).sum(), ts),
                    strict=True):
        assert float((a - b).norm() / b.norm()) <= GRAD_L2_TOL
    want, _ = ref_fn(jnp.asarray(x.detach().numpy()), _jax(w), rcfg)
    _close(two.detach(), want)


def _state_view(kind, st, plan):
    """A state as the mesh hands it to the split block: the mamba and
    mLSTM conv states as the members' blocks, the rest whole."""
    view = dict(st)
    if kind in ("mamba", "mlstm") and plan:
        # the members' channels: the conv's rows in either block's plan
        view["conv"] = _conv_parts(st["conv"], [
            ix[0] for ix in plan[("conv", "w")]])
    return view


def _states_close(kind, got, want, plan, what):
    if isinstance(got["conv"], Parts):
        for m in got["conv"].members:
            c = got["conv"].index[m][2]
            _close(got["conv"][m], want["conv"][..., c], what=what + " conv")
    else:
        _close(got["conv"], want["conv"], what=what + " conv")
    key = {"mamba": "ssm", "mlstm": "mlstm", "slstm": "slstm"}[kind]
    a = got[key] if isinstance(got[key], tuple) else (got[key],)
    b = want[key] if isinstance(want[key], tuple) else (want[key],)
    for x, y in zip(a, b, strict=True):
        _close(x, y, what=f"{what} {key}")


@pytest.mark.parametrize("case", list(BLOCKS))
def test_split_block_streams_from_a_state(case, rng):
    """A prompt from a random state, then one step (mamba's ``ssd_step``,
    the mLSTM's ``_mlstm_step``, the sLSTM's step): outputs and every
    state leaf against the unsplit port and the reference."""
    cfg, rcfg, kind, tp, w, plan = _block_setup(case, rng)
    port, ref_fn, init = _fns(kind)
    gen = torch.Generator().manual_seed(1)

    def randomise(t):
        if isinstance(t, tuple):
            return tuple(randomise(u) for u in t)
        return torch.randn(t.shape, generator=gen) * 0.3
    st = {k: randomise(v) for k, v in init(cfg, 2, device="cpu").items()}
    if kind == "mlstm":                 # m is a log scale: keep it finite
        C, n, m = st["mlstm"]
        st["mlstm"] = (C, n.abs() + 1.0, m)
    if kind == "slstm":
        c, n, h, m = st["slstm"]
        st["slstm"] = (c, n.abs() + 1.0, h, m)
    sw = _split(w, plan)
    x = torch.from_numpy(rng.standard_normal((2, SEQ, cfg.d_model)).astype(
        np.float32))
    with torch.no_grad():
        s1, s2 = st, _state_view(kind, st, plan)
        rs = _jax(st)
        for step, xs in enumerate((x, x[:, :1])):
            one, s1 = port(xs, w, cfg, state_in=s1)
            two, s2 = port(xs, sw, cfg, state_in=s2, tp=tp)
            want, rs = ref_fn(jnp.asarray(xs.numpy()), _jax(w), rcfg,
                              state_in=rs)
            _close(two, one, what=f"{case} {step}")
            _close(two, want, what=f"{case} {step} reference")
            _states_close(kind, s2, s1, plan, f"{case} {step}")
            _states_close(kind, s2, {k: np.asarray(v) if not isinstance(
                v, tuple) else tuple(np.asarray(u) for u in v)
                for k, v in rs.items()}, plan, f"{case} {step} reference")


@pytest.mark.parametrize("scale", [0.5, 40.0])
def test_ssd_gradient_where_the_decay_overflows(scale, rng):
    """The SSD chunk's decay-masked scores exp(P_t - P_s): above the
    diagonal P_t - P_s > 0 overflows to inf once a chunk's decays sum past
    ~88 (hymba-1.5b at full width, 128-token chunks, on the card), and a
    mask after the exp gives backward inf x 0 = NaN. The port masks before
    the exp: the forward is the reference's, and the gradients are the
    reference's where its are finite (``scale`` 0.5) and finite where the
    reference's are NaN (40)."""
    B, S, H, dh, N = 2, 32, 2, 4, 3
    x = rng.standard_normal((B, S, H, dh)).astype(np.float32)
    dt = (np.abs(rng.standard_normal((B, S, H))) * scale).astype(np.float32)
    A = -np.ones(H, np.float32)
    Bm = rng.standard_normal((B, S, N)).astype(np.float32)
    Cm = rng.standard_normal((B, S, N)).astype(np.float32)
    ts = [torch.from_numpy(a).requires_grad_() for a in (x, dt, Bm, Cm)]
    y, _ = ssm.ssd_chunked(ts[0], ts[1], torch.from_numpy(A), ts[2], ts[3],
                           chunk=S)
    grads = torch.autograd.grad(y.sum(), ts)
    import jax
    ry = r_ssm.ssd_chunked(*(jnp.asarray(a) for a in (x, dt, A, Bm, Cm)),
                           chunk=S)[0]
    # outputs of ~1e2 at scale 40, their float32 sums in another order
    _close(y.detach(), ry, tol=TOL if scale < 1 else 1e-4)
    rg = jax.grad(lambda x_, d_, b_, c_: r_ssm.ssd_chunked(
        x_, d_, jnp.asarray(A), b_, c_, chunk=S)[0].sum(),
        argnums=(0, 1, 2, 3))(*(jnp.asarray(a) for a in (x, dt, Bm, Cm)))
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    if scale < 1:
        for g, r in zip(grads, rg, strict=True):
            _close(g, r, tol=1e-4)
    else:
        assert not all(bool(np.isfinite(np.asarray(r)).all()) for r in rg)


def test_the_splits_include_the_recurrent_inner_dim():
    """``act_ssm`` is split under the train and decode profiles (and the
    EP overrides), never under ``dp_only``; the plan covers every
    recurrent leaf the reference's per-device program splits."""
    from repro_torch.sharding.rules import EP_OVERRIDES
    mesh = make_mesh((2, 2), ("data", "model"), ["meta"] * 4)
    for prof in ("train", "decode"):
        assert "act_ssm" in make_ctx(mesh, prof).tp_splits()
    ep = make_mesh((2, 2, 2), ("data", "expert", "model"), ["meta"] * 8)
    assert "act_ssm" in make_ctx(ep, "train", EP_OVERRIDES).tp_splits()
    assert make_ctx(mesh, "dp_only").tp_splits() == ()
    ctx = make_ctx(mesh, "train")
    for arch, want in (
            ("hymba_1_5b", {("mamba", k) for k in (
                "in_proj", "A_log", "dt_bias", "D", "norm", "out_proj")}
             | {("mamba", "conv", "w"), ("mamba", "conv", "b")}),
            ("xlstm_350m", {("mlstm", k) for k in (
                "up_proj", "wq", "wk", "wv", "wi", "wf", "wo_gate", "norm",
                "down_proj")} | {("mlstm", "conv", "w"),
                                 ("mlstm", "conv", "b")}
             | {("slstm", k) for k in ("w_in", "b", "r")}
             | {("slstm", "ffn", k) for k in ("wi", "wg", "wo")})):
        rc = _rc(arch)
        plan = spmd.tp_plan(rc, ctx)
        got = {p[1:] for p in plan if p[0].startswith("stage_")
               and p[1] in ("mamba", "mlstm", "slstm")}
        assert got == want, arch
        for p, regions in plan.items():
            assert all(ix is not None for ix in regions), p


# -- the slice -----------------------------------------------------------------

def _rc(arch, batch=B, mb=0, remat="none", shape="train_4k", seq=SEQ):
    return RunConfig(model=tiny_of(arch),
                     shape=dataclasses.replace(SHAPES[shape], seq_len=seq,
                                               global_batch=batch),
                     train=TrainConfig(total_steps=50, warmup_steps=2,
                                       loss_chunk=SEQ, remat_policy=remat,
                                       microbatch=mb))


@pytest.mark.parametrize("case", list(CASES))
def test_train_loop_with_split_recurrent_layers_matches_the_references(
        ref, case, tmp_path):
    out, res = ref
    arch, batch, mb, remat = CASES[case]
    rc = _rc(arch, batch, mb, remat)
    mesh = make_mesh((2, 2), ("data", "model"), ["cpu"] * 4)
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


def _serve_run(rc, params, toks, steps, mesh, count_flops=False):
    """The port's mesh prefill and the decode steps: (prefill, decode,
    [prefill logits, step logits...], caches)."""
    bundle = registry.build(rc, device="cpu")
    tctx, dctx = make_ctx(mesh, "train"), make_ctx(mesh, "decode")
    placed = shard_tree(params, tctx.spec_tree_shardings(bundle.specs))
    pre = serve.make_spmd_prefill(bundle, rc, tctx, count_flops)
    dec = serve.make_spmd_decode_step(bundle, rc, dctx, count_flops)
    logits, caches = pre(placed, {"inputs": torch.as_tensor(toks)})
    rows = [logits]
    P, M = toks.shape[1], rc.model.num_meta_tokens
    for s in range(steps.shape[1]):
        lg, caches = dec(placed, torch.as_tensor(steps[:, s:s + 1]), caches,
                         P + M + s)
        rows.append(lg)
    return pre, dec, rows, caches


def _serve_rc(arch):
    return _rc(arch, shape="prefill_32k")


@pytest.mark.parametrize("name", list(ARCHS))
def test_mesh_serving_with_split_recurrent_layers_matches_the_reference(
        ref, name):
    from test_torch_serve_mesh import _params, _walk
    out, _ = ref
    with np.load(out / f"{name}.npz") as z:
        want = {k: z[k] for k in z.files}
        params = _params(z)
    mesh = make_mesh((2, 2), ("data", "model"), ["cpu"] * 4)
    _, _, rows, caches = _serve_run(_serve_rc(ARCHS[name]), params,
                                    want["toks"], want["steps"], mesh)
    _close(rows[0], want["prefill"], what="prefill")
    for s in range(DECODE_STEPS):
        _close(rows[s + 1], want[f"step{s}"], what=f"step {s}")
    got = dict(_walk(caches))
    assert {"cache/" + k for k in got} == {k for k in want
                                           if k.startswith("cache/")}
    for path, x in got.items():
        g = x.gather("cpu").numpy()
        w = want["cache/" + path]
        assert g.shape == w.shape and g.dtype == w.dtype, path
        if np.issubdtype(g.dtype, np.floating):
            _close(g, w, what=path)
        else:
            np.testing.assert_array_equal(g, w, err_msg=path)


def _by_design(arch, kind):
    """The port's flops beyond XLA's per device (module note), for one
    coordinate of a (data 2, model 2) mesh."""
    mc, n, rows = tiny_of(arch), 2, B // 2
    D, V = mc.d_model, mc.vocab_size
    S = SEQ + mc.num_meta_tokens
    T = rows * S
    train = kind == "train"
    times = 3 if train else 1
    out = 2 * rows * SEQ * D * V // n if train else 0
    kinds = [st.kind for st in tfm.make_stages(mc)
             for _ in range(st.count)]
    for k in kinds:
        if k == "mlstm":
            d_in, H = 2 * D, mc.num_heads
            dh = d_in // H
            out -= times * 2 * T * D * d_in // n
            if train:
                out -= 2 * T * (H // n) * dh * (dh + 1)
        if k == "slstm":
            d, H = D, mc.num_heads
            if train:
                out -= 2 * rows * 4 * (d // n) * (d // H)
        if k == "hymba":
            d_in, N, H = mc.ssm_expand * D, mc.ssm_state, mc.mamba_heads
            dh, hd = d_in // H, mc.resolved_head_dim()
            out += times * 2 * T * D * (2 * N + H) * (n - 1) // n
            out += times * (n - 1) * 2 * rows * S * S * N // n
            if train:
                out -= 2 * T * (H // n) * dh * N
                out -= 2 * rows * S * S * H // n
                out -= 4 * 2 * T * (H // n) * N
            # one key/value head: XLA splits K and V's contraction over D
            out += (2 if train else 1) * (n - 1) * 2 * 2 * T * D * hd // n
    return out


FLOPS = [(a, k) for a in ARCHS for k in ("train", "prefill")]


@pytest.mark.parametrize("name,kind", FLOPS)
def test_every_coordinate_computes_the_references_per_device_flops(
        ref, name, kind):
    arch = ARCHS[name]
    want = ref[1]["flops"][f"{name}/{kind}"]
    mesh = make_mesh((2, 2), ("data", "model"), ["cpu"] * 4)
    meta = make_mesh((2, 2), ("data", "model"), ["meta"] * 4)
    if kind == "train":
        rc = _rc(arch)
        got = _step(rc, count_flops=True).coord_flops
    else:
        rc = _serve_rc(arch)
        bundle = registry.build(rc, device="cpu")
        params = bundle.init_params(torch.Generator().manual_seed(0))
        toks = np.zeros((B, SEQ), dtype=np.int64)
        pre, _, _, _ = _serve_run(rc, params, toks, toks[:, :0], mesh,
                                  count_flops=True)
        got = pre.coord_flops
    assert len(got) == 4 and len(set(got.values())) == 1, got
    for c, f in got.items():
        assert f > 0
        assert f - _by_design(arch, kind) == want, (c, f, want)
    cell = R.count_cell(rc, meta, kind, cut=False)
    assert cell["flops"] == got[(0, 0)]


def test_moves_equal_the_rooflines():
    """Tiny xlstm's train step: the ``all_reduced`` bytes (the split
    blocks' sums, the mLSTM's partial products and its norm's sums of
    squares included) against the roofline's all-reduce (x 2 on the
    wire), per computing coordinate; the sLSTM's hidden states put
    together (``states``) within its all-gather."""
    rc = _rc("xlstm_350m")
    step = _step(rc)
    t = step.traffic
    assert t["all_reduced"].moved == 0 and t["all_reduced"].local > 0
    assert t["states"].local > 0
    meta = make_mesh((2, 2), ("data", "model"), ["meta"] * 4)
    got = R.collective_bytes(rc, meta, "train")
    assert got["ranks"] == 4
    assert got["by_kind"]["all-reduce"] == 2 * t["all_reduced"].local / 4
    moves = R.combine(R.class_counts(rc, meta, "train"))
    assert moves["states"] * 2 == t["states"].local


@pytest.mark.parametrize("arch", list(ARCHS.values()))
def test_recomputation_started_on_the_ranks_own_card(monkeypatch, arch):
    """Under remat 'full' each recomputed layer, its new sums inside
    (the partial products, the norms' sums of squares, the sLSTM's hidden
    states put together), ends in ``tp._Recompute`` where the members are
    distinct cards. Forced here on CPU members, the step is the same, and
    the mark ran."""
    from repro_torch.models.module import tree_leaves
    rc = _rc(arch, remat="full")

    def stepped(rc_):
        mesh = make_mesh((2, 2), ("data", "model"), ["cpu"] * 4)
        ctx = make_ctx(mesh, "train")
        bundle = registry.build(rc_, device="cpu")
        params = shard_tree(
            bundle.init_params(torch.Generator().manual_seed(0)),
            ctx.spec_tree_shardings(bundle.specs))
        bs = {k: ctx.sharding(s.shape, ("act_batch",) + (None,) * (
            s.ndim - 1)) for k, s in bundle.input_specs("train").items()}
        step = spmd.make_spmd_train_step(bundle, rc_, ctx)
        _, _, m = step(params, adamw_init(params),
                       make_train_batch(rc_, 0, "cpu", mesh, bs))
        return m, [x.gather("cpu") for x in tree_leaves(params)]

    m0, p0 = stepped(rc)
    ran = []

    def first(tp, x):
        ran.append(x.requires_grad)
        return tp_mod._Recompute.apply(x) if x.requires_grad else x
    monkeypatch.setattr(tp_mod.TP, "recomputed_first", first)
    m1, p1 = stepped(rc)
    assert any(ran)
    for k in ("loss", "grad_norm"):
        assert float(m1[k]) == float(m0[k])
    for a, b in zip(p1, p0, strict=True):
        assert torch.equal(a, b)


def test_gathered_peak_counts_the_regions():
    """A coordinate holds its regions of the split recurrent leaves (the
    mamba ``in_proj``'s three slices counted as gathered): the step's
    peak equals ``fsdp.peak_bytes`` of the plan, below the unsplit's."""
    from repro_torch.sharding import fsdp
    for arch in ARCHS.values():
        rc = _rc(arch)
        step = _step(rc)
        specs = registry.build(rc, device="meta").specs
        plan = spmd.tp_plan(rc, make_ctx(make_mesh(
            (2, 2), ("data", "model"), ["meta"] * 4), "train"))
        assert step.gathered_peak == fsdp.peak_bytes(specs, plan=plan)
        assert step.gathered_peak < fsdp.peak_bytes(specs)


# -- the chip's controls, on the CPU ------------------------------------------

def _own_mean_square(tp, parts, members, width):
    n = len(members)
    return [(t * t).sum(dim=-1, keepdim=True) / (width / n) for t in parts]


def _dropped_partial(tp, parts, members):
    kept = list(parts[:-1]) + [torch.zeros_like(parts[-1])]
    return tp.all_reduce(kept, members)


def _reversed_blocks(self, x, axes):
    got = KEEP_BLOCKS(self, x, axes)
    if got is None:
        return None
    return Parts(got.tensors[::-1], got.index)


KEEP_BLOCKS = serve._Rank.blocks
TRAIN_CONTROLS = {"own-mean-square": (TP, "mean_square", _own_mean_square),
                  "dropped-partial": (TP, "row_sum", _dropped_partial)}
SERVE_CONTROLS = {"reversed-conv-blocks": (serve._Rank, "blocks",
                                           _reversed_blocks),
                  "dropped-partial": (TP, "row_sum", _dropped_partial)}


def _one_device_step(rc):
    bundle = registry.build(rc, device="cpu")
    params = bundle.init_params(torch.Generator().manual_seed(0))
    batch = make_train_batch(rc, 0, "cpu")
    loss, _ = bundle.loss_fn(params, batch, loss_chunk=rc.train.loss_chunk)
    return float(loss)


@pytest.mark.parametrize("arch", list(ARCHS.values()))
@pytest.mark.parametrize("control", list(TRAIN_CONTROLS))
def test_phase_16f_controls_fail(monkeypatch, arch, control):
    """``chip_smoke.py``'s phase 16 (f) controls: each takes the mesh
    step's loss beyond the check's limit of one device's."""
    rc = _rc(arch)
    want = _one_device_step(rc)
    mesh = make_mesh((2, 2), ("data", "model"), ["cpu"] * 4)
    ctx = make_ctx(mesh, "train")

    def loss():
        bundle = registry.build(rc, device="cpu")
        params = shard_tree(
            bundle.init_params(torch.Generator().manual_seed(0)),
            ctx.spec_tree_shardings(bundle.specs))
        bs = {k: ctx.sharding(s.shape, ("act_batch",) + (None,) * (
            s.ndim - 1)) for k, s in bundle.input_specs("train").items()}
        step = spmd.make_spmd_train_step(bundle, rc, ctx)
        _, _, m = step(params, adamw_init(params),
                       make_train_batch(rc, 0, "cpu", mesh, bs))
        return float(m["loss"])
    assert abs(loss() - want) <= TOL * abs(want)
    obj, name, fn = TRAIN_CONTROLS[control]
    monkeypatch.setattr(obj, name, fn)
    assert abs(loss() - want) > TOL * abs(want)


@pytest.mark.parametrize("arch", list(ARCHS.values()))
@pytest.mark.parametrize("control", list(SERVE_CONTROLS))
def test_phase_18f_controls_fail(monkeypatch, arch, control):
    """``chip_smoke.py``'s phase 18 (f) controls: each takes the mesh's
    logits or its states beyond the check's limit."""
    rc = _serve_rc(arch)
    bundle = registry.build(rc, device="cpu")
    params = bundle.init_params(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    P = SEQ - DECODE_STEPS - rc.model.num_meta_tokens
    toks = rng.integers(0, 256, (B, P))
    steps = rng.integers(0, 256, (B, DECODE_STEPS))
    mesh = make_mesh((2, 2), ("data", "model"), ["cpu"] * 4)
    _, _, base_rows, base_caches = _serve_run(rc, params, toks, steps, mesh)
    obj, name, fn = SERVE_CONTROLS[control]
    monkeypatch.setattr(obj, name, fn)
    _, _, rows, caches = _serve_run(rc, params, toks, steps, mesh)
    worst = max(float((a - b).abs().max()) for a, b in zip(rows, base_rows))
    from test_torch_serve_mesh import _walk
    for (p, x), (_, y) in zip(_walk(caches), _walk(base_caches)):
        g, w = x.gather("cpu"), y.gather("cpu")
        if g.is_floating_point():
            worst = max(worst, float((g - w).abs().max()))
    assert worst > TOL
