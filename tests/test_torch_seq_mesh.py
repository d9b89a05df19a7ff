"""Sequence parallelism (``train_sp``) and context parallelism
(``kv_seq``) over 'model' in the mesh train step and the mesh prefill,
held against the port on one device and against the reference.

The partial. ``attention.attend_partial`` over each block of the keys,
joined by ``tp.TP.combine``, equals ``attend`` over the whole, values
and gradients, for any split of the keys (a hypothesis test): causal
or not, a window with and without sinks, META and PAD keys, a softcap,
and a block every key of which some row may not attend (causal rows
before the block's first key, rows outside the window), which combines
to nothing with no NaN either way.

The slice. For tiny h2o-danube, qwen2-vl, qwen3-moe, hymba and whisper
on (data 2, model 2) under each profile: two steps of
``make_spmd_train_step`` from the reference's initial weights against
two steps of the port's one-device ``make_train_step`` and two steps of
the reference's ``make_train_step(shd=ctx)`` jitted on an ``Auto``-axes
host mesh under the same profile (R2): each step's loss and grad norm
within relative 1e-5, and the parameters after the second within
relative L2 1e-5 over the whole tree and 1e-4 element by element (the
mesh suites' bound: ``_params_close``);
``make_spmd_prefill`` against the reference's ``shd=ctx`` prefill: the
last logits and every cache leaf within 1e-5. Both profiles keep a
rank's group of two members; ``dp_only`` none.

The flops. Each coordinate's ``coord_flops`` against the dot flops of
the reference's compiled per-device HLO of the same step (the
reference's ``hlo_matmul_flops``, ``tests/test_torch_roofline.py``), at
remat 'none', train and prefill, for h2o-danube, qwen2-vl, qwen3-moe,
hymba (its recurrent terms as ``tests/test_torch_ssm_mesh.py`` names
them) and whisper under ``train_sp`` (equal with no term). They are
equal after these
differences by design, each added exactly (``_by_design``), per
coordinate, n = 2 members, rows = 2 a rank, S its sequence (hymba's meta
tokens included), T = rows x S, per layer where it applies:

- the loss chunk's head projection runs again in backward (train; as
  ``tests/test_torch_tp.py``): 2 x rows x 16 x D x V / n (under
  ``train_sp`` a member's tokens over the whole vocabulary, under
  ``kv_seq`` every token over its vocabulary block: the same count);
- ``kv_seq``, train: XLA takes the out-projection's input gradient for
  every head over every token (it gathers the projection's weights, not
  the gradient), where a member takes its heads': (1 − 1/n) x 2 x T x H
  x hd x D less in the port;
- the MoE router: XLA routes a member's tokens (T / n of them), where a
  port member routes the gathered tokens: (1 − 1/n) x 2 x T x D x E
  more a product (forward; to train, its input's and weight's gradients
  too, x 3).

Held by value only: whisper under ``kv_seq`` (its three attentions split
over the members' blocks of the tokens and frames; XLA's HLO projects
the queries over every head, on a member's tokens and again on every
token, which the port does not; ``ROADMAP.md`` §1). Under ``train_sp``
hymba's mamba part runs on the sequence gathered on the first member,
its channels split as under ``train`` (XLA scans a member's tokens with
every channel), and whisper's residual stream stays whole there, its
heads, columns and vocabulary split as under ``train``: a coordinate's
dots are XLA's all the same.

The EP check. A coordinate of (data 2, expert 2, model 2) with the EP
overrides and tiny qwen3-moe (``moe_force_ep``) against the reference's
per-device HLO, after the terms of ``tests/test_torch_tp.py`` with the
group of four: the head recompute, and the router's and the one
key/value head's split contractions.

The controls of ``chip_smoke.py``'s phase 16 (g) fail here too: under
``kv_seq`` one member's partial dropped from the combine, or a member's
key positions taken block-local; under ``train_sp`` a block's
reduce-scatter replaced by the member's own partial.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro_torch.configs.base import SHAPES, RunConfig, TrainConfig
from repro_torch.configs.tiny import tiny_of
from repro_torch.data import make_train_batch
from repro_torch.launch import roofline as R
from repro_torch.models import attention as attn
from repro_torch.models import moe
from repro_torch.models import registry
from repro_torch.models import transformer as tfm
from repro_torch.models.module import tree_paths
from repro_torch.optim import adamw_init
from repro_torch.sharding import serve
from repro_torch.sharding import tp as tp_mod
from repro_torch.sharding.mesh import make_mesh
from repro_torch.sharding.placement import shard_tree
from repro_torch.sharding.rules import EP_OVERRIDES, make_ctx
from repro_torch.training import spmd
from repro_torch.training.step import make_train_step

import test_torch_ssm_mesh as SM
import test_torch_tp as TT

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
HERE = os.path.dirname(__file__)
TOL = 1e-5
PARAM_TOL = 1e-4            # as tests/test_torch_spmd.py's (_params_close)
SEQ, B, STEPS = 16, 4, 2
PROFILES = {"train_sp": "sp", "kv_seq": "cp"}
ARCHS = {"danube": "h2o_danube_1_8b", "qwen2vl": "qwen2_vl_7b",
         "qwen3moe": "qwen3_moe_30b_a3b", "hymba": "hymba_1_5b",
         "whisper": "whisper_large_v3"}
CASES = {f"{a}-{p}": (ARCHS[a], p) for a in ARCHS for p in PROFILES}
# the cases whose flops are held to the reference's (module note)
FLOPS = [c for c in CASES if c != "whisper-kv_seq"]
XLA_FLAGS = ("--xla_force_host_platform_device_count=8 "
             "--xla_backend_optimization_level=0")
N_PROCS = 3
# each case's coordinate flops, (case, kind) -> {coord: flops}, kept by
# the value tests' runs for the flops tests (the same steps)
_FLOPS = {}

REFERENCE = """
import dataclasses, json, os, re, sys
sys.path[:0] = [%r, %r]
import numpy as np, jax, jax.numpy as jnp
from _torch_parity import reference_init_params
from repro.configs.base import RunConfig, SHAPES, SINGLE_POD, TrainConfig
from repro.configs.tiny import tiny_of
from repro.data import make_train_batch
from repro.launch import dryrun
from repro.models import module, registry
from repro.optim import adamw_init
from repro.sharding import rules
CASES, PROFILES, SEQ, B, STEPS = %r, %r, %r, %r, %r
out, part, nproc = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
AUTO = jax.sharding.AxisType.Auto
mesh = jax.make_mesh((2, 2), ("data", "model"), devices=jax.devices()[:4],
                     axis_types=(AUTO,) * 2)
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

def rc_of(arch, prof, shape):
    return RunConfig(model=tiny_of(arch), mesh=SINGLE_POD,
                     shape=dataclasses.replace(SHAPES[shape], seq_len=SEQ,
                                               global_batch=B),
                     train=TrainConfig(total_steps=50, warmup_steps=2,
                                       loss_chunk=SEQ, remat_policy="none"),
                     sharding_profile=PROFILES[prof])

res = {}
jobs = sorted(CASES.items()) + [("ep", None)]
for i, (case, spec) in enumerate(jobs):
    if i %% nproc != part:
        continue
    if case == "ep":
        rc = RunConfig(model=dataclasses.replace(
            tiny_of("qwen3_moe_30b_a3b"), moe_force_ep=True),
            mesh=SINGLE_POD, shape=dataclasses.replace(
                SHAPES["train_4k"], seq_len=SEQ, global_batch=B),
            train=TrainConfig(total_steps=50, warmup_steps=2,
                              loss_chunk=SEQ, remat_policy="none"),
            sharding_profile="ep")
        ep = jax.make_mesh((2, 2, 2), ("data", "expert", "model"),
                           axis_types=(AUTO,) * 3)
        lowered, _ = dryrun.build_lowered(rc, ep, "train")
        res["ep/train"] = hlo_matmul_flops(lowered.compile().as_text())
        continue
    arch, prof = spec
    rc = rc_of(arch, prof, "train_4k")
    rb = registry.build(rc)
    params = jax.jit(lambda k: reference_init_params(
        rb.specs, k, jnp.float32))(jax.random.key(rc.train.seed))
    arrays = {"init/" + "/".join(p): np.asarray(v)
              for p, v in module.tree_paths(params).items()}
    ctx = rules.make_ctx(mesh, prof)
    bsh = {k: ctx.sharding(s.shape, ("act_batch",) + (None,) * (
        len(s.shape) - 1)) for k, s in rb.input_specs("train").items()}
    # the step as the dry run lowers it: weights, moments and rows placed
    lowered, _ = dryrun.build_lowered(rc, mesh, "train")
    step = lowered.compile()
    res[case + "/train"] = hlo_matmul_flops(step.as_text())
    ish = step.input_shardings[0]
    p_, opt = params, adamw_init(params)
    for s in range(STEPS):
        # an output's placement may differ from the one the input takes
        p_, opt, batch = jax.device_put(
            (p_, opt, make_train_batch(rc, s, mesh, bsh)), tuple(ish))
        p_, opt, m = step(p_, opt, batch)
        for k in ("loss", "grad_norm"):
            res[f"{case}/{k}{s}"] = float(m[k])
    for p, v in module.tree_paths(p_).items():
        arrays["final/" + "/".join(p)] = np.asarray(v)
    prc = rc_of(arch, prof, "prefill_32k")
    pb = registry.build(prc)
    rng = np.random.default_rng(5)
    specs = pb.input_specs("prefill")
    inputs = {k: (rng.integers(0, prc.model.vocab_size, s.shape)
                  .astype(np.int32) if s.dtype == jnp.int32
                  else rng.standard_normal(s.shape).astype(np.float32))
              for k, s in specs.items()}
    psh = {k: ctx.sharding(s.shape, ("act_batch",) + (None,) * (
        len(s.shape) - 1)) for k, s in specs.items()}
    with mesh:
        pre = jax.jit(lambda p, b: pb.prefill(p, b, shd=ctx),
                      in_shardings=(ctx.spec_tree_shardings(pb.specs), psh))
        logits, caches = pre(params, inputs)
        res[case + "/prefill"] = hlo_matmul_flops(
            pre.lower(params, inputs).compile().as_text())
    for k, v in inputs.items():
        arrays["inputs/" + k] = v
    arrays["logits"] = np.asarray(logits)
    for path, v in walk(caches):
        arrays["cache/" + path] = v
    np.savez(os.path.join(out, case + ".npz"), **arrays)
with open(os.path.join(out, f"ref{part}.json"), "w") as f:
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
    """The reference's runs and lowerings, in ``N_PROCS`` subprocesses
    side by side: the directory of one ``.npz`` a case, and the metrics
    and flops by key."""
    out = tmp_path_factory.mktemp("seq_mesh")
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS=XLA_FLAGS)
    script = textwrap.dedent(REFERENCE) % (
        SRC, HERE, CASES, PROFILES, SEQ, B, STEPS, TT._hlo_source())
    procs = [subprocess.Popen([sys.executable, "-c", script, str(out),
                               str(i), str(N_PROCS)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env) for i in range(N_PROCS)]
    res = {}
    for i, p in enumerate(procs):
        o, e = p.communicate(timeout=600)
        assert p.returncode == 0, f"stdout:\n{o}\nstderr:\n{e[-4000:]}"
        with open(out / f"ref{i}.json") as f:
            res.update(json.load(f))
    return out, res


def _npz(out, case):
    with np.load(out / f"{case}.npz") as z:
        return {k: z[k] for k in z.files}


def _tree(arrays, prefix):
    tree = {}
    for k, v in arrays.items():
        if not k.startswith(prefix + "/"):
            continue
        *p, leaf = k.split("/")[1:]
        d = tree
        for seg in p:
            d = d.setdefault(seg, {})
        d[leaf] = v
    return tree


def _params(arrays, prefix="init"):
    from repro_torch.convert import params_from_reference
    return params_from_reference(_tree(arrays, prefix), device="cpu")


def _rc(arch, prof, shape="train_4k"):
    return RunConfig(model=tiny_of(arch),
                     shape=dataclasses.replace(SHAPES[shape], seq_len=SEQ,
                                               global_batch=B),
                     train=TrainConfig(total_steps=50, warmup_steps=2,
                                       loss_chunk=SEQ, remat_policy="none"),
                     sharding_profile=PROFILES[prof])


def _mesh():
    return make_mesh((2, 2), ("data", "model"), ["cpu"] * 4)


def _close(got, want, tol=TOL, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol, err_msg=what)


def _mesh_steps(rc, prof, params, count_flops=False):
    """Two mesh steps from ``params``: (step, [metrics], final params
    gathered whole)."""
    mesh = _mesh()
    ctx = make_ctx(mesh, prof)
    bundle = registry.build(rc, device="cpu")
    placed = shard_tree(params, ctx.spec_tree_shardings(bundle.specs))
    bs = {k: ctx.sharding(s.shape, ("act_batch",) + (None,) * (s.ndim - 1))
          for k, s in bundle.input_specs("train").items()}
    step = spmd.make_spmd_train_step(bundle, rc, ctx, count_flops)
    opt = adamw_init(placed)
    metrics = []
    for s in range(STEPS):
        placed, opt, m = step(placed, opt,
                              make_train_batch(rc, s, "cpu", mesh, bs))
        metrics.append(m)
    final = {p: x.gather("cpu") for p, x in tree_paths(placed).items()}
    return step, metrics, final


def _params_close(got, want, what):
    """The parameters after two steps (trees by path): within ``TOL`` in
    relative L2 over the whole tree, and every element within
    ``PARAM_TOL``. AdamW's first steps divide by the root of the second
    moment, so a gradient element near zero carries a 1e-7 difference of
    the sums' order into a 1e-5 step of its parameter."""
    diff = sum(float(((got[p].double() - w.double()) ** 2).sum())
               for p, w in want.items())
    norm = sum(float((w.double() ** 2).sum()) for w in want.values())
    assert (diff / norm) ** 0.5 <= TOL, (what, (diff / norm) ** 0.5)
    for p, w in want.items():
        _close(got[p], w, PARAM_TOL, f"{what} {p}")


def _one_device_steps(rc, params):
    bundle = registry.build(rc, device="cpu")
    step = make_train_step(bundle, rc)
    opt = adamw_init(params)
    metrics = []
    for s in range(STEPS):
        params, opt, m = step(params, opt, make_train_batch(rc, s, "cpu"))
        metrics.append(m)
    return metrics, tree_paths(params)


# -- the partial -----------------------------------------------------------------


def _group(n):
    ctx = make_ctx(make_mesh((1, n), ("data", "model"), ["cpu"] * n),
                   "kv_seq")
    return tp_mod.TP(ctx, ["cpu"] * n)


@settings(max_examples=30, deadline=None, database=None)
@given(seed=st.integers(0, 2 ** 16), n=st.sampled_from([2, 3, 4]),
       causal=st.booleans(), window=st.sampled_from([None, 0, 3, 6]),
       sinks=st.sampled_from([0, 2]), softcap=st.sampled_from([0.0, 5.0]),
       special=st.sampled_from(["none", "meta", "pad"]),
       q_chunk=st.sampled_from([0, 4]))
def test_combined_partials_equal_attend(seed, n, causal, window, sinks,
                                        softcap, special, q_chunk):
    """Every query against each block of the keys, joined by
    ``TP.combine``: ``attend`` over the whole, values and gradients.
    The queries sit at the sequence's first positions, so the later
    blocks hold keys a causal row may not attend at all."""
    rng = np.random.default_rng(seed)
    Bq, Sq, H, hd = 2, 8, 2, 4
    Sk = 4 * n
    q = torch.from_numpy(rng.standard_normal((Bq, Sq, H, hd))
                         .astype(np.float32)).requires_grad_()
    k = torch.from_numpy(rng.standard_normal((Bq, Sk, H, hd))
                         .astype(np.float32)).requires_grad_()
    v = torch.from_numpy(rng.standard_normal((Bq, Sk, H, hd))
                         .astype(np.float32)).requires_grad_()
    q_pos = torch.arange(Sq, dtype=torch.int32)[None].expand(Bq, Sq)
    kv_pos = torch.arange(Sk, dtype=torch.int32)[None].repeat(Bq, 1)
    if special != "none":       # a few keys META (always) or PAD (never)
        idx = torch.from_numpy(rng.choice(Sk, 3, replace=False))
        kv_pos[:, idx] = attn.META_POS if special == "meta" else attn.PAD_POS
        if special == "pad":
            kv_pos[:, 0] = 0        # every row keeps a key
    kw = dict(causal=causal, window=window, softcap=softcap, sinks=sinks,
              q_chunk=q_chunk)
    want = attn.attend(q, k, v, q_pos, kv_pos, **kw)
    tp = _group(n)
    blocks = [slice(j * 4, (j + 1) * 4) for j in range(n)]
    parts = [attn.attend_partial(q, k[:, b], v[:, b], q_pos, kv_pos[:, b],
                                 **kw) for b in blocks]
    got = sum(tp.combine(parts, range(n))).transpose(1, 2)
    assert torch.isfinite(got).all()
    _close(got.detach(), want.detach(), 1e-5)
    seed_out = torch.from_numpy(rng.standard_normal(tuple(want.shape))
                                .astype(np.float32))
    g_want = torch.autograd.grad((want * seed_out).sum(), (q, k, v))
    g_got = torch.autograd.grad((got * seed_out).sum(), (q, k, v))
    for a, b in zip(g_got, g_want):
        assert torch.isfinite(a).all()
        _close(a, b, 1e-5)


def test_a_block_no_row_may_attend_weighs_nothing():
    """A causal block after every query, and a windowed block behind
    every row's window: each row's maximum ``NEG_INF``, its sum and
    output 0, and the combine (and its gradient) finite."""
    torch.manual_seed(0)
    q = torch.randn(1, 4, 2, 8, requires_grad=True)
    k = torch.randn(1, 8, 2, 8, requires_grad=True)
    v = torch.randn(1, 8, 2, 8, requires_grad=True)
    q_pos = torch.arange(12, 16, dtype=torch.int32)[None]

    def at(lo):
        return torch.arange(lo, lo + 8, dtype=torch.int32)[None]
    for kv_pos, window in ((at(16), None), (at(0), 2)):
        mx, l, o = attn.attend_partial(q, k, v, q_pos, kv_pos, window=window)
        assert bool((mx == attn.NEG_INF).all())
        assert bool((l == 0).all()) and bool((o == 0).all())
    parts = [attn.attend_partial(q, k, v, q_pos, at(lo), window=2)
             for lo in (0, 8, 16)]
    out = sum(_group(3).combine(parts, range(3)))
    out.sum().backward()
    assert torch.isfinite(out).all()
    assert all(torch.isfinite(t.grad).all() for t in (q, k, v))


# -- the slice -------------------------------------------------------------------


def test_both_profiles_keep_the_group():
    mesh = make_mesh((2, 4), ("data", "model"), ["meta"] * 8)
    for prof in PROFILES:
        ctx = make_ctx(mesh, prof)
        assert ctx.tp_axes() == ("model",) and ctx.tp_size() == 4
    assert make_ctx(mesh, "train_sp").tp_splits()[0] == "act_seq"
    assert "act_heads" not in make_ctx(mesh, "kv_seq").tp_splits()
    assert make_ctx(mesh, "dp_only").tp_size() == 1
    rc = _rc("h2o_danube_1_8b", "train_sp")
    assert spmd.tp_plan(rc, make_ctx(mesh, "dp_only")) is None
    for prof in PROFILES:
        assert spmd.tp_plan(rc, make_ctx(mesh, prof)) is not None


@pytest.mark.parametrize("case", list(CASES))
def test_mesh_step_matches_one_device_and_the_reference(ref, case):
    out, res = ref
    arch, prof = CASES[case]
    rc = _rc(arch, prof)
    arrays = _npz(out, case)
    step, got, final = _mesh_steps(rc, prof, _params(arrays), True)
    _FLOPS[case, "train"] = step.coord_flops     # its last step's
    one, one_final = _one_device_steps(rc, _params(arrays))
    for s in range(STEPS):
        for k in ("loss", "grad_norm"):
            g, o = float(got[s][k]), float(one[s][k])
            w = res[f"{case}/{k}{s}"]
            assert abs(g - o) <= TOL * abs(o), (case, k, s, g, o)
            assert abs(g - w) <= TOL * abs(w), (case, k, s, g, w)
    want = tree_paths(_params(arrays, "final"))
    assert set(final) == set(want) == set(one_final)
    _params_close(final, one_final, f"{case} one device")
    _params_close(final, want, f"{case} reference")


def _prefill(rc, prof, params, inputs, count_flops=False):
    bundle = registry.build(rc, device="cpu")
    ctx = make_ctx(_mesh(), prof)
    placed = shard_tree(params, ctx.spec_tree_shardings(bundle.specs))
    pre = serve.make_spmd_prefill(bundle, rc, ctx, count_flops)
    logits, caches = pre(placed, {k: torch.from_numpy(v)
                                  for k, v in inputs.items()})
    return pre, logits, caches


@pytest.mark.parametrize("case", list(CASES))
def test_mesh_prefill_matches_the_reference(ref, case):
    out, _ = ref
    arch, prof = CASES[case]
    arrays = _npz(out, case)
    rc = _rc(arch, prof, "prefill_32k")
    inputs = {k[len("inputs/"):]: v for k, v in arrays.items()
              if k.startswith("inputs/")}
    pre, logits, caches = _prefill(rc, prof, _params(arrays), inputs, True)
    _FLOPS[case, "prefill"] = pre.coord_flops
    _close(logits, arrays["logits"], what="logits")
    got = dict(_walk(caches))
    assert {"cache/" + k for k in got} == {k for k in arrays
                                           if k.startswith("cache/")}
    for path, x in got.items():
        w = arrays["cache/" + path]
        if x.dtype.is_floating_point:
            _close(x.float(), w, what=path)
        else:
            assert np.array_equal(x.numpy(), w), path


def _walk(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _walk(v, prefix + (str(i),))
    else:
        yield "/".join(prefix), tree.gather("cpu")


# -- the flops -------------------------------------------------------------------


def _by_design(arch, prof, kind):
    """The port's flops beyond XLA's per device (module note), for one
    coordinate of a (data 2, model 2) mesh."""
    mc, n, rows = tiny_of(arch), 2, B // 2
    if mc.family == "encdec":
        return 0            # whisper under train_sp: XLA's dots, exactly
    D, V, E = mc.d_model, mc.vocab_size, mc.num_experts
    H, hd = mc.num_heads, mc.resolved_head_dim()
    T = rows * (SEQ + mc.num_meta_tokens)
    train = kind == "train"
    out = 2 * rows * SEQ * D * V // n if train else 0
    for st_ in tfm.make_stages(mc):
        per = 0
        if st_.kind in ("dense", "moe", "hymba") and prof == "kv_seq" \
                and train:
            per -= (n - 1) * 2 * T * H * hd * D // n
        if st_.kind == "moe":
            per += (3 if train else 1) * (n - 1) * 2 * T * D * E // n
        out += st_.count * per
    if mc.family == "hybrid":
        # the recurrent terms, as under ``train`` (the attention's split
        # contraction of one key/value head left out: each member projects
        # its own tokens' keys and values here)
        extra = SM._by_design(arch, kind) - (
            2 * rows * SEQ * D * V // n if train else 0)
        extra -= mc.num_layers * (2 if train else 1) * (n - 1) * 2 * 2 * T \
            * D * hd // n
        out += extra
    return out


@pytest.mark.parametrize("case", FLOPS)
@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_every_coordinate_computes_the_references_per_device_flops(
        ref, case, kind):
    out, res = ref
    arch, prof = CASES[case]
    arrays = _npz(out, case)
    meta = make_mesh((2, 2), ("data", "model"), ["meta"] * 4)
    rc = _rc(arch, prof, "train_4k" if kind == "train" else "prefill_32k")
    got = _FLOPS.get((case, kind))    # counted by the value tests' runs
    if got is None and kind == "train":
        got = _mesh_flops_step(rc, prof).coord_flops
    elif got is None:
        inputs = {k[len("inputs/"):]: v for k, v in arrays.items()
                  if k.startswith("inputs/")}
        got = _prefill(rc, prof, _params(arrays), inputs, True)[0] \
            .coord_flops
    want = res[f"{case}/{kind}"]
    assert len(got) == 4 and len(set(got.values())) == 1, got
    for c, f in got.items():
        assert f - _by_design(arch, prof, kind) == want, (c, f, want)
    # the dry run's probe: the first coordinate's count, on meta
    cell = R.count_cell(rc, meta, kind, cut=False)
    assert cell["flops"] == got[(0, 0)]


def _mesh_flops_step(rc, prof):
    mesh = _mesh()
    ctx = make_ctx(mesh, prof)
    bundle = registry.build(rc, device="cpu")
    params = shard_tree(bundle.init_params(torch.Generator().manual_seed(0)),
                        ctx.spec_tree_shardings(bundle.specs))
    bs = {k: ctx.sharding(s.shape, ("act_batch",) + (None,) * (s.ndim - 1))
          for k, s in bundle.input_specs("train").items()}
    step = spmd.make_spmd_train_step(bundle, rc, ctx, count_flops=True)
    step(params, adamw_init(params), make_train_batch(rc, 0, "cpu", mesh, bs))
    return step


def test_an_ep_coordinate_computes_the_references_per_device_flops(ref):
    """(data 2, expert 2, model 2), the EP overrides, tiny qwen3-moe with
    its experts split in storage: every coordinate's flops are XLA's
    after the terms of ``tests/test_torch_tp.py`` with a group of four
    (the head recompute; the router's and the key/value head's split
    contractions)."""
    mc = dataclasses.replace(tiny_of("qwen3_moe_30b_a3b"), moe_force_ep=True)
    rc = RunConfig(model=mc, shape=dataclasses.replace(
        SHAPES["train_4k"], seq_len=SEQ, global_batch=B),
        train=TrainConfig(total_steps=50, warmup_steps=2, loss_chunk=SEQ,
                          remat_policy="none"), sharding_profile="ep")
    mesh = make_mesh((2, 2, 2), ("data", "expert", "model"), ["cpu"] * 8)
    ctx = make_ctx(mesh, "train", EP_OVERRIDES)
    bundle = registry.build(rc, device="cpu")
    params = shard_tree(bundle.init_params(torch.Generator().manual_seed(0)),
                        ctx.spec_tree_shardings(bundle.specs))
    bs = {k: ctx.sharding(s.shape, ("act_batch",) + (None,) * (s.ndim - 1))
          for k, s in bundle.input_specs("train").items()}
    step = spmd.make_spmd_train_step(bundle, rc, ctx, count_flops=True)
    step(params, adamw_init(params), make_train_batch(rc, 0, "cpu", mesh, bs))
    got = step.coord_flops
    n, m, rows = 4, 2, B // 2
    T, D, hd = rows * SEQ, mc.d_model, mc.resolved_head_dim()
    E, F = mc.num_experts, mc.moe_d_ff
    C = moe.capacity(SEQ, E, mc.num_experts_per_tok, mc.capacity_factor)
    extra = 2 * T * D * mc.vocab_size // n
    # the key and value projections and the router: XLA splits their
    # forward contraction over D across the group and their weight
    # gradient's over 'model'
    per_layer = 2 * 2 * T * D * hd * ((n - 1) * m + (m - 1) * n) // (n * m)
    per_layer += 2 * T * D * E * ((n - 1) * m + (m - 1) * n) // (n * m)
    # the experts' forward down projection: XLA all-gathers the hidden
    # and the weights over 'model' and projects the dispatched rows of
    # both 'model' members
    per_layer -= 2 * (E // 2) * rows * C * F * D // m
    extra += mc.num_layers * per_layer
    assert len(got) == 8 and len(set(got.values())) == 1, got
    for c, f in got.items():
        assert f - extra == ref[1]["ep/train"], (c, f, ref[1]["ep/train"])


# -- the moves and the controls --------------------------------------------------


def test_the_moves_equal_the_probes_and_the_rooflines():
    """A step's group collectives (``tp_gathered``, ``tp_scattered``,
    ``all_reduced``) against the dry run's probe of one coordinate (its
    bytes a device, over the mesh's four devices) and the all-reduce
    against the roofline's classes' count (x 2 on the wire)."""
    from repro_torch.launch import dryrun
    meta = make_mesh((2, 2), ("data", "model"), ["meta"] * 4)
    for prof in PROFILES:
        rc = _rc("h2o_danube_1_8b", prof)
        t = _mesh_flops_step(rc, prof).traffic
        assert t["tp_gathered"].local > 0 and t["tp_scattered"].local > 0
        assert all(x.moved == 0 for x in t.values())
        rep = dryrun.run_cell("h2o_danube_1_8b", "train_4k", False, rc=rc,
                              mesh=meta)
        assert rep["tp_members"] == 2
        for key, kind in (("all_gathered", "tp_gathered"),
                          ("reduce_scattered", "tp_scattered"),
                          ("all_reduced", "all_reduced")):
            assert rep[f"{key}_bytes_per_device"] * 4 == t[kind].local, key
        got = R.collective_bytes(rc, meta, "train")
        assert got["by_kind"]["all-reduce"] == 2 * t["all_reduced"].local / 4


def _one_device_loss(rc, params):
    bundle = registry.build(rc, device="cpu")
    loss, _ = bundle.loss_fn(params, make_train_batch(rc, 0, "cpu"),
                             remat_policy="none", loss_chunk=SEQ)
    return float(loss)


def _dropped_partial(self, parts, members):
    out = _REAL_COMBINE(self, parts, members)
    return [o * (0 if m == len(out) - 1 else 1) for m, o in enumerate(out)]


def _own_partial(self, parts, members, spans):
    return tp_mod.Seq([p.narrow(1, spans[m].start,
                                 spans[m].stop - spans[m].start)
                       for m, p in zip(self.live(members), parts)], spans)


def _local_positions(part):
    def wrapped(q, k, v, q_pos, kv_pos, **kw):
        return part(q, k, v, q_pos, kv_pos - kv_pos[:, :1], **kw)
    return wrapped


_REAL_COMBINE = tp_mod.TP.combine


@pytest.mark.parametrize("control", ["dropped-partial", "local-positions",
                                     "own-partial"])
def test_phase_16g_controls_fail(monkeypatch, control):
    prof = "train_sp" if control == "own-partial" else "kv_seq"
    rc = _rc("h2o_danube_1_8b", prof)
    bundle = registry.build(rc, device="cpu")
    params = bundle.init_params(torch.Generator().manual_seed(0))
    one = _one_device_loss(rc, params)
    copy = {p: t.clone() for p, t in tree_paths(params).items()}
    _, good, _ = _mesh_steps(rc, prof, params)
    want = float(good[0]["loss"])
    assert abs(want - one) <= TOL * abs(want)
    for p, t in tree_paths(params).items():     # the step ran in place
        t.data.copy_(copy[p])
    if control == "dropped-partial":
        monkeypatch.setattr(tp_mod.TP, "combine", _dropped_partial)
    elif control == "local-positions":
        monkeypatch.setattr(attn, "attend_partial",
                            _local_positions(attn.attend_partial))
    else:
        monkeypatch.setattr(tp_mod.TP, "scatter_sum", _own_partial)
    _, bad, _ = _mesh_steps(rc, prof, params)
    # a loss that is NaN (no key left to a row) fails the check too
    assert not abs(float(bad[0]["loss"]) - want) <= 1e-3 * abs(want), control
