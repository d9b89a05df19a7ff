"""Port vs reference: prefill and the decode step on a mesh
(``sharding/serve.py``).

The reference's partitioned serving is ``launch/dryrun.py``'s
``build_lowered``: ``jax.jit(lambda p, b: bundle.prefill(p, b,
shd=ctx), in_shardings=...)`` under the train profile and the decode
step under the decode profile (heads replicated, the KV cache's
sequence on 'model'). It runs here in subprocesses on 8 host devices, a
(pod 2, data 2, model 2) mesh of ``AxisType.Auto`` axes (ROADMAP R2),
as ``tests/test_torch_tp.py`` runs its reference: a prefill, the caches
put on the decode profile's placement, then ``STEPS`` decode steps fed
the same seeded tokens. The port runs ``make_spmd_prefill`` and
``make_spmd_decode_step`` on the same mesh of CPU entries from the same
weights (``_torch_parity.reference_init_params``) and inputs (seeded
numpy). Tiny configs: yi-6b at kv 2 (the key/value heads split) and kv 1
(replicated: each member projects the one its heads read; a prompt past
its first block of slots, so keys and values are exchanged);
h2o-danube with a prompt past its window (the eviction write spans both
blocks); gemma3-4b (local and global windows, a tied head); qwen3-moe
with its experts split at a capacity factor that drops (R3; a decode
step routes each rank's rows as one group, and at tiny sizes no decode
assignment drops: capacity pads to 8 slots); hymba (sink slots; the
mamba part whole on the first member, its states placed by
``cache_axes``); yi-6b with an int8 KV cache; and yi-6b at a cache
length of 33, which does not divide 'model' (the placement dropped,
decode attention whole on the first member).

Tolerances: float32 last logits, every step's logits and every cache
leaf within rtol = atol = 1e-5; positions equal. The int8 case's
quantised values are equal except where the two programs' float keys
and values straddle a rounding boundary: a flip of one unit, in at most
``INT8_FLIPS`` of the values (1 of 16,384 here); its scales and logits
within 1e-5.

The flops. Each coordinate's ``coord_flops`` on the same mesh against
the dot flops of the reference's compiled per-device HLO
(``test_torch_roofline``'s ``hlo_matmul_flops``) for one prefill and one
decode cell (tiny yi-6b, kv 1 and kv 2). They are equal after the
differences by design, each added exactly (``_by_design``), per
coordinate, n = 2 members, T = its rows x prompt tokens, per layer:

- prefill, where the key/value heads do not split over 'model' (kv 1):
  XLA splits the K and V projections' contraction over D between the
  members, where a member projects the head its query heads read whole:
  (1 − 1/n) x 2 (K, V) x 2 x T x D x hd;
- decode, the heads replicated: a member with a block of the cache
  projects the token's q, k, v and its out-projection whole, where XLA
  splits each projection over the members (the weights are stored split
  over heads): (1 − 1/n) x 2 x rows x D x (2 H + 2 Kv) x hd.

The moves: the prefill's ``all_reduced`` and ``exchanged`` bytes and the
decode step's ``all_reduced`` (the flash-decode combine) against
``roofline.collective_bytes``' all-reduce (x 2 on the wire) and
all-to-all. The controls of ``chip_smoke.py``'s phase 18 (a) fail here
too: the cache blocks written in reversed 'model' order, the combine
without rescaling by the maximum, one member's partial dropped.
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

from repro_torch.configs.base import SHAPES, RunConfig
from repro_torch.configs.tiny import tiny_of
from repro_torch.launch import dryrun
from repro_torch.launch import roofline as R
from repro_torch.models import attention as attn
from repro_torch.models import registry
from repro_torch.sharding import fsdp, serve
from repro_torch.sharding import tp as tp_mod
from repro_torch.sharding.mesh import make_mesh
from repro_torch.sharding.placement import shard_tree
from repro_torch.sharding.rules import make_ctx
from repro_torch.training import spmd

import test_torch_spmd as TS
import test_torch_tp as TT

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
HERE = os.path.dirname(__file__)
TOL = 1e-5
INT8_FLIPS = 1e-3
B, STEPS = 4, 3
XLA_FLAGS = TS.XLA_FLAGS
N_PROCS = 2

# case -> (arch, model overrides, cache tokens, prompt)
CASES = {
    "yi-kv2": ("yi_6b", {"num_kv_heads": 2}, 32, 20),
    "yi-kv1": ("yi_6b", {}, 32, 20),
    "danube-evict": ("h2o_danube_1_8b", {}, 32, 13),
    "gemma3": ("gemma3_4b", {}, 32, 20),
    "qwen3-drops": ("qwen3_moe_30b_a3b", {"capacity_factor": 0.5}, 32, 20),
    "hymba": ("hymba_1_5b", {}, 32, 13),
    "yi-int8": ("yi_6b", {"num_kv_heads": 2, "kv_cache_dtype": "int8"},
                32, 20),
    "yi-odd-cache": ("yi_6b", {}, 33, 20),
}
# the flops cells: (case, kind)
FLOPS = [("yi-kv1", "prefill"), ("yi-kv2", "prefill"),
         ("yi-kv2", "decode")]

REFERENCE = """
import dataclasses, json, os, re, sys
sys.path[:0] = [%r, %r]
import numpy as np, jax, jax.numpy as jnp
from _torch_parity import reference_init_params
from repro.configs.base import RunConfig, SHAPES, SINGLE_POD
from repro.configs.tiny import tiny_of
from repro.launch import dryrun
from repro.models import module, registry
from repro.sharding import rules
CASES, B, STEPS = %r, %r, %r
out, part, nproc = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
AUTO = jax.sharding.AxisType.Auto
mesh = jax.make_mesh((2, 2, 2), ("pod", "data", "model"),
                     axis_types=(AUTO,) * 3)
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

flops = {}
for i, (case, (arch, over, seq, P)) in enumerate(sorted(CASES.items())):
    if i %% nproc != part:
        continue
    rc = RunConfig(model=dataclasses.replace(tiny_of(arch), **over),
                   mesh=SINGLE_POD,
                   shape=dataclasses.replace(SHAPES["prefill_32k"],
                                             seq_len=seq, global_batch=B))
    rb = registry.build(rc)
    params = jax.jit(lambda k: reference_init_params(
        rb.specs, k, jnp.float32))(jax.random.key(3))
    rng = np.random.default_rng(5)
    toks = rng.integers(0, rc.model.vocab_size, (B, P)).astype(np.int32)
    steps = rng.integers(0, rc.model.vocab_size, (B, STEPS)).astype(np.int32)
    M = rc.model.num_meta_tokens
    tctx = rules.make_ctx(mesh, "train")
    dctx = rules.make_ctx(mesh, "decode")
    res = {"/".join(("params",) + p): np.asarray(v)
           for p, v in module.tree_paths(params).items()}
    res["toks"], res["steps"] = toks, steps
    with mesh:
        bsh = dryrun.batch_shardings(
            {"inputs": jax.ShapeDtypeStruct((B, P), jnp.int32)}, tctx)
        pre = jax.jit(lambda p, b: rb.prefill(p, b, shd=tctx),
                      in_shardings=(tctx.spec_tree_shardings(rb.specs), bsh))
        logits, caches = pre(params, {"inputs": toks})
        res["prefill"] = np.asarray(logits)
        cab = rb.cache_abstract(B, seq)
        csh = dryrun.tree_shardings(cab, rb.cache_axes(), dctx)
        caches = jax.device_put(caches, csh)
        ish = dryrun.batch_shardings(
            {"inputs": jax.ShapeDtypeStruct((B, 1), jnp.int32)}, dctx)
        rep = jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec())
        dec = jax.jit(lambda p, x, c, cur: rb.decode_step(
            p, x["inputs"], c, cur, shd=dctx),
            in_shardings=(dctx.spec_tree_shardings(rb.specs), ish, csh, rep))
        first = caches
        for s in range(STEPS):
            lg, caches = dec(params, {"inputs": steps[:, s:s + 1]}, caches,
                             jnp.int32(P + M + s))
            caches = jax.device_put(caches, csh)
            res[f"step{s}"] = np.asarray(lg)
        for path, v in walk(caches):
            res["cache/" + path] = v
        if case in %r:
            flops[case + "/prefill"] = hlo_matmul_flops(pre.lower(
                params, {"inputs": toks}).compile().as_text())
            flops[case + "/decode"] = hlo_matmul_flops(dec.lower(
                params, {"inputs": steps[:, :1]}, first,
                jnp.int32(P + M)).compile().as_text())
    np.savez(os.path.join(out, case + ".npz"), **res)
with open(os.path.join(out, f"flops{part}.json"), "w") as f:
    json.dump(flops, f)
"""


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's runs, in ``N_PROCS`` subprocesses side by side:
    the directory of one ``.npz`` a case, and the flops by cell."""
    out = tmp_path_factory.mktemp("serve_mesh")
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS=XLA_FLAGS)
    script = textwrap.dedent(REFERENCE) % (
        SRC, HERE, CASES, B, STEPS, TT._hlo_source(),
        sorted({c for c, _ in FLOPS}))
    procs = [subprocess.Popen([sys.executable, "-c", script, str(out),
                               str(i), str(N_PROCS)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env) for i in range(N_PROCS)]
    flops = {}
    for i, p in enumerate(procs):
        o, e = p.communicate(timeout=600)
        assert p.returncode == 0, f"stdout:\n{o}\nstderr:\n{e[-4000:]}"
        with open(out / f"flops{i}.json") as f:
            flops.update(json.load(f))
    return out, flops


def _rc(case, batch=B):
    arch, over, seq, _ = CASES[case]
    return RunConfig(model=dataclasses.replace(tiny_of(arch), **over),
                     shape=dataclasses.replace(SHAPES["prefill_32k"],
                                               seq_len=seq,
                                               global_batch=batch))


def _mesh(shape=(2, 2, 2), axes=("pod", "data", "model")):
    n = int(np.prod(shape))
    return make_mesh(shape, axes, ["cpu"] * n)


def _params(z):
    tree = {}
    for k in z.files:
        if not k.startswith("params/"):
            continue
        *p, leaf = k.split("/")[1:]
        d = tree
        for seg in p:
            d = d.setdefault(seg, {})
        d[leaf] = z[k]
    from repro_torch.convert import params_from_reference
    return params_from_reference(tree, device="cpu")


def _walk(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _walk(v, prefix + (str(i),))
    else:
        yield "/".join(prefix), tree


def _serve(case, params, toks, steps, mesh=None, count_flops=False):
    """The port's mesh prefill and ``steps`` decode steps: (prefill
    function, decode function, [prefill logits, step logits...],
    caches)."""
    rc = _rc(case)
    mesh = mesh or _mesh()
    bundle = registry.build(rc, device="cpu")
    tctx, dctx = make_ctx(mesh, "train"), make_ctx(mesh, "decode")
    placed = shard_tree(params, tctx.spec_tree_shardings(bundle.specs))
    pre = serve.make_spmd_prefill(bundle, rc, tctx, count_flops)
    dec = serve.make_spmd_decode_step(bundle, rc, dctx, count_flops)
    logits, caches = pre(placed, {"inputs": torch.from_numpy(toks)})
    rows = [logits]
    P, M = toks.shape[1], rc.model.num_meta_tokens
    for s in range(steps.shape[1]):
        lg, caches = dec(placed, torch.from_numpy(steps[:, s:s + 1]), caches,
                         P + M + s)
        rows.append(lg)
    return pre, dec, rows, caches


def _close(got, want, tol=TOL, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol, err_msg=what)


@pytest.mark.parametrize("case", list(CASES))
def test_mesh_serving_matches_the_reference(ref, case):
    out, _ = ref
    with np.load(out / f"{case}.npz") as z:
        want = {k: z[k] for k in z.files}
        params = _params(z)
    _, _, rows, caches = _serve(case, params, want["toks"], want["steps"])
    _close(rows[0], want["prefill"], what="prefill")
    for s in range(STEPS):
        _close(rows[s + 1], want[f"step{s}"], what=f"step {s}")
    got = dict(_walk(caches))
    assert {"cache/" + k for k in got} == {k for k in want
                                           if k.startswith("cache/")}
    for path, x in got.items():
        g = x.gather("cpu").numpy()
        w = want["cache/" + path]
        assert g.shape == w.shape and g.dtype == w.dtype, path
        if g.dtype == np.int8:
            diff = np.abs(g.astype(np.int32) - w.astype(np.int32))
            assert diff.max() <= 1 and (diff > 0).mean() <= INT8_FLIPS, path
        elif not np.issubdtype(g.dtype, np.floating):
            np.testing.assert_array_equal(g, w, err_msg=path)
        else:
            _close(g, w, what=path)


def _by_design(case, kind):
    """The port's flops beyond XLA's per device (module note), for one
    coordinate of a (pod 2, data 2, model 2) mesh."""
    mc, n, P = _rc(case).model, 2, CASES[case][3]
    D, hd, H, Kv = (mc.d_model, mc.resolved_head_dim(), mc.num_heads,
                    mc.num_kv_heads)
    rows = B // 4
    if kind == "prefill":
        if Kv % n == 0:
            return 0
        return mc.num_layers * (n - 1) * 2 * 2 * rows * P * D * hd // n
    return mc.num_layers * (n - 1) * 2 * rows * D * (2 * H + 2 * Kv) * hd // n


@pytest.mark.parametrize("case,kind", FLOPS)
def test_every_coordinate_computes_the_references_per_device_flops(
        ref, case, kind):
    out, flops = ref
    with np.load(out / f"{case}.npz") as z:
        params = _params(z)
        toks, steps = z["toks"], z["steps"]
    pre, dec, _, _ = _serve(case, params, toks, steps[:, :1],
                            count_flops=True)
    got = (pre if kind == "prefill" else dec).coord_flops
    want = flops[f"{case}/{kind}"]
    rc = _rc(case)
    assert len(got) == 8 and len(set(got.values())) == 1
    for c, f in got.items():
        assert f > 0
        assert f - _by_design(case, kind) == want, (c, f, want)
    # the dry run's probe: the first coordinate's count, on meta
    mesh = make_mesh((2, 2, 2), ("pod", "data", "model"), ["meta"] * 8)
    rc_p = dataclasses.replace(rc, shape=dataclasses.replace(
        rc.shape, seq_len=toks.shape[1]))
    if kind == "prefill":
        cell = R.count_cell(rc_p, mesh, "prefill", cut=False)
        assert cell["flops"] == got[(0, 0, 0)]


def _tiny_danube(prompt=13, seq=24, batch=4):
    rc = RunConfig(model=tiny_of("h2o_danube_1_8b"),
                   shape=dataclasses.replace(SHAPES["prefill_32k"],
                                             seq_len=seq,
                                             global_batch=batch))
    bundle = registry.build(rc, device="cpu")
    params = bundle.init_params(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, 256, (batch, prompt)))
    steps = torch.from_numpy(rng.integers(0, 256, (batch, 4)))
    return rc, bundle, params, toks, steps


def _one_device(bundle, params, toks, steps):
    logits, caches = bundle.prefill(params, {"inputs": toks})
    rows = [logits]
    for s in range(steps.shape[1]):
        lg, caches = bundle.decode_step(params, steps[:, s:s + 1], caches,
                                        toks.shape[1] + s)
        rows.append(lg)
    return rows, caches


def _mesh_run(rc, bundle, params, toks, steps, mesh):
    tctx, dctx = make_ctx(mesh, "train"), make_ctx(mesh, "decode")
    placed = shard_tree(params, tctx.spec_tree_shardings(bundle.specs))
    pre = serve.make_spmd_prefill(bundle, rc, tctx)
    dec = serve.make_spmd_decode_step(bundle, rc, dctx)
    logits, caches = pre(placed, {"inputs": toks})
    rows = [logits]
    for s in range(steps.shape[1]):
        lg, caches = dec(placed, steps[:, s:s + 1], caches,
                         toks.shape[1] + s)
        rows.append(lg)
    return pre, dec, rows, caches


def _worst(rows, caches, want_rows, want_caches):
    """The largest relative L2 over the rows and the cache leaves
    gathered whole (inf where an integer leaf differs)."""
    worst = max(float((g - w).norm() / w.norm())
                for g, w in zip(rows, want_rows))
    for (_, x), (_, w) in zip(_walk(caches), _walk(want_caches),
                              strict=True):
        g = x.gather("cpu")
        if not g.is_floating_point():
            if not torch.equal(g, w):
                return float("inf")
            continue
        worst = max(worst, float((g - w).norm() / w.norm().clamp_min(1e-30)))
    return worst


def _reversed_block(mesh):
    keep = serve.cache_block
    n = mesh.shape["model"]
    i = mesh.axis_names.index("model")

    def reversed_block(x, coord):
        c = list(coord)
        c[i] = n - 1 - c[i]
        return keep(x, tuple(c))
    return serve, "cache_block", reversed_block


def _unscaled(mesh):
    def unscaled(tp, parts, members):
        total = tp.all_reduce([p[1] for p in parts], members)
        total = tp.replicate(total, members)
        return [p[2].float() / t for p, t in zip(parts, total)]
    return tp_mod.TP, "combine", unscaled


def _dropped(mesh):
    keep = tp_mod.TP.combine

    def dropped(tp, parts, members):
        kept = keep(tp, parts[:-1], members[:-1])
        return kept + [torch.zeros_like(kept[0])]
    return tp_mod.TP, "combine", dropped


CONTROLS = {"reversed-blocks": _reversed_block, "unscaled": _unscaled,
            "dropped": _dropped}


def test_the_mesh_serves_as_one_device_does():
    """(data 2, model 2) of CPU entries against the port on one device:
    the eviction write spanning both members' blocks, within 1e-5."""
    rc, bundle, params, toks, steps = _tiny_danube()
    want_rows, want_caches = _one_device(bundle, params, toks, steps)
    mesh = _mesh((2, 2), ("data", "model"))
    _, _, rows, caches = _mesh_run(rc, bundle, params, toks, steps, mesh)
    assert _worst(rows, caches, want_rows, want_caches) <= TOL


@pytest.mark.parametrize("control", list(CONTROLS))
def test_phase_18_controls_fail(monkeypatch, control):
    """``chip_smoke.py``'s phase 18 (a) controls, on the CPU: each must
    take the mesh's logits or caches beyond the check's limit."""
    rc, bundle, params, toks, steps = _tiny_danube()
    want_rows, want_caches = _one_device(bundle, params, toks, steps)
    mesh = _mesh((2, 2), ("data", "model"))
    obj, name, fn = CONTROLS[control](mesh)
    monkeypatch.setattr(obj, name, fn)
    _, _, rows, caches = _mesh_run(rc, bundle, params, toks, steps, mesh)
    assert _worst(rows, caches, want_rows, want_caches) > TOL


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_moves_equal_the_rooflines(kind):
    """Tiny yi-6b at kv 2 on (data 2, model 2) of CPU entries, the prompt
    filling both members' slots: the call's ``all_reduced`` bytes (the
    sums; to decode, the flash-decode combine) and, to prefill, its
    ``exchanged`` bytes (keys and values to the members whose slots they
    fill) against the roofline's all-reduce (x 2 on the wire) and
    all-to-all, per computing coordinate; the weights gathered against
    its all-gather, with the logits' blocks."""
    S = 20
    rc = RunConfig(model=dataclasses.replace(tiny_of("yi_6b"),
                                             num_kv_heads=2),
                   shape=dataclasses.replace(SHAPES["prefill_32k"],
                                             seq_len=S, global_batch=4))
    bundle = registry.build(rc, device="cpu")
    params = bundle.init_params(torch.Generator().manual_seed(0))
    toks = torch.zeros((4, S), dtype=torch.long)
    mesh = _mesh((2, 2), ("data", "model"))
    # the dry run's cells: a prompt of S tokens, a step at position S - 1
    P = S if kind == "prefill" else S - 1
    pre, dec, _, _ = _mesh_run(rc, bundle, params, toks[:, :P],
                               toks[:, :1], mesh)
    fn = pre if kind == "prefill" else dec
    t = fn.traffic
    reduced = t["all_reduced"].local
    assert t["all_reduced"].moved == 0 and reduced > 0
    got = R.collective_bytes(rc, make_mesh((2, 2), ("data", "model"),
                                           ["meta"] * 4), kind)
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
    the leaves outside the stacks, without gradients, under each
    profile's plan (to decode: the projections whole at both members,
    the MLP and vocabulary split)."""
    rc, bundle, params, toks, steps = _tiny_danube()
    mesh = _mesh((2, 2), ("data", "model"))
    pre, dec, _, _ = _mesh_run(rc, bundle, params, toks, steps[:, :1], mesh)
    for fn, prof in ((pre, "train"), (dec, "decode")):
        plan = spmd.tp_plan(rc, make_ctx(mesh, prof))
        assert fn.gathered_peak == fsdp.peak_bytes(bundle.specs, plan=plan,
                                                   grads=False)
        assert fn.gathered_peak < fsdp.peak_bytes(bundle.specs, plan=plan)
    attn_plan = spmd.tp_plan(rc, make_ctx(mesh, "decode"))[
        ("stage_0", "attn", "wq")]
    assert attn_plan == [(slice(None),) * 4] * 2


def test_decode_group_and_splits():
    """Under ``decode`` a rank's group is its 'model' coordinates, as
    under ``train``; what it splits differs; ``train_sp`` adds the
    sequence to ``train``'s splits, ``kv_seq`` splits the keys' sequence
    in place of the heads; ``dp_only`` keeps no group."""
    mesh = make_mesh((2, 2), ("data", "model"), ["meta"] * 4)
    train, decode = make_ctx(mesh, "train"), make_ctx(mesh, "decode")
    assert train.tp_axes() == decode.tp_axes() == ("model",)
    assert train.tp_splits() == ("act_heads", "act_mlp", "act_experts",
                                 "act_vocab", "act_ssm")
    assert decode.tp_splits() == ("act_kv_seq", "act_mlp", "act_experts",
                                  "act_vocab", "act_ssm")
    assert make_ctx(mesh, "train_sp").tp_splits() == (
        "act_seq",) + train.tp_splits()
    assert make_ctx(mesh, "kv_seq").tp_splits() == decode.tp_splits()
    for prof in ("train_sp", "kv_seq"):
        assert make_ctx(mesh, prof).tp_axes() == ("model",)
    assert make_ctx(mesh, "dp_only").tp_axes() == ()
    assert make_ctx(mesh, "dp_only").tp_splits() == ()


@pytest.mark.parametrize("S_new,cur,sinks", [(1, 5, 0), (1, 13, 0),
                                             (6, 0, 0), (13, 0, 0),
                                             (13, 0, 4), (20, 3, 4),
                                             (1, 30, 4)])
def test_block_writes_make_the_whole_write(S_new, cur, sinks):
    """``write_cache`` into each block of the slot space (``span``) gives
    the whole cache's write: the decode write, the short prefill and the
    eviction write with its roll and its sink slots, int8 too."""
    rng = np.random.default_rng(1)
    L, Kv, hd = 12, 2, 4
    k = torch.from_numpy(rng.standard_normal((2, S_new, Kv, hd)).astype(
        np.float32))
    v = torch.from_numpy(rng.standard_normal((2, S_new, Kv, hd)).astype(
        np.float32))
    for dtype in (torch.float32, torch.int8):
        whole = attn.init_cache(2, L, Kv, hd, dtype, device="cpu")
        attn.write_cache(whole, k, v, cur, sinks=sinks)
        blocks = []
        for lo in range(0, L, 4):
            b = attn.init_cache(2, 4, Kv, hd, dtype, device="cpu")
            attn.write_cache(b, k, v, cur, sinks=sinks, span=(lo, lo + 4),
                             length=L)
            blocks.append(b)
        for name, t in whole.items():
            dim = 0 if name == "pos" else 1
            assert torch.equal(torch.cat([b[name] for b in blocks], dim),
                               t), name


@pytest.mark.parametrize("window,softcap,sinks", [(0, 0.0, 0), (6, 0.0, 0),
                                                  (6, 5.0, 2)])
def test_partials_combine_to_decode_attend(window, softcap, sinks):
    """Two members' ``decode_partial`` over their halves of a cache,
    combined (``TP.combine``) and summed, equal ``decode_attend`` over
    the whole; a half with no key to attend (out of the window) scales
    to nothing."""
    rng = np.random.default_rng(2)
    Bq, H, Kv, hd, L = 2, 4, 2, 8, 12
    cache = attn.init_cache(Bq, L, Kv, hd, torch.float32, device="cpu")
    k = torch.from_numpy(rng.standard_normal((Bq, 10, Kv, hd)).astype(
        np.float32))
    attn.write_cache(cache, k, k * 0.5, 0, sinks=sinks)
    q = torch.from_numpy(rng.standard_normal((Bq, 1, H, hd)).astype(
        np.float32))
    q_pos = torch.full((Bq, 1), 9, dtype=torch.int32)
    kw = dict(window=window, softcap=softcap, scale=0.3, q_pos=q_pos,
              sinks=sinks)
    want = attn.decode_attend(q, cache, H, **kw)
    ctx = make_ctx(make_mesh((1, 2), ("data", "model"), ["cpu"] * 2),
                   "decode")
    tp = tp_mod.TP(ctx, ["cpu", "cpu"])
    halves = [{n: (t[:6] if n == "pos" else t[:, :6])
               for n, t in cache.items()},
              {n: (t[6:] if n == "pos" else t[:, 6:])
               for n, t in cache.items()}]
    parts = [attn.decode_partial(q, h, **kw) for h in halves]
    got = sum(tp.combine(parts, [0, 1])).reshape(Bq, 1, H, hd)
    _close(got, want)


def test_refusals():
    """No fallback: a bundle off the mesh's first entry, a split prefill
    without the mesh's caches, a split attention handed a plain cache."""
    rc, bundle, params, toks, _ = _tiny_danube()
    mesh = make_mesh((2, 2), ("data", "model"), ["meta"] * 4)
    with pytest.raises(ValueError, match="first entry"):
        serve.make_spmd_prefill(bundle, rc, make_ctx(mesh, "train"))
    cpu = _mesh((2, 2), ("data", "model"))
    tp = tp_mod.TP(make_ctx(cpu, "train"), ["cpu", "cpu"])
    with pytest.raises(ValueError, match="caches the mesh holds"):
        bundle.prefill(params, {"inputs": toks}, tp=tp)
    dec = serve.make_spmd_decode_step(bundle, rc, make_ctx(cpu, "decode"))
    with pytest.raises(ValueError, match="not the bundle's"):
        dec({"embed": None}, toks[:, :1], None, 13)


def test_the_dry_run_counts_one_coordinate():
    """A serving cell's dry run on (pod 2, data 2, model 2) of ``meta``
    entries: one coordinate's weights gathered a layer at a time without
    gradients, its flops below a rank computing alone, and its group's
    computing members."""
    rc = _rc("yi-kv2")
    mesh = make_mesh((2, 2, 2), ("pod", "data", "model"), ["meta"] * 8)
    alone = make_mesh((2, 2, 1), ("pod", "data", "model"), ["meta"] * 4)
    for shape in ("prefill_32k", "decode_32k"):
        kind = dryrun.shape_kind(shape)
        rep = dryrun.run_cell("yi_6b", shape, False, rc=rc, mesh=mesh)
        one = dryrun.run_cell("yi_6b", shape, False, rc=rc, mesh=alone)
        specs = registry.build(rc, device="meta").specs
        plan = spmd.tp_plan(rc, make_ctx(mesh, "train" if kind == "prefill"
                                         else "decode"))
        assert rep["memory"]["gathered_bytes"] == fsdp.peak_bytes(
            specs, plan=plan, grads=False)
        assert rep["tp_members"] == 2 and one["tp_members"] == 1
        assert rep["matmul_flops_per_device"] < one[
            "matmul_flops_per_device"]
        assert rep["all_reduced_bytes_per_device"] > 0


@pytest.mark.parametrize("arch", ["xlstm_350m", "whisper_large_v3"])
def test_the_unsplit_kinds_serve_as_one_device_does(arch):
    """What the mesh train step leaves whole stays whole: xlstm's layers
    on each rank's first coordinate (its vocabulary split), its states
    gathered there and written back to their blocks. Whisper now splits
    (``whisper.tp_plan``: to prefill its heads, MLP columns and
    vocabulary, to decode its self ring and cross cache along their
    sequence) and is held to one device the same way.
    (data 2, model 2) of CPU entries against the port on one device,
    within 1e-5."""
    mc = tiny_of(arch)
    rc = RunConfig(model=mc, shape=dataclasses.replace(
        SHAPES["prefill_32k"], seq_len=16, global_batch=4))
    bundle = registry.build(rc, device="cpu")
    params = bundle.init_params(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(3)
    if arch == "whisper_large_v3":
        batch = {"frames": torch.from_numpy(rng.standard_normal(
            (4, 16, mc.d_model)).astype(np.float32)),
            "dec_tokens": torch.from_numpy(rng.integers(0, 256, (4, 4)))}
    else:
        batch = {"inputs": torch.from_numpy(rng.integers(0, 256, (4, 9)))}
    P = next(iter(batch.values())).shape[1] if arch != "whisper_large_v3" \
        else 4
    steps = torch.from_numpy(rng.integers(0, 256, (4, 3)))
    logits, caches = bundle.prefill(params, batch)
    want = [logits]
    for s in range(3):
        lg, caches = bundle.decode_step(params, steps[:, s:s + 1], caches,
                                        P + s)
        want.append(lg)
    mesh = _mesh((2, 2), ("data", "model"))
    tctx, dctx = make_ctx(mesh, "train"), make_ctx(mesh, "decode")
    plans = [spmd.tp_plan(rc, c) for c in (tctx, dctx)]
    assert all(p is not None for p in plans)
    if arch == "whisper_large_v3":
        assert ("decoder", "cross_attn", "wq") in plans[0]
        assert plans[1][("decoder", "cross_attn", "wq")] == [
            (slice(None),) * 4] * 2
    placed = shard_tree(params, tctx.spec_tree_shardings(bundle.specs))
    pre = serve.make_spmd_prefill(bundle, rc, tctx)
    dec = serve.make_spmd_decode_step(bundle, rc, dctx)
    lg, placed_caches = pre(placed, batch)
    rows = [lg]
    for s in range(3):
        lg, placed_caches = dec(placed, steps[:, s:s + 1], placed_caches,
                                P + s)
        rows.append(lg)
    assert _worst(rows, placed_caches, want, caches) <= TOL
