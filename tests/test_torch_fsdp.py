"""The mesh train step gathers one layer at a time (``sharding/fsdp.py``,
``training/spmd.py``): on (data 2, model 2) meshes of CPU entries, with
tiny yi-6b (dense), qwen3-moe-30b-a3b (moe), hymba-1.5b (hybrid, two
stages) and whisper-large-v3 (encoder, cross K/V, decoder).

- A spy on ``ShardedTensor.gather_layer`` shows the order: each rank's
  microbatch gathers the leaves outside the stacks, then the layers
  0 … L−1 in forward and L−1 … 0 in backward, under remat 'none',
  'full' and 'dots' and in microbatches.
- Weakrefs taken by the spy show that when a layer is gathered no other
  layer's gathered weights are alive, and no layer's gradient is.
- ``step.gathered_peak`` equals ``fsdp.peak_bytes`` of the specs and the
  step's tensor-parallel plan (``spmd.tp_plan``: each coordinate gathers
  its region of a split weight) and is below the whole tree's bytes; the
  whole tree gathered at once (the test-only hook ``spmd.stacked_leaf``)
  reports the whole tree at the same regions and gives the same loss and
  parameters.
- Blocks on "distinct devices" (each coordinate's block a copy of its
  own, the layout of distinct cards, on the CPU) give the same step as
  the shared base of one device.
- The step's gathered, reduce-scattered and all-reduced bytes equal the
  roofline's collective bytes (``launch/roofline.py::collective_bytes``),
  averaged over the coordinates that compute.

Tolerances: ``METRIC_TOL`` and ``PARAM_TOL`` of ``tests/test_torch_spmd.py``
(relative 1e-5 for loss and grad norm, 1e-4 absolute for parameters).
"""
import dataclasses
import weakref

import pytest
import torch

from repro_torch.configs.base import SHAPES, RunConfig, TrainConfig
from repro_torch.configs.tiny import tiny_of
from repro_torch.data import make_train_batch
from repro_torch.launch import roofline as R
from repro_torch.models import registry
from repro_torch.models.module import tree_leaves, tree_paths
from repro_torch.optim import adamw_init
from repro_torch.sharding import fsdp
from repro_torch.sharding.collectives import Traffic
from repro_torch.sharding.mesh import make_mesh
from repro_torch.sharding.placement import (NamedSharding, ShardedTensor,
                                            shard_tree)
from repro_torch.sharding.rules import make_ctx
from repro_torch.training import spmd

METRIC_TOL = 1e-5
PARAM_TOL = 1e-4
SEQ = 16
ARCHS = {"dense": "yi_6b", "moe": "qwen3_moe_30b_a3b",
         "hymba": "hymba_1_5b", "whisper": "whisper_large_v3"}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rc(arch, remat="none", batch=4, microbatch=0):
    return RunConfig(model=tiny_of(arch),
                     shape=dataclasses.replace(SHAPES["train_4k"],
                                               seq_len=SEQ,
                                               global_batch=batch),
                     train=TrainConfig(total_steps=50, warmup_steps=2,
                                       loss_chunk=SEQ, remat_policy=remat,
                                       microbatch=microbatch))


def _setup(rc, mesh_shape=(2, 2)):
    mesh = make_mesh(mesh_shape, ("data", "model")[:len(mesh_shape)],
                     ["cpu"] * 4)
    ctx = make_ctx(mesh, "train")
    bundle = registry.build(rc, device="cpu")
    params = shard_tree(
        bundle.init_params(torch.Generator().manual_seed(0)),
        ctx.spec_tree_shardings(bundle.specs))
    bs = {k: ctx.sharding(s.shape, ("act_batch",) + (None,) * (s.ndim - 1))
          for k, s in bundle.input_specs("train").items()}
    batch = make_train_batch(rc, 0, "cpu", mesh, bs)
    return mesh, ctx, bundle, params, batch


def _plan(rc):
    """The step's tensor-parallel plan on the (data 2, model 2) mesh."""
    mesh = make_mesh((2, 2), ("data", "model"), ["cpu"] * 4)
    return spmd.tp_plan(rc, make_ctx(mesh, "train"))


def _step(rc, params=None, setup=None):
    mesh, ctx, bundle, p0, batch = setup or _setup(rc)
    params = p0 if params is None else params
    step = spmd.make_spmd_train_step(bundle, rc, ctx)
    _, _, metrics = step(params, adamw_init(params), batch)
    return step, {k: float(v) for k, v in metrics.items()}, params, bundle


class _Spy:
    """Every ``gather_layer`` and ``scatter_add`` of a step: (stack,
    layer) or (None, None) for a leaf outside the stacks, and weakrefs
    of the gathered tensors and of the layers' gradients."""

    def __init__(self, monkeypatch, params):
        self.names = {id(x): p for p, x in tree_paths(params).items()}
        self.events = []           # (kind, stack, layer)
        self.tensors = []          # (stack, layer, weakref)
        self.grads = []            # (stack, layer, weakref)
        self.violations = []
        self.phase = "forward"
        gather, scatter = ShardedTensor.gather_layer, \
            ShardedTensor.scatter_add
        backward = fsdp.Group.backward
        spy = self

        def rank_backward(rank, loss):
            spy.phase = "backward"
            try:
                backward(rank, loss)
            finally:
                spy.phase = "forward"

        def gather_layer(x, device, layer=None, traffic=None, at=None,
                         index=None):
            key = (spy.names[id(x)][0] if layer is not None else None, layer)
            spy._check(key)
            t = gather(x, device, layer, traffic, at, index)
            spy.events.append((spy.phase,) + key)
            spy.tensors.append(key + (weakref.ref(t),))
            return t

        def scatter_add(x, grad, into, layer=None, index=None):
            key = (spy.names[id(x)][0] if layer is not None else None, layer)
            scatter(x, grad, into, layer, index)
            if layer is not None:
                spy.grads.append(key + (weakref.ref(grad),))
        monkeypatch.setattr(ShardedTensor, "gather_layer", gather_layer)
        monkeypatch.setattr(ShardedTensor, "scatter_add", scatter_add)
        monkeypatch.setattr(fsdp.Group, "backward", rank_backward)

    def _check(self, key):
        """Before a gather: no other layer's gathered weights alive, and
        no layer's gradient."""
        if key[1] is None:
            return
        for s, i, ref in self.tensors:
            if i is not None and (s, i) != key and ref() is not None:
                self.violations.append(("weights", (s, i), "at", key))
        for s, i, ref in self.grads:
            if ref() is not None:
                self.violations.append(("gradient", (s, i), "at", key))

    def runs(self):
        """The layers' order, one (forward, backward) pair per rank's
        microbatch: the (stack, layer) of each run of consecutive
        gathers."""
        out = []
        for phase, s, i in self.events:
            if i is None:
                if not out or out[-1] != ([], []):
                    out.append(([], []))
                continue
            seq = out[-1][phase == "backward"]
            if not seq or seq[-1] != (s, i):
                seq.append((s, i))
        return out


def _layers(bundle):
    """(stack, layer) in forward order, as the model runs them; whisper
    runs its encoder, the cross K/V of every decoder layer, then the
    decoder."""
    order = []
    for path, spec in tree_paths(bundle.specs).items():
        if fsdp.stacked(spec) and path[0] not in [s for s, _ in order]:
            order.append((path[0], spec.shape[0]))
    fwd = [(s, i) for s, n in order for i in range(n)]
    if dict(order).get("decoder"):
        dec = [(s, i) for s, i in fwd if s == "decoder"]
        fwd = [(s, i) for s, i in fwd if s != "decoder"] + dec + dec
    return fwd


ORDER_CASES = [(a, r, 0) for a in ("dense", "moe", "hymba")
               for r in ("none", "full", "dots")]
ORDER_CASES += [("whisper", "none", 0), ("whisper", "full", 0),
                ("dense", "full", 2), ("moe", "none", 2)]


@pytest.mark.parametrize("arch,remat,microbatch", ORDER_CASES)
def test_layers_gathered_in_order_and_let_go(monkeypatch, arch, remat,
                                             microbatch):
    rc = _rc(ARCHS[arch], remat, microbatch=microbatch)
    setup = _setup(rc)
    spy = _Spy(monkeypatch, setup[3])
    step, metrics, _, bundle = _step(rc, setup=setup)
    fwd = _layers(bundle)
    runs = spy.runs()
    n_runs = (4 // (microbatch or 4)) * 2        # microbatches x ranks
    assert len(runs) == n_runs
    for forward, backward in runs:
        assert forward == fwd and backward == fwd[::-1]
    assert spy.violations == []
    assert all(ref() is None for *_, ref in spy.tensors + spy.grads)
    assert metrics["loss"] > 0


@pytest.mark.parametrize("arch", list(ARCHS))
def test_gathered_peak_is_the_specs_reckoning(arch):
    rc = _rc(ARCHS[arch], "full")
    step, _, _, bundle = _step(rc)
    plan = _plan(rc)
    want = fsdp.peak_bytes(bundle.specs, plan=plan)
    assert step.gathered_peak == want
    assert want < fsdp.whole_bytes(bundle.specs, plan=plan)
    # every arch splits (whisper too: its heads, MLP columns and
    # vocabulary), so a coordinate holds less than a rank computing alone
    unsplit = fsdp.peak_bytes(bundle.specs)
    assert plan is not None and want < unsplit
    # the reckoning by hand: the largest layer of any stack and every
    # leaf outside the stacks, float32 weights and gradients
    layer, other = {}, 0
    for path, s in tree_paths(bundle.specs).items():
        n = 8 * torch.Size(s.shape).numel()
        if s.axes[0] == "layers":
            layer[path[0]] = layer.get(path[0], 0) + n // s.shape[0]
        else:
            other += n
    assert unsplit == other + max(layer.values())


def _logical(params):
    return [x.gather("cpu") for x in tree_leaves(params)]


@pytest.mark.parametrize("arch,remat", [("dense", "full"), ("moe", "none"),
                                        ("hymba", "dots")])
def test_whole_tree_gathered_gives_the_same_step(monkeypatch, arch, remat):
    """The control: every stacked leaf gathered whole for the microbatch
    (``spmd.stacked_leaf`` replaced) holds the whole tree and moves the
    same values."""
    rc = _rc(ARCHS[arch], remat, microbatch=2)
    step, m, params, bundle = _step(rc)
    with monkeypatch.context() as mp:
        mp.setattr(spmd, "stacked_leaf",
                   lambda x, rank: rank.gather_whole(x))
        whole, mw, pw, _ = _step(rc)
    plan = _plan(rc)
    assert whole.gathered_peak == fsdp.whole_bytes(bundle.specs, plan=plan)
    assert step.gathered_peak == fsdp.peak_bytes(bundle.specs, plan=plan)
    for k in ("loss", "aux_loss", "grad_norm"):
        assert abs(m[k] - mw[k]) <= METRIC_TOL * max(abs(mw[k]), 1e-6), k
    for a, b in zip(_logical(params), _logical(pw), strict=True):
        torch.testing.assert_close(a, b, rtol=0, atol=PARAM_TOL)


def _blocks_only(x: ShardedTensor) -> ShardedTensor:
    """``x`` with every coordinate's block a copy of its own and no base:
    the layout of distinct cards, on the CPU."""
    whole = x.gather("cpu")
    sh = x.sharding
    blocks = {}
    for c in sh.mesh.coords():
        key = sh.key(c, x.ndim)
        blocks[(torch.device("cpu"), key)] = whole[
            sh.key_index(key, x.shape)].clone()
    return ShardedTensor(sh, x.shape, x.dtype, {}, blocks)


@pytest.mark.parametrize("arch,remat", [("dense", "none"), ("moe", "full")])
def test_assembled_blocks_give_the_same_step(arch, remat):
    """Layers assembled from blocks (no shared base) and the gradients
    added into each owner's blocks give the step of the shared base."""
    rc = _rc(ARCHS[arch], remat, microbatch=2)
    setup = _setup(rc)
    _, m, params, bundle = _step(rc, setup=setup)
    setup = _setup(rc)
    blocks = {id(x): _blocks_only(x) for x in tree_leaves(setup[3])}

    def swap(t):
        if isinstance(t, dict):
            return {k: swap(v) for k, v in t.items()}
        return blocks[id(t)]
    split = swap(setup[3])
    step, mb, _, _ = _step(rc, params=split, setup=setup)
    assert step.gathered_peak == fsdp.peak_bytes(bundle.specs,
                                                 plan=_plan(rc))
    for k in ("loss", "aux_loss", "grad_norm"):
        assert abs(m[k] - mb[k]) <= METRIC_TOL * max(abs(m[k]), 1e-6), k
    for a, b in zip(_logical(params), _logical(split), strict=True):
        torch.testing.assert_close(a, b, rtol=0, atol=PARAM_TOL)


@pytest.mark.parametrize("spec", [(None, "data", "model"),
                                  (None, ("data", "model")), (None,),
                                  (None, None, "model")])
def test_one_layer_gathered_and_scattered(spec):
    """``gather_layer`` gives index i of the leading dim, from a base or
    from blocks, counting that layer's share of the whole gather;
    ``scatter_add`` adds a layer's gradient into the owners' blocks."""
    mesh = make_mesh((2, 2), ("data", "model"), ["cpu"] * 4)
    x = torch.randn(3, 4, 6)
    sh = NamedSharding(mesh, spec)
    for st in (sh.shard(x), _blocks_only(sh.shard(x))):
        whole = Traffic()
        st.count_gather("cpu", whole, (0, 1))
        per = Traffic()
        for i in range(3):
            t = st.gather_layer("cpu", i, per, (0, 1))
            assert t.equal(x[i]) and t._base is None
        assert per.local == whole.local and per.moved == whole.moved
        assert st.gather_layer("cpu").equal(x)
        accs = [torch.zeros_like(u) for u in st.owned_units()]
        g = torch.randn(3, 4, 6)
        for i in range(3):
            st.scatter_add(g[i], accs, i)
        st.scatter_add(g, accs)
        got = torch.empty_like(x)
        for (dev, key), a in zip(st.owned_keys(), accs):
            got[... if key is None else sh.key_index(key, x.shape)] = a
        torch.testing.assert_close(got, 2 * g, rtol=0, atol=0)
        s_whole, s_per = Traffic(), Traffic()
        st.count_scatter((1, 0), s_whole)
        for _ in range(3):
            st.count_scatter((1, 0), s_per, layer=True)
        assert s_per.local == s_whole.local


def test_a_sharded_leading_dim_is_refused():
    mesh = make_mesh((2, 2), ("data", "model"), ["cpu"] * 4)
    st = NamedSharding(mesh, ("data",)).shard(torch.randn(4, 2))
    with pytest.raises(ValueError, match="leading dim is sharded"):
        st.gather_layer("cpu", 0)


@pytest.mark.parametrize("arch,microbatch", [("moe", 2), ("hymba", 0),
                                             ("whisper", 2)])
def test_traffic_equals_the_rooflines_collective_bytes(arch, microbatch):
    """Every microbatch and coordinate that computes (both of each
    rank's 'model' coordinates, whisper's too): the stacked leaves
    gathered in forward and in backward (whisper's cross K/V weights
    twice each), the other leaves once, every gradient reduce-scattered,
    and with tensor parallelism the members' parts of the group's sums
    all-reduced (x 2 on the wire)."""
    rc = _rc(ARCHS[arch], "full", microbatch=microbatch)
    step, _, _, _ = _step(rc)
    got = R.collective_bytes(rc, make_mesh((2, 2), ("data", "model"),
                                           ["meta"] * 4), "train")
    t = step.traffic
    n = got["ranks"]
    assert n == 4
    want = {
        "all-gather": (t["gathered"].local + t["gathered"].moved) / n,
        "reduce-scatter": (t["reduce_scattered"].local
                           + t["reduce_scattered"].moved) / n,
        "all-reduce": 2 * (t["all_reduced"].local
                           + t["all_reduced"].moved) / n}
    assert want["all-reduce"] > 0
    assert got["by_kind"] == want


def test_plain_trees_pass_the_seam_untouched():
    """Without handles the seam calls the layer as it is."""
    lp = {"w": torch.ones(2)}
    seen = []

    def f(tree, x):
        seen.append(tree)
        return x
    assert fsdp.gathered(f)(lp, 3) == 3 and fsdp.hooked(f)(lp, 4) == 4
    assert seen[0] is lp and seen[1] is lp
