"""Port vs reference: weights placed by a ``PartitionSpec`` on a mesh
(``repro_torch.sharding.placement``) and the collectives over named axes.

The reference's placements run once per module in a subprocess on 8
host devices (the host-platform device count must be set before JAX
starts, and the mesh is built with ``AxisType.Auto`` axes): for every
leaf of tiny yi-6b, qwen3-moe-30b-a3b, hymba-1.5b and whisper-large-v3,
on (data 2, model 2) and (pod 2, data 2, model 2), ``jax.device_put(x,
ctx.sharding(shape, axes))`` of ``x = arange`` records each device's
``addressable_shards`` index and a digest of its data (first, last and
sum); ``all_gather`` and ``psum_scatter`` run in a ``shard_map`` on
numpy inputs. Everything is written to a JSON / ``.npz`` file that the
port's cases read, the devices mapped to mesh coordinates by id.

Tolerances: none. Indices and blocks are exact; the collectives' sums of
float32 values are held to the reference's within 1 ulp of its result.
"""
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
from repro_torch.models import registry
from repro_torch.models.module import map_specs, tree_paths
from repro_torch.sharding import collectives as coll
from repro_torch.sharding.collectives import MeshValue, Traffic
from repro_torch.sharding.mesh import make_mesh
from repro_torch.sharding.placement import (NamedSharding, ShardedTensor,
                                            gather, shard_tree)
from repro_torch.sharding.rules import make_ctx

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
ARCHS = ("yi_6b", "qwen3_moe_30b_a3b", "hymba_1_5b", "whisper_large_v3")
MESHES = {"dm": ((2, 2), ("data", "model")),
          "pdm": ((2, 2, 2), ("pod", "data", "model"))}
# the collectives: a [4, 6, 8] value per coordinate of (pod, data, model)
COLL = [("data", 1), (("data", "model"), 0), ("model", 2),
        (("pod", "data"), 0)]

REFERENCE = """
import json, sys
sys.path[:0] = [%r]
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from jax.experimental.shard_map import shard_map
from repro.configs.base import RunConfig, SHAPES, SINGLE_POD
from repro.configs.tiny import tiny_of
from repro.models import module, registry
from repro.sharding import rules
ARCHS, MESHES, COLL = %r, %r, %r
AUTO = jax.sharding.AxisType.Auto
out = {"place": {}, "coords": {}}
for name, (shape, axes) in MESHES.items():
    n = int(np.prod(shape))
    mesh = jax.make_mesh(shape, axes, devices=jax.devices()[:n],
                         axis_types=(AUTO,) * len(shape))
    out["coords"][name] = {str(mesh.devices[c].id): list(c)
                           for c in np.ndindex(mesh.devices.shape)}
    ctx = rules.make_ctx(mesh, "train")
    for arch in ARCHS:
        rb = registry.build(RunConfig(model=tiny_of(arch),
                                      shape=SHAPES["train_4k"], mesh=SINGLE_POD))
        leaves = {}
        for path, spec in module.tree_paths(rb.specs).items():
            x = np.arange(np.prod(spec.shape), dtype=np.float32).reshape(
                spec.shape)
            arr = jax.device_put(x, ctx.sharding(spec.shape, spec.axes))
            shards = {}
            for s in arr.addressable_shards:
                idx = [[sl.start or 0,
                        dim if sl.stop is None else sl.stop]
                       for sl, dim in zip(s.index, spec.shape)]
                d = np.asarray(s.data, np.float64)
                shards[str(s.device.id)] = [idx, float(d.ravel()[0]),
                                            float(d.ravel()[-1]),
                                            float(d.sum())]
            leaves["/".join(path)] = shards
        out["place"][name + ":" + arch] = leaves

# the collectives, in a shard_map over every axis of (pod, data, model)
shape, axes = MESHES["pdm"]
mesh = jax.make_mesh(shape, axes, axis_types=(AUTO,) * 3)
rng = np.random.default_rng(23)
x = rng.standard_normal(shape + (4, 6, 8)).astype(np.float32)
spec = P("pod", "data", "model")
res = {"x": x}
for i, (ax, dim) in enumerate(COLL):
    ax = tuple(ax) if isinstance(ax, list) else ax
    def ag(v, ax=ax, dim=dim):
        return jax.lax.all_gather(v[0, 0, 0], ax, axis=dim,
                                  tiled=True)[None, None, None]
    def rs(v, ax=ax, dim=dim):
        return jax.lax.psum_scatter(v[0, 0, 0], ax, scatter_dimension=dim,
                                    tiled=True)[None, None, None]
    for nm, f in (("ag", ag), ("rs", rs)):
        g = jax.jit(shard_map(f, mesh=mesh, in_specs=spec, out_specs=spec,
                              check_rep=False))
        res[f"{nm}{i}"] = np.asarray(g(x))
np.savez(sys.argv[1] + ".npz", **res)
with open(sys.argv[1], "w") as f:
    json.dump(out, f)
""" % (SRC, ARCHS, MESHES, COLL)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's placements and collectives, once for the module."""
    path = tmp_path_factory.mktemp("placement") / "ref.json"
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(REFERENCE),
                        str(path)], capture_output=True, text=True,
                       timeout=300, env=env)
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"
    with open(path) as f:
        out = json.load(f)
    with np.load(str(path) + ".npz") as z:
        out["coll"] = dict(z)
    return out


def _mesh(name, devices=None):
    shape, axes = MESHES[name]
    return make_mesh(shape, axes, devices or ["cpu"] * 8)


def _specs(arch):
    return registry.build(RunConfig(model=tiny_of(arch),
                                    shape=SHAPES["train_4k"]),
                          device="cpu").specs


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_blocks_equal_the_references_addressable_shards(ref, arch,
                                                        mesh_name):
    """Every leaf: ``index`` and the block ``shard`` leaves at each
    coordinate are the reference's shard on the device at that
    coordinate; ``gather(shard(x))`` is ``x``."""
    mesh = _mesh(mesh_name)
    ctx = make_ctx(mesh, "train")
    coord_of = {k: tuple(v) for k, v in ref["coords"][mesh_name].items()}
    want = ref["place"][f"{mesh_name}:{arch}"]
    specs = tree_paths(_specs(arch))
    assert sorted("/".join(p) for p in specs) == sorted(want)
    for path, spec in specs.items():
        x = torch.arange(int(np.prod(spec.shape)),
                         dtype=torch.float32).reshape(spec.shape)
        sharding = ctx.sharding(spec.shape, spec.axes)
        assert isinstance(sharding, NamedSharding) and hasattr(sharding,
                                                               "spec")
        st = sharding.shard(x)
        shards = want["/".join(path)]
        assert len(shards) == mesh.size
        for dev_id, (idx, first, last, total) in shards.items():
            c = coord_of[dev_id]
            got = [[s.start or 0, n if s.stop is None else s.stop]
                   for s, n in zip(sharding.index(c, spec.shape),
                                   spec.shape)]
            assert got == idx, (path, c)
            block = st.block(c)
            np.testing.assert_array_equal(
                block.numpy(), x[tuple(slice(a, b) for a, b in idx)].numpy())
            b = block.double()
            assert (float(b.flatten()[0]), float(b.flatten()[-1]),
                    float(b.sum())) == (first, last, total), (path, c)
        assert st.gather("cpu") is x          # one device: the base itself


@pytest.mark.parametrize("arch", ARCHS)
def test_one_device_holds_each_leaf_once(arch):
    """Four entries of one device share storage: each leaf is stored once,
    every block a view of it, and a gather takes its blocks from the same
    device (bytes ``local``, none ``moved``)."""
    mesh = _mesh("dm")
    ctx = make_ctx(mesh, "train")
    for path, spec in tree_paths(_specs(arch)).items():
        x = torch.randn(spec.shape)
        st = ctx.sharding(spec.shape, spec.axes).shard(x)
        assert st.stored_nbytes() == {torch.device("cpu"): x.nbytes}
        for c in mesh.coords():
            assert st.block(c).untyped_storage().data_ptr() == \
                x.untyped_storage().data_ptr()
        t = Traffic()
        assert st.gather("cpu", traffic=t, at=(0, 0)) is x
        assert t.moved == 0
        assert t.local == x.nbytes - st.block_nbytes()
        assert st.owned_units() == [x] and st.replica_pairs() == []


def _blocks_only(sharding, x, devices):
    """A ShardedTensor whose blocks are copies on each coordinate's
    device: the layout of distinct cards, on the CPU."""
    blocks = {}
    for c in sharding.mesh.coords():
        key = sharding.key(c, x.ndim)
        blocks[(devices[c], key)] = x[sharding.key_index(
            key, x.shape)].clone()
    return ShardedTensor(sharding, x.shape, x.dtype, {}, blocks)


def test_gather_assembles_blocks_in_order():
    """Without a base, ``gather`` places every block at its index; the
    reversed order along 'model' is another tensor."""
    mesh = _mesh("pdm")
    x = torch.randn(8, 12, 3)
    for spec in [(("pod", "data"), "model"), ("model",), (None, "data"),
                 (), (("model", "data"),)]:
        sh = NamedSharding(mesh, spec)
        st = _blocks_only(sh, x, {c: torch.device("cpu")
                                  for c in mesh.coords()})
        out = st.gather("cpu")
        assert out is not x
        torch.testing.assert_close(out, x, rtol=0, atol=0)
        assert gather(st, "cpu").equal(x)
    sh = NamedSharding(mesh, (None, "model"))
    st = _blocks_only(sh, x, {c: torch.device("cpu") for c in mesh.coords()})
    rev = torch.cat([st.block((0, 0, 1)), st.block((0, 0, 0))], dim=1)
    assert not rev.equal(st.gather("cpu"))


def test_owned_units_cover_each_element_once():
    """A block held by several coordinates is owned by the first: the
    owned units cover the tensor once (what the clip's norm and AdamW
    run over), however many coordinates hold each block."""
    mesh = _mesh("pdm")
    x = torch.randn(4, 8)
    for spec in [("model",), (None, ("pod", "data")), (), ("data", "pod")]:
        sh = NamedSharding(mesh, spec)
        for st in (sh.shard(x), _blocks_only(sh, x, {
                c: torch.device("cpu") for c in mesh.coords()})):
            units = st.owned_units()
            assert sum(u.numel() for u in units) == x.numel()
            torch.testing.assert_close(
                sum(u.square().sum() for u in units), x.square().sum())
            assert st.replica_pairs() == []
        n_keys = len({sh.key(c, x.ndim) for c in mesh.coords()})
        assert len(_blocks_only(sh, x, {c: torch.device("cpu") for c in
                                        mesh.coords()}).owned_units()) == \
            n_keys


def test_shard_tree_and_placements_of_a_mesh():
    """``spec_tree_shardings`` gives a ``NamedSharding`` per leaf of the
    reference's ``pspec``, and ``shard_tree`` places a tree by it;
    ``constrain`` on a mesh raises, naming the mesh step."""
    mesh = _mesh("dm")
    ctx = make_ctx(mesh, "train")
    specs = _specs("yi_6b")
    sh = ctx.spec_tree_shardings(specs)
    params = map_specs(lambda s: torch.randn(s.shape), specs)
    placed = shard_tree(params, sh)
    flat = tree_paths(params)
    for path, spec in tree_paths(specs).items():
        v = tree_paths(placed)[path]
        assert isinstance(v, ShardedTensor)
        assert v.gather("cpu") is flat[path]
        assert tuple(v.sharding.spec) == tuple(ctx.pspec(spec.shape,
                                                         spec.axes))
    with pytest.raises(NotImplementedError, match="spmd.py"):
        ctx.constrain(torch.ones(4, 4), "act_batch", None)


@pytest.mark.parametrize("i", range(len(COLL)))
def test_collectives_equal_the_references(ref, i):
    """``all_gather`` / ``reduce_scatter`` over named axes equal
    ``jax.lax.all_gather(tiled=True)`` / ``psum_scatter(tiled=True)`` in a
    ``shard_map``; between entries of one device they move nothing."""
    mesh = _mesh("pdm")
    axes, dim = COLL[i]
    axes = tuple(axes) if isinstance(axes, list) else axes
    x = ref["coll"]["x"]
    v = MeshValue(mesh, {c: torch.from_numpy(x[c]) for c in mesh.coords()})
    t = Traffic()
    ag = coll.all_gather(v, axes, dim, traffic=t)
    rs = coll.reduce_scatter(v, axes, dim, traffic=t)
    assert t.moved == 0 and t.local > 0
    for c in mesh.coords():
        np.testing.assert_array_equal(ag[c].numpy(), ref["coll"][f"ag{i}"][c])
        want = ref["coll"][f"rs{i}"][c]
        assert np.all(np.abs(rs[c].numpy() - want)
                      <= np.spacing(np.abs(want)))


def test_collectives_carry_gradients():
    """``all_gather``'s backward is a reduce-scatter of the cotangent, and
    ``reduce_scatter``'s an all-gather."""
    mesh = _mesh("dm")
    xs = {c: torch.randn(4, 6, requires_grad=True) for c in mesh.coords()}
    v = MeshValue(mesh, xs)
    ag = coll.all_gather(v, "model", 1)
    w = {c: torch.randn(4, 12) for c in mesh.coords()}
    sum((ag[c] * w[c]).sum() for c in mesh.coords()).backward()
    want = coll.reduce_scatter(MeshValue(mesh, w), "model", 1)
    for c in mesh.coords():
        torch.testing.assert_close(xs[c].grad, want[c])
    ys = {c: torch.randn(4, 6, requires_grad=True) for c in mesh.coords()}
    rs = coll.reduce_scatter(MeshValue(mesh, ys), "data", 0)
    u = {c: torch.randn(2, 6) for c in mesh.coords()}
    sum((rs[c] * u[c]).sum() for c in mesh.coords()).backward()
    want = coll.all_gather(MeshValue(mesh, u), "data", 0)
    for c in mesh.coords():
        torch.testing.assert_close(ys[c].grad, want[c])


def test_gather_of_adjacent_views_is_a_view():
    """On one device, gathering blocks that are adjacent views of one
    tensor returns a view of it (no copy)."""
    mesh = _mesh("dm")
    x = torch.randn(4, 6)
    st = NamedSharding(mesh, ("data",)).shard(x)
    ag = coll.all_gather(st.local_blocks(), "data", 0)
    for c in mesh.coords():
        assert ag[c].data_ptr() == x.data_ptr() and ag[c].equal(x)


def test_clip_counts_each_element_of_the_blocks_once():
    """``clip_by_global_norm`` over sharded leaves (replicated ones among
    them) equals the clip of the logical tensors: each element counted
    once, the scale applied once."""
    from repro_torch.optim import clip_by_global_norm
    mesh = _mesh("pdm")
    g = torch.Generator().manual_seed(3)
    logical = [torch.randn(8, 4, generator=g) * 3 for _ in range(3)]
    specs = [("model", "data"), (), ("pod",)]
    sharded = [NamedSharding(mesh, sp).shard(x.clone())
               for sp, x in zip(specs, logical)]
    _, n = clip_by_global_norm(sharded, 1.0)
    _, want = clip_by_global_norm(logical, 1.0)
    torch.testing.assert_close(n, want, rtol=1e-6, atol=0)
    for st, x in zip(sharded, logical):
        torch.testing.assert_close(st.gather("cpu"), x, rtol=1e-6, atol=0)
