"""Port vs reference: the sharding rules (``sharding/rules.py``), the mesh
configs (``configs/base.py``'s mesh half, ``resolve``) and the meshes of
``launch/mesh.py`` / ``sharding/mesh.py``.

The reference's ``pspec`` runs once per module in a subprocess on 8 host
devices (the host-platform device count must be set before JAX starts):
every spec of every tiny config, under every profile, on a (2, 2)
(data, model) mesh, a (2, 2, 2) (pod, data, model) mesh and, with the EP
overrides, a (2, 2, 2) (data, expert, model) mesh, plus hand-made specs
that hit the axis-reuse guard, a drop and the trimming. It writes each
spec and the ``dropped`` record to JSON; the port's must be equal,
``dropped`` in the same order. Exact equality throughout: this is shape
logic."""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch

from repro.configs import base as r_base
from repro.sharding import rules as r_rules
from repro_torch.configs import base
from repro_torch.configs.base import (ARCH_IDS, MULTI_POD, SHAPES,
                                      SINGLE_POD, MeshConfig, RunConfig)
from repro_torch.configs.tiny import tiny_of
from repro_torch.launch import mesh as launch_mesh
from repro_torch.models import registry
from repro_torch.models.module import tree_paths
from repro_torch.sharding import mesh as smesh
from repro_torch.sharding import rules
from repro_torch.sharding.placement import NamedSharding
from repro_torch.sharding.rules import PartitionSpec

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
PROFILES = ("train", "decode", "dp_only", "zero1", "train_sp", "kv_seq")
MESHES = {"dm": ((2, 2), ("data", "model"), ()),
          "pdm": ((2, 2, 2), ("pod", "data", "model"), ()),
          "ep": ((2, 2, 2), ("data", "expert", "model"), "EP")}
# specs no config has: the reuse guard (two dims on 'model'), a drop (3 is
# not divisible by 2), trailing Nones trimmed, activation axes
EXTRA = [((8, 6), ("heads", "mlp")), ((3, 8), ("mlp", "embed")),
         ((4, 4, 4), ("embed", "head_dim", "layers")),
         ((8, 64, 4, 16), ("act_batch", "act_seq", "act_heads", None)),
         ((6, 32, 8), ("act_batch", "act_kv_seq", "act_mlp")),
         ((4, 4), ("cache_seq", "act_vocab")), ((5,), ("act_batch",)),
         ((4, 4), ("experts", "expert_mlp")), ((), ())]

REFERENCE = """
import dataclasses, json, sys
import jax
from repro.configs.base import ARCH_IDS, SHAPES, SINGLE_POD, RunConfig
from repro.configs.tiny import tiny_of
from repro.models import module as mod, registry
from repro.sharding import rules
MESHES, PROFILES, EXTRA = %r, %r, %r
def js(p):
    return [list(e) if isinstance(e, tuple) else e for e in tuple(p)]
out = {}
specs = {}
for arch in ARCH_IDS:
    rc = RunConfig(model=tiny_of(arch), shape=SHAPES["train_4k"],
                   mesh=SINGLE_POD)
    specs[arch] = mod.tree_paths(registry.build(rc).specs)
for name, (shape, axes, ov) in MESHES.items():
    mesh = jax.make_mesh(shape, axes)
    overrides = rules.EP_OVERRIDES if ov else ()
    for profile in PROFILES:
        for arch in ARCH_IDS:
            ctx = rules.make_ctx(mesh, profile, overrides)
            got = {"/".join(k): js(ctx.pspec(s.shape, s.axes))
                   for k, s in sorted(specs[arch].items())}
            out[f"{name}|{profile}|{arch}"] = {
                "pspecs": got, "dropped": [[list(d[0]), d[1], d[2]
                    if isinstance(d[2], str) else list(d[2])]
                    for d in ctx.dropped]}
        ctx = rules.make_ctx(mesh, profile, overrides)
        out[f"{name}|{profile}|extra"] = {
            "pspecs": [js(ctx.pspec(s, a)) for s, a in EXTRA],
            "dropped": [[list(d[0]), d[1], d[2] if isinstance(d[2], str)
                         else list(d[2])] for d in ctx.dropped]}
with open(sys.argv[1], "w") as f:
    json.dump(out, f)
""" % (MESHES, PROFILES, EXTRA)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's specs and drops, computed once for the module."""
    path = tmp_path_factory.mktemp("sharding") / "ref.json"
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(REFERENCE),
                        str(path)], capture_output=True, text=True,
                       timeout=300, env=env)
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"
    with open(path) as f:
        return json.load(f)


def _mesh(name):
    shape, axes, _ = MESHES[name]
    return smesh.make_mesh(shape, axes, ["cpu"] * 8)


def _js(p):
    assert isinstance(p, PartitionSpec)
    return [list(e) if isinstance(e, tuple) else e for e in tuple(p)]


def _dropped(ctx):
    return [[list(d[0]), d[1], d[2] if isinstance(d[2], str) else list(d[2])]
            for d in ctx.dropped]


@pytest.fixture(scope="module")
def specs():
    out = {}
    for arch in ARCH_IDS:
        rc = RunConfig(model=tiny_of(arch), shape=SHAPES["train_4k"])
        out[arch] = tree_paths(registry.build(rc, device="cpu").specs)
    return out


@pytest.mark.parametrize("profile", PROFILES)
@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_pspec_matches_reference_for_every_tiny_spec(ref, specs, mesh_name,
                                                     profile):
    mesh = _mesh(mesh_name)
    overrides = rules.EP_OVERRIDES if MESHES[mesh_name][2] else ()
    for arch in ARCH_IDS:
        want = ref[f"{mesh_name}|{profile}|{arch}"]
        ctx = rules.make_ctx(mesh, profile, overrides)
        got = {"/".join(k): _js(ctx.pspec(s.shape, s.axes))
               for k, s in sorted(specs[arch].items())}
        assert got == want["pspecs"], (arch, mesh_name, profile)
        assert _dropped(ctx) == want["dropped"], (arch, mesh_name, profile)


@pytest.mark.parametrize("profile", PROFILES)
@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_pspec_guard_drop_and_trim_match_reference(ref, mesh_name, profile):
    mesh = _mesh(mesh_name)
    overrides = rules.EP_OVERRIDES if MESHES[mesh_name][2] else ()
    ctx = rules.make_ctx(mesh, profile, overrides)
    want = ref[f"{mesh_name}|{profile}|extra"]
    assert [_js(ctx.pspec(s, a)) for s, a in EXTRA] == want["pspecs"]
    assert _dropped(ctx) == want["dropped"]


def test_the_extra_specs_hit_the_guard_the_drop_and_the_trim():
    """The hand-made specs do what they are there for."""
    ctx = rules.make_ctx(_mesh("pdm"), "train")
    assert tuple(ctx.pspec((8, 6), ("heads", "mlp"))) == ("model",)  # guard
    assert tuple(ctx.pspec((3, 8), ("mlp", "embed"))) == (None, "data")
    assert ctx.dropped == [((3, 8), "mlp", "model")]                 # drop
    assert tuple(ctx.pspec((4, 4, 4), ("embed", "head_dim", "layers"))) \
        == ("data",)                                                 # trim
    assert tuple(ctx.pspec((8, 64), ("act_batch", None))) == (("pod",
                                                              "data"),)


@pytest.mark.parametrize("profile", PROFILES + ("nope",))
@pytest.mark.parametrize("ep", [False, True])
def test_make_rules_equals_reference(profile, ep):
    ov = rules.EP_OVERRIDES if ep else ()
    r_ov = r_rules.EP_OVERRIDES if ep else ()
    if profile == "nope":
        with pytest.raises(ValueError):
            rules.make_rules(profile, ov)
        with pytest.raises(ValueError):
            r_rules.make_rules(profile, r_ov)
        return
    assert rules.make_rules(profile, ov) == r_rules.make_rules(profile, r_ov)


def test_rule_tables_equal_reference():
    assert rules.W_RULES == r_rules.W_RULES
    assert rules.A_RULES == r_rules.A_RULES
    assert rules.EP_OVERRIDES == r_rules.EP_OVERRIDES


def test_without_a_mesh_as_the_reference():
    """No mesh: every spec replicated (empty), ``sharding`` None,
    ``constrain`` the tensor itself; ``null_ctx`` is the train rules."""
    ctx, r_ctx = rules.null_ctx(), r_rules.null_ctx()
    assert ctx.rules == r_ctx.rules
    for s, a in EXTRA:
        assert tuple(ctx.pspec(s, a)) == tuple(r_ctx.pspec(s, a)) == ()
    assert ctx.sharding((4, 4), ("embed", "mlp")) is None
    x = torch.ones(2, 3)
    assert ctx.constrain(x, "act_batch", None) is x
    specs = registry.build(RunConfig(model=tiny_of("yi_6b"),
                                     shape=SHAPES["train_4k"]),
                           device="cpu").specs
    assert all(v is None for v in tree_paths(
        ctx.spec_tree_shardings(specs)).values())
    assert all(tuple(v) == () for v in tree_paths(
        ctx.spec_tree_pspecs(specs)).values())


def test_placement_on_a_mesh_is_refused():
    """With a mesh, only the activation constraint is refused (it names
    the mesh step that stands in for it); placing by a spec gives a
    ``NamedSharding`` of the reference's ``pspec``, never something that
    only looks like one (placements against the reference's own:
    tests/test_torch_placement.py)."""
    ctx = rules.make_ctx(_mesh("dm"), "train")
    s = ctx.sharding((4, 4), ("embed", "mlp"))
    assert isinstance(s, NamedSharding) and s.mesh is ctx.mesh
    assert tuple(s.spec) == tuple(ctx.pspec((4, 4), ("embed", "mlp")))
    with pytest.raises(NotImplementedError, match="training/spmd.py"):
        ctx.constrain(torch.ones(4, 4), "act_batch", None)
    specs = {"w": registry.build(RunConfig(model=tiny_of("yi_6b"),
                                           shape=SHAPES["train_4k"]),
                                 device="cpu").specs["embed"]}
    tree = ctx.spec_tree_shardings(specs)
    assert all(isinstance(v, NamedSharding)
               for v in tree_paths(tree).values())


def test_partition_spec_is_a_tuple():
    p = PartitionSpec(("pod", "data"), None, "model")
    assert tuple(p) == (("pod", "data"), None, "model")
    assert p == (("pod", "data"), None, "model") and len(p) == 3
    assert "PartitionSpec" in repr(p) and tuple(PartitionSpec()) == ()


# -- configs: the mesh half ---------------------------------------------------

def test_mesh_configs_equal_reference():
    for port, ref in ((SINGLE_POD, r_base.SINGLE_POD),
                      (MULTI_POD, r_base.MULTI_POD), (MeshConfig(),
                                                      r_base.MeshConfig())):
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
        assert port.multi_pod == ref.multi_pod
        assert port.num_devices() == ref.num_devices()
        assert port.dp_axes() == ref.dp_axes()
    assert SINGLE_POD.num_devices() == 256 and MULTI_POD.num_devices() == 512
    assert MULTI_POD.dp_axes() == ("pod", "data")
    mc = MeshConfig((4, 2), ("model", "data"))
    assert mc.dp_axes() == ("data",) and not mc.multi_pod


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_resolve_equals_reference(arch):
    for shape in SHAPES:
        for multi_pod in (False, True):
            try:
                want = r_base.resolve(arch, shape, multi_pod=multi_pod,
                                      sharding_profile="zero1")
            except ValueError:
                with pytest.raises(ValueError, match="not supported"):
                    base.resolve(arch, shape, multi_pod=multi_pod)
                continue
            got = base.resolve(arch, shape, multi_pod=multi_pod,
                               sharding_profile="zero1")
            assert dataclasses.asdict(got.model) == {
                k: v for k, v in dataclasses.asdict(want.model).items()}
            assert dataclasses.asdict(got.shape) == dataclasses.asdict(
                want.shape)
            assert dataclasses.asdict(got.mesh) == dataclasses.asdict(
                want.mesh)
            assert dataclasses.asdict(got.train) == dataclasses.asdict(
                want.train)
            assert got.sharding_profile == want.sharding_profile == "zero1"


def test_run_config_defaults():
    """The port's ``mesh`` defaults to SINGLE_POD (the reference's has no
    default); ``sharding_profile`` defaults as the reference's."""
    rc = RunConfig(model=tiny_of("yi_6b"), shape=SHAPES["train_4k"])
    assert rc.mesh == SINGLE_POD and rc.sharding_profile == "default"
    r_rc = r_base.RunConfig(model=None, shape=None, mesh=r_base.SINGLE_POD)
    assert r_rc.sharding_profile == rc.sharding_profile
    assert [f.name for f in dataclasses.fields(RunConfig)] == [
        f.name for f in dataclasses.fields(r_base.RunConfig)
        if f.name != "use_pallas"]


# -- meshes -------------------------------------------------------------------

def test_launch_meshes_shapes_and_axes():
    dev = ["cpu"] * 512
    m = launch_mesh.make_production_mesh(dev)
    assert m.shape == {"data": 16, "model": 16}
    m = launch_mesh.make_production_mesh(dev, multi_pod=True)
    assert m.shape == {"pod": 2, "data": 16, "model": 16}
    m = launch_mesh.make_moe_mesh(dev)
    assert m.shape == {"data": 16, "expert": 8, "model": 2}
    m = launch_mesh.make_moe_mesh(dev, multi_pod=True, experts=4)
    assert m.shape == {"pod": 2, "data": 16, "expert": 4, "model": 4}
    m = launch_mesh.make_test_mesh(["cpu"] * 4)
    assert m.shape == {"data": 2, "model": 2} and m.size == 4
    m = launch_mesh.make_test_mesh(["cpu"] * 9, (2, 2, 2),
                                   ("pod", "data", "model"))
    assert m.axis_names == ("pod", "data", "model") and m.size == 8


@pytest.mark.parametrize("make", [
    lambda d: launch_mesh.make_production_mesh(d),
    lambda d: launch_mesh.make_production_mesh(d, multi_pod=True),
    lambda d: launch_mesh.make_moe_mesh(d),
    lambda d: launch_mesh.make_test_mesh(d),
    lambda d: launch_mesh.make_test_mesh(d, (2, 2, 2),
                                         ("pod", "data", "model"))])
def test_launch_meshes_refuse_too_few_devices(make):
    """Fewer devices than the mesh's size raise; nothing repeats a card."""
    with pytest.raises(ValueError, match="devices for a mesh"):
        make(["cpu"] * 3)


def test_device_mesh_axes_groups_and_sub():
    m = smesh.make_mesh((2, 3), ("pod", "data"),
                        [torch.device("cpu")] * 6)
    assert m.shape == {"pod": 2, "data": 3} and list(m.shape) == ["pod",
                                                                 "data"]
    assert list(m.coords())[:4] == [(0, 0), (0, 1), (0, 2), (1, 0)]
    assert m.groups("data") == [[(0, 0), (0, 1), (0, 2)],
                                [(1, 0), (1, 1), (1, 2)]]
    assert m.groups("pod") == [[(0, 0), (1, 0)], [(0, 1), (1, 1)],
                               [(0, 2), (1, 2)]]
    assert m.axis_index((1, 2), "data") == 2
    sub = m.sub(pod=1)
    assert sub.axis_names == ("data",) and sub.shape == {"data": 3}
    assert m.sub(pod=0, data=1).size == 1
    assert m.distinct_devices() == [torch.device("cpu")]
    assert m == smesh.make_mesh((2, 3), ("pod", "data"), ["cpu"] * 6)
    with pytest.raises(ValueError):
        m.sub(model=0)


def test_device_mesh_refusals():
    with pytest.raises(ValueError):
        smesh.DeviceMesh([["cpu", "cpu"]], ("data",))        # rank
    with pytest.raises(ValueError):
        smesh.DeviceMesh([["cpu"], ["cpu"]], ("data", "data"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            smesh.DeviceMesh(["cuda:0", "cuda:0"], ("stage",))
    else:
        n = torch.cuda.device_count()
        with pytest.raises(RuntimeError, match="not there"):
            smesh.DeviceMesh([f"cuda:{n}"], ("stage",))
