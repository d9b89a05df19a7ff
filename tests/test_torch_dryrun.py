"""Port vs reference: the dry run (``launch/dryrun.py``). Each cell is
built on ``meta`` tensors and a mesh of ``meta`` entries; its per-device
argument bytes come from the port's placements.

The reference's ``build_lowered(rc, mesh, kind).compile()`` runs in
subprocesses on 8 host devices, on a (pod 2, data 2, model 2) mesh built
with ``AxisType.Auto`` axes (ROADMAP R2), for every tiny arch at each of
its supported shapes (sequence 32, batch 8 or the shape's own if less),
and for tiny yi-6b under each sharding profile (``sp``, ``zero1``,
``cp``, ``dp``, ``ep``) at train and decode. It records
``memory_analysis().argument_size_in_bytes`` and the drops its rules
make placing the weights, the batch and the caches (its ``pspec``,
outside the lowering: the lowering's own count also takes in its
activation constraints, which the port's step does not apply).

Tolerances: none. ``argument_bytes`` equals the compiled argument size
and the drops equal the reference's, cell by cell.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys
import textwrap

import pytest

from repro_torch.configs.base import (ARCH_IDS, SHAPES, RunConfig,
                                      get_model_config, resolve,
                                      supported_shapes)
from repro_torch.configs.tiny import tiny_of
from repro_torch.launch import dryrun
from repro_torch.models import registry
from repro_torch.models.module import tree_leaves, tree_paths
from repro_torch.sharding.mesh import make_mesh

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
ROOT = os.path.join(os.path.dirname(__file__), "..")
SEQ, BATCH = 32, 8
CELLS = [(a, s, "default") for a in ARCH_IDS
         for s in supported_shapes(tiny_of(a))]
CELLS += [("yi_6b", s, p) for p in ("sp", "zero1", "cp", "dp", "ep")
          for s in ("train_4k", "decode_32k")]
XLA_FLAGS = ("--xla_force_host_platform_device_count=8 "
             "--xla_backend_optimization_level=0")
N_PROCS = 3

REFERENCE = """
import dataclasses, json, sys
sys.path[:0] = [%r]
import jax, numpy as np
from repro.configs.base import RunConfig, SHAPES, SINGLE_POD
from repro.configs.tiny import tiny_of
from repro.launch import dryrun
from repro.models import registry
from repro.sharding import rules
CELLS, SEQ, BATCH = %r, %r, %r
part, n = int(sys.argv[2]), int(sys.argv[3])
AUTO = jax.sharding.AxisType.Auto
mesh = jax.make_mesh((2, 2, 2), ("pod", "data", "model"),
                     axis_types=(AUTO,) * 3)
out = {}
for i, (arch, shape, prof) in enumerate(CELLS):
    if i %% n != part:
        continue
    sh = SHAPES[shape]
    rc = RunConfig(model=tiny_of(arch), mesh=SINGLE_POD,
                   shape=dataclasses.replace(sh, seq_len=SEQ,
                                             global_batch=min(BATCH,
                                                              sh.global_batch)),
                   sharding_profile=prof)
    kind = dryrun.shape_kind(shape)
    lowered, ctx = dryrun.build_lowered(rc, mesh, kind)
    mem = lowered.compile().memory_analysis()
    # the drops of the placements alone: weights, batch, caches
    rb = registry.build(rc)
    overrides = rules.EP_OVERRIDES if prof == "ep" else ()
    profile = ("decode" if kind == "decode" else
               {"sp": "train_sp", "zero1": "zero1", "cp": "kv_seq",
                "dp": "dp_only"}.get(prof, "train"))
    c = rules.make_ctx(mesh, profile, overrides)
    c.spec_tree_shardings(rb.specs)
    if kind == "decode":
        dryrun.tree_shardings(rb.cache_abstract(rc.shape.global_batch, SEQ),
                              rb.cache_axes(), c)
    dryrun.batch_shardings(rb.input_specs(kind), c)
    out["/".join((arch, shape, prof))] = {
        "argument_bytes": mem.argument_size_in_bytes,
        "placement_drops": len(c.dropped), "lowering_drops": len(ctx.dropped)}
with open(sys.argv[1], "w") as f:
    json.dump(out, f)
""" % (SRC, CELLS, SEQ, BATCH)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's compiled cells, in ``N_PROCS`` subprocesses side by
    side."""
    out = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS=XLA_FLAGS)
    procs = [subprocess.Popen([sys.executable, "-c",
                               textwrap.dedent(REFERENCE),
                               str(out / f"{i}.json"), str(i), str(N_PROCS)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env) for i in range(N_PROCS)]
    cells = {}
    for i, p in enumerate(procs):
        o, e = p.communicate(timeout=300)
        assert p.returncode == 0, f"stdout:\n{o}\nstderr:\n{e}"
        with open(out / f"{i}.json") as f:
            cells.update(json.load(f))
    return cells


@pytest.mark.parametrize("arch,shape,profile", CELLS)
def test_argument_bytes_equal_the_references_compiled(ref, arch, shape,
                                                      profile):
    sh = SHAPES[shape]
    rc = RunConfig(model=tiny_of(arch), sharding_profile=profile,
                   shape=dataclasses.replace(
                       sh, seq_len=SEQ, global_batch=min(BATCH,
                                                         sh.global_batch)))
    mesh = make_mesh((2, 2, 2), ("pod", "data", "model"), ["meta"] * 8)
    rep = dryrun.run_cell(arch, shape, False, rc=rc, mesh=mesh)
    want = ref["/".join((arch, shape, profile))]
    assert rep["memory"]["argument_bytes"] == want["argument_bytes"]
    assert rep["dropped_shardings"] == want["placement_drops"]
    # the lowering's count adds the activation constraints' drops
    assert want["lowering_drops"] >= want["placement_drops"]
    assert rep["memory"]["temp_bytes"] is None
    assert rep["memory"]["generated_code_bytes"] is None
    assert rep["matmul_flops_per_device"] > 0
    assert rep["mesh"] == "2x2x2" and rep["devices"] == 8
    if profile in ("sp", "cp"):
        # sequence and context parallelism split each rank over 'model'
        assert rep["tp_members"] > 1


def test_production_cell_builds_on_meta():
    """``--arch h2o_danube_1_8b --shape train_4k`` on the 16 x 16 meta
    mesh, as a command with its own time limit: no card, no allocation."""
    env = dict(os.environ, PYTHONPATH=SRC, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                        "--arch", "h2o_danube_1_8b", "--shape", "train_4k"],
                       capture_output=True, text=True, timeout=120, env=env,
                       cwd=ROOT)
    assert r.returncode == 0, r.stderr
    lines = r.stdout.strip().splitlines()
    assert lines[0].startswith("[dryrun] OK   h2o_danube_1_8b/train_4k/16x16")
    assert "fits True" in lines[0] and lines[-1] == "[dryrun] all 1 cells built"


def _one_layer_at_a_time(arch):
    """The gathered working set of a data-parallel rank that computes
    alone, reckoned from the specs: the leaves outside the stacks and the
    largest layer of any stack, each element a float32 weight and a
    float32 gradient (the mesh step before it split the products over
    'model': no coordinate may gather more)."""
    specs = registry.build(resolve(arch, "train_4k"), device="meta").specs
    other, layer = 0, {}
    for path, s in tree_paths(specs).items():
        n = 8 * math.prod(s.shape)
        if s.axes[0] == "layers":
            layer[path[0]] = layer.get(path[0], 0) + n // s.shape[0]
        else:
            other += n
    return other + max(layer.values())


def _per_coordinate(arch, multi_pod=False, shape="train_4k"):
    """``fsdp.peak_bytes`` of the specs and the profile's tensor-parallel
    plan on the production mesh: each split leaf at a coordinate's
    region; to train with the float32 gradients, to prefill or decode
    (``sharding/serve.py``, forward only) without."""
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.sharding import fsdp
    from repro_torch.sharding.rules import make_ctx
    from repro_torch.training import spmd
    rc = resolve(arch, shape, multi_pod=multi_pod)
    mesh = make_production_mesh(["meta"] * 512, multi_pod=multi_pod)
    kind = dryrun.shape_kind(shape)
    ctx = make_ctx(mesh, "decode" if kind == "decode" else "train")
    specs = registry.build(rc, device="meta").specs
    return fsdp.peak_bytes(specs, plan=spmd.tp_plan(rc, ctx),
                           grads=kind == "train")


def test_production_figures():
    """h2o-danube-1.8b ``train_4k`` on both production meshes: the
    parameters and moments (1,831,201,280 float32 each) as placed, the
    batch's rows over the data axes, one layer at a time gathered at a
    coordinate's regions (less than a whole layer), and a coordinate's
    matmul flops: its 16-way share of the q/o, MLP, score and head
    products (the 8 key/value heads do not split 16 ways: a member
    projects the one its two query heads read), under an eighth of the
    rank's whole products that a mesh with no 'model' axis counts."""
    from repro_torch.sharding.mesh import make_mesh
    reps = {}
    for mp, rows in ((False, 16), (True, 8)):
        rep = reps[mp] = dryrun.run_cell("h2o_danube_1_8b", "train_4k", mp)
        assert rep["devices"] == (512 if mp else 256)
        assert rep["rank_rows"] == rows
        gathered = rep["memory"]["gathered_bytes"]
        assert gathered == _per_coordinate("h2o_danube_1_8b", mp)
        assert gathered < _one_layer_at_a_time("h2o_danube_1_8b")
        assert rep["fits"] is True and rep["tp_members"] == 16
        assert rep["all_reduced_bytes_per_device"] > 0
        json.dumps(rep)
    whole = dryrun.run_cell("h2o_danube_1_8b", "train_4k", False,
                            mesh=make_mesh((16,), ("data",), ["meta"] * 16))
    assert whole["rank_rows"] == 16 and whole["tp_members"] == 1
    assert reps[False]["matmul_flops_per_device"] * 8 < (
        whole["matmul_flops_per_device"])


@pytest.mark.parametrize("arch", ["mixtral_8x7b", "qwen3_moe_30b_a3b"])
def test_moe_train_cells_fit_one_layer_at_a_time(arch):
    """``train_4k`` on 16 x 16: the arguments as placed and one layer at
    a time gathered, at a coordinate's regions, fit the card's 80 GB,
    where the whole tree gathered would not (the train step reads every
    argument, so no body need run to count them)."""
    from repro_torch.launch.mesh import make_production_mesh
    rc = resolve(arch, "train_4k")
    cell = dryrun.build_cell(rc, make_production_mesh(["meta"] * 512),
                             "train")
    args, _ = dryrun.unique_bytes(cell, None, None)
    gathered = cell["gathered_bytes"]
    assert gathered == _per_coordinate(arch)
    assert gathered <= _one_layer_at_a_time(arch)
    assert args + gathered <= dryrun.HBM_BYTES
    whole = sum(8 * math.prod(t.shape)
                for t in tree_leaves(cell["args"][0][0]))
    assert args + whole > dryrun.HBM_BYTES


TRAIN_CELLS = [(a, mp) for a in ARCH_IDS
               if "train_4k" in supported_shapes(get_model_config(a))
               for mp in (False, True)]


@pytest.mark.parametrize("arch,multi_pod", TRAIN_CELLS)
def test_every_train_cell_fits_per_coordinate(arch, multi_pod):
    """Every ``train_4k`` cell on both production meshes: a coordinate
    gathers no more than a rank that computes alone did, and its
    arguments and gathered working set fit the card."""
    from repro_torch.launch.mesh import make_production_mesh
    rc = resolve(arch, "train_4k", multi_pod=multi_pod)
    mesh = make_production_mesh(["meta"] * 512, multi_pod=multi_pod)
    cell = dryrun.build_cell(rc, mesh, "train")
    args, _ = dryrun.unique_bytes(cell, None, None)
    assert cell["gathered_bytes"] == _per_coordinate(arch, multi_pod)
    assert cell["gathered_bytes"] <= _one_layer_at_a_time(arch)
    assert args + cell["gathered_bytes"] <= dryrun.HBM_BYTES


SERVING_CELLS = [(a, s) for a in ("mixtral_8x7b", "qwen3_moe_30b_a3b")
                 for s in supported_shapes(get_model_config(a))
                 if s != "train_4k"]


@pytest.mark.parametrize("arch,shape", SERVING_CELLS)
def test_moe_serving_cells_fit_per_coordinate(arch, shape):
    """Every ``prefill_32k``, ``decode_32k`` and ``long_500k`` cell of
    the two moe models on 16 x 16: a coordinate gathers its regions of
    the profile's plan one layer at a time, weights alone (under 1 GiB),
    its 'model' group of 16 computes, and the cell fits the card's 80 GB
    (the whole tree gathered, as before the mesh serving path, would
    not)."""
    rep = dryrun.run_cell(arch, shape, False)
    mem = rep["memory"]
    assert mem["gathered_bytes"] == _per_coordinate(arch, shape=shape)
    assert mem["gathered_bytes"] < 2 ** 30
    assert rep["tp_members"] == 16 and rep["fits"] is True
    assert rep["all_reduced_bytes_per_device"] > 0
    whole = sum(4 * math.prod(s.shape) for s in tree_leaves(
        registry.build(resolve(arch, shape), device="meta").specs))
    assert mem["argument_bytes"] + whole > dryrun.HBM_BYTES


def test_meta_meshes():
    """The production and moe meshes take ``meta`` entries (the
    reference's shapes, no device behind them); entries stay all of one
    kind."""
    from repro_torch.launch.mesh import make_moe_mesh, make_production_mesh
    from repro_torch.sharding.mesh import DeviceMesh
    assert make_production_mesh(["meta"] * 512).shape == {"data": 16,
                                                          "model": 16}
    m = make_moe_mesh(["meta"] * 512, multi_pod=True)
    assert m.shape == {"pod": 2, "data": 16, "expert": 8, "model": 2}
    assert {d.type for d in m.devices.flat} == {"meta"}
    with pytest.raises(ValueError, match="all meta"):
        DeviceMesh([["meta", "cpu"]], ("data", "model"))
