"""Port vs reference: the elastic restart, the port's counterpart of
tests/test_elastic.py. A checkpoint written by ``train_loop`` on one mesh
resumes on another: the checkpoint holds logical arrays, and the restore
places every leaf by the new mesh's shardings
(``restore_checkpoint(shardings=)``).

The reference runs once for the module in a subprocess on 4 host devices
with ``AxisType.Auto`` meshes (ROADMAP R2): tiny yi-6b, sequence 16,
batch 4, ``TrainConfig(total_steps=50, warmup_steps=2, loss_chunk=16)``
(remat 'full', the default), 3 steps on (data 2) with a checkpoint, then
2 more resumed on (data 2, model 2); and the uninterrupted run of 5
steps on one device. Its weights are drawn through
``reference_init_params`` (the same in every process) and written out
for the port's ``train_loop(params=)``. Checkpoints are read across the
two packages both ways.

Tolerances: loss and grad norm within relative 1e-5, parameters and
moments within 1e-4 absolute (float32), as tests/test_torch_spmd.py;
checkpoints read across packages bit for bit.
"""
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro.checkpoint import restore_checkpoint as r_restore
from repro_torch.checkpoint import (latest_step, restore_checkpoint,
                                    save_checkpoint)
from repro_torch.configs.base import SHAPES, RunConfig, TrainConfig
from repro_torch.configs.tiny import tiny_of
from repro_torch.convert import params_from_reference
from repro_torch.models import registry
from repro_torch.models.module import tree_leaves, tree_paths
from repro_torch.optim import AdamWState, adamw_init
from repro_torch.sharding.mesh import make_mesh
from repro_torch.sharding.placement import NamedSharding, ShardedTensor
from repro_torch.sharding.rules import make_ctx
from repro_torch.training.trainer import train_loop

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
HERE = os.path.dirname(__file__)
METRIC_TOL = 1e-5
PARAM_TOL = 1e-4
XLA_FLAGS = ("--xla_force_host_platform_device_count=4 "
             "--xla_backend_optimization_level=0")

REFERENCE = """
import dataclasses, json, os, sys
sys.path[:0] = [%r, %r]
import numpy as np, jax, jax.numpy as jnp
from _torch_parity import reference_init_params
from repro.configs.base import RunConfig, SHAPES, SINGLE_POD, TrainConfig
from repro.configs.tiny import tiny_of
from repro.models import module, registry
from repro.training import trainer
out = sys.argv[1]
build = registry.build
def build_fixed(rc):
    rb = build(rc)
    draw = jax.jit(lambda k: reference_init_params(rb.specs, k, jnp.float32))
    return dataclasses.replace(rb, init_params=lambda k, dtype=None: draw(k))
trainer.registry.build = build_fixed
AUTO = jax.sharding.AxisType.Auto
def mesh(shape, axes):
    return jax.make_mesh(shape, axes, devices=jax.devices()[:int(np.prod(shape))],
                         axis_types=(AUTO,) * len(shape))
rc = RunConfig(model=tiny_of("yi_6b"),
               shape=dataclasses.replace(SHAPES["train_4k"], seq_len=16,
                                         global_batch=4),
               mesh=SINGLE_POD,
               train=TrainConfig(total_steps=50, warmup_steps=2,
                                 loss_chunk=16))
quiet = dict(log_every=0, log_fn=lambda *x: None)
ck = os.path.join(out, "elastic")
r1 = trainer.train_loop(rc, num_steps=3, mesh=mesh((2,), ("data",)),
                        ckpt_dir=ck, ckpt_every=3, **quiet)
import shutil
shutil.copytree(ck, os.path.join(out, "phase1"))
r2 = trainer.train_loop(rc, num_steps=2, mesh=mesh((2, 2), ("data", "model")),
                        ckpt_dir=ck, ckpt_every=50, **quiet)
r0 = trainer.train_loop(rc, num_steps=5, ckpt_dir=os.path.join(out, "whole"),
                        ckpt_every=50, **quiet)
params = build_fixed(rc).init_params(jax.random.key(rc.train.seed))
np.savez(os.path.join(out, "init.npz"), **{
    "/".join(p): np.asarray(v) for p, v in module.tree_paths(params).items()})
with open(os.path.join(out, "ref.json"), "w") as f:
    json.dump({"phase1": r1.final_metrics, "phase2": r2.final_metrics,
               "resumed_from": r2.resumed_from, "whole": r0.final_metrics}, f)
""" % (SRC, HERE)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Tiny tensors on one intra-op thread (see tests/test_torch_spmd.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("elastic")
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS=XLA_FLAGS)
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(REFERENCE),
                        str(out)], capture_output=True, text=True,
                       timeout=300, env=env)
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"
    with open(out / "ref.json") as f:
        return out, json.load(f)


def _rc():
    return RunConfig(model=tiny_of("yi_6b"),
                     shape=dataclasses.replace(SHAPES["train_4k"],
                                               seq_len=16, global_batch=4),
                     train=TrainConfig(total_steps=50, warmup_steps=2,
                                       loss_chunk=16))


def _mesh(shape, axes):
    return make_mesh(shape, axes, ["cpu"] * int(np.prod(shape)))


def _ref_tree(out):
    """The reference's initial weights, as numpy."""
    tree = {}
    with np.load(out / "init.npz") as z:
        for k, v in z.items():
            *p, leaf = k.split("/")
            d = tree
            for seg in p:
                d = d.setdefault(seg, {})
            d[leaf] = v
    return tree


def _init(out):
    return params_from_reference(_ref_tree(out), device="cpu")


def _ckpt(d, step):
    path = os.path.join(d, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        man = json.load(f)
    return {k: np.load(os.path.join(path, v["file"]))
            for k, v in man["leaves"].items()}


def _same_run(got_metrics, got_dir, want_metrics, want_dir, step):
    for k in ("loss", "grad_norm"):
        assert abs(got_metrics[k] - want_metrics[k]) <= METRIC_TOL * abs(
            want_metrics[k]), (k, got_metrics[k], want_metrics[k])
    got, want = _ckpt(got_dir, step), _ckpt(want_dir, step)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=PARAM_TOL,
                                   err_msg=k)


QUIET = dict(log_every=0, log_fn=lambda *x: None)


def test_elastic_restart_matches_the_references(ref, tmp_path):
    """3 steps on (data 2) with a checkpoint, 2 more resumed on (data 2,
    model 2): ``resumed_from`` 3, and every number the reference's own
    two-phase run's."""
    out, want = ref
    ck = str(tmp_path / "ck")
    r1 = train_loop(_rc(), num_steps=3, mesh=_mesh((2,), ("data",)),
                    params=_init(out), ckpt_dir=ck, ckpt_every=3, **QUIET)
    assert r1.steps_run == 3 and latest_step(ck) == 3
    _same_run(r1.final_metrics, ck, want["phase1"], out / "phase1", 3)
    r2 = train_loop(_rc(), num_steps=2, mesh=_mesh((2, 2), ("data", "model")),
                    ckpt_dir=ck, ckpt_every=50, **QUIET)
    assert r2.resumed_from == want["resumed_from"] == 3
    assert r2.steps_run == 2 and latest_step(ck) == 5
    _same_run(r2.final_metrics, ck, want["phase2"], out / "elastic", 5)
    # and the uninterrupted run on one device, the reference's
    _same_run(r2.final_metrics, ck, want["whole"], out / "whole", 5)


@pytest.mark.parametrize("mesh", [((2, 2), ("data", "model")),
                                  ((1,), ("data",)),
                                  ((2, 2, 1), ("pod", "data", "model"))])
def test_port_resumes_the_references_checkpoint_on_another_mesh(
        ref, tmp_path, mesh):
    """The reference's step-3 checkpoint (written on (data 2)) resumed by
    the port on another mesh, a one-entry mesh included: the reference's
    own phase 2."""
    out, want = ref
    ck = tmp_path / "ck"
    shutil.copytree(out / "phase1", ck)
    r = train_loop(_rc(), num_steps=2, mesh=_mesh(*mesh), ckpt_dir=str(ck),
                   ckpt_every=50, **QUIET)
    assert r.resumed_from == 3
    _same_run(r.final_metrics, ck, want["phase2"], out / "elastic", 5)


def test_reference_reads_the_ports_sharded_checkpoint(ref, tmp_path):
    """A checkpoint the port wrote from sharded leaves holds the logical
    arrays: the reference's ``restore_checkpoint`` reads them bit for bit
    (and the port its own)."""
    out, _ = ref
    ck = str(tmp_path / "ck")
    mesh = _mesh((2, 2), ("data", "model"))
    train_loop(_rc(), num_steps=1, mesh=mesh, params=_init(out), ckpt_dir=ck,
               ckpt_every=1, **QUIET)
    flat = _ckpt(ck, 1)
    template = {"params": _ref_tree(out), "opt": None}
    state, step = r_restore(ck, template)
    assert step == 1
    for path, v in tree_paths(state["params"]).items():
        np.testing.assert_array_equal(np.asarray(v),
                                      flat["::".join(("params",) + path)])
    bundle = registry.build(_rc(), device="cpu")
    params = bundle.init_params(torch.Generator().manual_seed(0))
    ctx = make_ctx(mesh, "train")
    sh = ctx.spec_tree_shardings(bundle.specs)
    got, _ = restore_checkpoint(
        ck, {"params": params, "opt": adamw_init(params)},
        shardings={"params": sh, "opt": None})
    for path, v in tree_paths(got["params"]).items():
        assert isinstance(v, ShardedTensor)
        np.testing.assert_array_equal(
            v.gather("cpu").numpy(), flat["::".join(("params",) + path)])
    for x in tree_leaves(got["opt"].m):     # no sharding: the template's
        assert torch.is_tensor(x) and x.device.type == "cpu"


def test_restore_walks_the_shardings_with_the_template(tmp_path):
    """``shardings`` is a tree shaped like the template: a
    ``NamedSharding`` places its leaf, ``None`` (a leaf or a subtree)
    keeps the template's placement, and the optimiser's leaves (which
    sort first on disk) are never paired with the parameters'
    shardings."""
    mesh = _mesh((2, 2), ("data", "model"))
    rng = np.random.default_rng(0)
    params = {"a": torch.from_numpy(rng.standard_normal((4, 6))
                                    .astype(np.float32)),
              "b": torch.from_numpy(rng.standard_normal((8,))
                                    .astype(np.float32))}
    opt = adamw_init(params)
    opt = AdamWState(step=torch.tensor(7, dtype=torch.int32),
                     m={k: v + 1 for k, v in params.items()},
                     v={k: v * 2 for k, v in params.items()})
    save_checkpoint(str(tmp_path), 7, {"params": params, "opt": opt})
    sh = {"a": NamedSharding(mesh, ("data", "model")),
          "b": NamedSharding(mesh, ())}
    tmpl = {"params": {k: torch.zeros_like(v) for k, v in params.items()},
            "opt": adamw_init(params)}
    for opt_sh in (None, AdamWState(step=None, m=sh, v=None)):
        got, step = restore_checkpoint(str(tmp_path), tmpl,
                                       shardings={"params": sh,
                                                  "opt": opt_sh})
        assert step == 7
        for k, v in params.items():
            assert isinstance(got["params"][k], ShardedTensor)
            assert got["params"][k].sharding == sh[k]
            assert got["params"][k].gather("cpu").equal(v)
        assert int(got["opt"].step) == 7
        m = got["opt"].m["a"]
        if opt_sh is None:
            assert torch.is_tensor(m) and m.equal(params["a"] + 1)
        else:
            assert isinstance(m, ShardedTensor)
            assert m.gather("cpu").equal(params["a"] + 1)
        assert torch.is_tensor(got["opt"].v["a"])
        assert got["opt"].v["a"].equal(params["a"] * 2)
    # a sharded template leaf without a sharding keeps its own placement
    st = sh["a"].shard(torch.zeros(4, 6))
    got, _ = restore_checkpoint(str(tmp_path), {"params": {
        "a": st, "b": tmpl["params"]["b"]}, "opt": tmpl["opt"]})
    assert isinstance(got["params"]["a"], ShardedTensor)
    assert got["params"]["a"].sharding == sh["a"]
    assert got["params"]["a"].gather("cpu").equal(params["a"])
