"""Port vs reference: ``train_loop(mesh=)``, the weights and AdamW's
moments sharded by the train profile (``training/spmd.py``), against the
reference's own ``train_loop(mesh=)`` on the same mesh.

The reference runs in subprocesses on 8 host devices (the host-platform
device count set before JAX starts), its meshes built with
``AxisType.Auto`` axes (jax 0.9's ``make_mesh`` makes ``Explicit`` axes,
under which its ``with_sharding_constraint`` acts as an assert: ROADMAP
R2), in four subprocesses run side by side, once for the module. Its loop draws its weights through its bundle, here
``reference_init_params`` (the same weights in every process), written
out for the port's ``train_loop(params=)``. Each case runs 3 steps and
writes a checkpoint at step 3; the two packages' checkpoints (the same
on-disk layout) are compared leaf by leaf.

Cases: tiny yi-6b (dense), qwen3-moe-30b-a3b (moe) and hymba-1.5b
(hybrid), each on (data 2), (data 2, model 2) and (pod 2, data 2, model
1), at sequence 16 and batch 4; yi-6b at batch 8 in microbatches of 4 on
(pod 2, data 2, model 1) and qwen3-moe in microbatches of 2 on (data 2,
model 2); and labels masked by a different count in every row (one row
all masked), in microbatches of 2 on (data 2, model 2), where splitting
the batch by rank before microbatch would pair other rows.

Tolerances: loss, aux loss and grad norm within relative 1e-5, every
parameter and moment within 1e-4 absolute, after 3 steps (float32 on
both sides; tests/test_torch_train.py holds the single-device step to
the same).
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

from repro_torch.checkpoint import latest_step
from repro_torch.configs.base import SHAPES, RunConfig, TrainConfig
from repro_torch.configs.tiny import tiny_of
from repro_torch.convert import params_from_reference
from repro_torch.data import make_train_batch
from repro_torch.sharding.mesh import make_mesh
from repro_torch.training import spmd
from repro_torch.training import trainer as port_trainer
from repro_torch.training.loss import IGNORE
from repro_torch.training.trainer import train_loop

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
HERE = os.path.dirname(__file__)
METRIC_TOL = 1e-5
PARAM_TOL = 1e-4
STEPS = 3
MESHES = {"d": ((2,), ("data",)), "dm": ((2, 2), ("data", "model")),
          "pdm": ((2, 2, 1), ("pod", "data", "model"))}
ARCHS = {"dense": "yi_6b", "moe": "qwen3_moe_30b_a3b",
         "hymba": "hymba_1_5b"}
# case -> (arch key, mesh, batch, microbatch, masked labels)
CASES = {f"{a}-{m}": (a, m, 4, 0, False) for a in ARCHS for m in MESHES}
CASES.update({"dense-mb": ("dense", "pdm", 8, 4, False),
              "moe-mb": ("moe", "dm", 4, 2, False),
              "dense-masked": ("dense", "dm", 4, 2, True)})
# the reference's runs, one subprocess a group, side by side
GROUPS = {"dense": [c for c in CASES if c.startswith("dense")],
          "moe": [c for c in CASES if c.startswith("moe")],
          "hymba-a": ["hymba-d"], "hymba-b": ["hymba-dm", "hymba-pdm"]}
GROUP_OF = {c: g for g, cs in GROUPS.items() for c in cs}
SEQ = 16
# 8 host devices; LLVM at -O0 halves XLA's compile time here, and leaves
# float results alone (no fast math either way)
XLA_FLAGS = ("--xla_force_host_platform_device_count=8 "
             "--xla_backend_optimization_level=0")
# labels masked at the start of each row: a different count per row
MASKED = (0, 5, 12, 16, 3, 9, 1, 14)

REFERENCE = """
import dataclasses, json, os, sys
sys.path[:0] = [%r, %r]
import numpy as np, jax, jax.numpy as jnp
from _torch_parity import reference_init_params
from repro.configs.base import RunConfig, SHAPES, SINGLE_POD, TrainConfig
from repro.configs.tiny import tiny_of
from repro.models import module, registry
from repro.training import trainer
ARCHS, MESHES, CASES, GROUPS, SEQ, STEPS, MASKED = %r, %r, %r, %r, %r, %r, %r
group, out = sys.argv[1], sys.argv[2]
build = registry.build
def build_fixed(rc):
    rb = build(rc)
    draw = jax.jit(lambda k: reference_init_params(rb.specs, k, jnp.float32))
    return dataclasses.replace(rb, init_params=lambda k, dtype=None: draw(k))
trainer.registry.build = build_fixed
make_batch = trainer.make_train_batch
def masked_batch(rc, step, mesh=None, batch_sharding=None):
    b = make_batch(rc, step, mesh, batch_sharding)
    lab = np.array(b["labels"])
    for r in range(lab.shape[0]):
        lab[r, :MASKED[r]] = -100
    b["labels"] = jax.device_put(lab, b["labels"].sharding)
    return b
AUTO = jax.sharding.AxisType.Auto
metrics = {}
for case in GROUPS[group]:
    a, m, batch, mb, masked = CASES[case]
    rc = RunConfig(model=tiny_of(ARCHS[a]),
                   shape=dataclasses.replace(SHAPES["train_4k"], seq_len=SEQ,
                                             global_batch=batch),
                   mesh=SINGLE_POD,
                   train=TrainConfig(total_steps=50, warmup_steps=2,
                                     loss_chunk=SEQ, remat_policy="none",
                                     microbatch=mb))
    shape, axes = MESHES[m]
    mesh = jax.make_mesh(shape, axes, devices=jax.devices()[:int(np.prod(shape))],
                         axis_types=(AUTO,) * len(shape))
    trainer.make_train_batch = masked_batch if masked else make_batch
    rep = trainer.train_loop(rc, num_steps=STEPS, mesh=mesh,
                             ckpt_dir=os.path.join(out, case),
                             ckpt_every=STEPS, log_every=0,
                             log_fn=lambda *x: None)
    metrics[case] = rep.final_metrics
params = build_fixed(rc).init_params(jax.random.key(rc.train.seed))
np.savez(os.path.join(out, group + ".init.npz"), **{
    "/".join(p): np.asarray(v) for p, v in module.tree_paths(params).items()})
with open(os.path.join(out, group + ".json"), "w") as f:
    json.dump(metrics, f)
""" % (SRC, HERE, ARCHS, MESHES, CASES, GROUPS, SEQ, STEPS, MASKED)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Tiny tensors on one intra-op thread: with every core shared, many
    threads spend each small operation waiting on one another."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's runs: one subprocess per group of cases, side by
    side. Returns (output dir, metrics by case)."""
    out = tmp_path_factory.mktemp("spmd")
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS=XLA_FLAGS)
    procs = [subprocess.Popen([sys.executable, "-c",
                               textwrap.dedent(REFERENCE), key, str(out)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env) for key in GROUPS]
    metrics = {}
    for key, p in zip(GROUPS, procs):
        o, e = p.communicate(timeout=300)
        assert p.returncode == 0, f"{key}:\nstdout:\n{o}\nstderr:\n{e}"
        with open(out / f"{key}.json") as f:
            metrics.update(json.load(f))
    return out, metrics


def _rc(arch, batch, mb):
    return RunConfig(model=tiny_of(arch),
                     shape=dataclasses.replace(SHAPES["train_4k"],
                                               seq_len=SEQ,
                                               global_batch=batch),
                     train=TrainConfig(total_steps=50, warmup_steps=2,
                                       loss_chunk=SEQ, remat_policy="none",
                                       microbatch=mb))


def _init(path):
    tree = {}
    with np.load(path) as z:
        for k, v in z.items():
            *p, leaf = k.split("/")
            d = tree
            for seg in p:
                d = d.setdefault(seg, {})
            d[leaf] = v
    return params_from_reference(tree, device="cpu")


def _ckpt(d):
    """{leaf key: array} of the checkpoint at step STEPS under ``d``."""
    path = os.path.join(d, f"step_{STEPS:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        man = json.load(f)
    return {k: np.load(os.path.join(path, v["file"]))
            for k, v in man["leaves"].items()}


def _masked_batch(rc, step, device, mesh=None, batch_sharding=None):
    b = make_train_batch(rc, step, device, mesh, batch_sharding)
    lab = b["labels"].gather("cpu").clone()
    for r in range(lab.shape[0]):
        lab[r, :MASKED[r]] = IGNORE
    b["labels"] = b["labels"].sharding.shard(lab)
    return b


def _run(ref, case, tmp_path, monkeypatch):
    out, _ = ref
    a, m, batch, mb, masked = CASES[case]
    rc = _rc(ARCHS[a], batch, mb)
    shape, axes = MESHES[m]
    mesh = make_mesh(shape, axes, ["cpu"] * int(np.prod(shape)))
    if masked:
        monkeypatch.setattr(port_trainer, "make_train_batch", _masked_batch)
    rep = train_loop(rc, num_steps=STEPS, mesh=mesh, log_every=0,
                     params=_init(out / f"{GROUP_OF[case]}.init.npz"),
                     ckpt_dir=str(tmp_path), ckpt_every=STEPS)
    return rep


def _compare(ref, case, rep, port_dir):
    out, metrics = ref
    want = metrics[case]
    for k in ("loss", "aux_loss", "grad_norm"):
        assert abs(rep.final_metrics[k] - want[k]) <= METRIC_TOL * max(
            abs(want[k]), 1e-6), (case, k, rep.final_metrics[k], want[k])
    assert rep.final_metrics["lr"] == pytest.approx(want["lr"], rel=1e-7)
    assert rep.final_metrics["step"] == want["step"] == STEPS
    got, exp = _ckpt(port_dir), _ckpt(out / case)
    assert sorted(got) == sorted(exp)
    for k in exp:
        assert got[k].shape == exp[k].shape and got[k].dtype == exp[k].dtype
        np.testing.assert_allclose(got[k], exp[k], rtol=0, atol=PARAM_TOL,
                                   err_msg=f"{case} {k}")


@pytest.mark.parametrize("case", list(CASES))
def test_train_loop_on_a_mesh_matches_the_references(ref, case, tmp_path,
                                                     monkeypatch):
    rep = _run(ref, case, tmp_path, monkeypatch)
    assert rep.steps_run == STEPS and rep.resumed_from is None
    _compare(ref, case, rep, tmp_path)


def test_masked_rows_make_the_ranks_weights_differ(ref, tmp_path,
                                                   monkeypatch):
    """The masked case is one the weighting decides: the mean of the
    ranks' means (every rank weighted alike) is another loss."""
    monkeypatch.setattr(spmd, "rank_weight",
                        lambda count, total: torch.full_like(count, 0.5))
    rep = _run(ref, "dense-masked", tmp_path, monkeypatch)
    want = ref[1]["dense-masked"]["loss"]
    assert abs(rep.final_metrics["loss"] - want) > 100 * METRIC_TOL * want


def test_launcher_runs_train_loop_on_a_mesh(tmp_path, capsys):
    """``--mesh 2x2 --device cpu``: ``train_loop(mesh=)`` on a (data 2,
    model 2) mesh of CPU entries, a checkpoint at the end; the same run
    as a direct call gives the same loss."""
    from repro_torch.launch import train
    train.main(["--arch", "yi_6b", "--tiny", "--steps", "2", "--seq", "16",
                "--batch", "4", "--mesh", "2x2", "--device", "cpu",
                "--ckpt-dir", str(tmp_path / "l"), "--remat", "none"])
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert last.startswith("[train] done: 2 steps, final loss ")
    loss = float(last.split("final loss ")[1].split(",")[0])
    assert np.isfinite(loss) and latest_step(str(tmp_path / "l")) == 2
    rc = RunConfig(model=tiny_of("yi_6b"),
                   shape=dataclasses.replace(SHAPES["train_4k"], seq_len=16,
                                             global_batch=4),
                   train=TrainConfig(learning_rate=3e-4, total_steps=10,
                                     warmup_steps=1, remat_policy="none"))
    rep = train_loop(rc, num_steps=2, log_every=0, mesh=make_mesh(
        (2, 2), ("data", "model"), ["cpu"] * 4))
    assert rep.final_metrics["loss"] == pytest.approx(loss, abs=1e-4)


def test_step_traffic_on_one_device():
    """On entries of one device every gather and reduce-scatter is local
    (no copy): ``moved`` is 0, ``local`` the blocks of the other
    coordinates."""
    from repro_torch.models import registry
    from repro_torch.optim import adamw_init
    from repro_torch.sharding.placement import shard_tree
    from repro_torch.sharding.rules import make_ctx
    rc = _rc("yi_6b", 4, 0)
    mesh = make_mesh((2, 2), ("data", "model"), ["cpu"] * 4)
    ctx = make_ctx(mesh, "train")
    bundle = registry.build(rc, device="cpu")
    params = shard_tree(bundle.init_params(torch.Generator().manual_seed(0)),
                        ctx.spec_tree_shardings(bundle.specs))
    opt = adamw_init(params)
    bs = {k: ctx.sharding(s.shape, ("act_batch",) + (None,) * (s.ndim - 1))
          for k, s in bundle.input_specs("train").items()}
    step = spmd.make_spmd_train_step(bundle, rc, ctx)
    step(params, opt, make_train_batch(rc, 0, "cpu", mesh, bs))
    t = step.traffic
    assert all(v.moved == 0 for v in t.values())
    assert t["gathered"].local > 0 and t["reduce_scattered"].local > 0
    assert t["replicas"].local == 0
