"""The port's checkpoints and trainer: the reference's on-disk layout read
and written by both packages (parameters and the AdamW state, bfloat16
leaves included), atomic publish, the async writer's snapshot, and the
trainer's resume, preemption and straggler watchdog, as in
tests/test_checkpoint_trainer.py. The cross test: the reference's
``train_loop`` writes step 2; the port's ``train_loop`` resumes from a
copy and its next two losses are the reference's own continuation.

Tolerances: checkpoint leaves bit for bit (bfloat16 is widened to float32
on disk, exactly); the continued losses within relative 1e-5 (float32 on
both sides, tests/test_torch_train.py).
"""
import dataclasses
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import latest_step as r_latest_step
from repro.checkpoint import restore_checkpoint as r_restore
from repro.checkpoint import save_checkpoint as r_save
from repro.configs.base import SHAPES as R_SHAPES
from repro.configs.base import RunConfig as RRunConfig
from repro.configs.base import SINGLE_POD
from repro.configs.base import TrainConfig as RTrainConfig
from repro.configs.tiny import tiny_of as r_tiny_of
from repro.data import make_train_batch as r_make_train_batch
from repro.models import registry as r_registry
from repro.optim import adamw_init as r_adamw_init
from repro.optim import adamw_update as r_adamw_update
from repro.training.step import make_train_step as r_make_train_step
from repro.training.trainer import train_loop as r_train_loop
from repro_torch.checkpoint import (AsyncCheckpointer, latest_step,
                                    restore_checkpoint, save_checkpoint)
from repro_torch.configs.base import SHAPES, RunConfig, TrainConfig
from repro_torch.configs.tiny import tiny_of
from repro_torch.convert import params_from_reference
from repro_torch.optim import AdamWState, adamw_init
from repro_torch.runtime import PreemptionGuard, StepWatchdog
from repro_torch.training.trainer import train_loop

from _torch_parity import reference_bundle_params, reference_init_params


def _tree(rng):
    return {"w": torch.from_numpy(rng.standard_normal((4, 5))
                                  .astype(np.float32)),
            "nested": {"b": torch.arange(7, dtype=torch.int32)},
            "tup": (torch.ones(2), torch.zeros(3, dtype=torch.bfloat16))}


def _assert_same(got, want):
    g, w = jax.tree.leaves(got), jax.tree.leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        a = a.float().numpy() if torch.is_tensor(a) else np.asarray(
            a, np.float32)
        b = b.float().numpy() if torch.is_tensor(b) else np.asarray(
            b, np.float32)
        np.testing.assert_array_equal(a, b)


def test_roundtrip(tmp_path, rng):
    t = _tree(rng)
    save_checkpoint(str(tmp_path), 3, t)
    assert latest_step(str(tmp_path)) == 3
    back, step = restore_checkpoint(str(tmp_path), t)
    assert step == 3
    assert isinstance(back["tup"], tuple)
    assert back["tup"][1].dtype == torch.bfloat16
    assert back["nested"]["b"].dtype == torch.int32
    _assert_same(back, t)


def test_layout_is_the_references(tmp_path, rng):
    save_checkpoint(str(tmp_path), 12, _tree(rng), metadata={"step": 12})
    path = tmp_path / "step_00000012"
    manifest = json.loads((path / "manifest.json").read_text())
    assert manifest["step"] == 12 and manifest["metadata"] == {"step": 12}
    leaves = manifest["leaves"]
    assert sorted(leaves) == ["nested::b", "tup::#0", "tup::#1", "w"]
    assert leaves["tup::#1"] == {"file": "tup::#1.npy", "shape": [3],
                                 "dtype": "bfloat16"}
    assert np.load(path / "tup::#1.npy").dtype == np.float32
    assert leaves["nested::b"]["dtype"] == "int32"


def test_atomic_publish_no_tmp_left(tmp_path, rng):
    save_checkpoint(str(tmp_path), 1, _tree(rng))
    save_checkpoint(str(tmp_path), 2, _tree(rng))
    entries = os.listdir(tmp_path)
    assert not any(e.endswith(".tmp") for e in entries)
    assert latest_step(str(tmp_path)) == 2
    assert latest_step(str(tmp_path / "none")) is None
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path / "none"), _tree(rng))


def test_async_checkpointer(tmp_path, rng):
    ck = AsyncCheckpointer(str(tmp_path))
    ck.save(5, _tree(rng))
    ck.wait()
    assert latest_step(str(tmp_path)) == 5 and ck.last_saved == 5


def test_async_snapshot_survives_an_in_place_update(tmp_path, rng,
                                                    monkeypatch):
    """The worker writes after ``save`` returns; an optimiser step that
    updates the tensors in place meanwhile must not reach the file."""
    import threading
    from repro_torch.checkpoint import store
    gate = threading.Event()
    real = store.save_checkpoint

    def held(*a, **kw):
        assert gate.wait(30)
        return real(*a, **kw)
    monkeypatch.setattr(store, "save_checkpoint", held)
    t = _tree(rng)
    want = jax.tree.map(lambda x: x.clone(), t)
    ck = AsyncCheckpointer(str(tmp_path))
    ck.save(1, t)
    t["w"].add_(1.0)                              # the next step, in place
    t["tup"][1].fill_(7)
    gate.set()
    ck.wait()
    back, _ = restore_checkpoint(str(tmp_path), t)
    _assert_same(back, want)


def _params(rng):
    return {"embed": {"table": rng.standard_normal((6, 4))
                      .astype(np.float32)},
            "stage_0": {"ln1": {"scale": np.ones((2, 4), np.float32)},
                        "w": rng.standard_normal((2, 4, 4))
                        .astype(np.float32)}}


def test_port_restores_the_references_checkpoint(tmp_path, rng):
    """Parameters (a bfloat16 leaf among them) and the reference's
    ``AdamWState`` after one update."""
    rp = jax.tree.map(jnp.asarray, _params(rng))
    rp["stage_0"]["w"] = rp["stage_0"]["w"].astype(jnp.bfloat16)
    ropt = r_adamw_update(rp, jax.tree.map(lambda x: x * 0.1, rp),
                          r_adamw_init(rp), lr=1e-2)[1]
    r_save(str(tmp_path), 4, {"params": rp, "opt": ropt})
    template_p = params_from_reference(jax.tree.map(np.asarray, rp),
                                       device="cpu")
    template_p["stage_0"]["w"] = template_p["stage_0"]["w"].to(
        torch.bfloat16)
    state, step = restore_checkpoint(
        str(tmp_path), {"params": template_p,
                        "opt": adamw_init(template_p)})
    assert step == 4
    assert isinstance(state["opt"], AdamWState)
    assert state["opt"].step.dtype == torch.int32
    assert int(state["opt"].step) == 1
    assert state["params"]["stage_0"]["w"].dtype == torch.bfloat16
    _assert_same(state, {"params": rp, "opt": ropt})


def test_reference_restores_the_ports_checkpoint(tmp_path, rng):
    p = params_from_reference(_params(rng), device="cpu")
    p["stage_0"]["w"] = p["stage_0"]["w"].to(torch.bfloat16)
    opt = adamw_init(p)
    opt.m["embed"]["table"].add_(0.5)
    opt = opt._replace(step=opt.step + 3)
    save_checkpoint(str(tmp_path), 9, {"params": p, "opt": opt})
    assert r_latest_step(str(tmp_path)) == 9
    rp = jax.tree.map(jnp.asarray, _params(rng))
    rp["stage_0"]["w"] = rp["stage_0"]["w"].astype(jnp.bfloat16)
    ropt = r_adamw_init(rp)
    back, step = r_restore(str(tmp_path), {"params": rp, "opt": ropt})
    assert step == 9
    assert type(back["opt"]).__name__ == "AdamWState"
    assert back["opt"].step.dtype == jnp.int32 and int(back["opt"].step) == 3
    assert back["params"]["stage_0"]["w"].dtype == jnp.bfloat16
    _assert_same(back, {"params": p, "opt": opt})


# -- the trainer -------------------------------------------------------------


def _tiny_rc(arch="yi_6b"):
    sh = dict(seq_len=16, global_batch=2)
    tc = dict(total_steps=50, warmup_steps=2, loss_chunk=16)
    return RunConfig(model=tiny_of(arch),
                     shape=dataclasses.replace(SHAPES["train_4k"], **sh),
                     train=TrainConfig(**tc))


def _quiet(*a):
    pass


def test_trainer_resume(tmp_path):
    rc = _tiny_rc()
    r1 = train_loop(rc, num_steps=4, device="cpu", ckpt_dir=str(tmp_path),
                    ckpt_every=2, log_every=0, log_fn=_quiet)
    assert r1.steps_run == 4 and r1.resumed_from is None
    assert sorted(os.listdir(tmp_path)) == ["step_00000002",
                                            "step_00000004"]
    r2 = train_loop(rc, num_steps=2, device="cpu", ckpt_dir=str(tmp_path),
                    ckpt_every=2, log_every=0, log_fn=_quiet)
    assert r2.resumed_from == 4 and r2.steps_run == 2
    assert latest_step(str(tmp_path)) == 6
    assert np.isfinite(r2.final_metrics["loss"])
    assert r2.final_metrics["step"] == 6.0


def test_trainer_resume_continues_the_same_run(tmp_path):
    """Steps 1-2, a checkpoint, then steps 3-4 from it, equal steps 1-4
    in one run: the data is stateless in the step, the state whole."""
    rc = _tiny_rc()
    whole = train_loop(rc, num_steps=4, device="cpu", log_every=0,
                       log_fn=_quiet)
    train_loop(rc, num_steps=2, device="cpu", ckpt_dir=str(tmp_path),
               ckpt_every=2, log_every=0, log_fn=_quiet)
    rest = train_loop(rc, num_steps=2, device="cpu", ckpt_dir=str(tmp_path),
                      ckpt_every=2, log_every=0, log_fn=_quiet)
    assert rest.resumed_from == 2
    assert rest.final_metrics == whole.final_metrics


def test_trainer_preemption(tmp_path):
    rc = _tiny_rc()
    guard = PreemptionGuard(install=False)
    guard.requested = True                    # preempt immediately
    r = train_loop(rc, num_steps=10, device="cpu", ckpt_dir=str(tmp_path),
                   ckpt_every=100, log_every=0, log_fn=_quiet, guard=guard)
    assert r.preempted and r.steps_run == 1
    assert latest_step(str(tmp_path)) == 1    # checkpoint written on preempt


def test_trainer_logs_and_flags_stragglers(tmp_path, monkeypatch):
    """A step ten times slower than the rest is logged and counted."""
    from repro_torch.training import trainer
    clock = iter(t for i in range(20)
                 for t in (0.0, 10.0 if i == 7 else 1.0))
    monkeypatch.setattr(trainer.time, "perf_counter", lambda: next(clock))
    lines = []
    r = train_loop(_tiny_rc(), num_steps=10, device="cpu", log_every=5,
                   log_fn=lines.append)
    assert r.straggler_steps == 1
    assert any(x.startswith("[watchdog] straggler step 8") for x in lines)
    assert sum(x.startswith("[trainer] step ") for x in lines) == 2


def test_trainer_refuses_a_mesh():
    """``train_loop(mesh=)`` takes a ``DeviceMesh`` (its runs against the
    reference's: tests/test_torch_spmd.py) and refuses anything else."""
    with pytest.raises(TypeError, match="DeviceMesh"):
        train_loop(_tiny_rc(), num_steps=1, device="cpu", mesh=object())


def test_watchdog_flags_stragglers():
    wd = StepWatchdog(ratio=3.0, min_samples=2)
    flags = [wd.observe(t) for t in [1.0] * 6 + [10.0] + [1.0] * 3]
    assert flags[6] is True
    assert sum(flags) == 1
    assert wd.ema < 1.5                      # straggler didn't poison EMA


def test_trainer_resumes_the_references_checkpoint(tmp_path, monkeypatch):
    """The reference's train_loop writes step 2; the port's train_loop
    resumes from a copy of that directory, one step per call. Its losses
    at steps 3 and 4 are those of the reference's own step, jitted,
    continuing from the same checkpoint on the same batches. The
    reference's loop draws its weights through its bundle, here
    ``reference_bundle_params`` (the same weights in every process)."""
    build = r_registry.build

    def build_with_fixed_draw(rc):
        rb = build(rc)
        return dataclasses.replace(
            rb, init_params=lambda key, dtype=jnp.float32:
            reference_init_params(rb.specs, key, dtype))

    monkeypatch.setattr(r_registry, "build", build_with_fixed_draw)
    rrc = RRunConfig(
        model=r_tiny_of("yi_6b"),
        shape=dataclasses.replace(R_SHAPES["train_4k"], seq_len=16,
                                  global_batch=2),
        mesh=SINGLE_POD, train=RTrainConfig(total_steps=50, warmup_steps=2,
                                            loss_chunk=16,
                                            remat_policy="none"))
    ref_dir, port_dir = tmp_path / "ref", tmp_path / "port"
    r_train_loop(rrc, num_steps=2, ckpt_dir=str(ref_dir), ckpt_every=2,
                 log_every=0, log_fn=_quiet)
    assert r_latest_step(str(ref_dir)) == 2
    shutil.copytree(ref_dir, port_dir)

    rb = build(rrc)
    params = reference_bundle_params(rb, jax.random.key(0))
    state, _ = r_restore(str(ref_dir), {"params": params,
                                        "opt": r_adamw_init(params)})
    params, opt = state["params"], state["opt"]
    step = jax.jit(r_make_train_step(rb, rrc))
    want = []
    for i in (2, 3):
        params, opt, m = step(params, opt, r_make_train_batch(rrc, i))
        want.append(float(m["loss"]))

    rc = _tiny_rc()
    got = []
    for resumed in (2, 3):
        r = train_loop(rc, num_steps=1, device="cpu",
                       ckpt_dir=str(port_dir), ckpt_every=1, log_every=0,
                       log_fn=_quiet)
        assert r.resumed_from == resumed
        got.append(r.final_metrics["loss"])
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert latest_step(str(port_dir)) == 4
