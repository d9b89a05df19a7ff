"""Training loop with fault tolerance: auto-resume, async checkpoints,
preemption handling, straggler logging — the reference's
``training/trainer.py`` on one device.

The loop is deliberately thin — the work is in the train step; the
loop's job is what a cluster supervisor needs: deterministic data
(stateless in step), atomic checkpoints, resume, and health signals.
Each step is synchronised (every card of the mesh) before it is timed,
so the watchdog sees the devices' time, not the time to queue the step.

With ``mesh`` (a ``DeviceMesh``) the loop is the reference's on a mesh:
the parameters and AdamW's moments placed by
``make_ctx(mesh, 'train').spec_tree_shardings`` (the step replicated,
on the host), the batch by ``act_batch`` rows, and the step
``training/spmd.py``'s. A resume places every restored leaf by the new
mesh's shardings, so a run may resume on another mesh (the elastic
restart); checkpoints hold the gathered logical arrays. The explicit
data-parallel step with int8 error feedback is
``training/dp_shardmap.py``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Optional

import torch

from repro_torch.checkpoint import (AsyncCheckpointer, latest_step,
                                    restore_checkpoint)
from repro_torch.configs.base import RunConfig
from repro_torch.data import make_train_batch
from repro_torch.models import registry
from repro_torch.optim import adamw_init
from repro_torch.optim.adamw import AdamWState
from repro_torch.runtime import PreemptionGuard, StepWatchdog
from repro_torch.sharding.mesh import DeviceMesh
from repro_torch.sharding.placement import shard_tree
from repro_torch.sharding.rules import make_ctx
from repro_torch.training.spmd import make_spmd_train_step
from repro_torch.training.step import make_train_step


@dataclasses.dataclass
class TrainerReport:
    steps_run: int
    final_metrics: Dict
    resumed_from: Optional[int]
    straggler_steps: int
    preempted: bool


def train_loop(rc: RunConfig, *, num_steps: int, device="cuda",
               ckpt_dir: Optional[str] = None, ckpt_every: int = 50,
               log_every: int = 10, log_fn: Callable = print,
               guard: Optional[PreemptionGuard] = None, params=None,
               mesh=None) -> TrainerReport:
    """Train ``rc``'s model for ``num_steps`` steps on ``device`` (the
    card unless the caller passes ``device='cpu'``), or on ``mesh`` (a
    ``DeviceMesh``; ``device`` is then unused), resuming from the latest
    checkpoint under ``ckpt_dir`` where there is one. Parameters come from
    ``bundle.init_params`` seeded with ``rc.train.seed``, or are ``params``
    (a tree on ``device``, updated in place unless a checkpoint replaces
    it; with a mesh, the logical tree, placed by the mesh's
    shardings)."""
    if mesh is not None and not isinstance(mesh, DeviceMesh):
        raise TypeError(f"mesh must be a DeviceMesh, not {type(mesh)}")
    dev = mesh.devices.flat[0] if mesh is not None else device
    bundle = registry.build(rc, device=dev)
    dev = bundle.device
    if params is None:
        gen = torch.Generator(device=dev).manual_seed(rc.train.seed)
        params = bundle.init_params(gen)
    shardings = batch_sharding = None
    if mesh is not None:
        ctx = make_ctx(mesh, "train")
        pshard = ctx.spec_tree_shardings(bundle.specs)
        shardings = {"params": pshard,
                     "opt": AdamWState(step=None, m=pshard, v=pshard)}
        params = shard_tree(params, pshard)
        batch_sharding = {k: ctx.sharding(s.shape, ("act_batch",) + (None,)
                                          * (len(s.shape) - 1))
                          for k, s in bundle.input_specs("train").items()}
        step_fn = make_spmd_train_step(bundle, rc, ctx)
        cards = [d for d in mesh.distinct_devices() if d.type == "cuda"]
    else:
        step_fn = make_train_step(bundle, rc)
        cards = [dev] if dev.type == "cuda" else []
    opt_state = adamw_init(params)
    start_step = 0
    resumed = None
    if ckpt_dir and latest_step(ckpt_dir) is not None:
        state, start_step = restore_checkpoint(
            ckpt_dir, {"params": params, "opt": opt_state},
            shardings=shardings)
        params, opt_state = state["params"], state["opt"]
        resumed = start_step
        log_fn(f"[trainer] resumed from step {start_step}")

    ckpt = AsyncCheckpointer(ckpt_dir) if ckpt_dir else None
    guard = guard or PreemptionGuard(install=False)
    watchdog = StepWatchdog()
    metrics = {}
    preempted = False

    t_end = start_step + num_steps
    step = start_step
    while step < t_end:
        batch = make_train_batch(rc, step, dev, mesh, batch_sharding)
        t0 = time.perf_counter()
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        for card in cards:
            torch.cuda.synchronize(card)
        dt = time.perf_counter() - t0
        slow = watchdog.observe(dt)
        step += 1
        if slow:
            log_fn(f"[watchdog] straggler step {step}: {dt:.3f}s "
                   f"(ema {watchdog.ema:.3f}s)")
        if log_every and step % log_every == 0:
            log_fn(f"[trainer] step {step} loss {float(metrics['loss']):.4f}"
                   f" gnorm {float(metrics['grad_norm']):.3f} {dt*1e3:.0f}ms")
        if ckpt and (step % ckpt_every == 0 or guard.should_stop()):
            ckpt.save(step, {"params": params, "opt": opt_state},
                      metadata={"step": step})
        if guard.should_stop():
            log_fn(f"[trainer] preemption at step {step}: checkpoint + exit")
            preempted = True
            break
    if ckpt:
        if not preempted and watchdog.count and step % ckpt_every != 0:
            ckpt.save(step, {"params": params, "opt": opt_state},
                      metadata={"step": step})
        ckpt.wait()
    return TrainerReport(steps_run=step - start_step, final_metrics={
        k: float(v) for k, v in metrics.items()}, resumed_from=resumed,
        straggler_steps=watchdog.flagged, preempted=preempted)
