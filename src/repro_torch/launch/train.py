"""Training launcher, as the reference's ``launch/train.py``.

  PYTHONPATH=src python -m repro_torch.launch.train --arch <id> [--tiny] \
      [--steps N] [--ckpt-dir DIR] [--seq S] [--batch B] [--device cpu] \
      [--mesh [px]dxm --grad-compression int8_ef]

Every arch of ``configs.ARCH_IDS`` trains: the decoder LMs on tokens (or
embeddings), whisper on frame embeddings, decoder tokens and labels.
``--tiny`` swaps in the reduced same-family config (sequence 128, batch
8 unless given); without it the full config and its shape apply. The
run is on the card unless ``--device cpu``.

``--mesh`` takes the reference's axes: ``dxm`` is (data, model),
``pxdxm`` (pod, data, model). With ``--grad-compression int8_ef`` the
pure data-parallel step with int8 error feedback over 'pod'
(``training/dp_shardmap.py``) runs on a mesh of ``cuda:0`` …
``cuda:n-1`` (n the mesh's size; a card that is not there raises), or of
n CPU entries with ``--device cpu``. ``int8_ef`` without ``--mesh`` is
an error, as the reference's ``assert`` is. ``--mesh`` alone runs
``train_loop(mesh=)`` on the same mesh: the weights and AdamW's moments
sharded by the train profile, each data-parallel rank on gathered
weights (``training/spmd.py``).
"""
from __future__ import annotations

import argparse
import dataclasses
import math

import torch

from repro_torch.configs.base import (SHAPES, RunConfig, TrainConfig,
                                      get_model_config)
from repro_torch.configs.tiny import tiny_of
from repro_torch.runtime import PreemptionGuard
from repro_torch.sharding.mesh import make_mesh
from repro_torch.training.trainer import train_loop


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=None)
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--mesh", default=None,
                    help="e.g. 2x2 -> (data=2, model=2), 2x2x1 -> (pod=2, "
                    "data=2, model=1)")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--remat", default="full")
    ap.add_argument("--grad-compression", default="none",
                    choices=["none", "int8_ef"])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.grad_compression == "int8_ef" and not args.mesh:
        ap.error("--grad-compression int8_ef needs --mesh")

    if args.tiny:
        mc = tiny_of(args.arch)
        sh = dataclasses.replace(SHAPES[args.shape],
                                 seq_len=args.seq or 128,
                                 global_batch=args.batch or 8)
    else:
        mc, sh = get_model_config(args.arch), SHAPES[args.shape]
        if args.seq or args.batch:
            sh = dataclasses.replace(sh, seq_len=args.seq or sh.seq_len,
                                     global_batch=args.batch
                                     or sh.global_batch)

    tc = TrainConfig(learning_rate=args.lr, total_steps=max(args.steps, 10),
                     warmup_steps=min(100, args.steps // 10 + 1),
                     microbatch=args.microbatch, remat_policy=args.remat,
                     grad_compression=args.grad_compression)
    rc = RunConfig(model=mc, shape=sh, train=tc)

    mesh = None
    if args.mesh:
        dims = tuple(int(x) for x in args.mesh.split("x"))
        axes = ("data", "model")[:len(dims)] if len(dims) <= 2 else \
            ("pod", "data", "model")
        n = math.prod(dims)
        devices = (["cpu"] * n if torch.device(args.device).type == "cpu"
                   else [f"cuda:{i}" for i in range(n)])
        mesh = make_mesh(dims, axes, devices)

    guard = PreemptionGuard()
    if args.grad_compression == "int8_ef":
        _run_compressed(rc, mesh, args)
        return
    rep = train_loop(rc, num_steps=args.steps, device=args.device,
                     ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                     guard=guard, mesh=mesh)
    print(f"[train] done: {rep.steps_run} steps, "
          f"final loss {rep.final_metrics.get('loss'):.4f}, "
          f"stragglers {rep.straggler_steps}, preempted {rep.preempted}")



def _run_compressed(rc, mesh, args):
    """Pure-DP path with hierarchical int8-EF gradient reduction, as the
    reference's loop: parameters seeded with ``rc.train.seed`` on the
    mesh's first entry, one batch per step."""
    from repro_torch.data import make_train_batch
    from repro_torch.models import registry
    from repro_torch.optim import adamw_init
    from repro_torch.training.dp_shardmap import (init_error_feedback,
                                                  make_compressed_dp_step)
    dev = mesh.devices.flat[0]
    bundle = registry.build(rc, device=dev)
    params = bundle.init_params(
        torch.Generator(device=dev).manual_seed(rc.train.seed))
    opt = adamw_init(params)
    err = init_error_feedback(params, mesh)
    step_fn = make_compressed_dp_step(bundle, rc, mesh)
    for step in range(args.steps):
        batch = make_train_batch(rc, step, dev)
        params, opt, err, metrics = step_fn(params, opt, err, batch)
        if step % 10 == 0 or step == args.steps - 1:
            print(f"[train/int8_ef] step {step} "
                  f"loss {float(metrics['loss']):.4f}")


if __name__ == "__main__":
    main()
