"""Training launcher, as the reference's ``launch/train.py``.

  PYTHONPATH=src python -m repro_torch.launch.train --arch <id> [--tiny] \
      [--steps N] [--ckpt-dir DIR] [--seq S] [--batch B] [--device cpu]

Every arch of ``configs.ARCH_IDS`` trains: the decoder LMs on tokens (or
embeddings), whisper on frame embeddings, decoder tokens and labels.
``--tiny`` swaps in the reduced same-family config (sequence 128, batch
8 unless given); without it the full config and its shape apply. The
run is on the card unless ``--device cpu``. ``--mesh`` and
``--grad-compression int8_ef`` wait for the port's sharding slice and
are refused.
"""
from __future__ import annotations

import argparse
import dataclasses

from repro_torch.configs.base import (SHAPES, RunConfig, TrainConfig,
                                      get_model_config)
from repro_torch.configs.tiny import tiny_of
from repro_torch.runtime import PreemptionGuard
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
                    help="refused: waits for the sharding slice")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--remat", default="full")
    ap.add_argument("--grad-compression", default="none",
                    choices=["none", "int8_ef"])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.mesh:
        ap.error("--mesh waits for the port's sharding slice; the trainer "
                 "runs on one device")
    if args.grad_compression != "none":
        ap.error("--grad-compression int8_ef waits for the port's sharding "
                 "slice (the data-parallel step that uses it)")

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
    rep = train_loop(rc, num_steps=args.steps, device=args.device,
                     ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                     guard=PreemptionGuard())
    print(f"[train] done: {rep.steps_run} steps, "
          f"final loss {rep.final_metrics.get('loss'):.4f}, "
          f"stragglers {rep.straggler_steps}, preempted {rep.preempted}")


if __name__ == "__main__":
    main()
