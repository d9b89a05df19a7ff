#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py            # from the root of a checkout

Phases, in order; any failure exits non-zero:

  1. devices  — the card's name and count, and ``nvidia-smi``'s name and
                power limit. No card is a failure.
  2. build    — builds the three CUDA kernels (``filter2d_halo``,
                ``swattn``, ``dwconv1d``) from ``src/`` into ``build/``
                (one ``nvcc`` per source, all started together) and
                summarises ``-Xptxas -v`` per kernel: registers, shared
                memory, spills (the full reports stay in ``build/``).
  3. kernel   — holds the kernel against its plain torch version
                (``filter2d_halo_ref``) on the card: 6 border policies
                (non-zero constant), 4 forms + separable, w ∈ {3, 5, 7},
                float32/bfloat16/int8/uint8/int16, banks of 4, requant in
                all 3 roundings on the integer frames, twice: on ragged
                [3, 67, 301] planes (rows not 16-byte aligned: the
                per-thread loader) and on [3, 67, 336] planes (aligned
                for every dtype, ragged against the tile and the strip:
                the TMA loader); then frames smaller than one tile and
                one strip ([2, 5, 48], TMA), a view one element off 16
                bytes (per-thread), an all-max overflow edge and full-HD
                [3, 1440, 1920] planes. Every case asserts which loader
                it took (``filter2d_halo.tma_launches``). Integers
                bit-exact; float32 within rtol=atol=3e-4; bfloat16 within
                3e-2.
  4. serving  — ``FilterServeEngine(batch_size=4, device='cuda')`` serves
                32 requests drawn from ``build_mix(rng, scale=15)`` (1440x1920
                float32 w5 mirror for two tenants, 960x1440 float32 w3
                replicate, 960x1440 int8 w3 unity requant). Each result is
                held against ``filter2d_halo_ref`` on the card; recompiles
                must equal buckets, errors 0, and the kernel's launch
                counter must grow by exactly one per wave, every launch
                through the TMA loader.
  5. timing   — CUDA events after warm-up at each bucket's serving shape:
                the kernel, its bound (HBM bytes over the card's memory
                rate, and the operations over the peak for the input type,
                both from ``obs/roofline.py``'s table for the card's H100
                part: 3.35 TB/s for SXM5) and its share
                of it, the plain version, a PyTorch copy of the planes
                (the same bytes in and out: the rate this card reaches),
                and for float32 ``F.conv2d`` on a pre-padded frame with
                TF32 off (a yardstick the port never calls); the kernel's
                tile geometry from the built library; then where one
                served wave's time goes (host stacking, copy in, pipeline
                call, copy out).
  6. executors — the strip-scan (``'streaming'``) and library-convolution
                (``'xla'``) executors held against the ``'cuda'`` executor,
                with torch's own TF32 setting in force (``'xla'`` switches
                it off around its call and must hand it back): the three
                serving buckets, 8K UHD [1,4320,7680] float32 w5 mirror
                (72 strips), int8 w3 wrap unity requant [4,960,1440] (the
                wrap prologue), the int16 all-max overflow edge, xla
                int16 at w 13 and 15 (split coefficient halves; all-max
                and random frames, held against ``'core'`` on the CPU,
                since the kernel stops at w 7), and policy x {float32, bfloat16, int8, uint8, int16} x w
                {3, 5} at [3,67,336] (xla; streaming in one strip) and
                [3,64,336] (streaming in 8 strips). Integers bit-exact,
                float32 within 3e-4, bfloat16 within 3e-2; every
                streaming call adds one ``filter2d_halo`` launch per
                strip. Then ``FilterServeEngine(execution=...)`` serves the
                serving phase's 32 requests under each (results equal the
                cuda engine's, recompiles == buckets, counts set to 0
                before and read after: one launch per strip per wave for
                streaming, none for xla); then CUDA-event times of all
                three executors at each bucket and 8K beside
                ``explain()``'s predicted pixel rate, one ``explain()``
                text per bucket and executor, and a ``profile_dump``
                trace of one streaming call.
 6b. sharded  — the halo ring (``'sharded'``) on meshes of 2 and 4 entries
                of ``cuda:0`` (and of all cards where there are several)
                held against ``'cuda'`` on the same frame: the three
                serving buckets, 8K UHD on 4 shards, each policy (zero,
                constant -3, replicate, mirror, mirror_dup, wrap) x
                {float32, int16, uint8, int8 with requant} x w {3, 5} at
                [2,64,332], and a gain swap on one compiled ring.
                Integers bit-exact, float32 within 3e-4; exactly one
                ``filter2d_halo`` launch per shard per call; the halo rows
                at the storage dtype, as many bytes as ``wire_bytes`` (on
                one card's entries these are the neighbours' own slices,
                counted as no copies: the check bites across cards);
                TMA launches per case; then device and host-paced ms of
                each bucket and 8K beside ``'cuda'``, and a profiler
                breakdown of one 4-shard call of two buckets.

  7. swattn   — the banded attention kernel against its plain version
                (``swattn_ref``) on the card, swept over the edges of its
                tile geometry: float32 (the CUDA-core kernel) and bfloat16
                (the tensor-core kernel), S ∈ {1, 63, 64, 65, 127, 128,
                129, 191, 192, 193, 1000}, window ∈ {0, 1, BK−1, BK,
                BK+1, 300, S+7} with BK the dtype's key tile as the
                built library reports it (``tile_keys``), H/KV 32/8, 8/8
                and 4/1, hd 16 / 64 / 80 /
                128 / 256, B = 3. float32 within
                rtol=atol=3e-4; bfloat16 within 3e-2 (p is rounded to
                bfloat16 before the PV product).
  8. dwconv1d — the causal depthwise conv kernel against its plain version
                (``dwconv1d_ref``): k 2 and 4, C 3200 and 130, S 1000 and
                37, float32 and bfloat16, bit-exact (the plain version
                repeats the kernel's roundings).
  9. LM       — ``h2o-danube-1.8b`` at full width (24 layers, d 2560, 32/8
                heads, hd 80, window 4096, vocab 32000), random weights
                from a seeded generator, one sequence of 8192 seeded
                tokens, through ``train_forward`` with ``use_pallas_attn``
                off (plain attention) and on (the kernel): float32 with
                TF32 off, then bfloat16. Every kernel forward must add
                exactly 24 ``swattn`` launches; the logits must be finite
                and agree (float32: max |Δ| within 1e-3 of max |logit|;
                bfloat16: relative L2 error within ``LM_TOL``). Two
                bfloat16 controls, the attention output zeroed and the
                window ignored, must land beyond that limit. Prints each
                forward's ms, tokens/s and the kernel's share, and a
                ``torch.profiler`` breakdown of one bf16 kernel forward
                (device busy/idle share, top kernels).
 10. mamba    — ``mamba_block`` at hymba-1.5b width (d 1600, d_in 3200,
                25 heads, state 16, conv 4), bfloat16, B = 2, S = 4096,
                with ``use_pallas_conv`` on (one ``dwconv1d`` launch per
                block) and off, twice each (the second run timed); the
                outputs agree bit for bit; a profiler breakdown.
 10b. LM serving — ``prefill`` and greedy ``decode_step`` at full width,
                bf16 weights drawn in bf16 from a seeded generator.
                h2o-danube-1.8b: 4 prompts of 6144 tokens (past the 4096
                window: the ring's eviction write), 64 steps (the ring
                wraps from slot 2048); hymba-1.5b: 2 x 2048 (+128 meta
                tokens in sink slots, past the 1024 window), 32 steps, the
                mamba state through ``ssd_step``. The kernel gate on: 24
                ``swattn`` launches per h2o-danube prefill, none in
                decode nor for hymba (the sinks bar it). Checks: the
                gated prefill's last logits against the plain prefill's
                (relative L2 within ``LM_TOL``); every row that made a
                token against the teacher-forced ``train_forward`` over
                prompt + generated tokens (no farther, in relative L2,
                from the float32 forward on the same weights than the
                bf16 forward is, plus ``LM_TOL``; the token equal to the
                bf16 forward's argmax wherever its top-2 margin exceeds
                twice the row's max |Δ|); every stage's cache
                positions on the ring's slot layout; two controls (the
                cache write skipped, the ring slot off by one) must fail
                that check; h2o-danube with int8 KV within the
                reference's 0.05 of max |logit| of the bf16-cache decode;
                float32 (h2o-danube 1 x 4608 + 16, hymba 1 x 2048 + 8)
                within 1e-3 of max |logit|.
                Prints prefill ms (the second call), decode ms per step
                (median, p90), tokens/s, cache bytes and a profile of one
                decode step.
 11. timing   — both new kernels at their path's shapes (``swattn`` also
                at the serving prefill's [4,6144], bf16, and at phase
                13's prefill shapes in both dtypes: [2,4096,32/4,128]
                W 0, [2,6144,32/8,128] W 4096, [2,4096,8/4,256] W 1024
                and W 0), first held
                against their plain versions there (``swattn`` float32
                within 3e-4, bfloat16 within rtol=atol=1e-2 and relative
                L2 1e-2; ``dwconv1d`` bit-exact), then timed with CUDA
                events: kernel, bound, plain version and a library
                yardstick the port never calls (SDPA with a band mask and
                GQA, float32 with TF32 off; ``F.conv1d`` with groups=C on
                a pre-padded input). The bfloat16 ``swattn`` must beat
                SDPA at every shape.
 12. LM training — ``make_train_step`` / ``train_loop`` of h2o-danube-1.8b,
                the config's gate off (plain attention, as the reference
                trains; the kernels refuse a gradient). (a) 2 layers at full
                width, float32 (TF32 off), [2, 512], microbatch 1 (two
                microbatches): one step on the card against the same step on
                the CPU from the same weights and batch — the loss within
                relative 1e-5, the clipped gradients and the updated
                parameters within relative L2 1e-5; two controls (only the
                first microbatch accumulated, the labels unshifted) must
                fail it. (b) The gradients under remat 'none', 'full' and
                'dots' agree within 1e-6. (c) The published config (24
                layers, bf16 compute, float32 master weights and AdamW
                state) at [4, 4096], microbatch 2, remat 'full': step 1's
                gradients against a float32 step on the same weights and
                batch (relative L2 within ``TRAIN_BF16_TOL``; the labels
                unshifted beyond it), then a warm-up step and 3 timed ones,
                the last profiled again: every loss
                finite, step 1's within 0.2 of ln V + 1/2, no kernel launch;
                step ms, tokens/s, peak memory, the model-FLOPs share of the
                bf16 peak, a profile of one step. (d) ``train_loop`` 3 steps
                against 2 steps, a checkpoint and step 3 resumed (2-layer
                setup of (a)). (e) ``python -m repro_torch.launch.train
                --arch h2o_danube_1_8b --tiny --steps 3`` exits 0 (a
                subprocess beside (a) and (b)).
 13. LM kinds — the moe kind, M-RoPE and hd 256 at full width, weights
                drawn in bf16 from seeded generators with the kernel
                gate on; the experts' weights scaled to their own
                fan-in (at the spec's std their output is about 1e-6
                and no check could see them). (a) ``_serve_model``'s
                checks and controls (plus one: the top-k weights not
                renormalised) for qwen3-moe-30b-a3b (4 of 48 layers,
                2 x 2048 + 16 steps) and mixtral-8x7b (4 of 32 layers,
                2 x 6144 + 32 steps: past its 4096 window) at the
                capacity factor E / k, where nothing drops. (b)
                qwen3-moe-30b-a3b as published: 48 layers, capacity
                factor 1.25, 61.1 GB of bf16 weights (init peak under
                70 GB); the gated 2 x 4096 prefill's last logits
                against the plain one (relative L2 within
                ``LM_TOL``; the attention zeroed must fail it)
                with the routing choices that differ between the two
                counted per layer; 32 greedy steps (median, p90,
                tokens/s beside the step's bytes bound), the drops, the
                cache bytes, peak memory, a profile of one step. (c)
                gemma3-4b as published through ``_serve_model``
                (2 x 4096 + 32: 34 ``swattn`` launches at hd 256 per
                prefill, local W 1024 and global). (d) qwen2-vl-7b
                ([1,4096,3584] float32 embeddings, M-RoPE) and
                codeqwen1.5-7b at 2 layers: ``train_forward`` with the
                gate on against off, float32 (TF32 off) and bf16, the
                attention zeroed as the control. (e) a moe train step,
                qwen3-moe-30b-a3b at 1 layer, float32 [2, 256], two
                microbatches, on the card against the CPU (loss, aux,
                gradients and parameters within 1e-5; controls: the aux
                dropped from the total, one microbatch only); no kernel
                launch. Each part runs; a failure is raised at the end.
 14. LM recurrent — the recurrent kinds and the encoder-decoder, which
                launch no kernel (the reference runs their convs and
                attention plain): the three counts must stay 0. (a)
                xlstm-350m as published (21 mLSTM, 3 sLSTM layers), bf16
                weights drawn on the card, the convs scaled to their taps'
                fan-in (``_conv_at_own_fan_in``: at the spec's std the
                mLSTM's memory cannot move the logits), 4 x 2048 prompt
                + 64 greedy
                steps, every row held by ``_decode_check`` to the
                teacher-forced forward; controls that must fail: the
                mLSTM memory reset to its init every step, the sLSTM
                state reset every step; init time and peak, prefill ms,
                step median and p90, tokens/s, state bytes, launches a
                step and a sLSTM time step, the sLSTM scans' share of
                the prefill, a profiled 1 x 256 prefill, the step's bytes
                bound (weights, the [B, 4, 512, 512] float32 memories
                read and written). (b) whisper-large-v3 as published, 4
                streams of 1500 frame embeddings (the stubbed
                frontend's output), a 4-token prompt + 64 steps, each row
                held to ``train_forward``; the encoder once a request;
                controls: the cross K/V zeroed, rolled by one batch row;
                the encoder and the cross K/V timed apart, the step's
                bytes bound, a step profile. (c) float32 card against
                the CPU: xlstm at 8 layers 1 x 512 + 16; whisper at
                2 + 2 layers, 64 frames, a 12-token prompt decoded to
                position 460 (past the 448 learned positions and ring
                slots); the mamba kind (``stage_override``) at hymba-1.5b
                widths 2 x 256 + 8: logits and every cache leaf within
                1e-3 of their max. (d) one float32 train step of each
                (xlstm 8 layers [2, 256]; whisper 2 + 2 layers, 256
                frames, 64 tokens), two microbatches, card against CPU
                within 1e-5 (phase 12 (a)). Each part runs; a failure is
                raised at the end.

Every main path (serving, the streaming and xla engines, the ring, LM,
mamba, LM serving, LM kinds, LM recurrent) runs
with the three launch counts set to 0 just before it and read just after.
The line before the last is the ``kernels`` JSON summary; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# The card's device-memory rate and peak operations per input type come
# from ``repro_torch/obs/roofline.py`` (the H100 data sheet, per part).
TOL = {"float32": 3e-4, "bfloat16": 3e-2}
POLICIES = ("neglect", "constant", "wrap", "duplicate", "mirror_dup",
            "mirror")
FORMS = ("direct", "transposed", "tree", "compress", "separable")
ROUNDINGS = ("truncate", "nearest", "nearest_even")
KERNEL_SOURCE = "src/repro_torch/kernels/filter2d/csrc/filter2d_halo_ring.cuh"
# the instantiations the serving mix runs (w5 f32, w3 f32, w3 int8 -> int8)
SERVING_KERNELS = ("filter2d_halo<f32,f32,f32,w5,fold>",
                   "filter2d_halo<f32,f32,f32,w3,fold>",
                   "filter2d_halo<i8,i32,i8,w3,fold>")
REPLACES = "src/repro/kernels/filter2d/kernel.py:349"
SWATTN_SOURCE = "src/repro_torch/kernels/swattn/csrc/swattn_bf16.cu"
# the swattn kernel per dtype: bfloat16 on the tensor cores, float32 on the
# CUDA cores (the reference's float32 dot is not TF32)
SWATTN_ROUTES = {
    "bfloat16": "tensor-core wgmma (csrc/swattn_bf16.cu)",
    "float32": "cuda-core (csrc/swattn.cu)"}
SWATTN_REPLACES = "src/repro/kernels/swattn/kernel.py:76"
DWCONV_SOURCE = "src/repro_torch/kernels/dwconv1d/csrc/dwconv1d.cu"
DWCONV_REPLACES = "src/repro/kernels/dwconv1d/kernel.py:40"
# LM logits, kernel against plain attention. bfloat16 relative L2 on an
# H100: 1.2e-2 when sound, 0.14 with the window ignored and 0.95 with the
# attention output zeroed (the phase's controls); 4e-2 sits about 3.5x
# from the sound reading and from the nearer fault.
LM_TOL = {"float32": 1e-3, "bfloat16": 4e-2}
# swattn at the LM's own shape, where the mean |o| is 0.03: bfloat16 is
# held to relative L2 1e-2 as well as rtol=atol=1e-2 (an H100 reads 1.8e-3
# and 3.9e-3), so a kernel that returns zeros cannot pass.
MAIN_TOL = {"float32": (3e-4, 3e-4), "bfloat16": (1e-2, 1e-2)}
# LM training. float32 on the card against the same step on the CPU: the
# loss relative, the clipped gradients and the updated parameters in
# relative L2 (the first AdamW step moves a weight by about lr·sign(g),
# so elementwise limits would read the signs of near-zero gradients); the
# remat policies' gradients in relative L2. bf16 step-1 gradients of
# h2o-danube-1.8b at full width against a float32 step on the same
# weights and batch: an H100 reads 2.2e-2 when sound, 0.48 with the
# labels unshifted and 1.0 with one microbatch of two; 0.1 sits about
# 4.6x from the sound reading and from the nearer fault.
TRAIN_F32_TOL = 1e-5
# Phase 13's experts at EXPERT_GAIN x the std the stage's dense MLP would
# get (``Smoke._scale_experts``). Read on an H100 (dev runs): at 4 layers
# 0.6 holds qwen3-moe's decode 0.0095 past its forward, its
# unrenormalised-weights control at 0.076; 0.4 leaves that control at
# 0.019, under LM_TOL, and 1.0 makes the bf16 routes diverge (qwen3's
# decode 0.15 past its forward, mixtral's 0.32). At 48 layers 1.0 keeps
# qwen3's gated prefill 0.013 from the plain one, 1.7 reads 0.128, and
# the experts at their own fan-in (6.9) 1.10, every token's top 8
# differing by layer 20.
EXPERT_GAIN = 0.6
TRAIN_REMAT_TOL = 1e-6
TRAIN_BF16_TOL = 0.1


def counters():
    """The launch counters of the three kernel wrappers, by name."""
    from repro_torch.kernels.dwconv1d import kernel as DW
    from repro_torch.kernels.filter2d import kernel as F2
    from repro_torch.kernels.swattn import kernel as SW
    return {"filter2d_halo": F2.filter2d_halo, "swattn": SW.swattn,
            "dwconv1d": DW.dwconv1d}


def reset_counts() -> None:
    for fn in counters().values():
        fn.launches = 0
    counters()["filter2d_halo"].tma_launches = 0


def read_counts() -> dict:
    return {name: fn.launches for name, fn in counters().items()}


def tma_count() -> int:
    """``filter2d_halo``'s launches that took the TMA loader."""
    return counters()["filter2d_halo"].tma_launches


class saved_counts:
    """Restores every launch count on exit: launches made to compare a
    kernel with its plain version, or to time it, are not the main
    path's."""

    def __enter__(self):
        self.saved = read_counts()
        self.tma = tma_count()

    def __exit__(self, *exc):
        for name, fn in counters().items():
            fn.launches = self.saved[name]
        counters()["filter2d_halo"].tma_launches = self.tma


def ptxas_summary(text: str):
    """(kernel, registers, static shared memory bytes, spill bytes) per
    kernel instantiation in a ``-Xptxas -v`` report."""
    import re
    rows, name = [], None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name, spill = m.group(1), 0
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            spill = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:               # no "bytes smem": no static shared memory
            sm = re.search(r"(\d+) bytes smem", line)
            rows.append((name, int(m.group(1)), int(sm.group(1)) if sm else 0,
                         spill))
            name = None
    return rows


def kernel_label(mangled: str) -> str:
    """``filter2d_halo<storage,acc,out,wW,form>``, ``swattn<dtype,hdN>``,
    ``swattn<bf16,hdN,wgmma>`` or ``dwconv1d<dtype,kN>`` from a mangled
    name."""
    import re
    m = re.search(r"swattn_wgmma_kernelILi(\d+)E", mangled)
    if m:
        return f"swattn<bf16,hd{m.group(1)},wgmma>"
    m = re.search(r"swattn_kernelILi(\d+)E", mangled)
    if m:
        return f"swattn<f32,hd{m.group(1)}>"
    m = re.search(r"dwconv1d_kernelI(f|13__nv_bfloat16)Li(\d+)E", mangled)
    if m:
        dt = "f32" if m.group(1) == "f" else "bf16"
        return f"dwconv1d<{dt},k{m.group(2)}>"
    m = re.search(r"filter2d_halo_kernelI(.*?)Li(\d+)ELi(\d+)E", mangled)
    if not m:
        return mangled
    codes = {"f": "f32", "i": "i32", "a": "i8", "h": "u8", "s": "i16",
             "13__nv_bfloat16": "bf16", "S1_": "bf16"}  # S1_: repeated type
    types = re.findall(r"13__nv_bfloat16|S1_|[fiahs]", m.group(1))
    form = ("fold", "tree", "compress", "separable")[int(m.group(3))]
    return (f"filter2d_halo<{','.join(codes[t] for t in types)},"
            f"w{m.group(2)},{form}>")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


class Smoke:
    def __init__(self, torch, card: str, part):
        self.torch = torch
        self.card = card
        self.max_err = {}
        # the card's H100 part (``obs/roofline.py``): every bound's constants
        self.hbm_bw = part.hbm_bw
        self.peak_ops = part.peak_ops

    def say(self, msg: str) -> None:
        print(f"[{self.card}] {msg}", flush=True)

    # -- phase 3 -------------------------------------------------------------

    def _inputs(self, rng, dt, M, H, W, N, w, form):
        import numpy as np
        torch = self.torch
        dev = "cuda"
        if dt in ("float32", "bfloat16"):
            x = torch.from_numpy(rng.standard_normal((M, H, W))
                                 .astype(np.float32))
            x = x.to(getattr(torch, dt))
            shape = (N, 2, w) if form == "separable" else (N, w, w)
            co = torch.from_numpy(rng.standard_normal(shape)
                                  .astype(np.float32) / w)
        else:
            info = np.iinfo(dt)
            x = torch.from_numpy(rng.integers(info.min, int(info.max) + 1,
                                              (M, H, W)).astype(dt))
            shape = (N, 2, w) if form == "separable" else (N, w, w)
            co = torch.from_numpy(rng.integers(-8, 9, shape)
                                  .astype(np.int32))
        return x.to(dev), co.to(dev)

    def check_case(self, rng, dt, policy, form, w, *, M=3, H=67, W=301,
                   N=4, rounding=None, x=None, co=None, loader=None):
        import numpy as np
        torch = self.torch
        from repro_torch.core.border_spec import BorderSpec
        from repro_torch.core.requant import RequantSpec
        from repro_torch.kernels.filter2d import halo
        from repro_torch.kernels.filter2d.kernel import (filter2d_halo,
                                                         filter2d_halo_ref)
        if x is None:
            x, co = self._inputs(rng, dt, M, H, W, N, w, form)
        M, H, W = x.shape
        N = co.shape[0]
        const = 3.7 if dt in TOL else -300.0
        rq = None if rounding is None else RequantSpec(
            rounding=rounding, dtype=dt)
        plan = halo.make_plan(H, W, w, BorderSpec(policy, const), H, W,
                              dtype=dt, requant=rq)
        q = None
        if rq is not None:
            q = torch.from_numpy(np.stack(
                [rng.integers(-(1 << 12), 1 << 12, N),
                 rng.integers(0, 21, N)], axis=1).astype(np.int32))
            q[0, 1] = 0                      # the shift-0 edge
            q = q.cuda()
        tma_before = tma_count()
        got = filter2d_halo(x, co, plan, q_params=q, form=form)
        took = "tma" if tma_count() > tma_before else "thread"
        ref = filter2d_halo_ref(x, co, plan, q_params=q, form=form)
        torch.cuda.synchronize()
        case = (f"{dt} {policy} {form} w{w} N{N} [{M},{H},{W}] "
                f"requant={rounding} loader={took}")
        if loader is not None and took != loader:
            raise AssertionError(f"{case}: expected the {loader} loader")
        if got.shape != ref.shape or got.dtype != ref.dtype:
            raise AssertionError(f"{case}: shape/dtype {tuple(got.shape)} "
                                 f"{got.dtype} vs {tuple(ref.shape)} "
                                 f"{ref.dtype}")
        if dt in TOL:
            g, r = got.float(), ref.float()
            if not bool(torch.isfinite(g).all()):
                raise AssertionError(f"{case}: non-finite output")
            err = float((g - r).abs().max())
            tol = TOL[dt]
            if not torch.allclose(g, r, rtol=tol, atol=tol):
                raise AssertionError(f"{case}: max |err| {err} over "
                                     f"rtol=atol={tol}")
        else:
            if not torch.equal(got, ref):
                diff = int((got.long() - ref.long()).abs().max())
                raise AssertionError(f"{case}: not bit-exact (max diff "
                                     f"{diff})")
            err = 0.0
        self.max_err[dt] = max(self.max_err.get(dt, 0.0), err)
        return err

    def kernel_phase(self):
        import numpy as np
        torch = self.torch
        rng = np.random.default_rng(11)
        n = 0
        # W 301: no dtype's rows are 16-byte aligned (per-thread loader);
        # W 336: every dtype's are, and 336 is no multiple of the tile
        for W, loader in ((301, "thread"), (336, "tma")):
            for dt in ("float32", "bfloat16", "int8", "uint8", "int16"):
                for policy in POLICIES:
                    for form in FORMS:
                        for w in (3, 5, 7):
                            N = 1 if form == "separable" else 4
                            self.check_case(rng, dt, policy, form, w, N=N,
                                            W=W, loader=loader)
                            n += 1
                            if dt not in TOL:
                                rounding = ROUNDINGS[n % 3]
                                self.check_case(rng, dt, policy, form, w,
                                                N=N, W=W, rounding=rounding,
                                                loader=loader)
                                n += 1
            for rounding in ROUNDINGS:       # every rounding, every int dtype
                for dt in ("int8", "uint8", "int16"):
                    self.check_case(rng, dt, "mirror", "direct", 5, N=4, W=W,
                                    rounding=rounding, loader=loader)
                    n += 1
        # frames smaller than one tile and one strip, every policy (TMA)
        for dt in ("float32", "bfloat16", "int8", "uint8", "int16"):
            for policy in POLICIES[1:]:     # neglect leaves no 5 x 48 output
                for form in ("direct", "separable"):
                    self.check_case(rng, dt, policy, form, 7, M=2, H=5, W=48,
                                    N=4 if form == "direct" else 1,
                                    rounding=None if dt in TOL else "nearest",
                                    loader="tma")
                    n += 1
        # a view whose first element is one element off 16 bytes
        x, co = self._inputs(rng, "float32", 3, 67, 336, 4, 5, "direct")
        view = torch.empty(x.numel() + 1, dtype=x.dtype,
                           device="cuda")[1:].view(x.shape)
        view.copy_(x)
        self.check_case(rng, "float32", "wrap", "direct", 5, x=view, co=co,
                        loader="thread")
        n += 1
        # all-max overflow edge: the int32 MAC must wrap like the reference
        x = torch.full((2, 40, 70), 32767, dtype=torch.int16, device="cuda")
        co = torch.full((2, 7, 7), 1 << 20, dtype=torch.int32, device="cuda")
        self.check_case(rng, "int16", "duplicate", "direct", 7, x=x, co=co,
                        loader="thread")
        self.check_case(rng, "int16", "duplicate", "direct", 7, x=x, co=co,
                        rounding="nearest", loader="thread")
        n += 2
        # full-HD planes
        self.check_case(rng, "float32", "mirror", "direct", 5, M=3, H=1440,
                        W=1920, N=1, loader="tma")
        self.check_case(rng, "int8", "mirror", "direct", 3, M=3, H=1440,
                        W=1920, N=1, rounding="nearest", loader="tma")
        n += 2
        for dt, e in self.max_err.items():
            self.say(f"kernel phase: {dt} max |kernel - plain| = {e!r}")
        self.say(f"kernel phase: {n} cases agree, each through the loader "
                 "it was meant to take")

    # -- phase 4 -------------------------------------------------------------

    def serving_phase(self, seed: int = 0, requests: int = 32):
        import numpy as np
        torch = self.torch
        from repro_torch.core.pipeline import batched_shape
        from repro_torch.kernels.filter2d import kernel as K
        from repro_torch.kernels.filter2d import ops
        from repro_torch.serving.bench import build_mix
        from repro_torch.serving.engine import FilterServeEngine

        rng = np.random.default_rng(seed)
        templates = build_mix(rng, scale=15)
        weights = np.asarray([t.weight for t in templates])
        picks = rng.choice(len(templates), size=requests,
                           p=weights / weights.sum())
        picks[:len(templates)] = np.arange(len(templates))  # every template
        engine = FilterServeEngine(batch_size=4, device="cuda")
        try:
            reset_counts()
            t0 = time.perf_counter()
            handles = [(ti, engine.submit(
                templates[ti].frame, templates[ti].coeffs,
                spec=templates[ti].spec, gains=templates[ti].gains,
                tenant=templates[ti].tenant)) for ti in picks]
            if not engine.drain(timeout=600):
                raise AssertionError("serving phase: drain timed out")
            wall = time.perf_counter() - t0
            launches = K.filter2d_halo.launches
            tma_launches = K.filter2d_halo.tma_launches
            stats = engine.stats()
            buckets = engine.cache_size()
        finally:
            engine.shutdown()
        # the bucket pipelines' plans and executors, for the references
        expect = {}
        for ti, t in enumerate(templates):
            cf = t.spec.compile(batched_shape(t.frame.shape, 4), "auto",
                                device="cuda")
            if cf.execution != "cuda":
                raise AssertionError(f"auto resolved to {cf.execution!r} on "
                                     "a card")
            planes, _ = ops._fold_planes(torch.from_numpy(t.frame).cuda())
            co = torch.as_tensor(np.asarray(t.coeffs)).cuda()
            co = co.to(torch.int32 if t.spec.requant else torch.float32)
            q = None
            if t.gains is not None:
                q = torch.tensor(t.gains.params(1), dtype=torch.int32,
                                 device="cuda")
            y = K.filter2d_halo_ref(planes, co[None], cf.plan, q_params=q,
                                    form=t.spec.form)
            expect[ti] = y[0, 0].cpu()
        served = []
        for ti, h in handles:
            got = h.result(timeout=60)
            served.append(got)
            ref = expect[ti]
            if got.shape != ref.shape or got.dtype != ref.dtype:
                raise AssertionError(f"serving: {templates[ti].name} shape "
                                     f"{tuple(got.shape)} vs "
                                     f"{tuple(ref.shape)}")
            if got.is_floating_point():
                if not bool(torch.isfinite(got).all()):
                    raise AssertionError("serving: non-finite output")
                if not torch.allclose(got, ref, rtol=3e-4, atol=3e-4):
                    raise AssertionError(f"serving: {templates[ti].name} "
                                         "disagrees with the plain version")
            elif not torch.equal(got, ref):
                raise AssertionError(f"serving: {templates[ti].name} not "
                                     "bit-exact")
        n_buckets = len({t.bucket for t in templates})
        if stats["errors"] or stats["completed"] != requests:
            raise AssertionError(f"serving: stats {stats}")
        if not stats["recompiles"] == buckets == n_buckets:
            raise AssertionError(f"serving: recompiles {stats['recompiles']}"
                                 f" vs buckets {buckets}/{n_buckets}")
        if launches != stats["waves"]:
            raise AssertionError(f"serving: {launches} kernel launches for "
                                 f"{stats['waves']} waves")
        if tma_launches != launches:
            raise AssertionError(f"serving: {tma_launches} of {launches} "
                                 "launches took the TMA loader")
        pixels = sum(h.pixels for _, h in handles)
        self.say(f"serving phase: {requests} requests, {stats['waves']} "
                 f"waves, {launches} kernel launches ({tma_launches} through "
                 f"the TMA loader), recompiles "
                 f"{stats['recompiles']} == buckets {buckets}, errors 0")
        self.say(f"serving phase: sustained {pixels / wall!r} px/s "
                 f"({pixels} px in {wall!r} s, burst submit, batch 4, "
                 "host frames in and out)")
        return launches, tma_launches, templates, picks, served

    # -- phase 5 -------------------------------------------------------------

    def _time(self, fn, iters: int, warmup: int = 3) -> float:
        """Device ms per call: CUDA events around ``iters`` calls that
        were all queued while the card was held busy by a sleep kernel, so
        the host's per-call Python overhead does not pace the launches.
        Where the calls outran the sleep (the card's launch queue is
        bounded, and a call of many small kernels fills it), the count
        halves and the timing runs again."""
        torch = self.torch
        for _ in range(warmup):
            fn()
        while True:
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(200_000_000)       # ~0.1 s of device clock
            start.record()
            for _ in range(iters):
                fn()
            end.record()
            covered = not start.query()          # the sleep outlasted queueing
            end.synchronize()
            if covered:
                return start.elapsed_time(end) / iters
            if iters == 1:
                raise AssertionError("timing: one call was not queued "
                                     "before the covering sleep ended")
            self.say(f"timing: {iters} calls outran the covering sleep; "
                     f"timing {iters // 2}")
            iters //= 2

    def wave_breakdown(self, templates, reps: int = 5):
        """Where one served wave's time goes, per bucket: stacking the
        batch into pinned host memory (host clock), the copy to the card,
        the pipeline call (kernel, plus the operands' small copies), and
        the copy back (CUDA events); medians over ``reps`` waves."""
        import numpy as np
        torch = self.torch
        from repro_torch.core.pipeline import admit_batch, batched_shape
        seen = set()
        for t in templates:
            if t.bucket in seen:
                continue
            seen.add(t.bucket)
            cf = t.spec.compile(batched_shape(t.frame.shape, 4), "cuda",
                                device="cuda")
            parts = []
            with saved_counts():
                for _ in range(reps + 1):
                    ev = [torch.cuda.Event(enable_timing=True)
                          for _ in range(4)]
                    t0 = time.perf_counter()
                    x = admit_batch([t.frame] * 4, 4, pin_memory=True)
                    t1 = time.perf_counter()
                    ev[0].record()
                    xd = x.to("cuda", non_blocking=True)
                    ev[1].record()
                    y = cf(xd, t.coeffs, gains=t.gains)
                    ev[2].record()
                    yh = torch.empty(y.shape, dtype=y.dtype, pin_memory=True)
                    yh.copy_(y, non_blocking=True)
                    ev[3].record()
                    ev[3].synchronize()
                    t2 = time.perf_counter()
                    parts.append(((t1 - t0) * 1e3, ev[0].elapsed_time(ev[1]),
                                  ev[1].elapsed_time(ev[2]),
                                  ev[2].elapsed_time(ev[3]),
                                  (t2 - t0) * 1e3))
            med = [float(v) for v in np.median(np.asarray(parts[1:]),
                                               axis=0)]
            self.say(f"wave {t.bucket} batch 4 {tuple(x.shape)} "
                     f"{t.spec.dtype}: host stack {med[0]!r} ms, copy in "
                     f"{med[1]!r} ms, pipeline call {med[2]!r} ms, copy out "
                     f"{med[3]!r} ms, wall {med[4]!r} ms (medians of {reps})")

    def timing_phase(self, templates):
        rows = {}
        with saved_counts():
            for t in templates:
                if t.bucket not in rows:
                    rows[t.bucket] = self._filter_timing(t)
        return rows

    def _filter_timing(self, t):
        """One bucket's kernel, plain and library times, and its bound."""
        import numpy as np
        torch = self.torch
        import torch.nn.functional as F
        from repro_torch.core.borders import extend
        from repro_torch.core.filter2d import cudnn_without_tf32
        from repro_torch.core.pipeline import batched_shape
        from repro_torch.kernels.filter2d import kernel as K
        cf = t.spec.compile(batched_shape(t.frame.shape, 4), "cuda",
                            device="cuda")
        planes = torch.from_numpy(np.stack([t.frame] * 4)).cuda()
        fixed = t.spec.requant is not None
        co = torch.as_tensor(np.asarray(t.coeffs)).cuda()
        co = co.to(torch.int32 if fixed else torch.float32)[None]
        co = co.contiguous()
        q = None
        if t.gains is not None:
            q = torch.tensor(t.gains.params(1), dtype=torch.int32,
                             device="cuda")
        M, H, W = planes.shape
        w = t.spec.window

        def kern():
            return K.filter2d_halo(planes, co, cf.plan, q_params=q,
                                   form=t.spec.form)

        def plain():
            return K.filter2d_halo_ref(planes, co, cf.plan, q_params=q,
                                       form=t.spec.form)

        ms = self._time(kern, 50)
        plain_ms = self._time(plain, 5, warmup=1)
        copy = torch.empty_like(planes)
        copy_ms = self._time(lambda: copy.copy_(planes), 50)
        lib_ms = None
        if not fixed:
            xp = extend(planes, w // 2, t.spec.border)[:, None]
            wt = co[:, None]

            def lib():
                return F.conv2d(xp, wt)
            with cudnn_without_tf32():
                err = float((lib()[:, 0] - kern()[:, 0]).abs().max())
                if err > 1e-3:
                    raise AssertionError(f"yardstick conv2d disagrees: "
                                         f"{err}")
                lib_ms = self._time(lib, 50)
        out = kern()
        geo = K.geometry(planes.dtype, out.dtype, w)
        bytes_moved = (planes.numel() * planes.element_size()
                       + out.numel() * out.element_size())
        ops = 2 * w * w * out.numel()
        bytes_ms = bytes_moved / self.hbm_bw * 1e3
        ops_ms = ops / self.peak_ops[t.spec.dtype] * 1e3
        bound_ms = max(bytes_ms, ops_ms)
        row = {"bucket": t.bucket, "shape": [M, H, W], "w": w,
               "dtype": t.spec.dtype, "ms": ms, "plain_ms": plain_ms,
               "library_ms": lib_ms, "bound_ms": bound_ms,
               "bound_by": "bytes" if bytes_ms >= ops_ms
               else "operations",
               "bytes": bytes_moved, "ops": ops,
               "bytes_ms": bytes_ms, "ops_ms": ops_ms,
               "share_of_bound": bound_ms / ms, "copy_ms": copy_ms,
               "geometry": geo}
        self.say(f"timing {t.bucket} planes [{M},{H},{W}] w{w} "
                 f"{t.spec.dtype}: kernel {ms!r} ms, bound {bound_ms!r} "
                 f"ms ({row['bound_by']}: {bytes_moved} B / "
                 f"{self.hbm_bw:.3g} B/s = {bytes_ms!r} ms; {ops} ops / "
                 f"{self.peak_ops[t.spec.dtype]:.3g} op/s = "
                 f"{ops_ms!r} ms), plain {plain_ms!r} ms, library "
                 f"{lib_ms!r} ms, {bytes_moved / (ms * 1e-3) / 1e12!r} "
                 "TB/s achieved")
        copy_bytes = 2 * planes.numel() * planes.element_size()
        copy_rate = copy_bytes / (copy_ms * 1e-3) / 1e12
        self.say(f"timing {t.bucket}: share of bound {bound_ms / ms!r}; a "
                 f"PyTorch copy of the planes ({copy_bytes} B in and out) "
                 f"takes {copy_ms!r} ms ({copy_rate!r} TB/s); tile "
                 f"geometry {geo}")
        return row

    def _profiled(self, fn):
        """One call of ``fn`` under ``torch.profiler``: ([(device ms,
        launches, name)] of each device operation, the call's wall ms).
        Its launches are not the main path's."""
        torch = self.torch
        from torch.profiler import ProfilerActivity, profile
        with saved_counts():
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
        rows = []
        for e in prof.key_averages():
            if not str(getattr(e, "device_type", "")).endswith("CUDA"):
                continue
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = getattr(e, "self_cuda_time_total", 0)
            if us > 0:
                rows.append((us / 1e3, e.count, e.key))
        return rows, wall_ms

    def profile(self, label: str, fn, top: int = 8, warm: bool = False
                ) -> None:
        """One warm call of ``fn`` under ``torch.profiler`` (``warm``: the
        caller has run it already, so no call precedes it): the device's
        busy and idle share of the call's wall time, and the kernels that
        took the most device time. Its launches are not the main
        path's."""
        if not warm:
            with saved_counts():
                fn()
        rows, wall_ms = self._profiled(fn)
        if not rows:
            self.say(f"profile {label}: the profiler saw no device time "
                     f"(wall {wall_ms!r} ms)")
            return
        busy = sum(r[0] for r in rows)
        self.say(f"profile {label}: wall {wall_ms!r} ms (profiled), device "
                 f"busy {busy!r} ms, idle share {1 - busy / wall_ms!r}, "
                 f"{len(rows)} kernel names")
        for ms, count, key in sorted(rows, reverse=True)[:top]:
            self.say(f"profile {label}:   {ms!r} ms ({ms / busy:.3f} of "
                     f"busy) x{count} {key[:90]}")

    # -- phase 6 -------------------------------------------------------------

    def _hold(self, what: str, got, ref, dtype: str) -> float:
        """``got`` against the cuda executor's ``ref``: integers bit for
        bit, float32 within rtol=atol=3e-4, bfloat16 within 3e-2. Returns
        max |got - ref|."""
        torch = self.torch
        if got.shape != ref.shape or got.dtype != ref.dtype:
            raise AssertionError(f"{what}: {tuple(got.shape)} {got.dtype} vs "
                                 f"{tuple(ref.shape)} {ref.dtype}")
        if dtype not in TOL:
            if not torch.equal(got, ref):
                diff = int((got.long() - ref.long()).abs().max())
                raise AssertionError(f"{what}: not bit-exact (max diff "
                                     f"{diff})")
            return 0.0
        return self._agree(what, got, ref, TOL[dtype])

    def _exec_case(self, what, spec, x, co, gains=None, strip_h=None,
                   executors=("streaming", "xla")) -> dict:
        """One frame through the cuda executor and each of ``executors``;
        each held against cuda. A streaming call must add one
        ``filter2d_halo`` launch per strip, an xla call none, and neither
        may leave the caller's TF32 setting changed."""
        torch = self.torch
        from repro_torch.kernels.filter2d import kernel as K
        shape = tuple(x.shape)
        ref = spec.compile(shape, "cuda", device="cuda")(x, co, gains=gains)
        errs = {}
        for exe in executors:
            kw = {"strip_h": strip_h} if exe == "streaming" else {}
            cf = spec.compile(shape, exe, device="cuda", **kw)
            tf32 = torch.backends.cudnn.allow_tf32
            before = K.filter2d_halo.launches
            got = cf(x, co, gains=gains)
            added = K.filter2d_halo.launches - before
            want = cf.n_strips if exe == "streaming" else 0
            if added != want:
                raise AssertionError(f"{exe} {what}: {added} filter2d_halo "
                                     f"launches, expected {want}")
            if torch.backends.cudnn.allow_tf32 != tf32:
                raise AssertionError(f"{exe} {what}: the TF32 setting "
                                     "changed")
            torch.cuda.synchronize()
            errs[exe] = self._hold(f"{exe} {what}", got, ref, spec.dtype)
        return errs

    def executors_phase(self, templates, picks, served):
        """The strip-scan and library-convolution executors against the
        cuda executor: the serving buckets, 8K UHD, the int8 wrap prologue,
        the int16 overflow edge (and xla's split halves at w 13 and 15,
        against core) and a policy x dtype x window sweep; then
        both serve the serving phase's 32 requests; then each bucket and 8K
        timed under all three executors beside ``explain()``'s roofline."""
        import numpy as np
        torch = self.torch
        from repro_torch.core.border_spec import BorderSpec
        from repro_torch.core.pipeline import Filter2D
        from repro_torch.core.requant import RequantSpec
        if not torch.backends.cudnn.allow_tf32:
            raise AssertionError("executors phase: a global TF32 flip is in "
                                 "force; 'xla' must switch TF32 off itself")
        rng = np.random.default_rng(14)
        errs = {"streaming": {}, "xla": {}}
        n = 0

        def note(found, dt):
            nonlocal n
            for exe, e in found.items():
                errs[exe][dt] = max(errs[exe].get(dt, 0.0), e)
                n += 1

        cases = {}
        with saved_counts():
            for t in templates:                   # the serving buckets
                if t.bucket in cases:
                    continue
                x = torch.from_numpy(np.stack([t.frame] * 4)[..., None])
                cases[t.bucket] = (t.spec, x.cuda(), t.coeffs, t.gains)
            uhd = Filter2D(window=5, border=BorderSpec("mirror"))
            x8k = torch.from_numpy(rng.standard_normal(
                (1, 4320, 7680, 1)).astype(np.float32)).cuda()
            k5 = (rng.standard_normal((5, 5)) / 5).astype(np.float32)
            cases["8K"] = (uhd, x8k, k5, None)
            for name, (spec, x, co, gains) in cases.items():
                note(self._exec_case(name, spec, x, co, gains), spec.dtype)
            ki = rng.integers(-4, 5, (3, 3)).astype(np.int32)
            ki[1, 1] = 9
            rq = RequantSpec.unity_gain(ki, "int8")
            wrap = Filter2D(window=3, border=BorderSpec("wrap"), dtype="int8",
                            requant=rq.gain_free())
            xi = torch.from_numpy(rng.integers(-128, 128, (4, 960, 1440, 1))
                                  .astype(np.int8)).cuda()
            note(self._exec_case("int8 w3 wrap requant [4,960,1440]", wrap,
                                 xi, ki, rq), "int8")
            edge = Filter2D(window=7, border=BorderSpec("duplicate"),
                            dtype="int16")
            xe = torch.full((2, 40, 70, 1), 32767, dtype=torch.int16,
                            device="cuda")
            ke = np.full((7, 7), 1 << 20, np.int32)
            note(self._exec_case("int16 all-max overflow edge", edge, xe, ke,
                                 strip_h=8), "int16")
            note(self._wide_xla_cases(rng), "int16")
            for dt in ("float32", "bfloat16", "int8", "uint8", "int16"):
                for policy in POLICIES:
                    for w in (3, 5):
                        note(self._sweep_case(rng, dt, policy, w), dt)
        for exe, by_dt in errs.items():
            self.say(f"executors phase: {exe} max |{exe} - cuda| by dtype "
                     f"{by_dt}")
        self.say(f"executors phase: {n} executor calls agree with the cuda "
                 "executor, streaming launches == strips on each, TF32 left "
                 "as the caller set it")
        served_by = {exe: self._serve_with(exe, templates, picks, served)
                     for exe in ("streaming", "xla")}
        rows = self.executor_timing(cases)
        self.profile_dump_check(cases)
        return errs, served_by, rows

    def _wide_xla_cases(self, rng) -> dict:
        """'xla' at w 13 and 15, where one float64 convolution of int16
        sums could pass 2^53 and the coefficients split in 16-bit halves:
        an all-max frame under duplicate (every output is 32767 * sum(k)
        wrapped to int32) and a random frame under mirror, with
        coefficients over all of int32. The kernel is built for w <= 7,
        so each is held bit for bit against the plain 'core' executor on
        the CPU, and the all-max frame against its closed form too."""
        import numpy as np
        torch = self.torch
        from repro_torch.core.border_spec import BorderSpec
        from repro_torch.core.pipeline import Filter2D
        from repro_torch.kernels.filter2d import kernel as K
        for w in (13, 15):
            k = np.full((w, w), 1 << 20, np.int32)
            k[0, 0], k[w // 2, w // 2] = -(1 << 31), 0x7FFFBEEF
            edge = (32767 * int(k.astype(np.int64).sum()) + 2 ** 31) \
                % 2 ** 32 - 2 ** 31
            kr = rng.integers(-2 ** 31, 2 ** 31, (w, w)).astype(np.int32)
            xr = rng.integers(-2 ** 15, 2 ** 15, (2, 52, 67, 1)).astype(
                np.int16)
            for what, policy, x, co in (
                    ("all-max", "duplicate",
                     np.full((2, 40, 70, 1), 32767, np.int16), k),
                    ("random", "mirror", xr, kr)):
                spec = Filter2D(window=w, dtype="int16",
                                border=BorderSpec(policy))
                xc = torch.from_numpy(x)
                want = spec.compile(xc.shape, "core", device="cpu")(xc, co)
                if what == "all-max" and not bool((want == edge).all()):
                    raise AssertionError(f"core int16 all-max w{w}: not the "
                                         f"closed form {edge}")
                before = K.filter2d_halo.launches
                got = spec.compile(xc.shape, "xla", device="cuda")(
                    xc.cuda(), co)
                if K.filter2d_halo.launches != before:
                    raise AssertionError(f"xla int16 {what} w{w}: launched "
                                         "filter2d_halo")
                torch.cuda.synchronize()
                self._hold(f"xla int16 {what} w{w} (split halves)",
                           got.cpu(), want, "int16")
        self.say("executors phase: xla int16 at w 13 and 15 (split "
                 "coefficient halves) equals core on the CPU bit for bit, "
                 "all-max and random")
        return {"xla": 0.0}

    def _sweep_case(self, rng, dt, policy, w):
        """One policy x dtype x window case: xla at [3,67,336] (and
        streaming there too, one strip: the frame's own policy), streaming
        at [3,64,336] in 8 strips of 8 rows."""
        import numpy as np
        torch = self.torch
        from repro_torch.core.border_spec import BorderSpec
        from repro_torch.core.pipeline import Filter2D
        from repro_torch.core.requant import RequantSpec
        found = {}
        for H, strip_h in ((67, None), (64, 8)):
            if dt in TOL:
                x = torch.from_numpy(rng.standard_normal((3, H, 336, 1))
                                     .astype(np.float32)).to(getattr(torch,
                                                                     dt))
                co = (rng.standard_normal((w, w)) / w).astype(np.float32)
                rq = None
            else:
                info = np.iinfo(dt)
                x = torch.from_numpy(rng.integers(info.min, int(info.max) + 1,
                                                  (3, H, 336, 1)).astype(dt))
                co = rng.integers(-8, 9, (w, w)).astype(np.int32)
                rq = RequantSpec(multiplier=int(rng.integers(1, 1 << 10)),
                                 shift=int(rng.integers(0, 16)),
                                 rounding=ROUNDINGS[w % 3], dtype=dt)
            spec = Filter2D(window=w, dtype=dt, requant=rq.gain_free()
                            if rq else None, border=BorderSpec(
                                policy, 3.7 if dt in TOL else -300.0))
            if strip_h is None:                # neglect: no strip scan
                exes = ("xla",) if policy == "neglect" else ("streaming",
                                                             "xla")
            else:
                exes = () if policy == "neglect" else ("streaming",)
            if exes:
                got = self._exec_case(f"{dt} {policy} w{w} [3,{H},336]",
                                      spec, x.cuda(), co, rq, strip_h, exes)
                for exe, e in got.items():
                    found[exe] = max(found.get(exe, 0.0), e)
        return found

    def _serve_with(self, execution, templates, picks, served) -> dict:
        """The serving phase's requests through
        ``FilterServeEngine(execution=...)``; each result held against the
        cuda engine's. A main path of its own: counts set to 0 before,
        read after — a streaming wave launches ``filter2d_halo`` once per
        strip of its bucket, an xla wave not at all."""
        torch = self.torch
        from repro_torch import obs
        from repro_torch.core.pipeline import batched_shape
        from repro_torch.serving.engine import FilterServeEngine
        strips = {}
        for t in templates:
            cf = t.spec.compile(batched_shape(t.frame.shape, 4), execution,
                                device="cuda")
            strips[cf._obs_key] = cf.n_strips or 0
        engine = FilterServeEngine(batch_size=4, device="cuda",
                                   execution=execution)
        try:
            with obs.tracing():
                reset_counts()
                t0 = time.perf_counter()
                handles = [engine.submit(
                    templates[ti].frame, templates[ti].coeffs,
                    spec=templates[ti].spec, gains=templates[ti].gains,
                    tenant=templates[ti].tenant) for ti in picks]
                if not engine.drain(timeout=600):
                    raise AssertionError(f"{execution} serving: drain timed "
                                         "out")
                wall = time.perf_counter() - t0
                launches = read_counts()
                calls = [e.key for e in obs.events.events(kind="execute")]
            stats = engine.stats()
            buckets = engine.cache_size()
        finally:
            engine.shutdown()
        want = sum(strips[k] for k in calls)
        if launches != {"filter2d_halo": want, "swattn": 0, "dwconv1d": 0}:
            raise AssertionError(f"{execution} serving: counts {launches}, "
                                 f"expected {want} filter2d_halo launches "
                                 f"over {len(calls)} pipeline calls")
        n_buckets = len({t.bucket for t in templates})
        if stats["errors"] or not (stats["recompiles"] == buckets
                                   == n_buckets):
            raise AssertionError(f"{execution} serving: stats {stats}, "
                                 f"buckets {buckets}/{n_buckets}")
        for ti, h, ref in zip(picks, handles, served):
            self._hold(f"{execution} serving {templates[ti].name}",
                       h.result(timeout=60), ref, templates[ti].spec.dtype)
        pixels = sum(h.pixels for h in handles)
        self.say(f"executors phase: FilterServeEngine(execution="
                 f"{execution!r}) served {len(handles)} requests in "
                 f"{stats['waves']} waves ({len(calls)} pipeline calls, "
                 f"{want} filter2d_halo launches), recompiles "
                 f"{stats['recompiles']} == buckets {buckets}, results equal "
                 f"the cuda engine's; {pixels / wall!r} px/s (obs tracing on, "
                 "a synchronise per call)")
        return {"launches": want, "waves": stats["waves"],
                "px_per_s": pixels / wall}

    def _paced(self, fn, iters: int, warmup: int = 2) -> float:
        """ms per call as the host paces it: CUDA events around ``iters``
        back-to-back calls, with no covering sleep — host work between
        launches counts."""
        torch = self.torch
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters

    def executor_timing(self, cases) -> list:
        """Each bucket and 8K under cuda, streaming and xla: device ms
        (calls queued behind a sleep) and host-paced ms, beside the
        predicted pixel rate of ``explain()``'s roofline and the share of
        it reached; one ``explain()`` text per bucket and executor."""
        rows = []
        with saved_counts():
            for name, (spec, x, co, gains) in cases.items():
                for exe in ("cuda", "streaming", "xla"):
                    cf = spec.compile(tuple(x.shape), exe, device="cuda")
                    d = cf.explain(as_dict=True)
                    for line in cf.explain().splitlines():
                        self.say(f"explain {name} {exe}: {line}")

                    def call():
                        return cf(x, co, gains=gains)
                    iters = 5 if cf.n_strips and cf.n_strips > 8 else 20
                    tma0, n0 = tma_count(), read_counts()["filter2d_halo"]
                    call()
                    launched = read_counts()["filter2d_halo"] - n0
                    by_tma = tma_count() - tma0
                    ms = self._time(call, iters)
                    paced = self._paced(call, iters)
                    px = d["frame"]["pixels_per_call"]
                    pred = d["roofline"]["predicted_pixels_per_s"]
                    row = {"case": name, "executor": exe,
                           "shape": list(x.shape), "dtype": spec.dtype,
                           "w": spec.window, "strips": cf.n_strips,
                           "launches": launched, "tma_launches": by_tma,
                           "ms": ms, "paced_ms": paced,
                           "px_per_s": px / (ms * 1e-3),
                           "paced_px_per_s": px / (paced * 1e-3),
                           "predicted_px_per_s": pred,
                           "share": px / (ms * 1e-3) / pred,
                           "paced_share": px / (paced * 1e-3) / pred}
                    rows.append(row)
                    strips = (f" in {cf.n_strips} strips"
                              if exe == "streaming" else "")
                    strips += (f" ({launched} launches, {by_tma} by TMA)"
                               if launched else "")
                    self.say(f"executor timing {name} {exe} "
                             f"{list(x.shape)} {spec.dtype} w{spec.window}"
                             f"{strips}: {ms!r} ms device "
                             f"({row['px_per_s']!r} px/s, "
                             f"{row['share']!r} of the predicted "
                             f"{pred!r} px/s), {paced!r} ms host-paced "
                             f"({row['paced_share']!r} of it)")
        return rows

    def profile_dump_check(self, cases) -> None:
        """``compile(..., profile_dump=dir)`` on the card: the first call's
        Chrome trace lands in ``dir``; its device kernels are counted."""
        import glob
        spec, x, co, gains = cases["w5f32"]
        out = os.path.join(ROOT, "build", "profile_dump")
        for old in glob.glob(os.path.join(out, "*.trace.json")):
            os.remove(old)
        with saved_counts():
            cf = spec.compile(tuple(x.shape), "streaming", device="cuda",
                              profile_dump=out)
            cf(x, co, gains=gains)
            cf(x, co, gains=gains)
        traces = glob.glob(os.path.join(out, "*.trace.json"))
        if len(traces) != 1:
            raise AssertionError(f"profile_dump wrote {len(traces)} traces")
        with open(traces[0]) as fh:
            events = json.load(fh).get("traceEvents", [])
        kern = [e for e in events if e.get("cat") == "kernel"]
        halo = [e for e in kern if "filter2d_halo" in e.get("name", "")]
        self.say(f"profile_dump: one trace ({os.path.relpath(traces[0], ROOT)}"
                 f"), {len(kern)} device kernels, {len(halo)} of them "
                 f"filter2d_halo (the streaming call makes {cf.n_strips}), "
                 f"device busy {sum(e.get('dur', 0) for e in kern)!r} us")
        # where the host's time goes in that call: the outermost torch ops
        # (each op's time includes the ops it calls) against the host span
        ops = sorted((e for e in events if e.get("cat") == "cpu_op"),
                     key=lambda e: e["ts"])
        top, end, by_name = [], -1.0, {}
        for e in ops:
            if e["ts"] >= end:
                top.append(e)
                end = e["ts"] + e.get("dur", 0)
                by_name[e["name"]] = (by_name.get(e["name"], 0.0)
                                      + e.get("dur", 0))
        if top:
            span = top[-1]["ts"] + top[-1].get("dur", 0) - top[0]["ts"]
            self.say(f"profile_dump: host span {span!r} us, "
                     f"{len(top)} outermost torch ops taking "
                     f"{sum(by_name.values())!r} us (the rest is Python "
                     "between them); by name: " + "; ".join(
                         f"{n} {us:.0f} us" for n, us in sorted(
                             by_name.items(), key=lambda kv: -kv[1])[:10]))


    # -- phase 6b ------------------------------------------------------------

    def sharded_phase(self, templates):
        """The halo ring (``'sharded'``) on meshes of 2 and 4 entries of
        ``cuda:0`` (and of every card where there is more than one), each
        case held against the cuda executor on the same frame: the serving
        buckets, 8K UHD on 4 shards, each policy x {float32, int16, uint8,
        int8 with requant} x w {3, 5} at [2,64,332], and a gain swap on
        one compiled ring. A main path: counts set to 0 before the ring
        calls and read after (the cuda references are not counted); every
        call launches ``filter2d_halo`` once per shard and moves its halo
        rows at the storage dtype. Then device and host-paced ms beside
        cuda for each bucket and 8K."""
        import numpy as np
        torch = self.torch
        from repro_torch.core import distributed
        from repro_torch.core.border_spec import BorderSpec
        from repro_torch.core.pipeline import Filter2D
        from repro_torch.core.requant import RequantSpec
        meshes = [["cuda:0"] * 2, ["cuda:0"] * 4]
        if torch.cuda.device_count() > 1:
            meshes.append([f"cuda:{i}" for i in range(
                torch.cuda.device_count())])
        self.say(f"sharded phase: meshes {meshes}")
        rng = np.random.default_rng(16)
        wire, copies = [], [0, 0]
        real_exchange = distributed._exchange_halos

        def spy(shards, r):
            tops, bots = real_exchange(shards, r)
            wire.extend(tops + bots)
            # a halo still viewing its neighbour's shard moved no bytes
            copies[0] += sum(t._base is None for t in tops + bots)
            copies[1] += len(tops + bots)
            return tops, bots
        cases = {}
        for t in templates:                       # the serving buckets
            if t.bucket not in cases:
                x = torch.from_numpy(np.stack([t.frame] * 4)[..., None])
                cases[t.bucket] = (t.spec, x.cuda(), t.coeffs, t.gains,
                                   meshes)
        x8k = torch.from_numpy(rng.standard_normal(
            (1, 4320, 7680, 1)).astype(np.float32)).cuda()
        cases["8K"] = (Filter2D(window=5, border=BorderSpec("mirror")), x8k,
                       (rng.standard_normal((5, 5)) / 5).astype(np.float32),
                       None, [["cuda:0"] * 4])
        for dt in ("float32", "int16", "uint8", "int8"):
            for policy, c in (("constant", 0.0), ("constant", -3.0),
                              ("duplicate", 0.0), ("mirror", 0.0),
                              ("mirror_dup", 0.0), ("wrap", 0.0)):
                for w in (3, 5):
                    if dt == "float32":
                        x = rng.standard_normal((2, 64, 332, 1)).astype(
                            np.float32)
                        co = (rng.standard_normal((w, w)) / w).astype(
                            np.float32)
                        rq = None
                    else:
                        info = np.iinfo(dt)
                        x = rng.integers(info.min, int(info.max) + 1,
                                         (2, 64, 332, 1)).astype(dt)
                        co = rng.integers(-8, 9, (w, w)).astype(np.int32)
                        rq = RequantSpec(
                            multiplier=int(rng.integers(1, 1 << 10)),
                            shift=int(rng.integers(0, 16)),
                            rounding=ROUNDINGS[w % 3], dtype=dt)
                    spec = Filter2D(window=w, dtype=dt,
                                    border=BorderSpec(policy, c),
                                    requant=rq.gain_free() if rq else None)
                    cases[f"{dt} {policy}({c}) w{w} [2,64,332]"] = (
                        spec, torch.from_numpy(x).cuda(), co, rq, meshes)
        main = [t.bucket for t in templates] + ["8K"]   # timed below
        errs, n, expected, sweep_tma = {}, 0, 0, {}
        distributed._exchange_halos = spy
        try:
            reset_counts()
            for name, (spec, x, co, gains, on) in cases.items():
                with saved_counts():
                    ref = spec.compile(tuple(x.shape), "cuda",
                                       device="cuda")(x, co, gains=gains)
                for mesh in on:
                    if x.shape[1] % len(mesh):
                        self.say(f"sharded phase: {name} skipped on {mesh} "
                                 f"(H % {len(mesh)} != 0)")
                        continue
                    cf = spec.compile(tuple(x.shape), "sharded", mesh=mesh)
                    before, tma0 = read_counts()["filter2d_halo"], tma_count()
                    del wire[:]
                    got = cf(x, co, gains=gains)
                    added = read_counts()["filter2d_halo"] - before
                    if added != cf.n_shards:
                        raise AssertionError(
                            f"sharded {name} {mesh}: {added} filter2d_halo "
                            f"launches, expected {cf.n_shards}")
                    dts = {t.dtype for t in wire}
                    moved = sum(t.nbytes for t in wire)
                    if dts != {x.dtype} or moved != cf.wire_bytes:
                        raise AssertionError(
                            f"sharded {name} {mesh}: halo rows {dts}, "
                            f"{moved} B; expected {x.dtype}, "
                            f"{cf.wire_bytes} B")
                    expected += cf.n_shards
                    torch.cuda.synchronize()
                    e = self._hold(f"sharded {name} {len(mesh)} shards", got,
                                   ref, spec.dtype)
                    errs[spec.dtype] = max(errs.get(spec.dtype, 0.0), e)
                    n += 1
                    tma = tma_count() - tma0
                    if name in main:
                        self.say(f"sharded {name} {len(mesh)} shards: {tma} "
                                 f"of {len(mesh)} launches by TMA, {moved} B "
                                 "of halo rows per call")
                    else:
                        key = f"{spec.dtype} w{spec.window}"
                        sweep_tma[key] = sweep_tma.get(key, 0) + tma
            swap = cases["w3i8"]
            cf = swap[0].compile(tuple(swap[1].shape), "sharded",
                                 mesh=meshes[1])
            cuda = swap[0].compile(tuple(swap[1].shape), "cuda",
                                   device="cuda")
            for g in ((1, 0), (5, 3), (-7, 11), (300, 12)):
                got = cf(swap[1], swap[2], gains=g)
                expected += cf.n_shards
                with saved_counts():
                    ref = cuda(swap[1], swap[2], gains=g)
                self._hold(f"sharded gain swap {g}", got, ref, "int8")
                n += 1
            if cf.cache_size() != 1:
                raise AssertionError(f"sharded gain swap: cache_size "
                                     f"{cf.cache_size()}")
            launches = read_counts()
        finally:
            distributed._exchange_halos = real_exchange
        if launches != {"filter2d_halo": expected, "swattn": 0,
                        "dwconv1d": 0}:
            raise AssertionError(f"sharded phase: counts {launches}, "
                                 f"expected {expected} filter2d_halo")
        self.say(f"sharded phase: {n} ring calls agree with the cuda "
                 f"executor, {expected} filter2d_halo launches (one per "
                 f"shard per call), halo rows at the storage dtype; max "
                 f"|sharded - cuda| by dtype {errs}")
        self.say(f"sharded phase: {copies[0]} of {copies[1]} halo tensors "
                 "were copies (a mesh of one card's entries hands each shard "
                 "its neighbour's slice, so the wire check means something "
                 "only across cards)")
        self.say(f"sharded sweep: TMA launches by dtype and window, over "
                 f"every policy and mesh: {sweep_tma}")
        rows = self.sharded_timing({k: cases[k] for k in dict.fromkeys(main)})
        return {"launches": expected, "calls": n, "max_abs_err": errs,
                "meshes": meshes, "timing": rows}

    def sharded_timing(self, cases) -> list:
        """Each bucket (2 and 4 shards of cuda:0) and 8K (4 shards): device
        ms (calls queued behind a sleep) and host-paced ms, beside the cuda
        executor on the same frame."""
        rows = []
        with saved_counts():
            for name, (spec, x, co, gains, _) in cases.items():
                runs = [("cuda", spec.compile(tuple(x.shape), "cuda",
                                              device="cuda"))]
                for k in ((4,) if name == "8K" else (2, 4)):
                    runs.append((f"sharded x{k}", spec.compile(
                        tuple(x.shape), "sharded", mesh=["cuda:0"] * k)))
                for label, cf in runs:
                    def call():
                        return cf(x, co, gains=gains)
                    iters = 10 if name == "8K" else 20
                    ms = self._time(call, iters)
                    paced = self._paced(call, iters)
                    rows.append({"case": name, "executor": label,
                                 "shape": list(x.shape), "dtype": spec.dtype,
                                 "w": spec.window, "ms": ms,
                                 "paced_ms": paced,
                                 "wire_bytes": cf.wire_bytes})
                    self.say(f"sharded timing {name} {label} "
                             f"{list(x.shape)} {spec.dtype} w{spec.window}: "
                             f"{ms!r} ms device, {paced!r} ms host-paced"
                             + (f", {cf.wire_bytes} B of halo rows per call"
                                if cf.wire_bytes else ""))
                if name in ("w5f32", "w3i8"):     # where a ring call goes
                    self.profile(f"sharded {name} {label}", call)
        return rows

    # -- phase 7 -------------------------------------------------------------

    def _agree(self, what: str, got, ref, tol: float,
               rel_l2: float | None = None) -> float:
        """max |got - ref|, after checking shape, dtype, finiteness,
        allclose(rtol=atol=tol) and, where given, the relative L2 error."""
        torch = self.torch
        if got.shape != ref.shape or got.dtype != ref.dtype:
            raise AssertionError(f"{what}: {tuple(got.shape)} {got.dtype} vs "
                                 f"{tuple(ref.shape)} {ref.dtype}")
        g, r = got.float(), ref.float()
        if not bool(torch.isfinite(g).all()):
            raise AssertionError(f"{what}: non-finite output")
        err = float((g - r).abs().max())
        if not torch.allclose(g, r, rtol=tol, atol=tol):
            raise AssertionError(f"{what}: max |err| {err} over "
                                 f"rtol=atol={tol}")
        if rel_l2 is not None:
            rel = float((g - r).norm() / r.norm())
            self.say(f"{what}: max |err| {err!r}, relative L2 {rel!r} "
                     f"(mean |ref| {float(r.abs().mean())!r})")
            if not rel <= rel_l2:
                raise AssertionError(f"{what}: relative L2 error {rel} over "
                                     f"{rel_l2}")
        return err

    def _equal(self, what: str, got, ref) -> None:
        """Bit-exact: the plain version repeats the kernel's roundings."""
        if got.shape != ref.shape or got.dtype != ref.dtype:
            raise AssertionError(f"{what}: {tuple(got.shape)} {got.dtype} vs "
                                 f"{tuple(ref.shape)} {ref.dtype}")
        if not self.torch.equal(got, ref):
            diff = float((got.float() - ref.float()).abs().max())
            raise AssertionError(f"{what}: not bit-exact (max |err| {diff})")

    def swattn_phase(self):
        import numpy as np
        torch = self.torch
        from repro_torch.kernels.swattn import kernel as SW
        rng = np.random.default_rng(12)
        errs, n = {}, 0
        B = 3
        with saved_counts():
            for dt in ("float32", "bfloat16"):
                bk = SW.tile_keys(getattr(torch, dt))
                for H, KV in ((32, 8), (8, 8), (4, 1)):
                    for hd in (16, 64, 80, 128, 256):
                        for S in (1, 63, 64, 65, 127, 128, 129, 191,
                                  192, 193, 1000):
                            q = torch.from_numpy(rng.standard_normal(
                                (B, S, H, hd)).astype(np.float32)).cuda()
                            k, v = (torch.from_numpy(rng.standard_normal(
                                (B, S, KV, hd)).astype(np.float32)).cuda()
                                for _ in range(2))
                            q, k, v = (t.to(getattr(torch, dt))
                                       for t in (q, k, v))
                            for window in (0, 1, bk - 1, bk, bk + 1, 300,
                                           S + 7):
                                got = SW.swattn(q, k, v, window=window,
                                                scale=hd ** -0.5)
                                ref = SW.swattn_ref(q, k, v, window=window,
                                                    scale=hd ** -0.5)
                                torch.cuda.synchronize()
                                err = self._agree(
                                    f"swattn {dt} H{H}/{KV} hd{hd} "
                                    f"w{window} [{B},{S}]", got, ref,
                                    TOL[dt])
                                errs[dt] = max(errs.get(dt, 0.0), err)
                                n += 1
        for dt, e in errs.items():
            self.say(f"swattn phase: {dt} ({SWATTN_ROUTES[dt]}) max |kernel "
                     f"- plain| = {e!r}")
        self.say(f"swattn phase: {n} cases agree")
        return max(errs.values())

    # -- phase 8 -------------------------------------------------------------

    def dwconv_phase(self):
        import numpy as np
        torch = self.torch
        from repro_torch.kernels.dwconv1d import kernel as DW
        rng = np.random.default_rng(13)
        n = 0
        with saved_counts():
            for dt in ("float32", "bfloat16"):
                tdt = getattr(torch, dt)
                for k in (2, 4):
                    for C in (3200, 130):
                        for S in (1000, 37):
                            x = torch.from_numpy(rng.standard_normal(
                                (2, S, C)).astype(np.float32)).to("cuda", tdt)
                            w = torch.from_numpy((rng.standard_normal(
                                (k, C)) / k).astype(np.float32)).to("cuda", tdt)
                            b = torch.from_numpy(rng.standard_normal(C).astype(
                                np.float32)).to("cuda", tdt)
                            got = DW.dwconv1d(x, w, b)
                            ref = DW.dwconv1d_ref(x, w, b)
                            torch.cuda.synchronize()
                            self._equal(f"dwconv1d {dt} k{k} C{C} S{S}",
                                        got, ref)
                            n += 1
        self.say(f"dwconv1d phase: {n} cases agree bit for bit")

    # -- phase 9 -------------------------------------------------------------

    def lm_phase(self, seq: int = 8192, seed: int = 0):
        """h2o-danube-1.8b at full width through ``train_forward``, plain
        attention against the kernel, float32 then bfloat16. Returns
        ({dtype: {kernel?: forward ms}}, the layer count, the swattn
        launches of the phase)."""
        import dataclasses
        torch = self.torch
        from repro_torch.configs.base import SHAPES, RunConfig
        from repro_torch.configs.base import get_model_config
        from repro_torch.models import registry
        full = get_model_config("h2o_danube_1_8b")
        gen = torch.Generator(device="cuda").manual_seed(seed)
        tokens = torch.randint(0, full.vocab_size, (1, seq), generator=gen,
                               device="cuda")
        rc = RunConfig(model=full, shape=SHAPES["train_4k"])
        params = registry.build(rc, device="cuda").init_params(
            torch.Generator(device="cuda").manual_seed(seed))
        from repro_torch.models.module import tree_leaves
        nparams = sum(t.numel() for t in tree_leaves(params))
        self.say(f"LM phase: {full.name}, {nparams} parameters (float32), "
                 f"{full.num_layers} layers, d {full.d_model}, heads "
                 f"{full.num_heads}/{full.num_kv_heads}, hd "
                 f"{full.resolved_head_dim()}, window {full.attn_window}, "
                 f"1 x {seq} tokens")
        reset_counts()
        fwd_ms = {}
        for dt in ("float32", "bfloat16"):
            logits, ms = {}, {}
            for flag in (False, True):
                mc = dataclasses.replace(full, dtype=dt, use_pallas_attn=flag)
                bundle = registry.build(RunConfig(model=mc, shape=rc.shape),
                                        device="cuda")
                for rep in range(2):          # the second run is timed
                    before = read_counts()["swattn"]
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    out, _ = bundle.train_forward(params,
                                                  {"inputs": tokens})
                    torch.cuda.synchronize()
                    ms[flag] = (time.perf_counter() - t0) * 1e3
                    added = read_counts()["swattn"] - before
                    want = full.num_layers if flag else 0
                    if added != want:
                        raise AssertionError(f"LM {dt} kernel={flag}: "
                                             f"{added} swattn launches, "
                                             f"expected {want}")
                    if rep == 0:
                        logits[flag] = out
                    del out
            a, r = logits[True].float(), logits[False].float()
            if tuple(a.shape) != (1, seq, full.vocab_size):
                raise AssertionError(f"LM {dt}: logits {tuple(a.shape)}")
            if not (bool(torch.isfinite(a).all())
                    and bool(torch.isfinite(r).all())):
                raise AssertionError(f"LM {dt}: non-finite logits")
            max_abs = float((a - r).abs().max())
            scale = float(r.abs().max())
            rel_l2 = float((a - r).norm() / r.norm())
            ok = (max_abs <= LM_TOL[dt] * scale if dt == "float32"
                  else rel_l2 <= LM_TOL[dt])
            self.say(f"LM {dt}: kernel vs plain attention logits: max |Δ| "
                     f"{max_abs!r} (max |logit| {scale!r}, ratio "
                     f"{max_abs / scale!r}), relative L2 {rel_l2!r}; "
                     f"forward {ms[False]!r} ms plain, {ms[True]!r} ms "
                     f"kernel ({seq / (ms[True] * 1e-3)!r} tokens/s)")
            if not ok:
                raise AssertionError(f"LM {dt}: kernel and plain logits "
                                     f"disagree beyond {LM_TOL[dt]}")
            if dt == "bfloat16":
                self._lm_controls(bundle, params, tokens, r)
            fwd_ms[dt] = ms
            del logits, a, r
        launches = read_counts()
        self.profile("LM bf16 forward (kernel attention)",
                     lambda: bundle.train_forward(params, {"inputs": tokens}))
        if launches != {"filter2d_halo": 0, "swattn": 2 * 2 * full.num_layers,
                        "dwconv1d": 0}:
            raise AssertionError(f"LM phase: counts {launches}")
        del params
        torch.cuda.empty_cache()
        return fwd_ms, full.num_layers, launches["swattn"]

    def _lm_controls(self, bundle, params, tokens, plain_logits) -> None:
        """Upper readings of the bfloat16 logits check: the kernel forward
        with the attention output zeroed, and with the window ignored
        (full causal attention). Each must land beyond ``LM_TOL``, or the
        check could not tell such a kernel from a sound one."""
        torch = self.torch
        from repro_torch.models import transformer
        real = transformer.swattn_cuda
        faults = {
            "attention zeroed":
                lambda q, k, v, *, window, scale: torch.zeros_like(q),
            "window ignored":
                lambda q, k, v, *, window, scale: real(q, k, v, window=0,
                                                       scale=scale)}
        r, rel = plain_logits, {}
        try:
            with saved_counts():
                for name, fault in faults.items():
                    transformer.swattn_cuda = fault
                    out, _ = bundle.train_forward(params, {"inputs": tokens})
                    rel[name] = float((out.float() - r).norm() / r.norm())
                    del out
                    self.say(f"LM bfloat16 control, {name}: relative L2 "
                             f"{rel[name]!r} against plain attention (limit "
                             f"{LM_TOL['bfloat16']})")
        finally:
            transformer.swattn_cuda = real
        passed = [name for name, e in rel.items()
                  if not e > LM_TOL["bfloat16"]]
        if passed:
            raise AssertionError(f"LM bfloat16: the logits check passes a "
                                 f"kernel with the {' / '.join(passed)}")

    # -- phase 10 -------------------------------------------------------------

    def mamba_phase(self, batch: int = 2, seq: int = 4096, seed: int = 1):
        """One mamba block at hymba-1.5b width, bfloat16, the conv through
        the kernel and through the plain layer."""
        torch = self.torch
        from repro_torch.configs.base import get_model_config
        from repro_torch.models import module, ssm
        mc = get_model_config("hymba_1_5b")
        specs = ssm.mamba_specs(mc.d_model, expand=mc.ssm_expand,
                                heads=mc.mamba_heads, state=mc.ssm_state,
                                conv_width=mc.ssm_conv_width)
        gen = torch.Generator(device="cuda").manual_seed(seed)
        params = module.init_params(specs, gen)
        x = torch.randn((batch, seq, mc.d_model), generator=gen,
                        device="cuda").to(torch.bfloat16)
        reset_counts()
        out, ms = {}, {}
        for flag in (True, False):
            for rep in range(2):              # the second run is timed
                before = read_counts()["dwconv1d"]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out[flag], _ = ssm.mamba_block(x, params, mc,
                                               use_pallas_conv=flag)
                torch.cuda.synchronize()
                ms[flag] = (time.perf_counter() - t0) * 1e3
                if read_counts()["dwconv1d"] - before != int(flag):
                    raise AssertionError(f"mamba kernel={flag}: expected "
                                         f"{int(flag)} dwconv1d launch")
        launches = read_counts()
        if launches != {"filter2d_halo": 0, "swattn": 0, "dwconv1d": 2}:
            raise AssertionError(f"mamba phase: counts {launches}")
        # the kernel repeats the plain conv's roundings, so the blocks match
        self._equal(f"mamba block [{batch},{seq},{mc.d_model}] bf16",
                    out[True], out[False])
        self.say(f"mamba phase: d_in {mc.ssm_expand * mc.d_model}, "
                 f"{mc.mamba_heads} heads, state {mc.ssm_state}, conv "
                 f"{mc.ssm_conv_width}, [{batch},{seq}] bf16: kernel conv "
                 f"and plain conv blocks bit-exact; block {ms[True]!r} ms "
                 f"(kernel conv), {ms[False]!r} ms (plain conv); one "
                 "dwconv1d launch per kernel-conv block")
        self.profile("mamba block (kernel conv)", lambda: ssm.mamba_block(
            x, params, mc, use_pallas_conv=True))
        return launches["dwconv1d"]

    # -- phase 10b: LM serving ------------------------------------------------

    def _bundle(self, arch: str, batch: int, seq_len: int, **fields):
        import dataclasses
        from repro_torch.configs.base import SHAPES, RunConfig
        from repro_torch.configs.base import get_model_config
        from repro_torch.models import registry
        mc = dataclasses.replace(get_model_config(arch), **fields)
        shape = dataclasses.replace(SHAPES["prefill_32k"], seq_len=seq_len,
                                    global_batch=batch)
        return registry.build(RunConfig(model=mc, shape=shape),
                              device="cuda")

    def _serve(self, bundle, params, prompt, steps: int, feed=None,
               key: str = "inputs", more=None):
        """``prefill`` of ``prompt`` [B,P], then ``steps`` greedy
        ``decode_step`` calls (or the tokens of ``feed`` [B,steps], teacher
        forced). The prompt is the prefill batch's ``key``, beside the
        entries of ``more`` (whisper: ``dec_tokens`` beside ``frames``).
        Returns the logits of each row that made a token (the
        prefill's last, then each step's: [steps + 1, B, V]), the tokens
        fed [B, steps], the prefill's and each step's host ms (each call
        synchronised), the caches, and the swattn launches of the
        prefill."""
        torch = self.torch
        sw = counters()["swattn"]
        before = sw.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        last, caches = bundle.prefill(params, {key: prompt, **(more or {})})
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        prefill_launches = sw.launches - before
        M = bundle.cfg.model.num_meta_tokens
        P = prompt.shape[1]
        rows, fed, ms = [last], [], []
        for i in range(steps):
            tok = (rows[-1].argmax(-1) if feed is None else feed[:, i])
            fed.append(tok)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            before = sw.launches
            step, caches = bundle.decode_step(params, tok[:, None], caches,
                                              P + M + i)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            if sw.launches != before:
                raise AssertionError(f"decode step {i} launched swattn")
            rows.append(step)
        return (torch.stack(rows), torch.stack(fed, dim=1), prefill_ms, ms,
                caches, prefill_launches)

    def _oracle(self, bundle, params, prompt, fed, key: str = "inputs",
                more=None):
        """The teacher-forced ``train_forward`` over prompt + fed tokens
        (the batch's ``key``, beside ``more``): the logits at the rows
        ``_serve`` made tokens from, [steps+1,B,V]. A check, so its
        launches are not the main path's."""
        P = prompt.shape[1]
        with saved_counts():
            logits, _ = bundle.train_forward(
                params, {key: self.torch.cat([prompt, fed], dim=1),
                         **(more or {})})
            out = logits[:, P - 1:].transpose(0, 1).contiguous()
        del logits
        return out

    def _ring_layout(self, bundle, caches, end: int) -> list:
        """Where each stage's cache positions must sit after position
        ``end`` was written: a sink p < M at slot p, a ring position at M +
        (p - M) % (L - M), the last L - M positions live, every other slot
        empty. Returns the stages (index, layer count) that differ."""
        import numpy as np
        torch = self.torch
        M = bundle.cfg.model.num_meta_tokens
        bad = []
        for i, c in enumerate(caches):
            pos = (c["attn"] if "attn" in c else c)["pos"]
            L = pos.shape[1]
            want = np.full(L, -1, np.int32)
            for p in list(range(min(M, end + 1))) + list(
                    range(max(M, end + 1 - (L - M)), end + 1)):
                want[p if p < M else M + (p - M) % (L - M)] = p
            want = torch.from_numpy(want).to(pos.device)
            wrong = int((pos != want[None]).any(dim=1).sum())
            if wrong:
                bad.append((i, wrong))
        return bad

    def _decode_check(self, rows, oracle, truth=None):
        """Each row that made a token against the teacher-forced forward
        ``oracle`` (same dtype). float32 (``truth`` None): max |Δ| within
        1e-3 of max |logit|. bfloat16: ``truth`` is the float32 forward's
        rows on the same weights, and the decode may be no farther from it
        (relative L2) than the bf16 forward is plus ``LM_TOL`` — the bf16
        model's own rounding moves hymba-1.5b's logits 3-7% from float32,
        past any fixed limit between two bf16 paths. Either way the token
        must equal the forward's argmax wherever the forward's top-2 margin
        exceeds twice the row's max |Δ|. Returns (worst error against the
        limit, worst relative L2 between decode and forward, rows excluded
        by the margin rule, failed reasons, and the least and most relative
        L2 between the bf16 and float32 forwards over the rows)."""
        torch = self.torch
        dtype = "float32" if truth is None else "bfloat16"
        worst, worst_l2, excluded, fails, gap = 0.0, 0.0, 0, [], []

        def rel(a, b):
            return float((a - b).norm() / b.norm())
        for i in range(rows.shape[0]):
            g, r = rows[i].float(), oracle[i].float()
            if not bool(torch.isfinite(g).all()):
                fails.append(f"row {i}: non-finite logits")
                continue
            dmax = float((g - r).abs().max())
            worst_l2 = max(worst_l2, rel(g, r))
            if truth is None:
                err = dmax / float(r.abs().max())
            else:
                t = truth[i].float()
                gap.append(rel(r, t))
                err = rel(g, t) - gap[-1]
            worst = max(worst, err)
            if not err <= LM_TOL[dtype]:
                fails.append(f"row {i}: error {err!r} over {LM_TOL[dtype]}")
            top2 = r.topk(2, dim=-1).values
            sure = (top2[:, 0] - top2[:, 1]) > 2 * dmax
            excluded += int((~sure).sum())
            if bool((sure & (g.argmax(-1) != r.argmax(-1))).any()):
                fails.append(f"row {i}: a token differs from the forward's "
                             "argmax beyond the margin")
        return (worst, worst_l2, excluded, fails,
                (min(gap), max(gap)) if gap else None)

    def _serving_controls(self, bundle, params, prompt, fed, oracle, truth,
                          steps: int, faults=None) -> None:
        """The decode check must fail a decode with the cache write skipped
        (``write_cache`` returns its input), one with the ring slot off
        by one, and one under each of ``faults`` ({label: (module,
        attribute, replacement)}), fed the sound run's tokens for
        ``steps`` steps: the logits rules or the caches' slot layout."""
        from repro_torch.models import attention
        real_slot = attention.ring_slot

        def skipped(cache, *args, **kw):
            return cache

        def off_by_one(p, cache_len, sinks=0):
            if p < sinks:
                return p
            return sinks + (real_slot(p, cache_len, sinks) - sinks + 1) % (
                cache_len - sinks)
        faults = {"cache write skipped": (attention, "write_cache", skipped),
                  "ring slot off by one": (attention, "ring_slot",
                                           off_by_one), **(faults or {})}
        self._controls("LM serving", bundle, params, prompt, fed, oracle,
                       truth, steps, faults, ring=True)

    def _cache_bytes(self, caches) -> int:
        from repro_torch.models.module import tree_leaves
        return sum(t.numel() * t.element_size() for t in tree_leaves(caches))

    def _serve_model(self, arch: str, batch: int, prompt_len: int,
                     steps: int, seed: int, extra=None, faults=None,
                     **fields):
        """One model through prefill and greedy decode at full width in
        bfloat16 (weights drawn in bfloat16 from a seeded generator), held
        against the teacher-forced forward, with the controls (``faults``:
        more of them, as ``_serving_controls`` takes them). ``extra``
        runs more checks on the same weights and run; ``fields`` replace
        the config's (a depth cut, a capacity factor). A moe model's
        experts are scaled by ``_scale_experts``."""
        torch = self.torch
        bundle = self._bundle(arch, batch, prompt_len + steps,
                              use_pallas_attn=True, **fields)
        mc = bundle.cfg.model
        gen = torch.Generator(device="cuda").manual_seed(seed)
        params = bundle.init_params(gen, torch.bfloat16)
        self._scale_experts(params)
        prompt = torch.randint(0, mc.vocab_size, (batch, prompt_len),
                               generator=gen, device="cuda")
        M = mc.num_meta_tokens
        gated = 0 if M else mc.num_layers
        # the plain prefill (kernel gate off) against the kernel prefill
        plain = self._bundle(arch, batch, prompt_len + steps, **fields)
        with saved_counts():
            plain_last, plain_caches = plain.prefill(params,
                                                     {"inputs": prompt})
        del plain_caches
        bundle.prefill(params, {"inputs": prompt})  # warm-up: time the second
        rows, fed, prefill_ms, ms, caches, launches = self._serve(
            bundle, params, prompt, steps)
        self._agree_l2(f"LM serving {mc.name} prefill, kernel gate on vs off",
                       rows[0], plain_last)
        if launches != gated:
            raise AssertionError(f"LM serving {mc.name}: {launches} swattn "
                                 f"launches in prefill, expected {gated}")
        oracle = self._oracle(bundle, params, prompt, fed)
        truth = self._oracle(self._bundle(arch, batch, prompt_len + steps,
                                          **{**fields, "dtype": "float32",
                                             "use_pallas_attn": True}),
                             params, prompt, fed)
        worst, worst_l2, excluded, fails, gap = self._decode_check(
            rows, oracle, truth)
        bad = self._ring_layout(bundle, caches, prompt_len + M + steps - 1)
        if fails or bad:
            raise AssertionError(f"LM serving {mc.name}: {fails[:3]}, stages "
                                 f"off the slot layout {bad}")
        med, p90 = self._steps_summary(ms)
        self.say(f"LM serving {mc.name} ({mc.num_layers} layers): {batch} x "
                 f"{prompt_len} prompt "
                 f"(+{M} meta), {steps} greedy steps, bf16; prefill "
                 f"{prefill_ms!r} ms (the second call), "
                 f"{launches} swattn launches per prefill, 0 per step; "
                 f"decode step median {med!r} ms, p90 {p90!r} ms, "
                 f"{batch / (med * 1e-3)!r} tokens/s; cache "
                 f"{self._cache_bytes(caches)} B; against teacher forcing: "
                 f"worst relative L2 {worst_l2!r} to the bf16 forward, "
                 f"worst excess over the bf16 forward's distance from the "
                 f"float32 forward {worst!r} (limit {LM_TOL['bfloat16']}; "
                 f"the bf16 forward sits {gap[0]!r}..{gap[1]!r} from the "
                 f"float32 forward), "
                 f"{excluded} of {rows.shape[0] * batch} rows excluded by "
                 "the margin rule; every stage on its slot layout")
        end = prompt_len + M + steps
        tok = rows[-1].argmax(-1)[:, None]
        self.profile(f"LM serving {mc.name} decode step",
                     lambda: bundle.decode_step(params, tok, caches, end))
        del caches
        self._serving_controls(bundle, params, prompt, fed, oracle, truth,
                               min(steps, 8), faults)
        out = {"layers": mc.num_layers, "prefill_ms": prefill_ms,
               "step_ms_median": med,
               "step_ms_p90": p90, "tokens_per_s": batch / (med * 1e-3),
               "worst_rel_l2": worst_l2, "worst_excess": worst,
               "bf16_vs_float32_forward": gap,
               "excluded_rows": excluded}
        if extra is not None:
            out.update(extra(bundle, params, prompt, fed, rows))
        del params, oracle, truth
        torch.cuda.empty_cache()
        return out

    def _agree_l2(self, what: str, got, ref) -> float:
        g, r = got.float(), ref.float()
        if got.shape != ref.shape or not bool(self.torch.isfinite(g).all()):
            raise AssertionError(f"{what}: {tuple(got.shape)} vs "
                                 f"{tuple(ref.shape)} or non-finite")
        rel = float((g - r).norm() / r.norm())
        self.say(f"{what}: relative L2 {rel!r} (limit {LM_TOL['bfloat16']})")
        if not rel <= LM_TOL["bfloat16"]:
            raise AssertionError(f"{what}: relative L2 {rel} over "
                                 f"{LM_TOL['bfloat16']}")
        return rel

    def _danube_extra(self, bundle, params, prompt, fed, rows):
        """The int8-KV decode, fed the bf16 run's tokens, against the
        bf16-cache decode: max |Δ| / max |logit| < 0.05 (the reference's
        bar, tests/test_quantization.py)."""
        arch = "h2o_danube_1_8b"
        B, P = prompt.shape
        steps = fed.shape[1]
        q8 = self._bundle(arch, B, P + steps, use_pallas_attn=True,
                          kv_cache_dtype="int8")
        q_rows, *_, caches, _ = self._serve(q8, params, prompt, steps,
                                            feed=fed)
        g, r = q_rows.float(), rows.float()
        ratio = float((g - r).abs().max() / r.abs().max())
        self.say(f"LM serving {q8.cfg.model.name} int8 KV: max |Δ| / max "
                 f"|logit| {ratio!r} against the bf16 cache over "
                 f"{steps + 1} rows (limit 0.05); cache "
                 f"{self._cache_bytes(caches)} B")
        if not (bool(self.torch.isfinite(g).all()) and ratio < 0.05):
            raise AssertionError(f"LM serving int8 KV: {ratio} not < 0.05")
        return {"int8_ratio": ratio}

    def _float32_serving(self, arch="h2o_danube_1_8b", batch=1,
                         prompt_len=4608, steps=16, seed=3):
        """float32 (TF32 off): prefill and decode held to the teacher-forced
        forward within max |Δ| <= 1e-3 * max |logit|, every stage on its
        slot layout."""
        torch = self.torch
        bundle = self._bundle(arch, batch, prompt_len + steps, dtype="float32",
                              use_pallas_attn=True)
        mc = bundle.cfg.model
        gen = torch.Generator(device="cuda").manual_seed(seed)
        params = bundle.init_params(gen)
        prompt = torch.randint(0, mc.vocab_size, (batch, prompt_len),
                               generator=gen, device="cuda")
        rows, fed, _, ms, caches, launches = self._serve(bundle, params,
                                                         prompt, steps)
        M = mc.num_meta_tokens
        if launches != (0 if M else mc.num_layers):
            raise AssertionError(f"LM serving float32: {launches} swattn "
                                 "launches in prefill")
        oracle = self._oracle(bundle, params, prompt, fed)
        worst, _, excluded, fails, _ = self._decode_check(rows, oracle)
        bad = self._ring_layout(bundle, caches, prompt_len + M + steps - 1)
        self.say(f"LM serving {mc.name} float32 {batch} x {prompt_len} + "
                 f"{steps}: worst max |Δ| / max |logit| {worst!r} (limit "
                 f"{LM_TOL['float32']}), {excluded} rows excluded by the "
                 f"margin rule; decode step median "
                 f"{sorted(ms)[len(ms) // 2]!r} ms")
        if fails or bad:
            raise AssertionError(f"LM serving float32: {fails[:3]}, {bad}")
        del params, caches, oracle
        torch.cuda.empty_cache()
        return worst

    def lm_serving_phase(self, danube=(4, 6144, 64), hymba=(2, 2048, 32)):
        """h2o-danube-1.8b (ring eviction and wrap, the prefill through
        swattn, int8 KV, a float32 run) and hymba-1.5b (sink slots, mamba
        state) served at full width. Returns (per-model numbers, the swattn
        launches of the phase's prefills)."""
        reset_counts()
        out = {"h2o-danube-1.8b": self._serve_model(
            "h2o_danube_1_8b", *danube, seed=2, extra=self._danube_extra)}
        out["float32_worst"] = self._float32_serving()
        out["hymba-1.5b"] = self._serve_model("hymba_1_5b", *hymba, seed=4)
        out["hymba_float32_worst"] = self._float32_serving(
            "hymba_1_5b", prompt_len=2048, steps=8, seed=5)
        launches = read_counts()
        from repro_torch.configs.base import get_model_config
        # h2o-danube's kernel-gated prefills: bf16 (warm-up, served), int8
        # KV, float32; hymba's meta tokens bar the kernel
        want = 4 * get_model_config("h2o_danube_1_8b").num_layers
        if launches != {"filter2d_halo": 0, "swattn": want, "dwconv1d": 0}:
            raise AssertionError(f"LM serving phase: counts {launches}")
        return out, launches["swattn"]

    # -- phase 12: LM training ----------------------------------------------

    def _train_rc(self, mc, seq: int, batch: int, microbatch: int,
                  remat: str = "full"):
        import dataclasses
        from repro_torch.configs.base import SHAPES, RunConfig, TrainConfig
        shape = dataclasses.replace(SHAPES["train_4k"], seq_len=seq,
                                    global_batch=batch)
        return RunConfig(model=mc, shape=shape, train=TrainConfig(
            microbatch=microbatch, remat_policy=remat))

    def _tree_rel(self, got, want) -> float:
        """Relative L2 of two lists of matching tensors (``got`` moved to
        ``want``'s device), summed in float64 on the host."""
        torch = self.torch
        num = den = 0.0
        for a, b in zip(got, want, strict=True):
            b = b.float()
            num += float(torch.linalg.vector_norm(a.to(b.device).float()
                                                  - b)) ** 2
            den += float(torch.linalg.vector_norm(b)) ** 2
        return (num / den) ** 0.5

    def _one_step(self, rc, start, device: str, batch=None):
        """One ``train_step`` on ``device`` from a copy of the host weights
        ``start``: (metrics as floats, the parameters after, the clipped
        gradients, host ms of the synchronised step)."""
        torch = self.torch
        from repro_torch.data import make_train_batch
        from repro_torch.models import registry
        from repro_torch.models.module import tree_leaves, tree_map
        from repro_torch.optim import adamw_init
        from repro_torch.training import make_train_step
        bundle = registry.build(rc, device=device)
        params = tree_map(lambda t: t.to(device, copy=True), start)
        opt = adamw_init(params)
        batch = make_train_batch(rc, 0, device) if batch is None else batch
        if device == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, m = make_train_step(bundle, rc)(params, opt, batch)
        if device == "cuda":
            torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        leaves = tree_leaves(params)
        return ({k: float(v) for k, v in m.items()}, leaves,
                [p.grad for p in leaves], ms)

    def train_parity(self, mc, seq: int, batch: int, microbatch: int):
        """(a) one float32 train step on the card against the same step on
        the CPU, from the same weights and batch, with two controls that
        must fail the gradient check; (b) the remat policies' gradients on
        the card agree."""
        torch = self.torch
        from repro_torch.data import make_train_batch
        from repro_torch.models import registry
        from repro_torch.models.module import tree_leaves, tree_map
        from repro_torch.training import make_grad_fn
        if torch.backends.cuda.matmul.allow_tf32:
            raise AssertionError("training parity: TF32 must be off")
        rc = self._train_rc(mc, seq, batch, microbatch)
        start = tree_map(lambda t: t.cpu(), registry.build(
            rc, device="cuda").init_params(
                torch.Generator(device="cuda").manual_seed(0)))
        cpu_m, cpu_p, cpu_g, cpu_ms = self._one_step(rc, start, "cpu")
        card_m, card_p, card_g, card_ms = self._one_step(rc, start, "cuda")
        loss_rel = abs(card_m["loss"] - cpu_m["loss"]) / abs(cpu_m["loss"])
        g_rel = self._tree_rel(card_g, cpu_g)
        p_rel = self._tree_rel(card_p, cpu_p)
        moved = self._tree_rel(cpu_p, tree_leaves(start))
        self.say(f"LM training (a) float32 parity, {mc.name} {mc.num_layers} "
                 f"layers full width, [{batch},{seq}] microbatch "
                 f"{microbatch}: loss card {card_m['loss']!r} cpu "
                 f"{cpu_m['loss']!r} (relative {loss_rel!r}), grad norm "
                 f"{card_m['grad_norm']!r} / {cpu_m['grad_norm']!r}, clipped "
                 f"gradients relative L2 {g_rel!r}, updated parameters "
                 f"{p_rel!r} (the step moved them by {moved!r}); step "
                 f"{card_ms!r} ms card, {cpu_ms!r} ms cpu")
        if not (loss_rel <= TRAIN_F32_TOL and g_rel <= TRAIN_F32_TOL
                and p_rel <= TRAIN_F32_TOL):
            raise AssertionError(f"LM training parity beyond {TRAIN_F32_TOL}")
        b0 = make_train_batch(rc, 0, "cuda")
        mb = microbatch or batch
        controls = {
            "only the first microbatch accumulated":
                (self._train_rc(mc, seq, mb, mb),
                 {k: v[:mb] for k, v in b0.items()}),
            "labels unshifted":
                (rc, {"inputs": b0["inputs"], "labels": b0["inputs"]})}
        for name, (crc, cbatch) in controls.items():
            g = self._one_step(crc, start, "cuda", cbatch)[2]
            rel = self._tree_rel(g, cpu_g)
            self.say(f"LM training (a) control, {name}: clipped gradients "
                     f"relative L2 {rel!r} (limit {TRAIN_F32_TOL})")
            if not rel > TRAIN_F32_TOL:
                raise AssertionError(f"LM training: the parity check passes "
                                     f"a step with {name}")
        del card_p, card_g, cpu_p, cpu_g
        # (b) what backward keeps differs by policy, the gradients do not
        grads = {}
        for policy in ("none", "full", "dots"):
            prc = self._train_rc(mc, seq, batch, microbatch, remat=policy)
            params = tree_map(lambda t: t.to("cuda", copy=True), start)
            make_grad_fn(registry.build(prc, device="cuda"), prc)(params, b0)
            grads[policy] = [p.grad for p in tree_leaves(params)]
        rels = {p: self._tree_rel(grads[p], grads["none"])
                for p in ("full", "dots")}
        self.say(f"LM training (b) remat policies on the card, gradients "
                 f"relative L2 against 'none': {rels!r} (limit "
                 f"{TRAIN_REMAT_TOL})")
        if not all(r <= TRAIN_REMAT_TOL for r in rels.values()):
            raise AssertionError("LM training: remat policies disagree")
        return {"loss_rel": loss_rel, "grads_rel_l2": g_rel,
                "params_rel_l2": p_rel, "remat_rel_l2": rels}

    def train_full_width(self, mc, seq: int, batch: int, microbatch: int,
                         steps: int = 3):
        """(c) the published config at full width, bf16 compute on float32
        master weights and AdamW state: step 1's gradients against a
        float32 step on the same weights and batch (two controls must
        break that bar), then a warm-up step and ``steps`` timed ones."""
        import dataclasses
        import math
        import statistics
        torch = self.torch
        from repro_torch.data import make_train_batch
        from repro_torch.models import registry
        from repro_torch.models.module import tree_leaves
        from repro_torch.optim import adamw_init
        from repro_torch.training import make_grad_fn, make_train_step
        rc = self._train_rc(mc, seq, batch, microbatch)
        rc32 = rc.replace(model=dataclasses.replace(mc, dtype="float32"))
        bundle = registry.build(rc, device="cuda")
        params = bundle.init_params(
            torch.Generator(device="cuda").manual_seed(1))
        leaves = tree_leaves(params)
        nparams = sum(p.numel() for p in leaves)
        self.say(f"LM training (c) {mc.name}: {nparams} parameters "
                 f"(float32 master, AdamW m and v float32), {mc.dtype} "
                 f"compute, [{batch},{seq}] microbatch {microbatch}, remat "
                 f"{rc.train.remat_policy}; allocated with the parameters "
                 f"{torch.cuda.memory_allocated()} B")
        b0 = make_train_batch(rc, 0, "cuda")
        loss32, _ = make_grad_fn(registry.build(rc32, device="cuda"),
                                 rc32)(params, b0)
        g32 = [p.grad for p in leaves]
        grad_fn = make_grad_fn(bundle, rc)
        lossb, _ = grad_fn(params, b0)
        rel = self._tree_rel([p.grad for p in leaves], g32)
        # the nearer of (a)'s two faults (at full width: the labels
        # unshifted 0.48, one microbatch of two 1.0)
        grad_fn(params, {"inputs": b0["inputs"], "labels": b0["inputs"]})
        ctrl_rel = {"labels unshifted": self._tree_rel(
            [p.grad for p in leaves], g32)}
        for p in leaves:
            p.grad = None
        del g32
        self.say(f"LM training (c) step-1 gradients, bf16 against float32 "
                 f"on the same weights and batch: relative L2 {rel!r} "
                 f"(limit {TRAIN_BF16_TOL}); losses bf16 {float(lossb)!r}, "
                 f"float32 {float(loss32)!r}; controls {ctrl_rel!r}")
        if not rel <= TRAIN_BF16_TOL:
            raise AssertionError(f"LM training: bf16 gradients beyond "
                                 f"{TRAIN_BF16_TOL} of float32")
        passed = [n for n, r in ctrl_rel.items() if not r > TRAIN_BF16_TOL]
        if passed:
            raise AssertionError(f"LM training: the bf16 gradient check "
                                 f"passes {passed}")

        opt = adamw_init(params)
        step = make_train_step(bundle, rc)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        losses, ms = [], []
        for i in range(1 + steps):
            b = make_train_batch(rc, i, "cuda")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, opt, m = step(params, opt, b)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(m["loss"]))
        launches = read_counts()
        peak = torch.cuda.max_memory_allocated()
        if launches != {"filter2d_halo": 0, "swattn": 0, "dwconv1d": 0}:
            raise AssertionError(f"LM training: kernel launches {launches}")
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"LM training: losses {losses}")
        # at random init the logits are about N(0, d·std²) with the head's
        # std 1/sqrt(d): variance 1, so E[CE] = ln V + 1/2 (a 2-layer
        # float32 forward on the CPU reads 10.93 against 10.87)
        head_var = mc.d_model * (1 / math.sqrt(mc.d_model)) ** 2
        expect = math.log(mc.vocab_size) + head_var / 2
        if abs(losses[0] - expect) > 0.2:
            raise AssertionError(f"LM training: step 1 loss {losses[0]} is "
                                 f"not within 0.2 of ln V + 1/2 = {expect}")
        med = statistics.median(ms[1:])
        tokens = batch * seq
        # model FLOPs per token: 6 per weight of every product (the
        # embedding table is a lookup) plus attention's two products,
        # forward and backward (x3), over the keys each query attends
        n_mm = mc.param_count() - mc.vocab_size * mc.d_model
        keys = sum(min(i + 1, mc.attn_window or seq)
                   for i in range(seq)) / seq
        attn = (12 * mc.num_layers * mc.num_heads * mc.resolved_head_dim()
                * keys)
        flops_tok = 6 * n_mm + attn
        share = flops_tok * tokens / (med * 1e-3) / self.peak_ops["bfloat16"]
        self.say(f"LM training (c) steps: losses {losses!r} (step 1 "
                 f"expected {expect!r}); step ms "
                 f"{ms!r} (the first is the warm-up); median {med!r} ms, "
                 f"{tokens / (med * 1e-3)!r} tokens/s; peak allocated {peak} "
                 f"B; model FLOPs per token {flops_tok!r} (6 x {n_mm} + "
                 f"attention {attn!r}), {share!r} of the bf16 dense peak "
                 f"{self.peak_ops['bfloat16']!r}; kernel launches per step: "
                 f"swattn {launches['swattn']}, dwconv1d "
                 f"{launches['dwconv1d']}")
        self.profile("LM training step", lambda: step(
            params, opt, make_train_batch(rc, 0, "cuda")), warm=True)
        del params, opt, leaves, b0
        torch.cuda.empty_cache()
        return {"step_ms": ms, "median_step_ms": med,
                "tokens_per_s": tokens / (med * 1e-3), "losses": losses,
                "launches_per_step": launches["swattn"] + launches[
                    "dwconv1d"],
                "peak_allocated_bytes": peak, "model_flops_per_token":
                flops_tok, "bf16_peak_share": share, "bf16_vs_f32_rel_l2":
                rel, "controls_rel_l2": ctrl_rel, "parameters": nparams}

    def train_resume(self, mc, seq: int, batch: int, microbatch: int):
        """(d) ``train_loop`` on the card: 3 steps in one run against 2
        steps, a checkpoint, and step 3 resumed into fresh state."""
        import tempfile
        torch = self.torch
        from repro_torch.checkpoint import restore_checkpoint
        from repro_torch.models import registry
        from repro_torch.models.module import tree_leaves
        from repro_torch.optim import adamw_init
        from repro_torch.training.trainer import train_loop
        rc = self._train_rc(mc, seq, batch, microbatch)

        def quiet(*a):
            pass
        params = registry.build(rc, device="cuda").init_params(
            torch.Generator(device="cuda").manual_seed(rc.train.seed))
        whole = train_loop(rc, num_steps=3, device="cuda", log_every=0,
                           log_fn=quiet, params=params)  # in place
        with tempfile.TemporaryDirectory() as d:
            train_loop(rc, num_steps=2, device="cuda", ckpt_dir=d,
                       ckpt_every=2, log_every=0, log_fn=quiet)
            rest = train_loop(rc, num_steps=1, device="cuda", ckpt_dir=d,
                              ckpt_every=1, log_every=0, log_fn=quiet)
            state, saved = restore_checkpoint(
                d, {"params": params, "opt": adamw_init(params)})
        if (rest.resumed_from, rest.steps_run, saved) != (2, 1, 3):
            raise AssertionError(f"LM training resume: resumed from "
                                 f"{rest.resumed_from}, {rest.steps_run} "
                                 f"steps, last checkpoint {saved}")
        a, b = whole.final_metrics["loss"], rest.final_metrics["loss"]
        loss_rel = abs(b - a) / abs(a)
        p_rel = self._tree_rel(tree_leaves(state["params"]),
                               tree_leaves(params))
        self.say(f"LM training (d) resume on the card: step 3 loss "
                 f"{b!r} resumed, {a!r} uninterrupted (relative "
                 f"{loss_rel!r}); parameters after step 3 relative L2 "
                 f"{p_rel!r} (limit {TRAIN_F32_TOL})")
        if not (loss_rel <= TRAIN_F32_TOL and p_rel <= TRAIN_F32_TOL):
            raise AssertionError("LM training: the resumed step 3 differs")
        return {"loss_rel": loss_rel, "params_rel_l2": p_rel}

    def _start_launcher(self):
        """(e) ``python -m repro_torch.launch.train --tiny`` on the card,
        started as a subprocess (it overlaps (a) and (b), ahead of the
        timed steps). Returns (process, command, start time)."""
        env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
        cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
               "h2o_danube_1_8b", "--tiny", "--steps", "3"]
        return (subprocess.Popen(cmd, env=env, cwd=ROOT, text=True,
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE),
                cmd, time.perf_counter())

    def _finish_launcher(self, proc, cmd, t0) -> None:
        out, err = proc.communicate(timeout=300)
        last = (out.strip().splitlines() or [""])[-1]
        self.say(f"LM training (e) {' '.join(cmd[1:])}: exit "
                 f"{proc.returncode} {time.perf_counter() - t0:.1f} s after "
                 f"its start: {last}")
        if proc.returncode != 0 or not last.startswith("[train] done: 3"):
            raise AssertionError(f"LM training launcher: {err[-2000:]}")

    def train_phase(self, arch: str = "h2o_danube_1_8b", layers: int = 2,
                    parity=(512, 2, 1), full=(4096, 4, 2)):
        """(a)-(e) of the LM training path; ``parity`` and ``full`` are
        (sequence, global batch, microbatch)."""
        import dataclasses
        from repro_torch.configs.base import get_model_config
        published = get_model_config(arch)
        narrow = dataclasses.replace(published, num_layers=layers,
                                     dtype="float32")
        out, took = {}, {}
        t0 = time.perf_counter()
        proc, cmd, t_start = self._start_launcher()
        try:
            out["parity"] = self.train_parity(narrow, *parity)
            self._finish_launcher(proc, cmd, t_start)
        finally:
            if proc.poll() is None:          # a failure above: stop it
                proc.kill()
                proc.wait()
        took["parity_and_launcher"] = time.perf_counter() - t0
        for name, run in (("full_width", lambda: self.train_full_width(
                published, *full)), ("resume", lambda: self.train_resume(
                    narrow, *parity))):
            t0 = time.perf_counter()
            out[name] = run()
            took[name] = time.perf_counter() - t0
        self.say(f"LM training parts took (s): {took!r}")
        return out

    # -- phase 13: LM kinds ---------------------------------------------------

    def _scale_experts(self, params) -> None:
        """Draw the experts as the stage's dense MLP would be drawn, times
        ``EXPERT_GAIN``: each of ``wi``, ``wg``, ``wo`` of a moe stage is
        multiplied, in place, by EXPERT_GAIN · sqrt(E), taking the experts
        out of the spec's lecun fan-in (every leading dim: the stage's
        layers, the experts and the input, as the reference draws them).
        At the spec's std qwen3-moe's expert outputs are about 1e-6
        against embeddings of 0.02, and no check could see the MoE path."""
        import math
        for name, sp in params.items():
            if name.startswith("stage_") and "moe" in sp:
                for leaf in ("wi", "wg", "wo"):
                    t = sp["moe"][leaf]            # [layers, E, in, out]
                    t.mul_(EXPERT_GAIN * math.sqrt(t.shape[1]))

    def _free(self, label: str, phase: str = "LM kinds") -> None:
        """Drop what earlier work left cached and say what stays
        allocated."""
        import gc
        gc.collect()
        self.torch.cuda.empty_cache()
        self.say(f"{phase} {label}: {self.torch.cuda.memory_allocated()} B "
                 "allocated")

    def _run_part(self, phase: str, key: str, name: str, run, out: dict,
                  took: dict, failed: list) -> None:
        """Run one part of a phase into ``out[name]``; a failure is
        reported into ``failed`` (the phase raises it after every part has
        run) and what it left on the card is freed."""
        t0 = time.perf_counter()
        try:
            out[name] = run()
        except Exception as exc:          # raised by the phase
            import traceback
            traceback.print_exc()
            failed.append(f"({key}) {name}: {exc}")
            self._free(f"({key}) after a failure", phase)
        took[key] = time.perf_counter() - t0

    def _no_drops(self, arch: str) -> dict:
        """The capacity factor E / k: no assignment drops, so a decode
        step's routing group (the batch) and the teacher-forced forward's
        (a row) differ only in size."""
        from repro_torch.configs.base import get_model_config
        mc = get_model_config(arch)
        return {"capacity_factor": mc.num_experts / mc.num_experts_per_tok}

    def _unrenormalised(self):
        """A fault for the MoE serving controls: the top-k weights left as
        the softmax gave them (not renormalised over the k)."""
        torch = self.torch
        from repro_torch.models import moe
        real = moe.route

        def route(x, router_w, k):
            w, idx, aux = real(x, router_w, k)
            probs = torch.softmax(x.float() @ router_w.float(), dim=-1)
            return w * probs.gather(-1, idx).sum(-1, keepdim=True), idx, aux
        return {"top-k weights not renormalised": (moe, "route", route)}

    def moe_serving(self, qwen3=(2, 2048, 16), mixtral=(2, 6144, 32),
                    layers: int = 4):
        """(a) qwen3-moe-30b-a3b and mixtral-8x7b at full width, ``layers``
        layers, through ``_serve_model`` at the capacity factor E / k."""
        out = {}
        for arch, shape, seed in (("qwen3_moe_30b_a3b", qwen3, 11),
                                  ("mixtral_8x7b", mixtral, 12)):
            out[arch] = self._serve_model(
                arch, *shape, seed=seed, faults=self._unrenormalised(),
                num_layers=layers, **self._no_drops(arch))
            self._free(f"(a) after {arch}")
        return out

    def qwen3_published(self, batch: int = 2, prompt_len: int = 4096,
                        steps: int = 32, seed: int = 13):
        """(b) qwen3-moe-30b-a3b as published (48 layers, capacity factor
        1.25) served whole: bf16 weights drawn in bf16 (the init's peak
        must stay under 70 GB), the gated prefill against the plain one
        (relative L2 within ``LM_TOL``; the attention zeroed must fail
        it), greedy decode, drops, the decode step's byte bound."""
        import statistics
        torch = self.torch
        from repro_torch.models import moe, transformer
        from repro_torch.models.module import tree_leaves
        arch = "qwen3_moe_30b_a3b"
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        bundle = self._bundle(arch, batch, prompt_len + steps,
                              use_pallas_attn=True)
        mc = bundle.cfg.model
        gen = torch.Generator(device="cuda").manual_seed(seed)
        params = bundle.init_params(gen, torch.bfloat16)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        init_peak = torch.cuda.max_memory_allocated()
        self._scale_experts(params)
        weights = sum(t.numel() * t.element_size()
                      for t in tree_leaves(params))
        self.say(f"LM kinds (b) {mc.name}: {mc.num_layers} layers, "
                 f"{sum(t.numel() for t in tree_leaves(params))} parameters, "
                 f"{weights} B of bf16 weights drawn in {init_s!r} s, peak "
                 f"allocated during init {init_peak} B (limit 70e9)")
        if not init_peak < 70e9:
            raise AssertionError(f"qwen3 init peak {init_peak} B")
        prompt = torch.randint(0, mc.vocab_size, (batch, prompt_len),
                               generator=gen, device="cuda")
        plain = self._bundle(arch, batch, prompt_len + steps)
        # the routing of the plain and the gated prefill (the warm-up),
        # layer by layer, to count the choices that bf16 rounding flips
        real_route = moe.route
        routes = {"plain": [], "gated": []}

        def recording(key):
            def route(x, router_w, k):
                w, idx, aux = real_route(x, router_w, k)
                routes[key].append(idx.sort(dim=-1).values)
                return w, idx, aux
            return route
        try:
            moe.route = recording("plain")
            with saved_counts():
                plain_last, plain_caches = plain.prefill(params,
                                                         {"inputs": prompt})
            del plain_caches
            moe.route = recording("gated")
            bundle.prefill(params, {"inputs": prompt})  # warm-up
        finally:
            moe.route = real_route
        flips = [int((a != b).any(-1).sum())
                 for a, b in zip(routes["plain"], routes["gated"])]
        last_flips = [int((a[:, -1] != b[:, -1]).any(-1).sum())
                      for a, b in zip(routes["plain"], routes["gated"])]
        del routes
        rows, fed, prefill_ms, ms, caches, launches = self._serve(
            bundle, params, prompt, steps)
        if launches != mc.num_layers:
            raise AssertionError(f"{mc.name}: {launches} swattn launches in "
                                 f"prefill, expected {mc.num_layers}")
        g, r = rows[0].float(), plain_last.float()
        rel = float((g - r).norm() / r.norm())
        self.say(f"LM kinds (b) {mc.name} prefill, kernel gate on vs off: "
                 f"relative L2 {rel!r} (limit {LM_TOL['bfloat16']}); tokens "
                 f"whose top-{mc.num_experts_per_tok} set differs between "
                 f"the two routes, per layer, of {batch * prompt_len}: "
                 f"{flips} (at the last position, of {batch}: "
                 f"{last_flips})")
        if not (bool(torch.isfinite(rows).all())
                and rel <= LM_TOL["bfloat16"]):
            raise AssertionError(f"{mc.name}: gated prefill relative L2 {rel} "
                                 f"over {LM_TOL['bfloat16']}, or non-finite "
                                 "logits")
        # the control: the gate check must fail a prefill whose attention
        # output is zeroed
        real = transformer.swattn_cuda
        transformer.swattn_cuda = (
            lambda q, k, v, *, window, scale: torch.zeros_like(q))
        try:
            with saved_counts():
                bad, bad_caches = bundle.prefill(params, {"inputs": prompt})
        finally:
            transformer.swattn_cuda = real
        del bad_caches
        bad_rel = float((bad.float() - plain_last.float()).norm()
                        / plain_last.float().norm())
        self.say(f"LM kinds (b) control, attention zeroed: relative L2 "
                 f"{bad_rel!r} against the plain prefill (limit "
                 f"{LM_TOL['bfloat16']})")
        if not bad_rel > LM_TOL["bfloat16"]:
            raise AssertionError("qwen3: the gate check passes a prefill with "
                                 "the attention zeroed")
        # the share of assignments the prefill drops, per layer
        real_dispatch = moe.dispatch_indices
        drops = []

        def counting(top_i, num_experts, cap, T):
            slot, keep = real_dispatch(top_i, num_experts, cap, T)
            drops.append((int((~keep).sum()), keep.numel(), cap))
            return slot, keep
        moe.dispatch_indices = counting
        try:
            with saved_counts():
                _, drop_caches = bundle.prefill(params, {"inputs": prompt})
        finally:
            moe.dispatch_indices = real_dispatch
        del drop_caches
        dropped = sum(d for d, _, _ in drops)
        assigned = sum(n for _, n, _ in drops)
        med = statistics.median(ms)
        p90 = sorted(ms)[min(len(ms) - 1, int(0.9 * len(ms)))]
        cache_b = self._cache_bytes(caches)
        # a decode step reads every weight but the embedding table (one row
        # a token) and the whole cache: the reference's expert products
        # run over all E experts' weights
        step_bytes = (weights - params["embed"]["table"].numel() * 2
                      + cache_b)
        bound_ms = step_bytes / self.hbm_bw * 1e3
        peak = torch.cuda.max_memory_allocated()
        self.say(f"LM kinds (b) {mc.name} as published: {batch} x "
                 f"{prompt_len} prompt, {steps} greedy steps, capacity "
                 f"factor {mc.capacity_factor}; prefill {prefill_ms!r} ms "
                 f"(the second call), {launches} swattn launches per prefill; "
                 f"decode step median {med!r} ms, p90 {p90!r} ms, "
                 f"{batch / (med * 1e-3)!r} tokens/s; a step reads "
                 f"{step_bytes} B (weights but the embedding table, and the "
                 f"cache): bound {bound_ms!r} ms at {self.hbm_bw:.3g} B/s; "
                 f"cache {cache_b} B; peak allocated {peak} B; the prefill "
                 f"drops {dropped} of {assigned} assignments "
                 f"({dropped / assigned!r}; per layer "
                 f"{[d for d, _, _ in drops]}, capacity {drops[0][2]})")
        end = prompt_len + steps
        tok = rows[-1].argmax(-1)[:, None]
        self.profile(f"LM kinds (b) {mc.name} decode step",
                     lambda: bundle.decode_step(params, tok, caches, end))
        del params, caches, rows, plain_last, bad
        self._free("(b) after qwen3 as published")
        return {"layers": mc.num_layers, "init_s": init_s,
                "init_peak_bytes": init_peak, "weight_bytes": weights,
                "prefill_ms": prefill_ms, "gate_rel_l2": rel,
                "route_flips": flips, "last_route_flips": last_flips,
                "control_rel_l2": bad_rel, "step_ms_median": med,
                "step_ms_p90": p90, "tokens_per_s": batch / (med * 1e-3),
                "step_bytes": step_bytes, "step_bound_ms": bound_ms,
                "cache_bytes": cache_b, "peak_bytes": peak,
                "dropped": dropped, "assignments": assigned}

    def kinds_forward(self, arch: str, layers: int = 2, seq: int = 4096,
                      seed: int = 14):
        """(d) ``train_forward`` at full width and ``layers`` layers, the
        kernel gate on against off, float32 (TF32 off: max |Δ| within
        ``LM_TOL`` of max |logit|) and bf16 (relative L2 within
        ``LM_TOL``); the attention zeroed must fail each. Returns (the
        errors, the swattn launches)."""
        torch = self.torch
        from repro_torch.models import transformer
        gen = torch.Generator(device="cuda").manual_seed(seed)
        base = self._bundle(arch, 1, seq, num_layers=layers)
        mc = base.cfg.model
        params = base.init_params(gen, torch.bfloat16)
        if mc.embeddings_in:
            # at the embedding table's std (0.02), as a token's row would
            # be: at unit std the inputs drown the attention's output
            inputs = 0.02 * torch.randn((1, seq, mc.d_model), generator=gen,
                                        device="cuda")
        else:
            inputs = torch.randint(0, mc.vocab_size, (1, seq),
                                   generator=gen, device="cuda")
        real = transformer.swattn_cuda
        out, launches = {}, 0
        for dt in ("float32", "bfloat16"):
            logits = {}
            for flag in (False, True):
                b = self._bundle(arch, 1, seq, num_layers=layers, dtype=dt,
                                 use_pallas_attn=flag)
                before = read_counts()["swattn"]
                logits[flag], _ = b.train_forward(params, {"inputs": inputs})
                added = read_counts()["swattn"] - before
                if added != (layers if flag else 0):
                    raise AssertionError(f"{mc.name} {dt} gate {flag}: "
                                         f"{added} swattn launches")
                launches += added
            transformer.swattn_cuda = (
                lambda q, k, v, *, window, scale: torch.zeros_like(q))
            try:
                with saved_counts():
                    bad, _ = b.train_forward(params, {"inputs": inputs})
            finally:
                transformer.swattn_cuda = real
            r = logits[False].float()
            errs = {}
            for name, got in (("kernel", logits[True]), ("attention zeroed",
                                                         bad)):
                g = got.float()
                if not bool(torch.isfinite(g).all()):
                    raise AssertionError(f"{mc.name} {dt}: non-finite")
                errs[name] = (float((g - r).abs().max() / r.abs().max())
                              if dt == "float32"
                              else float((g - r).norm() / r.norm()))
            rule = ("max |Δ| / max |logit|" if dt == "float32"
                    else "relative L2")
            self.say(f"LM kinds (d) {mc.name} {layers} layers, [1,{seq}] "
                     f"{'embeddings' if mc.embeddings_in else 'tokens'}, "
                     f"{dt}: kernel gate on vs off {rule} "
                     f"{errs['kernel']!r}, control (attention zeroed) "
                     f"{errs['attention zeroed']!r} (limit {LM_TOL[dt]})")
            if not errs["kernel"] <= LM_TOL[dt]:
                raise AssertionError(f"{mc.name} {dt}: kernel and plain "
                                     f"logits disagree beyond {LM_TOL[dt]}")
            if not errs["attention zeroed"] > LM_TOL[dt]:
                raise AssertionError(f"{mc.name} {dt}: the check passes the "
                                     "attention zeroed")
            out[dt] = errs
            del logits, bad, r
        del params
        self._free(f"(d) after {mc.name}")
        return out, launches

    def moe_train_parity(self, arch: str = "qwen3_moe_30b_a3b",
                         layers: int = 1, seq: int = 256, batch: int = 2,
                         microbatch: int = 1):
        """(e) one float32 ``moe`` train step on the card against the same
        step on the CPU (phase 12 (a)'s limits, the aux loss held to the
        loss's), with two controls that must fail it: the aux loss dropped
        from the total, and one microbatch only."""
        import dataclasses
        torch = self.torch
        from repro_torch.configs.base import get_model_config
        from repro_torch.data import make_train_batch
        from repro_torch.models import moe, registry
        from repro_torch.models.module import tree_map
        mc = dataclasses.replace(get_model_config(arch), num_layers=layers,
                                 dtype="float32")
        rc = self._train_rc(mc, seq, batch, microbatch)
        start = registry.build(rc, device="cuda").init_params(
            torch.Generator(device="cuda").manual_seed(0))
        self._scale_experts(start)
        start = tree_map(lambda t: t.cpu(), start)
        reset_counts()
        cpu_m, cpu_p, cpu_g, cpu_ms = self._one_step(rc, start, "cpu")
        card_m, card_p, card_g, card_ms = self._one_step(rc, start, "cuda")
        launches = read_counts()
        if launches != {"filter2d_halo": 0, "swattn": 0, "dwconv1d": 0}:
            raise AssertionError(f"moe training: kernel launches {launches}")

        def rel(a, b):
            return abs(a - b) / abs(b)
        checks = {"loss": rel(card_m["loss"], cpu_m["loss"]),
                  "aux": rel(card_m["aux_loss"], cpu_m["aux_loss"]),
                  "gradients": self._tree_rel(card_g, cpu_g),
                  "parameters": self._tree_rel(card_p, cpu_p)}
        self.say(f"LM kinds (e) {mc.name} {layers} layer float32 train step, "
                 f"[{batch},{seq}] microbatch {microbatch}: loss card "
                 f"{card_m['loss']!r} cpu {cpu_m['loss']!r}, aux card "
                 f"{card_m['aux_loss']!r} cpu {cpu_m['aux_loss']!r}; "
                 f"relative {checks!r} (limit {TRAIN_F32_TOL}); step "
                 f"{card_ms!r} ms card, {cpu_ms!r} ms cpu; no kernel launch")
        if not all(v <= TRAIN_F32_TOL for v in checks.values()):
            raise AssertionError(f"moe training parity beyond "
                                 f"{TRAIN_F32_TOL}: {checks}")
        real = moe.moe_block

        def no_aux(*a, **kw):
            y, aux = real(*a, **kw)
            return y, aux * 0
        b0 = make_train_batch(rc, 0, "cuda")
        controls = {}
        moe.moe_block = no_aux
        try:
            m, p_, g, _ = self._one_step(rc, start, "cuda")
        finally:
            moe.moe_block = real
        controls["aux dropped from the total"] = max(
            rel(m["loss"], cpu_m["loss"]), self._tree_rel(g, cpu_g))
        m, p_, g, _ = self._one_step(
            self._train_rc(mc, seq, microbatch, microbatch), start, "cuda",
            {k: v[:microbatch] for k, v in b0.items()})
        controls["one microbatch only"] = max(
            rel(m["loss"], cpu_m["loss"]), self._tree_rel(g, cpu_g))
        self.say(f"LM kinds (e) controls: worst of loss and gradients "
                 f"relative {controls!r} (limit {TRAIN_F32_TOL})")
        passed = [n for n, v in controls.items() if not v > TRAIN_F32_TOL]
        if passed:
            raise AssertionError(f"moe training: the parity check passes "
                                 f"{passed}")
        del start, cpu_p, cpu_g, card_p, card_g, p_, g
        self._free("(e) after the train step")
        return {**checks, "controls": controls, "card_ms": card_ms,
                "cpu_ms": cpu_ms}

    def lm_kinds_phase(self):
        """Phase 13: the moe kind, gemma3 (swattn at hd 256), qwen2-vl
        (M-RoPE) and codeqwen at full width on the card. Returns (per-part
        results, the swattn launches of the phase's main path)."""
        from repro_torch.configs.base import get_model_config
        self._free("start")
        reset_counts()
        out, took, failed = {}, {}, []
        fwd = {}

        def part(key, name, run):
            self._run_part("LM kinds", key, name, run, out, took, failed)
        part("a", "moe_serving", self.moe_serving)
        part("b", "qwen3_published", self.qwen3_published)

        def gemma3():
            r = self._serve_model("gemma3_4b", 2, 4096, 32, seed=15)
            self._free("(c) after gemma3-4b")
            return r
        part("c", "gemma3", gemma3)
        for arch in ("qwen2_vl_7b", "codeqwen15_7b"):
            part("d", arch, lambda a=arch: fwd.setdefault(
                a, self.kinds_forward(a))[0])
        fwd_launches = sum(n for _, n in fwd.values())
        launches = read_counts()
        # two gated prefills (warm-up, served) per layer of each served
        # model, one gated forward per dtype and layer in (d)
        if not failed:
            served = [out["moe_serving"][a]["layers"] for a in
                      ("qwen3_moe_30b_a3b", "mixtral_8x7b")] + [
                out["qwen3_published"]["layers"], out["gemma3"]["layers"]]
            want = 2 * sum(served) + fwd_launches
            if served[2:] != [get_model_config(a).num_layers for a in (
                    "qwen3_moe_30b_a3b", "gemma3_4b")] \
                    or fwd_launches != 2 * 2 * 2 or launches != {
                        "filter2d_halo": 0, "swattn": want, "dwconv1d": 0}:
                failed.append(f"counts {launches}, expected {want} swattn "
                              f"(layers {served}, (d) {fwd_launches})")
        part("e", "moe_training", self.moe_train_parity)
        self.say(f"LM kinds parts took (s): {took!r}")
        if failed:
            raise AssertionError("LM kinds phase: " + "; ".join(failed))
        return out, launches["swattn"]

    # -- phase 14: LM recurrent kinds and enc-dec ----------------------------

    def _launch_count(self, fn):
        """One call of ``fn`` under ``torch.profiler``: (the device
        operations it launched, their device ms, the call's wall ms)."""
        rows, wall_ms = self._profiled(fn)
        return (sum(n for _, n, _ in rows), sum(ms for ms, _, _ in rows),
                wall_ms)

    def _controls(self, phase: str, bundle, params, prompt, fed, oracle,
                  truth, steps: int, faults: dict, key: str = "inputs",
                  more=None, ring: bool = False) -> dict:
        """The decode check must fail a decode under each of ``faults``
        ({label: (module, attribute, replacement)}), fed the sound run's
        tokens for ``steps`` steps: the logits rules, or with ``ring`` the
        caches' slot layout (``_ring_layout``). Returns each control's
        worst error."""
        name = bundle.cfg.model.name
        P = prompt.shape[1]
        M = bundle.cfg.model.num_meta_tokens
        out, passed = {}, []
        with saved_counts():
            for label, (module, attr, fault) in faults.items():
                real = getattr(module, attr)
                setattr(module, attr, fault)
                try:
                    rows, *_, caches, _ = self._serve(
                        bundle, params, prompt, steps, feed=fed[:, :steps],
                        key=key, more=more)
                finally:
                    setattr(module, attr, real)
                worst, worst_l2, _, fails, _ = self._decode_check(
                    rows, oracle[:steps + 1], truth[:steps + 1])
                bad = (self._ring_layout(bundle, caches, P + M + steps - 1)
                       if ring else [])
                self.say(f"{phase} {name} control, {label}: worst "
                         f"error {worst!r} (limit {LM_TOL['bfloat16']}), "
                         f"relative L2 to the forward {worst_l2!r}, "
                         f"{len(fails)} of {steps + 1} rows fail the logits "
                         "rules" + (f", stages off the slot layout (stage, "
                                    f"layers) {bad}" if ring else ""))
                out[label] = worst
                if not fails and not bad:
                    passed.append(label)
                del caches, rows
        if passed:
            raise AssertionError(f"{phase} {name}: the decode check passes "
                                 f"a decode with the {' / '.join(passed)}")
        return out

    def _conv_at_own_fan_in(self, params) -> None:
        """Scale each xLSTM block's depthwise conv ([layers, C, k] in a
        stage) to its own fan-in, the k taps: the spec's lecun std takes
        every leading dim (layers x channels), 1/sqrt(7 x 2048) for the
        first mLSTM stage, and the conv's output is then about 0.02: the
        mLSTM's q and k vanish, its block output is set by the norm's
        eps, and resetting the memory every step moves xlstm-350m's
        logits by 0.3% (a CPU reading at 8 layers), under any limit. At
        the taps' fan-in the same reset moves them by 80%."""
        import math
        for name, sp in params.items():
            for kind in ("mlstm", "slstm"):
                if name.startswith("stage_") and kind in sp:
                    w = sp[kind]["conv"]["w"]
                    w.mul_(math.sqrt(w.shape[0] * w.shape[1] / w.shape[2]))

    def _steps_summary(self, ms) -> tuple:
        """(median, p90) of the steps' ms."""
        ms_sorted = sorted(ms)
        return (ms_sorted[len(ms) // 2],
                ms_sorted[min(len(ms) - 1, int(0.9 * len(ms)))])

    def xlstm_published(self, batch: int = 4, prompt_len: int = 2048,
                        steps: int = 64, seed: int = 21):
        """(a) xlstm-350m as published (24 layers: 21 mLSTM, 3 sLSTM),
        bf16 weights drawn on the card: prefill and greedy decode, each
        row held to the teacher-forced forward (``_decode_check``), the
        mLSTM memory and the sLSTM state reset every step as controls;
        the sLSTM loop's launches per time step and its share of the
        prefill, the decode step's launches and bytes bound."""
        torch = self.torch
        from repro_torch.models import xlstm
        from repro_torch.models.module import tree_leaves
        arch = "xlstm_350m"
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        bundle = self._bundle(arch, batch, prompt_len + steps)
        mc = bundle.cfg.model
        gen = torch.Generator(device="cuda").manual_seed(seed)
        params = bundle.init_params(gen, torch.bfloat16)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        init_peak = torch.cuda.max_memory_allocated()
        self._conv_at_own_fan_in(params)
        weights = sum(t.numel() * t.element_size()
                      for t in tree_leaves(params))
        prompt = torch.randint(0, mc.vocab_size, (batch, prompt_len),
                               generator=gen, device="cuda")
        # the warm-up prefill, with each sLSTM scan timed (synchronised)
        real_scan = xlstm.slstm_scan
        loop_ms = []

        def timed_scan(*a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = real_scan(*a, **kw)
            torch.cuda.synchronize()
            loop_ms.append((time.perf_counter() - t) * 1e3)
            return out
        xlstm.slstm_scan = timed_scan
        try:
            torch.cuda.synchronize()
            t = time.perf_counter()
            bundle.prefill(params, {"inputs": prompt})
            torch.cuda.synchronize()
            warm_ms = (time.perf_counter() - t) * 1e3
        finally:
            xlstm.slstm_scan = real_scan
        rows, fed, prefill_ms, ms, caches, _ = self._serve(
            bundle, params, prompt, steps)
        oracle = self._oracle(bundle, params, prompt, fed)
        truth = self._oracle(self._bundle(arch, batch, prompt_len + steps,
                                          dtype="float32"),
                             params, prompt, fed)
        worst, worst_l2, excluded, fails, gap = self._decode_check(
            rows, oracle, truth)
        if fails:
            raise AssertionError(f"LM recurrent {mc.name}: {fails[:3]}")
        state_b = self._cache_bytes(caches)
        # a step reads every weight (the tied head reads the whole table)
        # and reads and writes every state (the [B, 4, 512, 512] float32
        # mLSTM memories)
        step_bytes = weights + 2 * state_b
        bound_ms = step_bytes / self.hbm_bw * 1e3
        med, p90 = self._steps_summary(ms)
        end = prompt_len + steps
        tok = rows[-1].argmax(-1)[:, None]
        step_launches, step_busy, step_wall = self._launch_count(
            lambda: bundle.decode_step(params, tok, caches, end))
        # launches per sLSTM time step: two scans at the published width,
        # 16 and 48 steps, of the first sLSTM layer's weights
        sp = params["stage_1"]["slstm"]
        g = torch.randn((batch, 48, 4 * mc.d_model), generator=gen,
                        device="cuda", dtype=torch.bfloat16)
        n16, _, _ = self._launch_count(lambda: xlstm.slstm_scan(
            g[:, :16], sp["r"][0], sp["b"][0], mc.num_heads))
        n48, busy48, wall48 = self._launch_count(lambda: xlstm.slstm_scan(
            g, sp["r"][0], sp["b"][0], mc.num_heads))
        per_step = (n48 - n16) / 32
        loop_share = sum(loop_ms) / warm_ms
        from repro_torch.models import transformer
        kinds = [st.kind for st in transformer.make_stages(mc)
                 for _ in range(st.count)]
        self.say(f"LM recurrent (a) {mc.name} as published ({mc.num_layers} "
                 f"layers: {kinds.count('mlstm')} mLSTM, "
                 f"{kinds.count('slstm')} sLSTM): {weights} B of bf16 weights "
                 f"drawn in {init_s!r} s, init peak {init_peak} B; {batch} x "
                 f"{prompt_len} prompt, {steps} greedy steps: prefill "
                 f"{prefill_ms!r} ms (the second call); decode step median "
                 f"{med!r} ms, p90 {p90!r} ms, {batch / (med * 1e-3)!r} "
                 f"tokens/s; state {state_b} B; a step launches "
                 f"{step_launches} device operations ({step_busy!r} ms busy "
                 f"of {step_wall!r} ms profiled) and reads {step_bytes} B "
                 f"(weights, and every state read and written): bound "
                 f"{bound_ms!r} ms at {self.hbm_bw:.3g} B/s; against teacher "
                 f"forcing: worst relative L2 {worst_l2!r}, worst excess "
                 f"{worst!r} (limit {LM_TOL['bfloat16']}; the bf16 forward "
                 f"sits {gap[0]!r}..{gap[1]!r} from float32), {excluded} of "
                 f"{rows.shape[0] * batch} rows excluded by the margin rule")
        self.say(f"LM recurrent (a) {mc.name} sLSTM loop: {per_step!r} "
                 f"launches per time step ({n16} in 16 steps, {n48} in 48); "
                 f"the warm-up prefill ({warm_ms!r} ms) spent {sum(loop_ms)!r}"
                 f" ms in its {len(loop_ms)} sLSTM scans ({loop_share!r} of "
                 f"it); in a 48-step scan the device is busy {busy48!r} of "
                 f"{wall48!r} ms")
        self.profile(f"LM recurrent (a) {mc.name} prefill 1 x 256",
                     lambda: bundle.prefill(params,
                                            {"inputs": prompt[:1, :256]}))
        del caches
        real_step = xlstm._mlstm_step
        faults = {
            "mLSTM memory reset every step": (
                xlstm, "_mlstm_step",
                lambda q, k, v, i_g, f_g, state: real_step(
                    q, k, v, i_g, f_g, xlstm._mlstm_zero(*q.shape, q.device))),
            "sLSTM state reset every step": (
                xlstm, "slstm_scan",
                lambda g_, r, b, heads, state=None: real_scan(
                    g_, r, b, heads, None if g_.shape[1] == 1 else state))}
        controls = self._controls("LM recurrent", bundle, params, prompt,
                                  fed, oracle, truth, min(steps, 8), faults)
        peak = torch.cuda.max_memory_allocated()
        del params, oracle, truth, rows
        self._free("(a) after xlstm-350m", "LM recurrent")
        return {"layers": mc.num_layers, "init_s": init_s,
                "init_peak_bytes": init_peak, "weight_bytes": weights,
                "prefill_ms": prefill_ms, "step_ms_median": med,
                "step_ms_p90": p90, "tokens_per_s": batch / (med * 1e-3),
                "state_bytes": state_b, "step_launches": step_launches,
                "step_bytes": step_bytes, "step_bound_ms": bound_ms,
                "slstm_launches_per_step": per_step,
                "slstm_prefill_share": loop_share,
                "slstm_loop_busy_share": busy48 / wall48,
                "worst_rel_l2": worst_l2, "worst_excess": worst,
                "bf16_vs_float32_forward": gap, "excluded_rows": excluded,
                "controls": controls, "peak_bytes": peak}

    def _stream_frames(self, gen, batch: int, n: int, d: int):
        """[batch, n, d] float32 frame embeddings: each stream's own
        offset (a vector per stream, as each recording has its own mean
        features) plus noise per frame. Random attention weighs the
        frames almost evenly, so without the offset every stream's cross
        attention would read nearly the same mean, and a decode reading
        another stream's cross cache could not be told apart."""
        torch = self.torch
        return (torch.randn((batch, 1, d), generator=gen, device="cuda")
                + torch.randn((batch, n, d), generator=gen, device="cuda"))

    def whisper_published(self, batch: int = 4, frames: int = 1500,
                          prompt_len: int = 4, steps: int = 64,
                          seed: int = 22):
        """(b) whisper-large-v3 as published (32 + 32 layers, d 1280),
        bf16 weights drawn on the card: ``frames`` frame embeddings a
        stream (the 30-s window after the stubbed conv frontend), a
        ``prompt_len``-token decoder prompt and greedy decode, each row
        held to ``train_forward`` over prompt + fed tokens; the encoder
        runs once a request; controls: the cross K/V zeroed, and rolled
        by one batch row."""
        torch = self.torch
        from repro_torch.models import whisper
        from repro_torch.models.module import tree_leaves
        arch = "whisper_large_v3"
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        bundle = self._bundle(arch, batch, frames)
        mc = bundle.cfg.model
        gen = torch.Generator(device="cuda").manual_seed(seed)
        params = bundle.init_params(gen, torch.bfloat16)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        init_peak = torch.cuda.max_memory_allocated()
        weights = sum(t.numel() * t.element_size()
                      for t in tree_leaves(params))
        enc_weights = sum(t.numel() * t.element_size() for t in tree_leaves(
            [params["encoder"], params["enc_ln"]]))
        more = {"frames": self._stream_frames(gen, batch, frames,
                                              mc.d_model)}
        prompt = torch.randint(0, mc.vocab_size, (batch, prompt_len),
                               generator=gen, device="cuda")
        bundle.prefill(params, {"dec_tokens": prompt, **more})  # warm-up
        # the encoder's runs in the served run: rows encoded per stream
        real_encode = whisper.encode
        encoded = []

        def counting(params_, frames_, *a, **kw):
            encoded.append(frames_.shape[0])
            return real_encode(params_, frames_, *a, **kw)
        whisper.encode = counting
        try:
            rows, fed, prefill_ms, ms, caches, _ = self._serve(
                bundle, params, prompt, steps, key="dec_tokens", more=more)
        finally:
            whisper.encode = real_encode
        runs_per_request = sum(encoded) / batch
        if runs_per_request != 1:
            raise AssertionError(f"{mc.name}: the encoder ran "
                                 f"{runs_per_request} times a request")
        # the prefill's parts: the encoder, then the cross K/V
        torch.cuda.synchronize()
        t = time.perf_counter()
        enc = whisper.encode(params, more["frames"], mc)
        torch.cuda.synchronize()
        enc_ms = (time.perf_counter() - t) * 1e3
        t = time.perf_counter()
        whisper.cross_kv(params, enc, mc)
        torch.cuda.synchronize()
        xkv_ms = (time.perf_counter() - t) * 1e3
        del enc
        oracle = self._oracle(bundle, params, prompt, fed, key="dec_tokens",
                              more=more)
        truth = self._oracle(self._bundle(arch, batch, frames,
                                          dtype="float32"),
                             params, prompt, fed, key="dec_tokens", more=more)
        worst, worst_l2, excluded, fails, gap = self._decode_check(
            rows, oracle, truth)
        pos = caches["self"]["pos"]
        want = torch.full_like(pos[0], -1)
        want[:prompt_len + steps] = torch.arange(prompt_len + steps,
                                                 device="cuda")
        bad_layers = int((pos != want[None]).any(dim=1).sum())
        if fails or bad_layers:
            raise AssertionError(f"LM recurrent {mc.name}: {fails[:3]}, "
                                 f"{bad_layers} layers off the ring layout")
        cross_b = self._cache_bytes(caches["cross"])
        self_b = self._cache_bytes(caches["self"])
        # a step reads the decoder's weights (the tied head the whole
        # table), the cross cache and the self ring
        step_bytes = weights - enc_weights + cross_b + self_b
        bound_ms = step_bytes / self.hbm_bw * 1e3
        med, p90 = self._steps_summary(ms)
        end = prompt_len + steps
        tok = rows[-1].argmax(-1)[:, None]
        step_launches, step_busy, step_wall = self._launch_count(
            lambda: bundle.decode_step(params, tok, caches, end))
        self.say(f"LM recurrent (b) {mc.name} as published "
                 f"({mc.encoder_layers} + {mc.num_layers} layers): {weights} "
                 f"B of bf16 weights drawn in {init_s!r} s, init peak "
                 f"{init_peak} B; {batch} streams of {frames} frames, a "
                 f"{prompt_len}-token prompt, {steps} greedy steps: prefill "
                 f"{prefill_ms!r} ms (the second call; the encoder "
                 f"{enc_ms!r} ms, the cross K/V {xkv_ms!r} ms), the encoder "
                 f"ran {runs_per_request!r} times a request; decode step "
                 f"median {med!r} ms, p90 {p90!r} ms, "
                 f"{batch / (med * 1e-3)!r} tokens/s; cross cache {cross_b} "
                 f"B, self rings {self_b} B; a step launches {step_launches} "
                 f"device operations ({step_busy!r} ms busy of "
                 f"{step_wall!r} ms profiled) and reads {step_bytes} B "
                 f"(the decoder's weights, the cross cache, the rings): "
                 f"bound {bound_ms!r} ms; against teacher forcing: worst "
                 f"relative L2 {worst_l2!r}, worst excess {worst!r} (limit "
                 f"{LM_TOL['bfloat16']}; the bf16 forward sits "
                 f"{gap[0]!r}..{gap[1]!r} from float32), {excluded} of "
                 f"{rows.shape[0] * batch} rows excluded by the margin rule; "
                 f"every ring on its slot layout")
        self.profile(f"LM recurrent (b) {mc.name} decode step",
                     lambda: bundle.decode_step(params, tok, caches, end + 1))
        del caches
        real_xkv = whisper.cross_kv
        faults = {
            "cross K/V zeroed": (
                whisper, "cross_kv", lambda p_, e, c: {
                    k: torch.zeros_like(v)
                    for k, v in real_xkv(p_, e, c).items()}),
            "cross K/V rolled by one batch row": (
                whisper, "cross_kv", lambda p_, e, c: {
                    k: v.roll(1, dims=1)
                    for k, v in real_xkv(p_, e, c).items()})}
        controls = self._controls("LM recurrent", bundle, params, prompt,
                                  fed, oracle, truth, min(steps, 8), faults,
                                  key="dec_tokens", more=more)
        peak = torch.cuda.max_memory_allocated()
        del params, oracle, truth, rows, more
        self._free("(b) after whisper-large-v3", "LM recurrent")
        return {"layers": [mc.encoder_layers, mc.num_layers],
                "init_s": init_s, "init_peak_bytes": init_peak,
                "weight_bytes": weights, "prefill_ms": prefill_ms,
                "encoder_ms": enc_ms, "cross_kv_ms": xkv_ms,
                "encoder_runs_per_request": runs_per_request,
                "step_ms_median": med, "step_ms_p90": p90,
                "tokens_per_s": batch / (med * 1e-3),
                "cross_cache_bytes": cross_b, "self_cache_bytes": self_b,
                "step_launches": step_launches, "step_bytes": step_bytes,
                "step_bound_ms": bound_ms, "worst_rel_l2": worst_l2,
                "worst_excess": worst, "bf16_vs_float32_forward": gap,
                "excluded_rows": excluded, "controls": controls,
                "peak_bytes": peak}

    def _card_vs_cpu(self, label: str, arch: str, batch: int,
                     prompt_len: int, steps: int, seed: int, frames: int = 0,
                     **fields) -> dict:
        """float32 (TF32 off) prefill and ``steps`` greedy decode steps on
        the card, and the same calls on the CPU fed the card's tokens
        from the same weights: every row's logits within ``LM_TOL``
        (float32) of the CPU's max |logit|, and every cache leaf within
        the same share of its own max (positions exactly)."""
        torch = self.torch
        from repro_torch.models import registry
        from repro_torch.models.module import tree_leaves, tree_map
        card = self._bundle(arch, batch, prompt_len + steps, dtype="float32",
                            **fields)
        cpu = registry.build(card.cfg, device="cpu")
        mc = card.cfg.model
        gen = torch.Generator(device="cuda").manual_seed(seed)
        params = card.init_params(gen)
        self._conv_at_own_fan_in(params)
        cpu_params = tree_map(lambda t: t.cpu(), params)
        prompt = torch.randint(0, mc.vocab_size, (batch, prompt_len),
                               generator=gen, device="cuda")
        key, more = "inputs", {}
        if frames:
            key = "dec_tokens"
            more = {"frames": self._stream_frames(gen, batch, frames,
                                                  mc.d_model)}
        rows, fed, _, ms, caches, _ = self._serve(card, params, prompt, steps,
                                                  key=key, more=more)
        last, cpu_caches = cpu.prefill(cpu_params, {
            key: prompt.cpu(), **{k: v.cpu() for k, v in more.items()}})
        cpu_rows = [last]
        for i in range(steps):
            step, cpu_caches = cpu.decode_step(cpu_params, fed[:, i:i + 1].cpu(),
                                               cpu_caches, prompt_len + i)
            cpu_rows.append(step)
        worst = max(float((g.cpu() - w).abs().max() / w.abs().max())
                    for g, w in zip(rows, cpu_rows))
        cache_worst, pos_equal = 0.0, True
        for g, w in zip(tree_leaves(caches), tree_leaves(cpu_caches),
                        strict=True):
            g = g.cpu()
            if w.is_floating_point():
                scale = float(w.abs().max()) or 1.0
                cache_worst = max(cache_worst,
                                  float((g.float() - w.float()).abs().max())
                                  / scale)
            else:
                pos_equal = pos_equal and bool(torch.equal(g, w))
        self.say(f"LM recurrent (c) {label}: float32 {batch} x {prompt_len} "
                 f"+ {steps} steps, card against the CPU: worst max |Δ| / "
                 f"max |logit| {worst!r}, worst cache leaf {cache_worst!r} "
                 f"(limit {LM_TOL['float32']}), positions "
                 f"{'equal' if pos_equal else 'DIFFER'}; card step median "
                 f"{self._steps_summary(ms)[0]!r} ms")
        if not (worst <= LM_TOL["float32"]
                and cache_worst <= LM_TOL["float32"] and pos_equal):
            raise AssertionError(f"LM recurrent (c) {label}: card and CPU "
                                 f"differ ({worst}, {cache_worst}, "
                                 f"{pos_equal})")
        del params, caches, rows
        return {"logits": worst, "caches": cache_worst}

    def recurrent_float32(self):
        """(c) card against CPU in float32 at cut depth: xlstm-350m at 8 of
        24 layers (7 mLSTM, 1 sLSTM), whisper-large-v3 at 2 + 2 layers
        decoded past its 448 learned positions (a 12-token prompt to
        position 460), and the mamba kind as a stage of its own at
        hymba-1.5b's widths."""
        out = {"xlstm-350m": self._card_vs_cpu(
            "xlstm-350m 8 layers", "xlstm_350m", 1, 512, 16, seed=23,
            num_layers=8)}
        out["whisper-large-v3"] = self._card_vs_cpu(
            "whisper-large-v3 2 + 2 layers, 64 frames, to position 460",
            "whisper_large_v3", 1, 12, 449, seed=24, frames=64,
            num_layers=2, encoder_layers=2)
        out["mamba"] = self._card_vs_cpu(
            "mamba kind at hymba-1.5b widths, 2 layers", "hymba_1_5b", 2,
            256, 8, seed=25, stage_override=(("mamba", 0, 2),),
            num_layers=2, num_meta_tokens=0)
        self._free("(c) after the float32 runs", "LM recurrent")
        return out

    def recurrent_train_parity(self):
        """(d) one float32 train step of each on the card against the same
        step on the CPU, two microbatches (every batch key sliced):
        xlstm-350m at 8 layers [2, 256]; whisper-large-v3 at 2 + 2 layers,
        256 frames, 64 decoder tokens. Loss, clipped gradients and
        updated parameters within ``TRAIN_F32_TOL`` (phase 12 (a))."""
        import dataclasses
        torch = self.torch
        from repro_torch.configs.base import get_model_config
        from repro_torch.data import make_train_batch
        from repro_torch.models import registry
        from repro_torch.models.module import tree_map
        out = {}
        for arch, fields, tokens in (
                ("xlstm_350m", {"num_layers": 8}, 0),
                ("whisper_large_v3", {"num_layers": 2, "encoder_layers": 2},
                 64)):
            mc = dataclasses.replace(get_model_config(arch), dtype="float32",
                                     **fields)
            rc = self._train_rc(mc, 256, 2, 1)
            start = tree_map(lambda t: t.cpu(), registry.build(
                rc, device="cuda").init_params(
                    torch.Generator(device="cuda").manual_seed(0)))
            batch = make_train_batch(rc, 0, "cpu")
            if tokens:
                batch["dec_tokens"] = batch["dec_tokens"][:, :tokens]
                batch["labels"] = batch["labels"][:, :tokens]
            cpu_m, cpu_p, cpu_g, cpu_ms = self._one_step(rc, start, "cpu",
                                                         batch)
            card_m, card_p, card_g, card_ms = self._one_step(
                rc, start, "cuda", {k: v.cuda() for k, v in batch.items()})
            checks = {"loss": abs(card_m["loss"] - cpu_m["loss"])
                      / abs(cpu_m["loss"]),
                      "gradients": self._tree_rel(card_g, cpu_g),
                      "parameters": self._tree_rel(card_p, cpu_p)}
            self.say(f"LM recurrent (d) {mc.name} float32 train step "
                     f"({fields}), [2, 256], two microbatches: loss card "
                     f"{card_m['loss']!r} cpu {cpu_m['loss']!r}; relative "
                     f"{checks!r} (limit {TRAIN_F32_TOL}); step {card_ms!r} "
                     f"ms card, {cpu_ms!r} ms cpu")
            if not all(v <= TRAIN_F32_TOL for v in checks.values()):
                raise AssertionError(f"LM recurrent (d) {mc.name}: train "
                                     f"step parity beyond {TRAIN_F32_TOL}: "
                                     f"{checks}")
            out[mc.name] = {**checks, "card_ms": card_ms, "cpu_ms": cpu_ms}
            del start, cpu_p, cpu_g, card_p, card_g
        self._free("(d) after the train steps", "LM recurrent")
        return out

    def recurrent_phase(self):
        """Phase 14: the recurrent kinds (xlstm-350m, the mamba kind) and
        the encoder-decoder (whisper-large-v3) on the card. None of them
        launches a kernel (the reference runs their convs and attention
        plain): the counts must stay 0. Returns (per-part results, the
        counts)."""
        self._free("start", "LM recurrent")
        reset_counts()
        out, took, failed = {}, {}, []
        for key, name, run in (("a", "xlstm_published", self.xlstm_published),
                               ("b", "whisper_published",
                                self.whisper_published),
                               ("c", "float32_card_vs_cpu",
                                self.recurrent_float32),
                               ("d", "train_step_card_vs_cpu",
                                self.recurrent_train_parity)):
            self._run_part("LM recurrent", key, name, run, out, took, failed)
        launches = read_counts()
        if any(launches.values()):
            failed.append(f"kernel launches {launches}, expected none")
        self.say(f"LM recurrent parts took (s): {took!r}; kernel launches "
                 f"{launches}")
        if failed:
            raise AssertionError("LM recurrent phase: " + "; ".join(failed))
        return out, launches

    # -- phase 11 ------------------------------------------------------------

    def _row(self, name, shape, dtype, ms, plain_ms, lib_ms, bytes_moved,
             ops, peak):
        bytes_ms = bytes_moved / self.hbm_bw * 1e3
        ops_ms = ops / peak * 1e3
        row = {"name": name, "shape": shape, "dtype": dtype, "ms": ms,
               "plain_ms": plain_ms, "library_ms": lib_ms,
               "bound_ms": max(bytes_ms, ops_ms),
               "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
               "bytes": bytes_moved, "ops": ops, "bytes_ms": bytes_ms,
               "ops_ms": ops_ms}
        self.say(f"timing {name} {shape} {dtype}: kernel {ms!r} ms, bound "
                 f"{row['bound_ms']!r} ms ({row['bound_by']}: {bytes_moved} "
                 f"B / {self.hbm_bw:.3g} B/s = {bytes_ms!r} ms; {ops} ops / "
                 f"{peak:.3g} "
                 f"op/s = {ops_ms!r} ms), plain {plain_ms!r} ms, library "
                 f"{lib_ms!r} ms, {ops / (ms * 1e-3) / 1e12!r} TFLOP/s "
                 "achieved")
        return row

    def swattn_timing(self, S=8192, H=32, KV=8, hd=80, window=4096, B=1,
                      dtypes=("bfloat16", "float32")):
        import torch.nn.functional as F
        torch = self.torch
        from repro_torch.kernels.swattn import kernel as SW
        gen = torch.Generator(device="cuda").manual_seed(5)
        pairs = (window * (window + 1) // 2 + (S - window) * window
                 if 0 < window < S else S * (S + 1) // 2)
        ops = 4 * hd * pairs * H * B
        rows = {}
        with saved_counts():
            for dt in dtypes:
                tdt = getattr(torch, dt)
                q = torch.randn((B, S, H, hd), generator=gen, device="cuda"
                                ).to(tdt)
                k, v = (torch.randn((B, S, KV, hd), generator=gen,
                                    device="cuda").to(tdt) for _ in range(2))
                scale = hd ** -0.5

                def kern():
                    return SW.swattn(q, k, v, window=window, scale=scale)

                def plain():
                    return SW.swattn_ref(q, k, v, window=window, scale=scale)

                rtol, rel = MAIN_TOL[dt]
                err = self._agree(
                    f"swattn {dt} [{B},{S},{H}/{KV},{hd}] w{window} vs plain",
                    kern(), plain(), rtol, rel)
                ms = self._time(kern, 5, warmup=1)
                plain_ms = self._time(plain, 2, warmup=1)
                pos = torch.arange(S, device="cuda")
                band = pos[None, :] <= pos[:, None]
                if window > 0:
                    band = band & (pos[:, None] - pos[None, :] < window)
                qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

                def lib():             # TF32 is off (main)
                    return F.scaled_dot_product_attention(
                        qt, kt, vt, attn_mask=band, scale=scale,
                        enable_gqa=True)
                self._agree(f"yardstick SDPA {dt} vs kernel",
                            lib().transpose(1, 2), kern(), TOL[dt],
                            2 * rel)
                lib_ms = self._time(lib, 5, warmup=1)
                nbytes = 2 * (q.numel() + k.numel()) * q.element_size()
                rows[dt] = self._row(
                    "swattn", [B, S, H, KV, hd, window], dt, ms, plain_ms,
                    lib_ms, nbytes, ops, self.peak_ops[dt])
                rows[dt]["max_abs_err"] = err
                rows[dt]["route"] = SWATTN_ROUTES[dt]
                del q, k, v
        sw = rows.get("bfloat16")
        if sw is not None and not sw["ms"] < sw["library_ms"]:
            raise AssertionError(f"swattn bf16 {sw['shape']} {sw['ms']} ms "
                                 f"does not beat SDPA's {sw['library_ms']} "
                                 "ms")
        return rows

    def dwconv_timing(self, B=2, S=4096, C=3200, k=4):
        import torch.nn.functional as F
        torch = self.torch
        from repro_torch.kernels.dwconv1d import kernel as DW
        gen = torch.Generator(device="cuda").manual_seed(6)
        x = torch.randn((B, S, C), generator=gen, device="cuda"
                        ).to(torch.bfloat16)
        w = (torch.randn((k, C), generator=gen, device="cuda") / k
             ).to(torch.bfloat16)
        b = torch.randn((C,), generator=gen, device="cuda").to(torch.bfloat16)
        xp = F.pad(x.transpose(1, 2), (k - 1, 0)).contiguous()   # [B,C,S+k-1]
        wc = w.t().contiguous()[:, None, :]                        # [C,1,k]

        def lib():
            return F.conv1d(xp, wc, b, groups=C)
        with saved_counts():
            self._equal(f"dwconv1d bf16 [{B},{S},{C}] k{k} vs plain",
                        DW.dwconv1d(x, w, b), DW.dwconv1d_ref(x, w, b))
            ms = self._time(lambda: DW.dwconv1d(x, w, b), 20)
            plain_ms = self._time(lambda: DW.dwconv1d_ref(x, w, b), 5)
            self._agree("yardstick conv1d", lib().transpose(1, 2),
                        DW.dwconv1d(x, w, b), TOL["bfloat16"])
            lib_ms = self._time(lib, 20)
        nbytes = (2 * x.numel() + w.numel() + b.numel()) * x.element_size()
        return self._row("dwconv1d", [B, S, C, k], "bfloat16", ms, plain_ms,
                         lib_ms, nbytes, 2 * k * x.numel(),
                         self.peak_ops["bfloat16"])


def ptxas_report(smoke, libs) -> None:
    """Per kernel library: each instantiation's registers, static shared
    memory and spills, and a summary line."""
    for lib in libs:
        kernels = ptxas_summary(lib.ptxas_log.read_text())
        if not kernels:
            raise AssertionError(f"no kernel in {lib.name}'s ptxas report")
        for mangled, nreg, smem, spill in kernels:
            print(f"ptxas {kernel_label(mangled)}: {nreg} registers, {smem} "
                  f"B static shared memory, {spill} B spilled")
        regs = [k[1] for k in kernels]
        smem = [k[2] for k in kernels]
        smoke.say(f"ptxas {lib.name}: {len(kernels)} kernel instantiations, "
                  f"registers {min(regs)}..{max(regs)}, static shared memory "
                  f"{min(smem)}..{max(smem)} B, spill bytes "
                  f"{sum(k[3] for k in kernels)} (full report: "
                  f"{lib.ptxas_log.relative_to(ROOT)})")
        serving = {kernel_label(m): (r, sp) for m, r, _, sp in kernels
                   if kernel_label(m) in SERVING_KERNELS}
        if lib.name == "filter2d_halo":
            if sorted(serving) != sorted(SERVING_KERNELS):
                raise AssertionError(f"ptxas: serving kernels missing from "
                                     f"{sorted(serving)}")
            smoke.say("ptxas filter2d_halo on the serving path: " + "; ".join(
                f"{label} {r} registers, {sp} B spilled"
                for label, (r, sp) in serving.items()))
            spilled = [label for label, (_, sp) in serving.items() if sp]
            if spilled:
                raise AssertionError(f"ptxas: serving kernels spill: "
                                     f"{spilled}")
        tc = [(kernel_label(m), r, sp) for m, r, _, sp in kernels
              if "wgmma" in kernel_label(m)]
        if tc:
            smoke.say(f"ptxas {lib.name} bf16 tensor-core kernel: "
                      + "; ".join(f"{label} {r} registers, {sp} B spilled"
                                  for label, r, sp in tc))
        # ptxas's remark when it must serialise wgmma (C7515 and kin)
        for line in lib.ptxas_log.read_text().splitlines():
            if "wgmma" in line and "Performance Loss" in line:
                smoke.say(f"ptxas {lib.name}: {line.strip()[:300]}")


def main() -> int:
    if not os.path.isdir(os.path.join(ROOT, "src", "repro_torch")):
        print(f"chip_smoke: no src/repro_torch beside {__file__}; run it "
              "from the root of a checkout", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    card = card_line()
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    print(f"device: {name} x{count}", flush=True)
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    from repro_torch.obs import roofline
    part = roofline.PARTS[roofline.part_of(name)]
    print(f"roofline constants: {part.name}, {part.hbm_bw!r} B/s, peak "
          f"op/s {dict(part.peak_ops)}", flush=True)

    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    libs = _build.all_libraries()
    paths = _build.build_all(libs, verbose=True)
    for lib in libs:
        lib.load()
    smoke = Smoke(torch, card, part)
    ptxas_report(smoke, libs)
    smoke.say("build: " + ", ".join(str(p.relative_to(ROOT)) for p in paths)
              + f" in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    smoke.kernel_phase()
    smoke.say(f"kernel phase took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    launches, tma_launches, templates, picks, served = smoke.serving_phase()
    smoke.say(f"serving phase took {time.perf_counter() - t0:.1f} s")
    rows = smoke.timing_phase(templates)
    smoke.wave_breakdown(templates)
    t0 = time.perf_counter()
    exec_errs, exec_served, exec_rows = smoke.executors_phase(
        templates, picks, served)
    del served
    smoke.say(f"executors phase took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    sharded = smoke.sharded_phase(templates)
    smoke.say(f"sharded phase took {time.perf_counter() - t0:.1f} s")
    # the float32 paths below (SDPA, the LM's products) run without TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    sw_err = smoke.swattn_phase()
    smoke.say(f"swattn phase took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    smoke.dwconv_phase()
    smoke.say(f"dwconv1d phase took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    fwd_ms, layers, sw_launches = smoke.lm_phase()
    smoke.say(f"LM phase took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    dw_launches = smoke.mamba_phase()
    smoke.say(f"mamba phase took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    serving_lm, serve_sw = smoke.lm_serving_phase()
    smoke.say(f"LM serving phase took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    sw_rows = smoke.swattn_timing()
    # the serving prefill's shape: h2o-danube, 4 prompts of 6144 tokens
    sw_prefill = smoke.swattn_timing(B=4, S=6144, dtypes=("bfloat16",))
    # phase 13's prefill shapes: qwen3-moe (full attention, hd 128),
    # mixtral (window 4096, hd 128), gemma3 (hd 256, local and global)
    sw_kinds = {name: smoke.swattn_timing(B=2, S=S, H=H, KV=KV, hd=hd,
                                          window=W)
                for name, (S, H, KV, hd, W) in {
                    "qwen3-moe": (4096, 32, 4, 128, 0),
                    "mixtral": (6144, 32, 8, 128, 4096),
                    "gemma3 local": (4096, 8, 4, 256, 1024),
                    "gemma3 global": (4096, 8, 4, 256, 0)}.items()}
    dw_row = smoke.dwconv_timing()
    for dt, ms in fwd_ms.items():
        share = layers * sw_rows[dt]["ms"] / ms[True]
        smoke.say(f"LM {dt}: {layers} swattn launches x "
                  f"{sw_rows[dt]['ms']!r} ms = {share!r} of the kernel "
                  f"forward ({ms[True]!r} ms)")
    smoke.say(f"timing phase (swattn, dwconv1d) took "
              f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    training = smoke.train_phase()
    smoke.say(f"LM training phase took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    kinds, kinds_sw = smoke.lm_kinds_phase()
    smoke.say(f"LM kinds phase took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    recurrent, rec_launches = smoke.recurrent_phase()
    smoke.say(f"LM recurrent phase took {time.perf_counter() - t0:.1f} s")

    main_row = rows["w5f32"]
    sw = sw_rows["bfloat16"]
    summary = {"kernels": [{
        "name": "filter2d_halo", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": REPLACES, "launches": launches,
        "tma_launches": tma_launches,
        "max_abs_err": max(smoke.max_err.values()),
        "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
        "shape": main_row["shape"], "buckets": list(rows.values()),
        "executors": {"max_abs_err": exec_errs, "serving": exec_served,
                      "timing": exec_rows},
        "sharded": sharded,
        "launches_lm_recurrent": rec_launches["filter2d_halo"],
        "card": card}, {
        "name": "swattn", "route": "cuda", "source": SWATTN_SOURCE,
        "replaces": SWATTN_REPLACES,
        "launches": sw_launches + serve_sw + kinds_sw,
        "launches_lm_forward": sw_launches, "launches_lm_serving": serve_sw,
        "launches_lm_kinds": kinds_sw,
        "launches_lm_training": training["full_width"]["launches_per_step"],
        "lm_training": training,
        "max_abs_err": max([sw_err] + [
            r["max_abs_err"] for rows_ in [sw_rows, sw_prefill]
            + list(sw_kinds.values()) for r in rows_.values()]),
        "ms": sw["ms"], "plain_ms": sw["plain_ms"],
        "bound_ms": sw["bound_ms"], "bound_by": sw["bound_by"],
        "library_ms": sw["library_ms"], "shape": sw["shape"],
        "dtype": sw["dtype"], "routes": SWATTN_ROUTES,
        "float32": sw_rows["float32"],
        "prefill_shape": sw_prefill["bfloat16"], "lm_serving": serving_lm,
        "lm_kinds_shapes": sw_kinds, "lm_kinds": kinds,
        "launches_lm_recurrent": rec_launches["swattn"],
        "lm_recurrent": recurrent,
        "card": card}, {
        "name": "dwconv1d", "route": "cuda", "source": DWCONV_SOURCE,
        "replaces": DWCONV_REPLACES, "launches": dw_launches,
        "max_abs_err": 0.0, "ms": dw_row["ms"],       # bit-exact
        "plain_ms": dw_row["plain_ms"], "bound_ms": dw_row["bound_ms"],
        "bound_by": dw_row["bound_by"], "library_ms": dw_row["library_ms"],
        "shape": dw_row["shape"], "dtype": dw_row["dtype"],
        "launches_lm_training": training["full_width"]["launches_per_step"],
        "launches_lm_recurrent": rec_launches["dwconv1d"],
        "card": card}]}
    print(json.dumps(summary), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
