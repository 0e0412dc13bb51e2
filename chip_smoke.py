#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of the stream processor once on one GPU.

    python3 chip_smoke.py          # from the repository root, on a CUDA host

Phases (any failure exits non-zero and prints no result line):
  1. set-up: the card's name and power limit, TF32 off for matmuls and
     convolutions, the hand-written kernels built from ``src/repro_torch/
     kernels/csrc`` (one ``nvcc`` per source, in parallel), ptxas' report
     of every fused_preprocess function (no stack frame, no spills, or it
     fails), and the tensor-core instructions in the built libraries
     counted with ``cuobjdump --dump-sass`` (HMMA in flash_attention's,
     decode_attention's, decode_attention_bf16's and ssd_scan's, IMMA
     in int8_matmul's; none fails), HGMMA in each bf16 flash forward
     function (one a head dim), and decode_attention_bf16's 16-byte
     cp.async copies and cluster barrier (``SASS_ASYNC``);
  2. kernel checks: each kernel against its plain PyTorch version on the
     card, at the main path's shapes and at ragged ones, with its device
     time, its roofline bound and a yardstick: PyTorch's SDPA for
     attention (prefill and decode; it cannot soft-cap, so it runs
     without the cap), the unfused chain (frame_diff + fused_preprocess
     kernels, colour and signature in PyTorch) for fused_prefix (timed
     only here; the port never calls SDPA); the pixel kernels beside the
     launch floor (an empty kernel, ``csrc/launch_floor.cu``, on each
     one's grid), fused_preprocess timed at the reduced and optimized
     plans' crops and the reduced one in grey and checked at ragged rows,
     odd offsets, f 1-5, B 1 and 64 and unaligned frames, fused_prefix's
     cluster occupancy, its stage cut, its frames of 127 and 30 rows, B 1
     and B 40, and its d and x equal bit for bit to frame_diff's and
     fused_preprocess's (path, grey and optimized specs); decode_attention
     at gemma2's, chatglm3-6b's (a group of 16) and phi3-mini's (D 96)
     decode shapes,
     timed at the served paths' two ticks (the long request's slot beside
     three short ones, and four short slots), and ragged ones, ssd_scan at mamba2's chunks (a 512-token prefill, a
     13-token one) and the reference sweep's grouped shapes,
     flash_attention at every head dim with groups of 1, 2, 16 and 64,
     ragged S, bidirectional, capped and windowed, and
     at gemma2's, chatglm3-6b's and phi3-mini's prefill of an 8192 bucket
     (bound at the 3xTF32 rate, the fp32 CUDA cores' beside it); the last
     two again at
     chatglm3's and phi3's magnitudes (q, k, v as the reference's init
     makes them: scores in the hundreds), held to the plain version and
     to float64 beside it (card and CPU), and ssd_scan at mamba2's two
     chunk shapes held to float64 the same way; int8_matmul (exact: equal to
     its plain version; each call one launch of its pre-pass transpose and
     one of its tensor-core product, by the launch counts) at the
     reference sweep's shapes, kernel_bench's 256x512x512, ragged ones and
     chatglm3-6b's projections at M = 4, with ``torch._int_mm`` plus the
     two scale multiplies as yardstick;
  3. Q8's naive plan: Source -> MLLM extract (full width: 4 layers,
     d_model 256, 8/4 heads, PATCH 16, seeded random weights) -> filter
     -> Sink over 512 TollBooth frames, micro-batch 16;
  4. Q8's reduced plan: Source -> Skip -> fused preprocess -> red-pixel
     filter -> MLLM extract -> filter -> Sink over the same stream;
  5. cross-check: the naive, reduced and fused plans, without Q8's filter
     so that every extracted record reaches the sink, on 64 frames on the
     card and on the CPU (the plain versions) give the same records, and
     the MLLM's logits agree;
  6. trace: one profiled run of the naive, reduced and fused plans, device
     kernel time by name and the device's busy share of the wall clock;
  7. the super-optimizer: ``SuperOptimizer(ctx).optimize`` for Q8 on the
     card (semantic, logical and physical phases and the calibration, with
     the big, small and pruned-at-0.5 MLLMs and a seeded TinyDet), its
     report, then its plan driven over the 512 frames;
  8. Q8's fused plan: the reduced plan plus the TinyDet cascade, its
     Skip -> FusedPreprocess -> CheapColor -> Detect prefix in one
     FusedPrefixOp (what the physical phase builds when it fuses), against
     its unfused twin: same records, MLLM frames and operator counts;
  9. gemma2-2b at full width (26 layers, seeded random weights) through
     ``ServingEngine(max_slots=4, s_max=8192)``: the serving launcher's 8
     requests plus one of 4200 prompt tokens (bucket 8192, so the local
     layers' window bites in prefill and decode); flash_attention (D 256)
     on every prefill, decode_attention on every decode step; then a
     profiled window of decode ticks (device busy share, top kernels);
 10. mamba2-130m at full width through the same engine and requests, the
     long one replaced by 512 tokens (two SSD chunks): ssd_scan on every
     prefill;
 11. card == CPU: gemma2-2b, mamba2-130m, chatglm3-6b, glm4-9b and
     phi3-mini-3.8b at full width and depth 2, the same weights on both
     devices, three requests: equal tokens, prefill and decode logits
     within 1e-3; the same steps on the card with the attention kernels'
     plain versions printed beside them, and for the dense zoo each
     layer's decode attention at the first decode step against float64
     (the kernel, the card's plain version, the CPU's; printed);
 12. chatglm3-6b at full width (28 layers, seeded random weights) through
     the same engine and requests (the long prompt 4200 tokens), then the
     reference's int8 recipe on the same weights on the card:
     ``quantize_params_int8`` (ratio < 0.35), ``matmul_int8_dynamic`` on
     every quantized projection of layer 0 at M = 4 and M = 4200 (the
     path ``chatglm3_int8``: the int8_matmul kernel, each product equal
     to its plain version, within 5% of the fp32 product), one stacked
     leaf's codes, scales and dequantized weights equal to the CPU's,
     ``dequantize_params`` and the requests again on the dense weights it
     rebuilds (the path ``chatglm3_dequant_serve``, as the reference
     serves), with the top-1 agreement of the logits against the fp32 run
     printed (not gated: random full-width weights over 65k tokens have
     near ties).
 13. the catalog (run after phase 8, on its models): every one of the 13
     queries' naive plans over 512 frames of its dataset (TollBooth seed
     11 for Q1-Q9, Volleyball seed 3 for Q10-Q13), micro-batch 16, fps,
     MLLM frames, outputs and evaluator score printed (the path
     ``catalog``); then each over 32 frames on the card and on the CPU:
     the same records, window results, counts and scores;
 14. multi-query shared execution: ``MultiQueryRuntime`` over Q1-Q9's
     naive plans on TollBooth (``mq_tollbooth``, one merged extract),
     Q10-Q13's on Volleyball (``mq_volleyball``), and Q8's reduced prefix
     (Skip, fused preprocess, red filter) under Q8's, Q6's and Q2's
     extracts and tails (``mq_reduced``); each query's result equal to its
     own ``StreamRuntime`` run bit for bit (records, windows, counts),
     fewer shared MLLM frames than the independent sum, query-frames/s
     shared against independent printed;
 15. the semantic gate (``SemanticGate(GateConfig(threshold=0.06))`` on
     the card): Q8's fused plan without its filter, gated
     (``q8_fused_gated``), against its gated unfused twin: the same
     records and gate counters, and no signature of the gate's own on the
     fused run (the fused_prefix kernel's is consumed); Q8's naive plan
     gated (``q8_naive_gated``): cache hits, fewer forward frames (misses
     plus revalidations) than MLLM frames, hit rate and forwards saved
     printed; a gate at threshold 0 equal to no gate;
 16. observability and faults: phase 14's Q1-Q9 set observed
     (``mq_observed``) equal to the unobserved run bit for bit, span
     categories and the SLO table printed, the Chrome trace written to
     ``build/mq_trace.json``, observed and unobserved walls printed; Q8's
     reduced plan without its filter under a ``FaultInjector`` whose
     corrupt deliveries ``guard_stream`` absorbs (``q8_reduced_faulted``):
     the unfaulted run's records, and the injector fired.
 17. the serving tier (after phase 16, on phase 8's models): (a) the
     reference's example feeds (tb-north 1234 Q2/Q6/Q8, tb-south 4321
     Q1/Q5, tb-east 2025 Q3/Q9, court-1 volleyball 1234 Q12/Q13) plus Q8's
     reduced and fused plans on TollBooth 11, 512 frames a feed,
     micro-batch 16, through ``MultiStreamRuntime`` (one
     ``SharedExtractServer``, max_batch 64, 2 forwards in flight on the
     server's own CUDA stream), after an untimed 128-frame warm-up run,
     pipelined (``serve_pipelined``) and lock-step (``serve_lockstep``),
     once each: equal to each other and each query
     to its own ``StreamRuntime`` run bit for bit, fewer forwards than
     the independent runs, at least 2 forwards in flight; feed-frames/s
     of both and of the independent runs (the sum of their walls), and a
     profiled 128-frame run's device busy share; (b) the same feeds over
     32 frames on the card and on the CPU: equal records, windows, counts
     and scores; (c) four TollBooth feeds on Q8's naive plan under
     ``SemanticGate(GateConfig(threshold=0.06))`` in the server
     (``serve_gated``) against ungated: hits, forward frames, forwards,
     feed-frames/s; threshold 0 equal to ungated; (d) (a)'s feeds under a
     ``FaultInjector`` (a transient forward error, forward latency, a
     dead source on tb-east; ``serve_faulted``): the healthy feeds equal
     the clean run, served + degraded + dropped = 512 on every feed, the
     breaker tripped on tb-east; (e) ``FleetOptimizer.optimize`` over the
     example workload, ``MultiStreamRuntime.from_fleet`` over 512 frames
     (``serve_fleet``) equal to each plan's solo run, then observed:
     ``PlanAudit``'s table and ``forward_gap`` from the server's
     ``forward_device_ms`` probes.  Phase 2 also checks and times
     flash_attention at the server's coalesced buckets, B 32 and B 64.
 18. training on the card (after phase 12): (a) flash_attention's
     backward kernel (``csrc/flash_attention_bwd.cu``, through the
     ``autograd.Function`` that launches the forward with its log-sum-exp)
     at the path shapes (the stream MLLMs' frame sizes, chatglm3-6b's
     micro-batch), every head dim with groups 1, 2, 16 and 64, ragged S,
     bidirectional, capped and windowed: dQ, dK, dV within TOL of the
     plain version's autograd and, against float64, within BWD_WITNESS
     times the plain version's error plus BWD_FLOOR of the largest
     gradient; two launches equal bit for bit; the backward timed alone
     and with its forward beside the plain version's autograd and SDPA's
     fp32 backward (timed only); (d) ``launch/train.py --arch
     chatglm3-6b --int8-opt --steps 3 --batch 16 --seq 64 --grad-accum 2``
     in its own process at full width and depth: finite losses, step
     seconds, peak memory, the forward-with-lse and backward launches
     28 x 2 x 3 (``chatglm3_train``); (b) ``train_stream_models`` on the
     card at PRETRAIN_STEPS (``stream_pretrain``): each model's mean loss
     over its last LOSS_WINDOW steps below its first, launches = layers x
     steps (the teacher's forwards apart), then Q8's naive plan over 512
     frames with the trained models (``q8_trained``), its score beside
     phase 3's; (c) the big MLLM's first three ``_train`` steps on the
     card, each step's loss and gradients against the CPU's on the same
     parameters (loss within 1e-3; a gradient leaf within 1e-3 of its
     largest |g| or no farther than twice the plain attention on the
     card; ``mllm_train_vs_cpu``); (e) a stream-MLLM ``Trainer`` saved
     and restored on the card replays the next five losses
     (``mllm_resume``); (f) ssd_scan's backward kernel
     (``csrc/ssd_scan_bwd.cu``, through ``SSDScanFn``) at
     ``SSD_BWD_SHAPES`` (mamba2-130m's training micro-batch and one of 8
     sequences, jamba's full-width SSM, a chunk of 64, a ragged 13,
     jamba-smoke's as (d) of phase 19 trains it) under
     mamba2's init decay (seg past exp's range: finite) and a slow one:
     dx, dB, dC, dcs, ddt within TOL of the repaired plain version's
     autograd and within the float64 gate, two launches equal bit for
     bit, timed alone and with its forward; (g) ``launch/train.py --arch
     mamba2-130m --steps 3 --batch 8 --seq 512 --grad-accum 2`` at full
     width and depth (``mamba2_train``: ssd_scan's forward and backward
     launched 24 x 2 x 3 times), then card == CPU at depth 2 on three
     steps (``mamba2_train_vs_cpu``; the witness runs the plain SSD).
     cuDNN runs deterministic algorithms in phase 18.
 19. the MoE family (after 18): (a) moonshot-v1-16b-a3b at full width
     and MOONSHOT_SERVE_DEPTH layers through ``ServingEngine`` as phase 9
     (``moonshot_serve``), its decode ticks profiled as phase 6 does; (b) card == CPU: moonshot and qwen3-moe at full
     width, depth 1, jamba at smoke width (one period): tokens, routing
     indices (the smallest top-k margin printed), logits within LM_TOL;
     (c) moonshot through ``Trainer`` at full width and
     MOONSHOT_TRAIN_DEPTH layers, int8 moments, 3 steps
     (``moonshot_train``: finite losses, aux > 0, peak under 80 GB); (d)
     jamba-smoke trained card == CPU as 18 (g) (``jamba_train``).
 20. the encoder-decoder and patch-frontend families (after 19): (a)
     seamless-m4t-medium at full width and depth (``seamless_serve``):
     one ``prefill(frames=...)`` of 4 requests' 1024 stub frames and
     16-token prompts, 32 greedy decode steps; encode, prefill and
     decode-step ms, peak memory, launches by step class (a prefill:
     flash_attention once an encoder layer, a decoder layer and its cross
     attention; a decode step: decode_attention twice a decoder layer);
     (b) pixtral-12b at full width, all 40 layers, through the engine as
     phase 9 (``pixtral_serve``), then one prefill of 1024 patch
     embeddings at seeded positions in a 2048-token prompt and 12 decode
     steps; peak under 80 GB; (c) card == CPU at full width, depth 2:
     the CPU's greedy tokens fed to both, the card's logits no farther
     from a float64 run of the model than ENCDEC_WITNESS times the CPU's
     fp32 ones (seamless at 64 frames; at 1024 printed); (d) seamless
     trained at full width and depth (batch 8 x 128, 512 frames a
     sample) and pixtral at PIXTRAL_TRAIN_DEPTH layers with int8 moments
     (64 patches a sample), 3 steps each (``seamless_train``,
     ``pixtral_train``), then one step of each at depth 2 card == CPU as
     18 (c) holds it.  Phase 2 and phase 18 (a) also hold the
     rectangular flash kernels (``CROSS_SHAPES``: Sq queries against Sk
     keys, no mask) to their plain versions and float64, and time the
     seamless shapes beside SDPA; phase 2 times decode_attention at the
     seamless cross decode (G 1, D 64, 1024 keys).
 21. the LM zoo in bf16 (after 20): (a) chatglm3-6b at full width and
     depth, phase 12's seeded weights cast once to bf16 (``LM.cast_``),
     through ``ServingEngine(max_slots=4, s_max=8192, dtype=bfloat16)`` on
     phase 12's requests (``chatglm3_bf16_serve``: flash_attention_bf16 a
     layer a prefill, decode_attention_bf16 a layer a decode step), its
     decode ticks profiled, printed beside phase 12's fp32 run with the
     top-1 agreement (not gated); (b) moonshot-v1-16b-a3b at full width
     and all 48 layers built in bf16 (``moonshot_bf16_serve``), peak under
     80 GB; (c) card == CPU at bf16, full width, depth 2, for gemma2-2b,
     chatglm3-6b, phi3-mini-3.8b, mamba2-130m and seamless-m4t-medium: the
     CPU bf16 run's greedy tokens fed to the card, the card's logits no
     farther from an fp32 run of the same bf16-rounded weights than twice
     the CPU bf16 run's; (d) the bf16 step (``REPRO_CAST_BF16_STEP=1``):
     mamba2-130m through launch/train.py (``mamba2_bf16_step_train``),
     then chatglm3-6b at depth 2 card == CPU on three steps
     (``chatglm3_bf16_step_vs_cpu``).  Phase 2 also holds the bf16 kernels
     (flash_attention_bf16, on wgmma, TMA and mbarriers, at every head dim,
     groups 1-64 and the fp32 sweep's options, lengths about its 64-row
     warpgroups and 128-key tiles and windows a key either side of a tile
     (``bf16_flash_cases``), ``CROSS_SHAPES`` and ``MAG_SHAPES``'
     magnitudes, its host plan against the library's figures, two launches
     equal bit for bit; decode_attention_bf16, every warp streaming its
     own keys with cp.async, a long slot's splits over the card merged in
     thread-block clusters, at gemma2's, chatglm3's, phi3-mini's,
     moonshot's and seamless's cross decode shapes and the design's edges
     (``bf16_decode_edges``: a long slot one key either side of a split
     and of a stage as the card's plan cuts it, its last cluster partly
     empty, G 3, G 16 at D 256, G 1 at D 96, a window shorter than a
     split), two launches equal bit for bit) to their plain
     versions (2e-2, 3e-2) and to float64 on the same bf16 inputs
     (``bf16_vs_float64``), timed beside SDPA in bf16 (a yardstick) at
     ``BF16_TIMED``; phase 1 finds HGMMA (wgmma) in each of
     flash_attention_bf16's functions.
 22. bf16 training (after 21): ``LM.loss(batch, dtype=torch.bfloat16)``
     on the card, fp32 masters and gradients: (a) chatglm3-6b at full
     width and depth through ``Trainer`` (int8 moments, 16 x 64 in 2
     micro-batches), 8 steps on one repeated batch, its attention
     ``conditioned`` (``chatglm3_bf16_train``: flash_attention_lse_bf16
     and flash_attention_bwd_bf16 28 x 2 x 8 times, the fp32 pair never),
     then the same recipe in fp32 and in bf16 on the attention's plain
     versions as controls: every loss falls, the kernels' by at least
     half the fp32 control's fall, peaks under 80 GB; (b) mamba2-130m
     (``mamba2_bf16_train``), its loss falling, beside 18 (g); (c)
     chatglm3-6b at depth 2, ``conditioned``, on two steps, each gradient
     leaf on the card no farther from an fp32 run's on the CPU than twice
     the CPU bf16 run's, as phase 21 (c) holds bf16 logits
     (``chatglm3_bf16_train_vs_cpu``).  Phase 2 holds the bf16 training
     pair (``BF16_TRAIN_CASES``: chatglm3's micro-batch, gemma2's
     train_4k at a batch of one, phi3-mini's D 96, moonshot's heads,
     seamless's training cross attention, the tiles' edges): lse within
     2e-5 of max(1, |lse|) of the plain one, the output equal to the
     serving kernel's bit for bit, dq, dk, dv within 3e-2 of the plain
     autograd and within the float64 bar, two launches equal; prints the
     delta choice (fp32 gradients with delta from the bf16 output and from
     the unrounded one, against float64) and times the pair beside SDPA's
     bf16 forward and backward.
 23. the dry run, the roofline and the pipeline (after 22): (a)
     ``launch/dryrun.py::run_cell`` for every applicable cell of
     gemma2-2b, mamba2-130m, phi3-mini-3.8b and chatglm3-6b: the step's
     operations counted on meta tensors at the cell's global batch, then
     the step at a batch of one on the card where its bytes fit (peak,
     wall, launches; the path ``dryrun``; the train step recomputes each
     period in its backward, the configs' remat), or
     ``does_not_fit_one_card`` with the bytes; (b) the meta
     counts of all ten assigned archs (a process of its own, started in
     phase 1); (c) the roofline table at the H100 SXM's peaks; (d)
     ``gpipe`` on a world of one (NCCL, ``launch/mesh.py``) equal to the
     stack bit for bit.

Each phase that drives a plan zeroes the kernels' launch counts first and
reads them after; a kernel of the plan that was never launched fails the
run.  The last lines are the card's ``nvidia-smi`` name/power line, one
``{"kernels": [...]}`` JSON line, and ``{"ok": true, "device": ...}``.
"""
from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import glob
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

N_FRAMES, MICRO_BATCH, STREAM_SEED = 512, 16, 11
#: TinyDet seed whose random-weight cascade keeps some of Q8's frames
#: (92% of the frames with a car in the first 512 of stream 11, on the
#: reduced plan's crop); chosen once, on the CPU
DETECTOR_SEED = 129
HBM_BYTES_S = 3.35e12        # H100 SXM device memory (data sheet)
FP32_OPS_S = 67e12           # H100 SXM fp32 outside the tensor cores
TF32_OPS_S = 495e12          # H100 SXM dense TF32 on the tensor cores
INT8_OPS_S = 1979e12         # H100 SXM dense int8 on the tensor cores
BF16_OPS_S = 989e12          # H100 SXM dense bf16 on the tensor cores
#: flash_attention runs each fp32 product as three TF32 products (3xTF32):
#: its operations bound is at a third of the TF32 rate
FLASH_OPS_S = TF32_OPS_S / 3
# fused_prefix: its diff is exact and its colour counts are exact (the
# distance is rounded as in the plain version); the preprocess divides
# where PyTorch multiplies by a reciprocal, and patch means sum in another
# order: a few ulps, well inside 1e-5
# decode_attention: the reference sweep's fp32 tolerance; ssd_scan its SSD
# sweep's (sums of up to 256 products in another order); int8_matmul none:
# its int32 sums are exact and both versions round (acc * sx) * sw alike
# flash_attention_lse: the forward's (its log-sum-exp sums the same
# exponentials); flash_attention_bwd: relative to the largest gradient,
# the forward's (sums of up to G x S products in other orders; phase 18
# also holds it to float64)
TOL = {"frame_diff": 1e-6, "fused_preprocess": 1e-5, "flash_attention": 2e-5,
       "fused_prefix": 1e-5, "decode_attention": 2e-5, "ssd_scan": 1e-4,
       "int8_matmul": 0.0, "flash_attention_lse": 2e-5,
       "flash_attention_bwd": 2e-5, "ssd_scan_bwd": 1e-4,
       # bf16 (phase 2, 21): the reference sweep's bf16 tolerances; the
       # bf16 backward's, 3e-2; its lse forward's the fp32 one's (held to
       # 2e-5 of max(1, |lse|) by bf16_train_check)
       "flash_attention_bf16": 2e-2, "decode_attention_bf16": 3e-2,
       "flash_attention_lse_bf16": 2e-5, "flash_attention_bwd_bf16": 3e-2}
KERNELS = {   # name -> (C symbol, source, TPU kernel it replaces)
    "frame_diff": ("frame_diff_u8",
                   "src/repro_torch/kernels/csrc/frame_diff.cu",
                   "src/repro/kernels/frame_diff/kernel.py:24"),
    "fused_preprocess": ("fused_preprocess_u8",
                         "src/repro_torch/kernels/csrc/fused_preprocess.cu",
                         "src/repro/kernels/fused_preprocess/kernel.py:46"),
    "flash_attention": ("flash_attention_f32",
                        "src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention/kernel.py:94"),
    "fused_prefix": ("fused_prefix_launch",
                     "src/repro_torch/kernels/csrc/fused_prefix.cu",
                     "src/repro/kernels/fused_prefix/kernel.py:114"),
    "decode_attention": ("decode_attention_f32",
                         "src/repro_torch/kernels/csrc/decode_attention.cu",
                         "src/repro/kernels/decode_attention/kernel.py:69"),
    "ssd_scan": ("ssd_scan_f32", "src/repro_torch/kernels/csrc/ssd_scan.cu",
                 "src/repro/kernels/ssd_scan/kernel.py:55"),
    "int8_matmul": ("int8_mma_f32",
                    "src/repro_torch/kernels/csrc/int8_matmul.cu",
                    "src/repro/kernels/int8_matmul/kernel.py:36"),
    # training (phase 18): the forward's entry point that also writes each
    # row's log-sum-exp, and the backward (the TPU package differentiates
    # plain jnp: no Pallas backward; it is the gradient of the kernel at
    # kernel.py:94)
    "flash_attention_lse": ("flash_attention_lse_f32",
                            "src/repro_torch/kernels/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention/kernel.py:94"),
    "flash_attention_bwd": ("flash_attention_bwd_f32",
                            "src/repro_torch/kernels/csrc/"
                            "flash_attention_bwd.cu",
                            "src/repro/kernels/flash_attention/kernel.py:94"),
    # training (phase 18 (f)-(g), 19 (d)): ssd_scan's backward (the TPU
    # package differentiates plain jnp; it is the gradient of the kernel at
    # kernel.py:55)
    "ssd_scan_bwd": ("ssd_scan_bwd_f32",
                     "src/repro_torch/kernels/csrc/ssd_scan_bwd.cu",
                     "src/repro/kernels/ssd_scan/kernel.py:55"),
    # the LM zoo in bf16 (phase 21): the two TPU kernels' bf16 half
    "flash_attention_bf16": ("flash_attention_bf16",
                             "src/repro_torch/kernels/csrc/"
                             "flash_attention.cu",
                             "src/repro/kernels/flash_attention/kernel.py:94"),
    "decode_attention_bf16": ("decode_attention_bf16",
                              "src/repro_torch/kernels/csrc/"
                              "decode_attention_bf16.cu",
                              "src/repro/kernels/decode_attention/"
                              "kernel.py:69"),
    # bf16 training (phase 22, 23): the bf16 forward writing each row's
    # log-sum-exp, and the bf16 backward (the gradient of kernel.py:94)
    "flash_attention_lse_bf16": ("flash_attention_lse_bf16",
                                 "src/repro_torch/kernels/csrc/"
                                 "flash_attention.cu",
                                 "src/repro/kernels/flash_attention/"
                                 "kernel.py:94"),
    "flash_attention_bwd_bf16": ("flash_attention_bwd_bf16",
                                 "src/repro_torch/kernels/csrc/"
                                 "flash_attention_bwd.cu",
                                 "src/repro/kernels/flash_attention/"
                                 "kernel.py:94"),
}
#: a kernel's other launches, each its own C entry point with its own
#: count, made once with every launch of the kernel's entry above
COMPANIONS = {"int8_matmul": ("int8_transpose_kn",)}
#: the tensor-core instruction each built library must hold (phase 1)
SASS_MMA = {"flash_attention": "HMMA", "flash_attention_bwd": "HMMA",
            "decode_attention": "HMMA", "decode_attention_bf16": "HMMA",
            "ssd_scan": "HMMA", "ssd_scan_bwd": "HMMA", "int8_matmul": "IMMA"}
#: the asynchronous instructions a library must hold (phase 1), by the
#: names ``cuobjdump --dump-sass`` prints (a prefix of the opcode):
#: decode_attention_bf16's 16-byte copies (``cp.async``) and its cluster
#: barrier (``barrier.cluster``)
SASS_ASYNC = {"decode_attention_bf16": ("LDGSTS", "UCGABAR")}
#: the functions that must hold HGMMA (wgmma), by library: name -> count
#: (phase 1; the bf16 flash forward, one a head dim)
SASS_WGMMA = {"flash_attention": {"flash_fwd_bf16_kernel": 6}}
#: the paths driven end to end, by the name used in ``launches_by_path``
PATHS = ("q8_naive", "q8_reduced", "q8_fused", "q8_unfused", "q8_optimized",
         "catalog", "mq_tollbooth", "mq_volleyball", "mq_reduced",
         "q8_fused_gated", "q8_naive_gated", "mq_observed",
         "q8_reduced_faulted", "serve_pipelined", "serve_lockstep",
         "serve_gated", "serve_faulted", "serve_fleet", "gemma2_serve",
         "mamba2_serve",
         "chatglm3_serve", "chatglm3_int8", "chatglm3_dequant_serve",
         "chatglm3_train", "stream_pretrain", "q8_trained",
         "mllm_train_vs_cpu", "mllm_resume", "mamba2_train",
         "mamba2_train_vs_cpu", "moonshot_serve", "moonshot_train",
         "jamba_train", "seamless_serve", "pixtral_serve", "seamless_train",
         "pixtral_train", "chatglm3_bf16_serve", "moonshot_bf16_serve",
         "mamba2_bf16_step_train", "chatglm3_bf16_step_vs_cpu",
         "chatglm3_bf16_train", "mamba2_bf16_train",
         "chatglm3_bf16_train_vs_cpu", "dryrun")
#: the volleyball stream's seed (Q10-Q13); TollBooth's is STREAM_SEED
VOLLEYBALL_SEED = 3
#: the semantic gate's threshold on the card (phase 15)
GATE_THRESHOLD = 0.06
#: the multi-query SLO target of the observed run (phase 16), ms
SLO_TARGET_MS = 100.0
#: the serving phases: 8 requests of the launcher's generator plus a long
#: one; s_max and slots as a deployment of gemma2-2b on one card would
SERVE_SLOTS, SERVE_S_MAX, SERVE_NEW = 4, 8192, 12
LONG_PROMPT = {"gemma2-2b": 4200, "mamba2-130m": 512, "chatglm3-6b": 4200,
               "moonshot-v1-16b-a3b": 4200, "pixtral-12b": 4200}
#: decode_attention's two shape classes (phase 2), the ticks the served
#: paths give: the long request's slot (4200 prompt tokens and up to 12
#: new) beside three short ones, and four short slots (the launcher's
#: prompts of 4-23 tokens plus up to 12 new)
LONG_LENS, SHORT_LENS = [7, 23, 30, 4206], [6, 14, 23, 35]
#: a step's shape class on the served paths: a decode step is long when a
#: slot holds more keys than one split takes (``MIN_KEYS_PER_SPLIT``), a
#: mamba prefill when it fills a whole chunk of 256
SSD_CHUNK = 256
#: the kernels whose launches the serving phases class by step
CLASSED = ("decode_attention", "ssd_scan", "decode_attention_bf16")
#: chatglm3-6b's quantized projections as (K, N) matrices, the operands of
#: matmul_int8_dynamic (wq/wk/wv (d, H, Dh) and wo (H, Dh, d) reshaped)
CHATGLM3_PROJ = {"wq": (4096, 4096), "wk": (4096, 256), "wv": (4096, 256),
                 "wo": (4096, 4096), "w_in": (4096, 13696),
                 "w_gate": (4096, 13696), "w_out": (13696, 4096)}
#: card == CPU: the logits' tolerance.  fp32 on both, but cuBLAS and the
#: CPU's BLAS sum d_model (up to 4096) products in other orders; the dense
#: zoo (no soft-cap) has scores in the hundreds, so both attention kernels
#: sum nearer float64 than the plain version (3xTF32 with staged sums)
LM_TOL = 1e-3
#: the dense zoo's LMs (no soft-cap, no window): phase 11 reads their
#: decode attention against float64
DENSE_ZOO = ("chatglm3-6b", "glm4-9b", "phi3-mini-3.8b")


#: the dense zoo's attention at its own magnitudes (phase 2): q, k and v
#: drawn with the standard deviations the reference's init gives them after
#: a norm (fan-in over the head axis: q sqrt(d_model / H), k and v
#: sqrt(d_model / Hk)), so the scores reach the hundreds, as in phase 11.
#: name -> (d_model, H, Hk, D)
MAG_SHAPES = {"chatglm3": (4096, 32, 2, 128), "phi3": (3072, 32, 32, 96)}
#: the kernel against its plain version there, relative to the plain
#: version's largest magnitude: a score (~500) rounded another way (~1e-4)
#: moves a near-tied softmax's output by up to ~p(1-p) 1e-4 |v_i - v_j|,
#: ~1e-4 of the largest |v|
MAG_TOL = 1e-3
#: the witness of rounding: against float64, the kernel no farther than
#: MAG_WITNESS times the plain version (on the card or the CPU, whichever
#: is farther)
MAG_WITNESS = 2.0


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# device timing
# ---------------------------------------------------------------------------

def _sleep_ms(cycles: int) -> float:
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    torch.cuda._sleep(cycles)
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b)


def device_ms(fn, n: int = 40, reps: int = 5) -> float:
    """Median over ``reps`` of the device time per call of ``n``
    back-to-back calls.  A sleep kernel queued first keeps the card busy
    while the host enqueues the calls, so the events see device time, not
    the host's launch rate (inputs stay in L2 between calls).  A call that
    waits for the card (a host copy) defeats the sleep: that is an error.
    So do more launches than the card queues behind the sleep (about a
    thousand): a function of many small launches is timed with a small
    ``n``."""
    fn()
    torch.cuda.synchronize()
    cycles = 20_000_000
    times = []
    for _ in range(4 * reps):
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda._sleep(cycles)
        s.record()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        host_ms = (time.perf_counter() - t0) * 1e3
        e.record()
        torch.cuda.synchronize()
        if host_ms > 0.5 * _sleep_ms(cycles):
            cycles = min(4 * cycles, 320_000_000)   # sleep longer
            continue
        times.append(s.elapsed_time(e) / n)
        if len(times) == reps:
            return statistics.median(times)
    raise SmokeFailure("timing: the host could not enqueue ahead of the "
                       "card (does the function synchronize?)")


def floor_ms(blocks: int, threads: int, cluster: int = 1) -> float:
    """The launch floor: ``device_ms`` of an empty kernel
    (``csrc/launch_floor.cu``) on a grid of ``blocks`` blocks of
    ``threads`` threads, in clusters of ``cluster`` blocks."""
    from repro_torch.kernels._build import load_library

    fn = load_library("launch_floor").empty_launch
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def launch():
        rc = fn(blocks, threads, cluster,
                torch.cuda.current_stream().cuda_stream)
        check(rc == 0, f"empty_launch: CUDA error {rc}")

    return device_ms(launch)


TIMING_KEYS = ("ms", "plain_ms", "library_ms", "bound")


def timing(t):
    """A timing dict as the kernels line writes it (with its launch floor
    where it has one)."""
    return {"ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound"][0], "bound_by": t["bound"][1],
            "library_ms": t["library_ms"],
            **{k: t[k] for k in t if k in ("launch_floor_ms",
                                            "library_expanded_ms")
               or k.startswith("fwd_bwd_")}}


def bound(nbytes: float, ops: float, ops_s: float = FP32_OPS_S):
    t_bytes, t_ops = nbytes / HBM_BYTES_S * 1e3, ops / ops_s * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations")


def flash_line(label, t, nbytes, ops, library="SDPA"):
    """flash_attention's times at one shape, its bound (``t["bound"]``, at
    the tensor cores' 3xTF32 rate) and the fp32 CUDA cores' bound beside
    it (printed only)."""
    print(f"  flash_attention {label}: kernel {t['ms']:.4f} ms, plain "
          f"{t['plain_ms']:.4f} ms, {library} {t['library_ms']:.4f} ms, "
          f"bound {t['bound'][0]:.5f} ms ({t['bound'][1]}, 3xTF32 at "
          f"{FLASH_OPS_S / 1e12:.0f} TFLOP/s; {bound(nbytes, ops)[0]:.5f} "
          f"ms at the fp32 CUDA cores' {FP32_OPS_S / 1e12:.0f})")


def no_stack(report, name):
    """Phase 1: every function of ``name``'s library reports 0 bytes of
    stack frame and of spill stores and loads (``-Xptxas -v``)."""
    found = re.findall(r"(\d+) bytes stack frame, (\d+) bytes spill "
                       r"stores, (\d+) bytes spill loads",
                       str(report[name]["log"]))
    print(f"[1] {name}: {len(found)} functions, stack frame and spill "
          f"bytes {sorted(set(found))} (ptxas)")
    check(found and all(f == ("0", "0", "0") for f in found),
          f"{name}: a function has a stack frame or spills")


def sass_mma_counts():
    """Phase 1: each library of ``SASS_MMA`` holds its tensor-core
    instruction, and of ``SASS_ASYNC`` its asynchronous ones (``cuobjdump
    --dump-sass``); a count of 0 fails.  In
    flash_attention's library, each function of ``SASS_WGMMA`` (one a
    head dim) holds HGMMA (wgmma), counted function by function."""
    from repro_torch.kernels._build import library_path, nvcc

    exe = shutil.which("cuobjdump") or os.path.join(
        os.path.dirname(nvcc()), "cuobjdump")
    for name, op in SASS_MMA.items():
        sass = subprocess.run([exe, "--dump-sass", str(library_path(name))],
                              capture_output=True, text=True, timeout=300,
                              check=True).stdout
        for o in (op,) + SASS_ASYNC.get(name, ()):
            n = len(re.findall(rf"\b{o}(?![A-Z0-9])", sass))
            print(f"[1] {name}: {n} {o} instructions (cuobjdump "
                  "--dump-sass)")
            check(n > 0, f"{name}: no {o} instruction in its library")
        for fn, want in SASS_WGMMA.get(name, {}).items():
            # the dump's sections, one a function: "Function : <name>"
            parts = [p for p in sass.split("Function : ")[1:]
                     if fn in p.split(None, 1)[0]]
            counts = [len(re.findall(r"\bHGMMA\b", p)) for p in parts]
            print(f"[1] {name}: {fn}: {len(parts)} functions, HGMMA "
                  f"{counts}")
            check(len(parts) == want and all(counts),
                  f"{name}: {fn} wants {want} functions with HGMMA, has "
                  f"{counts}")


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

#: each kernel's largest error against its plain version, over all checks
ERRS = {k: 0.0 for k in KERNELS}


def compare(name, got, want, label):
    """A kernel's output against its plain version's on the same inputs,
    within ``TOL[name]`` (absolute plus relative)."""
    got, want = got.float().cpu(), want.float().cpu()
    check(got.shape == want.shape and torch.isfinite(got).all(),
          f"{name} {label}: shape {tuple(got.shape)} or non-finite")
    err = (got - want).abs().max().item() if got.numel() else 0.0
    tol = TOL[name]
    bad = ((got - want).abs() > tol + tol * want.abs()).sum().item()
    print(f"  {name:17s} {label:44s} max_abs_err {err:.3e}"
          f" (tol {tol:g})")
    check(bad == 0, f"{name} {label}: {bad} values outside {tol}")
    ERRS[name] = max(ERRS[name], err)


def kernel_checks(dev):
    from repro_torch.kernels.flash_attention.kernel import (
        HEAD_DIMS, flash_attention_cuda)
    from repro_torch.kernels.flash_attention.ref import flash_attention_plain
    from repro_torch.kernels.frame_diff.kernel import frame_diff_cuda
    from repro_torch.kernels.frame_diff.ref import frame_diff_ref
    from repro_torch.kernels.fused_preprocess.kernel import \
        fused_preprocess_cuda
    from repro_torch.kernels.fused_preprocess.ref import fused_preprocess_ref

    gen = torch.Generator().manual_seed(0)
    rows = {}

    def frames(shape):
        return torch.randint(0, 256, shape, generator=gen,
                             dtype=torch.uint8).to(dev)

    # frame_diff: the Skip operator's shape, then ragged/unaligned ones
    for shape, regions in [((16, 3, 128, 256), (4, 8)),
                           ((16, 3, 128, 256), (4, 4)),
                           ((16, 3, 128, 256), (1, 1)),
                           ((1, 3, 128, 256), (4, 8)),
                           ((64, 3, 128, 256), (4, 8)),
                           ((3, 3, 30, 50), (3, 5))]:
        a, b = frames(shape), frames(shape)
        compare("frame_diff", frame_diff_cuda(a, b, regions=regions),
                frame_diff_ref(a, b, regions=regions),
                f"{shape} regions {regions}")
    a, b = frames((16, 3, 128, 256)), frames((16, 3, 128, 256))
    nbytes = 2 * a.numel() + 4 * 16 * 4 * 8
    rows["frame_diff"] = dict(
        ms=device_ms(lambda: frame_diff_cuda(a, b, regions=(4, 8))),
        plain_ms=device_ms(lambda: frame_diff_ref(a, b, regions=(4, 8))),
        library_ms=None, bound=bound(nbytes, 3 * a.numel()),
        # 512 regions, a warp each, four warps a block
        launch_floor_ms=floor_ms(128, 128))

    # fused_preprocess: the reduced plan's crop, then odd offsets, a ragged
    # output row (w/f % 4 != 0), an odd x0, f 4 and a generic f, B 1 and
    # 64, grey at the path crop, the optimized plan's crop, and frames
    # whose rows or address are not 16-byte aligned
    for b, shape, crop, f, grey in [
            (16, (3, 128, 256), (64, 0, 64, 256), 2, False),
            (16, (3, 128, 256), (0, 0, 128, 256), 1, False),
            (16, (3, 128, 256), (33, 17, 30, 98), 2, True),
            (16, (3, 128, 256), (1, 3, 63, 125), 1, False),
            (16, (3, 128, 256), (5, 7, 96, 60), 3, False),
            (16, (3, 128, 256), (0, 0, 128, 250), 2, False),
            (16, (3, 128, 256), (64, 3, 64, 250), 2, False),
            (16, (3, 128, 256), (96, 0, 32, 256), 4, False),
            (16, (3, 128, 256), (3, 5, 90, 150), 5, False),
            (1, (3, 128, 256), (64, 0, 64, 256), 2, False),
            (64, (3, 128, 256), (64, 0, 64, 256), 2, False),
            (16, (3, 128, 256), (64, 0, 64, 256), 2, True),
            (16, (3, 128, 256), (96, 0, 32, 256), 2, False),
            (4, (3, 30, 50), (1, 3, 26, 44), 2, False),
            (4, (3, 40, 100), (1, 3, 36, 94), 2, True)]:
        x = frames((b,) + shape)
        compare("fused_preprocess",
                fused_preprocess_cuda(x, crop=crop, factor=f, grey=grey),
                fused_preprocess_ref(x, crop=crop, factor=f, grey=grey),
                f"B{b} {shape[1]}x{shape[2]} crop {crop} /{f}"
                f"{' grey' if grey else ''}")
    x = frames((16, 3, 128, 256))
    raw = torch.empty(x.numel() + 1, dtype=torch.uint8, device=dev)
    odd = raw[1:].view(x.shape)          # a frame pointer off by one byte
    odd.copy_(x)
    compare("fused_preprocess",
            fused_preprocess_cuda(odd, crop=(64, 0, 64, 256), factor=2),
            fused_preprocess_ref(x, crop=(64, 0, 64, 256), factor=2),
            "B16 crop (64, 0, 64, 256) /2 frames at an odd address")
    del raw, odd
    rows["fused_preprocess"] = preprocess_timings(x)

    # flash attention in model layout: the MLLM's S (full frame 140, crop
    # 76, crop/2 28) and ragged S, G = 2 (big) and 1 (small)
    def qkv(b, s, h, hk, d):
        return [torch.randn(shape, generator=gen).to(dev) for shape in
                ((b, s, h, d), (b, s, hk, d), (b, s, hk, d))]

    cases = [(16, s, 4 * g, 4, 32, dict(causal=True))
             for s in (140, 76, 28, 1, 257) for g in (2, 1)]
    # the extract server's coalesced buckets (phase 17: up to 64 frames a
    # forward)
    cases += [(b, 140, 8, 4, 32, dict(causal=True)) for b in (32, 64)]
    cases += [(4, 140, 8, 4, 32, dict(causal=False)),
              (4, 140, 8, 4, 32, dict(causal=True, cap=20.0)),
              (4, 140, 8, 4, 32, dict(causal=True, window=35)),
              (2, 257, 8, 2, 64, dict(causal=True)),
              (2, 100, 16, 2, 128, dict(causal=True))]
    # every head dim the kernel takes, groups of 1, 2, 16 and 64 (two
    # positions per 128-row tile), ragged S, and each of bidirectional, cap
    # and a window shorter than a key tile
    cases += [(1, s, g * (1 if g == 64 else 2), 1 if g == 64 else 2, d, kw)
              for d in HEAD_DIMS for g in (1, 2, 16, 64) for s in (1, 33, 257)
              for kw in (dict(causal=False), dict(causal=True, cap=20.0),
                         dict(causal=True, window=7))]
    for b, s, h, hk, d, kw in cases:
        q, k, v = qkv(b, s, h, hk, d)
        compare("flash_attention", flash_attention_cuda(q, k, v, **kw),
                flash_attention_plain(q, k, v, **kw),
                f"B{b} S{s} H{h}/{hk} D{d} {kw}")
    shapes = {}
    for s in (140, 76, 28):
        q, k, v = qkv(16, s, 8, 4, 32)
        nbytes = 4 * (2 * q.numel() + 2 * k.numel())
        ops = 4 * 32 * s * (s + 1) // 2 * 16 * 8
        t = dict(
            ms=device_ms(lambda: flash_attention_cuda(q, k, v)),
            plain_ms=device_ms(lambda: flash_attention_plain(q, k, v)),
            library_ms=sdpa_ms(q, k, v),
            bound=bound(nbytes, ops, FLASH_OPS_S))
        shapes[s] = t
        flash_line(f"B16 S{s} H8/4 D32", t, nbytes, ops)
    coalesced = {}
    for b in (32, 64):
        q, k, v = qkv(b, 140, 8, 4, 32)
        nbytes = 4 * (2 * q.numel() + 2 * k.numel())
        ops = 4 * 32 * 140 * 141 // 2 * b * 8
        t = dict(
            ms=device_ms(lambda: flash_attention_cuda(q, k, v)),
            plain_ms=device_ms(lambda: flash_attention_plain(q, k, v)),
            library_ms=sdpa_ms(q, k, v),
            bound=bound(nbytes, ops, FLASH_OPS_S))
        coalesced[f"b{b}_s140"] = t
        flash_line(f"B{b} S140 H8/4 D32 (coalesced bucket)", t, nbytes,
                   ops)
    rows["flash_attention"] = {**shapes[140], **coalesced}
    rows["fused_prefix"] = prefix_checks(compare, frames)
    lm_kernel_checks(compare, gen, dev, rows)
    cross_kernel_checks(compare, gen, dev, rows)
    magnitude_checks(gen, dev)
    bf16_kernel_checks(compare, gen, dev, rows)
    bf16_train_kernel_checks(dev, rows)
    rows.update(int8_checks(dev))
    t = rows["frame_diff"]
    print(f"  frame_diff at the path's shape: kernel {t['ms']:.4f} ms, plain "
          f"{t['plain_ms']:.4f} ms, bound {t['bound'][0]:.5f} ms "
          f"({t['bound'][1]}), launch floor {t['launch_floor_ms']:.4f} "
          f"ms (an empty kernel on its grid)")
    return rows


#: fused_preprocess's timed shapes on 16 3x128x256 frames: the reduced
#: plan's crop (the kernels line's top level), the optimized plan's, and
#: the reduced crop in grey (the grey spec fused_prefix is held to)
PREPROCESS_TIMED = {"path": ((64, 0, 64, 256), 2, False),
                    "optimized": ((96, 0, 32, 256), 2, False),
                    "grey": ((64, 0, 64, 256), 2, True)}


def preprocess_timings(x):
    """fused_preprocess's kernel, plain version, bound and launch floor (an
    empty kernel on the grid ``preprocess_plan`` gives) at each of
    ``PREPROCESS_TIMED`` on frames ``x``; the path's timing with the
    others nested by name."""
    from repro_torch.kernels.fused_preprocess.kernel import (
        fused_preprocess_cuda, preprocess_plan)
    from repro_torch.kernels.fused_preprocess.ref import fused_preprocess_ref

    out = {}
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    for name, (crop, f, grey) in PREPROCESS_TIMED.items():
        kw = dict(crop=crop, factor=f, grey=grey)
        b, c = x.shape[:2]
        n_in = b * c * crop[2] * crop[3]
        n_out = b * (1 if grey else c) * (crop[2] // f) * (crop[3] // f)
        plan = preprocess_plan(tuple(x.shape), crop, f, grey, sms=sms)
        gx, gy = plan["grid"]
        t = dict(
            ms=device_ms(lambda: fused_preprocess_cuda(x, **kw)),
            plain_ms=device_ms(lambda: fused_preprocess_ref(x, **kw)),
            library_ms=None,
            # a sum a byte, then per channel value a division by 255, one
            # by f*f, a subtraction and a division (grey: 5 more)
            bound=bound(n_in + 4 * n_out,
                        n_in + (4 * c + 5 if grey else 4) * n_out),
            launch_floor_ms=floor_ms(gx * gy, plan["threads"]))
        print(f"  fused_preprocess {name} B{b} crop {crop} /{f}"
              f"{' grey' if grey else ''}: kernel {t['ms']:.4f} ms, plain "
              f"{t['plain_ms']:.4f} ms, bound {t['bound'][0]:.5f} ms "
              f"({t['bound'][1]}), launch floor {t['launch_floor_ms']:.4f} "
              f"ms (an empty kernel on its grid: {gx} x {gy} blocks of "
              f"{plan['threads']} threads, {plan['smem']} B of shared "
              f"memory a block)")
        out[name] = t
    return {**out.pop("path"), **out}


RED, BLUE = (190., 40., 40.), (40., 40., 190.)
#: the main path's prefix: Skip's diff, the preprocess, colour on its result
PATH_SPEC = (("diff", (4, 8)), ("preprocess", (64, 0, 64, 256), 2, False),
             ("color", RED, None))
GREY_SPEC = (("diff", (4, 8)), ("preprocess", (64, 0, 64, 256), 2, True),
             ("color", BLUE, None))
#: the path's prefix at the optimized plan's crop
OPTIMIZED_SPEC = (("diff", (4, 8)), ("preprocess", (96, 0, 32, 256), 2, False),
                  ("color", RED, None))
PREFIX_CASES = [   # (label, spec, batch, dtype[, frame shape])
    # the four specs of the reference's sweep (tests/test_kernels.py)
    ("sweep diff+color+pre", (("diff", (4, 8)), ("color", RED, None),
                              ("preprocess", (64, 0, 64, 256), 2, False)),
     4, torch.uint8),
    ("sweep crop+grey", (("diff", (4, 4)), ("crop", (32, 0, 64, 256)),
                         ("preprocess", (0, 0, 64, 256), 2, True)),
     4, torch.uint8),
    ("sweep two colours", (("color", RED, (0, 0, 64, 128)),
                           ("color", BLUE, None)), 4, torch.uint8),
    ("sweep transform only", (("crop", (0, 64, 128, 128)),
                              ("preprocess", (0, 0, 128, 128), 4, False)),
     4, torch.uint8),
    ("path B16", PATH_SPEC, 16, torch.uint8),
    ("path B16 float32", PATH_SPEC, 16, torch.float32),
    ("roi colour", (("preprocess", (0, 0, 128, 256), 2, False),
                    ("color", RED, (5, 9, 30, 50))), 4, torch.uint8),
    ("grey preprocess", GREY_SPEC, 4, torch.uint8),
    ("odd crop", (("diff", (2, 2)), ("crop", (3, 5, 90, 150)),
                  ("preprocess", (1, 0, 87, 147), 3, True),
                  ("color", BLUE, None), ("crop", (2, 4, 20, 30))),
     4, torch.uint8),
    ("two preprocess", (("preprocess", (0, 0, 128, 256), 2, False),
                        ("preprocess", (0, 0, 64, 128), 2, False)),
     4, torch.float32),
    # one frame; more clusters than run at once; bands of a cluster that
    # do not divide the rows (127 and 30 rows over 8 blocks)
    ("path B1", PATH_SPEC, 1, torch.uint8),
    ("path B40", PATH_SPEC, 40, torch.uint8),
    ("127 rows", (("diff", (1, 8)), ("preprocess", (63, 0, 64, 256), 2,
                                      False), ("color", RED, None)),
     4, torch.uint8, (3, 127, 256)),
    ("30x50 float32", (("diff", (3, 5)), ("color", BLUE, (5, 9, 20, 30)),
                       ("preprocess", (0, 0, 30, 50), 2, True)),
     4, torch.float32, (3, 30, 50)),
]


def with_signature(spec, shape):
    from repro_torch.kernels.fused_prefix.kernel import out_frame_shape
    from repro_torch.semantic.signature import signature_layout

    gy, gx, _, proj = signature_layout(out_frame_shape(spec, shape))
    return spec + (("signature", (gy, gx)),), torch.from_numpy(proj)


def prefix_checks(compare, frames):
    """fused_prefix against fused_prefix_ref on the card, every output, on
    each case; then, at the main path's shape, the kernel's time (without
    the projection, which is PyTorch work after it), the plain version's,
    the unfused chain's and the bound, and the projection's own time."""
    from repro_torch.kernels.frame_diff.kernel import frame_diff_cuda
    from repro_torch.kernels.fused_prefix.kernel import (BLOCKS,
                                                         cluster_occupancy,
                                                         cluster_plan,
                                                         compile_spec,
                                                         fused_prefix_cuda,
                                                         prefix_kernel)
    from repro_torch.kernels.fused_prefix.ref import (color_frac,
                                                      fused_prefix_ref,
                                                      project_rowwise,
                                                      signature_feats)
    from repro_torch.kernels.fused_preprocess.kernel import \
        fused_preprocess_cuda

    names = ("d", "fracs", "x", "feats", "emb")
    for label, spec, b, dtype, *shape in PREFIX_CASES:
        shape = tuple(shape[0]) if shape else (3, 128, 256)
        f, p = (frames((b,) + shape).to(dtype) for _ in range(2))
        spec, proj = with_signature(spec, shape)
        proj = proj.cuda()
        prev = p if spec[0][0] == "diff" else None
        got = fused_prefix_cuda(f, prev, proj, spec=spec)
        want = fused_prefix_ref(f, prev, proj, spec=spec)
        for name, a, r in zip(names, got, want):
            if r is None:
                check(a is None, f"fused_prefix {label}: {name} not None")
                continue
            pairs = list(zip(a, r)) if name == "fracs" else [(a, r)]
            check(len(pairs) == (len(r) if name == "fracs" else 1)
                  and all(x.dtype == y.dtype for x, y in pairs),
                  f"fused_prefix {label}: {name} count or dtype")
            for i, (x, y) in enumerate(pairs):
                compare("fused_prefix", x, y, f"{label} {name}"
                        + (f"[{i}]" if name == "fracs" else ""))
    f, p = frames((16, 3, 128, 256)), frames((16, 3, 128, 256))
    # the unfused kernels' outputs, bit for bit: phase 8's records rest on it
    for label, pspec in (("path", PATH_SPEC), ("grey", GREY_SPEC),
                         ("optimized", OPTIMIZED_SPEC)):
        d, _, x, _ = prefix_kernel(f, p, spec=pspec)
        crop, factor, grey = pspec[1][1:]
        xp = fused_preprocess_cuda(f, crop=crop, factor=factor, grey=grey)
        same = (torch.equal(d, frame_diff_cuda(f, p, regions=pspec[0][1]))
                and torch.equal(x, xp.expand(-1, 3, -1, -1) if grey else xp))
        print(f"  fused_prefix {label} spec B16: d == frame_diff, x == "
              f"fused_preprocess (torch.equal): {same}")
        check(same, f"fused_prefix {label}: d or x differs from the "
              "unfused kernels'")
    spec, proj = with_signature(PATH_SPEC, (3, 128, 256))
    proj = proj.cuda()
    gy, gx = spec[-1][1]
    clusters = {}
    for dtype in (torch.uint8, torch.float32):
        plan = cluster_plan(compile_spec(spec, (3, 128, 256))[0],
                            (3, 128, 256), dtype.itemsize)
        clusters[dtype] = cluster_occupancy(spec, (3, 128, 256), dtype,
                                            f.device)
        print(f"  fused_prefix B16 path spec {str(dtype)[6:]}: "
              f"{16 * BLOCKS} blocks of 512 threads in clusters of {BLOCKS}, "
              f"{plan['smem']} B of shared memory a block; "
              f"cudaOccupancyMaxActiveClusters {clusters[dtype]}")
        check(clusters[dtype] >= 1, "fused_prefix: no cluster fits the card")

    def plain():        # the plain version of the kernel's work
        signature_feats(fused_prefix_ref(f, p, spec=spec[:-1])[2], gy, gx)

    def unfused():      # the kernel's work, unfused (no projection)
        frame_diff_cuda(f, p, regions=(4, 8))
        x = fused_preprocess_cuda(f, crop=(64, 0, 64, 256), factor=2)
        color_frac(x, RED)
        signature_feats(x, gy, gx)

    # the kernel's bound: frames and prevs read, x, d, fracs, feats written
    n_in, n_crop, n_x = f.numel(), 16 * 3 * 64 * 256, 16 * 3 * 32 * 128
    sig_d = 3 * gy * gx
    nbytes = 2 * n_in + 4 * (n_x + 16 * 32 + 16 + 16 * sig_d)
    ops = 3 * n_in + 2 * n_crop + 12 * n_x // 3 + 3 * n_x
    feats = prefix_kernel(f, p, spec=spec)[3]
    emb_d = proj.shape[1]
    t = dict(
        ms=device_ms(lambda: prefix_kernel(f, p, spec=spec)),
        # ~45 and ~25 PyTorch launches per call: 8 calls per window
        plain_ms=device_ms(plain, n=8),
        unfused_chain_ms=device_ms(unfused, n=8), library_ms=None,
        bound=bound(nbytes, ops),
        # PyTorch's broadcast-multiply-and-sum after the kernel
        projection_ms=device_ms(lambda: project_rowwise(feats, proj)),
        projection_bound=bound(4 * (feats.numel() + proj.numel()
                                    + 16 * emb_d), 2 * 16 * sig_d * emb_d),
        launch_floor_ms=floor_ms(16 * BLOCKS, 512, BLOCKS),
        max_active_clusters=clusters[torch.uint8])
    print(f"  fused_prefix B16 path spec: kernel {t['ms']:.4f} ms, plain "
          f"{t['plain_ms']:.4f} ms, unfused chain "
          f"{t['unfused_chain_ms']:.4f} ms, bound {t['bound'][0]:.5f} ms "
          f"({t['bound'][1]}, {nbytes} B), launch floor "
          f"{t['launch_floor_ms']:.4f} ms (an empty kernel on its cluster "
          f"grid); projection after it {t['projection_ms']:.4f} ms, bound "
          f"{t['projection_bound'][0]:.5f} ms")
    # where the kernel's time goes: the path's spec cut after each stage
    # (the diff alone also copies the raw frame to x)
    cum = [device_ms(lambda k=k: prefix_kernel(f, p, spec=spec[:k]))
           for k in range(1, len(spec) + 1)]
    print("  fused_prefix B16 path spec, kernel ms cut after each stage: "
          + ", ".join(f"{st[0]} {ms:.4f}" for st, ms in zip(spec, cum)))
    return t


def lm_kernel_checks(compare, gen, dev, rows):
    """The served LMs' kernels: decode_attention at gemma2-2b's decode shape
    (4 slots of an 8192-row cache, lengths 7, 30, 4100, 4250; local layer
    with window 4096, global without) and at ragged shapes; ssd_scan at
    mamba2-130m's chunks (a 512-token prefill's two chunks of 256, a
    13-token one) and the reference sweep's grouped shapes;
    flash_attention at gemma2's prefill of an 8192 bucket (D 256, cap 50,
    window 4096).  Adds rows["decode_attention"], rows["ssd_scan"] and
    rows["flash_attention"]["gemma_prefill"]."""
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention.kernel import \
        decode_attention_cuda
    from repro_torch.kernels.decode_attention.ref import \
        decode_attention_plain
    from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
    from repro_torch.kernels.flash_attention.ref import flash_attention_plain
    from repro_torch.kernels.ssd_scan.kernel import ssd_scan_cuda
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref

    def randn(*shape):
        return torch.randn(shape, generator=gen).to(dev)

    def live(lens, window):
        return [n - max(0, n - window) if window else n for n in lens]

    # decode_attention: (B, S, H, Hk, D, kv_len, kw); the decode shapes of
    # gemma2-2b (local and global layers), chatglm3-6b / glm4-9b (32 query
    # heads over 2 kv heads of 128) and phi3-mini-3.8b (32 heads of 96), 4
    # slots of an 8192-row cache, timed at the served ticks' two classes:
    # one long slot beside three short ones (LONG_LENS), and four short
    # slots (SHORT_LENS)
    lens, short = LONG_LENS, SHORT_LENS   # the two classes, timed
    gemma = (4, 8192, 8, 4, 256)
    timed_shapes = {(4, 8192, 8, 4, 256): "gemma2",
                    (4, 8192, 32, 2, 128): "chatglm3_decode",
                    (4, 8192, 32, 32, 96): "phi3_decode"}
    cases = [gemma + (lens, dict(cap=50.0, window=4096)),
             gemma + (lens, dict(cap=50.0)),
             (4, 8192, 32, 2, 128, lens, {}),
             (4, 8192, 32, 32, 96, lens, {}),
             gemma + (short, dict(cap=50.0, window=4096)),
             (4, 8192, 32, 2, 128, short, {}),
             (4, 8192, 32, 32, 96, short, {}),
             (4, 8192, 32, 2, 128, [1, 1, 1, 1], {}),
             gemma + ([7, 30, 4100, 4250], dict(cap=50.0, window=4096)),
             (4, 8192, 32, 2, 128, [7, 30, 4100, 4250], {}),  # two long
             (4, 8192, 8, 4, 256, [40, 300, 1000, 2000],
              dict(cap=50.0, window=4096)),          # window > every slot
             (4, 8192, 32, 2, 128, [6, 129, 2049, 8192], {}),  # glm4-9b
             (2, 1000, 8, 8, 16, [999, 161], dict(window=517)),
             (2, 64, 4, 2, 32, [1, 1], {}),                # kv_len = 1
             (2, 64, 4, 2, 32, [5, 64], dict(window=100)),  # window > len
             (2, 64, 4, 4, 32, [17, 3], dict(cap=20.0)),    # G = 1
             (3, 96, 8, 2, 64, [1, 9, 96], dict(window=8)),  # D = 64
             (2, 300, 4, 2, 32, [299, 300], dict(window=50))]  # S % 256
    timed = {}
    for b, s, h, hk, d, lens, kw in cases:
        q, k, v = randn(b, 1, h, d), randn(b, s, hk, d), randn(b, s, hk, d)
        kv_len = torch.tensor(lens, dtype=torch.int32, device=dev)[:, None]
        compare("decode_attention",
                decode_attention_cuda(q, k, v, kv_len, **kw),
                decode_attention_plain(q, k, v, kv_len, **kw),
                f"B{b} S{s} H{h}/{hk} D{d} len {lens} {kw}")
        which = timed_shapes.get((b, s, h, hk, d))
        if which is None or lens not in (LONG_LENS, SHORT_LENS):
            continue
        if which == "gemma2":
            which = "local" if kw.get("window") else "global"
        if lens == SHORT_LENS:
            which = which.replace("_decode", "") + "_short"
        n_live = sum(live(lens, kw.get("window")))
        nbytes = 4 * (2 * q.numel() + 2 * hk * d * n_live + b)
        ops = 4 * d * (h // hk) * hk * n_live
        # PyTorch's SDPA on the same GQA problem with the same visible keys
        # as a boolean mask, without the soft-cap (SDPA cannot take one)
        kpos = torch.arange(s, device=dev)[None, :]
        mask = kpos < kv_len
        if kw.get("window"):
            mask &= kpos > kv_len - 1 - kw["window"]
        qh, kh, vh = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        t = dict(
            ms=device_ms(lambda: decode_attention_cuda(q, k, v, kv_len, **kw)),
            plain_ms=device_ms(lambda: decode_attention_plain(q, k, v, kv_len,
                                                              **kw), n=8),
            library_ms=device_ms(lambda: F.scaled_dot_product_attention(
                qh, kh, vh, attn_mask=mask[:, None, None, :],
                enable_gqa=True)),
            bound=bound(nbytes, ops), live_keys=n_live, bytes=nbytes)
        timed[which] = t
        print(f"  decode_attention {which} decode B4 S8192 H{h}/{hk} D{d} "
              f"len {lens} {kw} ({n_live} live keys x {hk} kv heads): kernel "
              f"{t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, SDPA "
              f"without the cap {t['library_ms']:.4f} ms, bound "
              f"{t['bound'][0]:.5f} ms ({t['bound'][1]}, {nbytes} B)")
    rows["decode_attention"] = {**timed.pop("local"), **timed}

    # ssd_scan: (BC, H, G, Q, P, N)
    ssd_rows = {}
    for bc, h, g, q, p, n in [(2, 24, 1, 256, 64, 128), (1, 24, 1, 13, 64, 128),
                              (4, 8, 4, 64, 16, 8), (2, 4, 2, 32, 16, 8),
                              (1, 24, 2, 13, 64, 128), (2, 8, 2, 200, 128, 256),
                              (1, 6, 3, 77, 24, 13)]:
        x = randn(bc, h, q, p)
        bm, cm = 0.3 * randn(bc, g, q, n), 0.3 * randn(bc, g, q, n)
        dt = F.softplus(randn(bc, h, 1, q))
        a = -torch.exp(0.2 * randn(h))
        cs = torch.cumsum(dt * a[None, :, None, None], dim=-1).contiguous()
        args = (x, bm, cm, cs, dt)
        got, want = ssd_scan_cuda(*args), ssd_scan_ref(*args)
        for name, a_, b_ in zip(("y_diag", "s_local"), got, want):
            compare("ssd_scan", a_, b_,
                    f"BC{bc} H{h} G{g} Q{q} P{p} N{n} {name}")
        if (h, g) != (24, 1):
            continue
        # C.B once per (chunk, group); per head its pairs' P-wide sums and
        # the local state
        pairs = q * (q + 1) // 2
        ops = bc * g * 2 * n * pairs + bc * h * (2 * p * pairs + 2 * q * n * p)
        nbytes = 4 * (2 * x.numel() + 2 * bm.numel() + 2 * cs.numel()
                      + bc * h * n * p)
        t = dict(ms=device_ms(lambda: ssd_scan_cuda(*args)),
                 plain_ms=device_ms(lambda: ssd_scan_ref(*args), n=8),
                 library_ms=None, bound=bound(nbytes, ops))
        ssd_rows[q] = t
        print(f"  ssd_scan mamba2 BC{bc} H24 Q{q} P64 N128: kernel "
              f"{t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, no library "
              f"call, bound {t['bound'][0]:.5f} ms ({t['bound'][1]})")
    rows["ssd_scan"] = {**ssd_rows[256], "q13": ssd_rows[13]}

    # flash_attention at gemma2's prefill of an 8192 bucket, local layer
    s, w = 8192, 4096
    q, k, v = randn(1, s, 8, 256), randn(1, s, 4, 256), randn(1, s, 4, 256)
    kw = dict(causal=True, cap=50.0, window=w)

    def plain():
        return flash_attention_plain(q, k, v, **kw)

    compare("flash_attention", flash_attention_cuda(q, k, v, **kw), plain(),
            f"B1 S{s} H8/4 D256 {kw}")
    pairs = w * (w + 1) // 2 + (s - w) * w
    pos = torch.arange(s, device=dev)
    mask = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - w)
    qh, kh, vh = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    nbytes, ops = 4 * (2 * q.numel() + 2 * k.numel()), 4 * 256 * pairs * 8
    t = dict(ms=device_ms(lambda: flash_attention_cuda(q, k, v, **kw), n=2,
                          reps=3),
             plain_ms=device_ms(plain, n=1, reps=3),
             library_ms=device_ms(lambda: F.scaled_dot_product_attention(
                 qh, kh, vh, attn_mask=mask, enable_gqa=True), n=2, reps=3),
             bound=bound(nbytes, ops, FLASH_OPS_S))
    rows["flash_attention"]["gemma_prefill"] = t
    flash_line("gemma2 prefill B1 S8192 H8/4 D256 cap 50 window 4096", t,
               nbytes, ops, "SDPA without the cap")
    del q, k, v, qh, kh, vh, mask

    # flash_attention at chatglm3-6b's (32/2 heads of 128: a group of 16,
    # 4 positions per tile) and phi3-mini's (32/32 of 96) causal prefill of
    # an 8192 bucket
    for which, h, hk, d in (("chatglm3_prefill", 32, 2, 128),
                            ("phi3_prefill", 32, 32, 96)):
        q, k, v = randn(1, s, h, d), randn(1, s, hk, d), randn(1, s, hk, d)

        def plain():
            return flash_attention_plain(q, k, v, causal=True)

        compare("flash_attention", flash_attention_cuda(q, k, v), plain(),
                f"B1 S{s} H{h}/{hk} D{d} causal")
        nbytes = 4 * (2 * q.numel() + 2 * k.numel())
        ops = 4 * d * s * (s + 1) // 2 * h
        qh, kh, vh = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        t = dict(ms=device_ms(lambda: flash_attention_cuda(q, k, v), n=2,
                              reps=3),
                 plain_ms=device_ms(plain, n=1, reps=3),
                 library_ms=device_ms(lambda: F.scaled_dot_product_attention(
                     qh, kh, vh, is_causal=True, enable_gqa=True), n=2,
                     reps=3),
                 bound=bound(nbytes, ops, FLASH_OPS_S))
        rows["flash_attention"][which] = t
        flash_line(f"{which} B1 S{s} H{h}/{hk} D{d} causal", t, nbytes, ops)
        del q, k, v, qh, kh, vh
        torch.cuda.empty_cache()


#: the rectangular flash kernel's shapes (Sq queries against Sk keys, no
#: mask: cross attention), phase 2's forward and phase 18 (a)'s backward,
#: label -> (B, Sq, Sk, H, Hk, D, options): seamless-m4t-medium's prefill
#: cross attention (4 requests' 16-token prompts against 1024 frames) and
#: its training micro-batch's (4 x 128 tokens against 512 frames), then a
#: ragged, a capped and a shorter key side
CROSS_SHAPES = {"seamless_prefill_cross": (4, 16, 1024, 16, 16, 64, {}),
                "seamless_train_cross": (4, 128, 512, 16, 16, 64, {}),
                "ragged": (2, 45, 130, 8, 4, 32, {}),
                "capped": (2, 33, 257, 4, 2, 128, dict(cap=20.0)),
                "sk_below_sq": (2, 200, 77, 8, 8, 64, {})}
#: the timed ones (the kernels line's rows)
CROSS_TIMED = ("seamless_prefill_cross", "seamless_train_cross")
#: seamless-m4t-medium's cross attention at a decode step: 4 requests'
#: one token against 1024 frames, 16 heads of 64 over 16 (G 1)
CROSS_DECODE = (4, 1024, 16, 16, 64)


def cross_kernel_checks(compare, gen, dev, rows):
    """The rectangular flash kernel (``CROSS_SHAPES``, ``causal=False``)
    against its plain version, with ``causal=True`` at Sq != Sk refused;
    its times at ``CROSS_TIMED`` beside the plain version and SDPA (one
    ``enable_gqa`` call, no mask); and decode_attention at the seamless
    cross decode (``CROSS_DECODE``, kv_len the whole 1024 frames) timed.
    Adds rows["flash_attention"][label] and
    rows["decode_attention"]["seamless_cross_decode"]."""
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention.kernel import \
        decode_attention_cuda
    from repro_torch.kernels.decode_attention.ref import \
        decode_attention_plain
    from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
    from repro_torch.kernels.flash_attention.ref import flash_attention_plain

    def randn(*shape):
        return torch.randn(shape, generator=gen).to(dev)

    for label, (b, sq, sk, h, hk, d, kw) in CROSS_SHAPES.items():
        q, k, v = randn(b, sq, h, d), randn(b, sk, hk, d), randn(b, sk, hk, d)
        kw = dict(causal=False, **kw)
        compare("flash_attention", flash_attention_cuda(q, k, v, **kw),
                flash_attention_plain(q, k, v, **kw),
                f"{label} B{b} Sq{sq} Sk{sk} H{h}/{hk} D{d}")
        try:
            flash_attention_cuda(q, k, v, causal=True)
        except ValueError:
            pass
        else:
            raise SmokeFailure(f"flash_attention {label}: causal at Sq {sq} "
                               f"!= Sk {sk} was not refused")
        if label not in CROSS_TIMED:
            continue
        nbytes = 4 * (2 * q.numel() + 2 * k.numel())
        ops = 4 * d * sq * sk * h * b
        qh, kh, vh = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        t = dict(ms=device_ms(lambda: flash_attention_cuda(q, k, v, **kw)),
                 plain_ms=device_ms(lambda: flash_attention_plain(
                     q, k, v, **kw), n=8),
                 library_ms=device_ms(lambda: F.scaled_dot_product_attention(
                     qh, kh, vh, enable_gqa=True)),
                 bound=bound(nbytes, ops, FLASH_OPS_S))
        rows["flash_attention"][label] = t
        flash_line(f"{label} B{b} Sq{sq} Sk{sk} H{h}/{hk} D{d}", t, nbytes,
                   ops)
    b, s, h, hk, d = CROSS_DECODE
    q, k, v = randn(b, 1, h, d), randn(b, s, hk, d), randn(b, s, hk, d)
    kv_len = torch.full((b, 1), s, dtype=torch.int32, device=dev)
    compare("decode_attention", decode_attention_cuda(q, k, v, kv_len),
            decode_attention_plain(q, k, v, kv_len),
            f"seamless cross B{b} S{s} H{h}/{hk} D{d} len {s}")
    nbytes = 4 * (2 * q.numel() + 2 * k.numel() + b)
    qh, kh, vh = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    t = dict(ms=device_ms(lambda: decode_attention_cuda(q, k, v, kv_len)),
             plain_ms=device_ms(lambda: decode_attention_plain(
                 q, k, v, kv_len), n=8),
             library_ms=device_ms(lambda: F.scaled_dot_product_attention(
                 qh, kh, vh, enable_gqa=True)),
             bound=bound(nbytes, 4 * d * h * s * b), live_keys=s * b,
             bytes=nbytes)
    rows["decode_attention"]["seamless_cross_decode"] = t
    print(f"  decode_attention seamless cross decode B{b} S{s} H{h}/{hk} "
          f"D{d} (G 1: fp64 scores): kernel {t['ms']:.4f} ms, plain "
          f"{t['plain_ms']:.4f} ms, SDPA {t['library_ms']:.4f} ms, bound "
          f"{t['bound'][0]:.5f} ms ({t['bound'][1]}, {nbytes} B)")


def attention64(q, k, v, mask, cap=None):
    """float64 attention in model layout, the value both fp32 versions are
    measured against: q (B, Sq, H, D), k/v (B, S, Hk, D), mask (B, Sq, S)
    of the visible keys, the logits soft-capped at ``cap`` when given."""
    b, sq, h, d = q.shape
    hk = k.shape[2]
    qg = q.double().reshape(b, sq, hk, h // hk, d)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.double()) / math.sqrt(d)
    if cap is not None:
        logits = cap * torch.tanh(logits / cap)
    logits = logits.masked_fill(~mask[:, None, None], float("-inf"))
    out = torch.einsum("bhgqk,bkhd->bqhgd", torch.softmax(logits, -1),
                       v.double())
    return out.reshape(b, sq, h, d)


def ssd64(x, bm, cm, cs, dt):
    """The within-chunk SSD terms in float64 from the same inputs (kernel
    layout), the values both fp32 versions are measured against: y_diag
    (BC, H, Q, P) and s_local (BC, H, N, P)."""
    x, bm, cm, cs, dt = (t.double() for t in (x, bm, cm, cs, dt))
    rep = x.shape[1] // bm.shape[1]
    bh, ch = (torch.repeat_interleave(t, rep, dim=1) for t in (bm, cm))
    c, d = cs[:, :, 0], dt[:, :, 0]
    q = x.shape[2]
    causal = torch.ones(q, q, dtype=torch.bool, device=x.device).tril()
    seg = (c[..., :, None] - c[..., None, :]).masked_fill(~causal,
                                                          float("-inf"))
    w = torch.einsum("bhin,bhjn->bhij", ch, bh) * torch.exp(seg) \
        * d[..., None, :]
    y = torch.einsum("bhij,bhjp->bhip", w, x)
    s = torch.einsum("bhqn,bhq,bhqp->bhnp", bh,
                     torch.exp(c[..., -1:] - c) * d, x)
    return y, s


def magnitude_checks(gen, dev):
    """decode_attention and flash_attention at chatglm3-6b's (a group of
    16) and phi3-mini's (D 96) shapes with q, k, v at the magnitudes the
    model gives them (``MAG_SHAPES``): the decode shape of phase 2 (4 slots
    of 8192, lengths 7/30/4100/4250) and a causal prefill of 2048; and
    ssd_scan at mamba2-130m's prefill of two chunks and of 13 tokens, with
    phase 2's inputs.  The attention kernels are held to their plain
    version within ``MAG_TOL`` of the largest magnitude; every kernel to
    float64 within ``MAG_WITNESS`` times the farther of the plain version
    on the card and on the CPU."""
    from repro_torch.kernels.decode_attention.kernel import \
        decode_attention_cuda
    from repro_torch.kernels.decode_attention.ref import \
        decode_attention_plain
    from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
    from repro_torch.kernels.flash_attention.ref import flash_attention_plain

    lens = torch.tensor([7, 30, 4100, 4250], dtype=torch.int32)[:, None]
    for name, (dm, h, hk, d) in MAG_SHAPES.items():
        for kind, b, sq, s in (("decode", 4, 1, 8192),
                               ("prefill", 1, 2048, 2048)):
            q = math.sqrt(dm / h) * torch.randn(b, sq, h, d, generator=gen)
            k, v = (math.sqrt(dm / hk) * torch.randn(b, s, hk, d,
                                                     generator=gen)
                    for _ in range(2))
            if kind == "decode":
                mask = torch.arange(s)[None, None, :] < lens[:, :, None]

                def kernel(q, k, v):
                    return decode_attention_cuda(q, k, v, lens.to(q.device))

                def plain(q, k, v):
                    return decode_attention_plain(q, k, v, lens.to(q.device))
            else:
                mask = torch.ones(s, s, dtype=torch.bool).tril()[None]
                kernel, plain = flash_attention_cuda, flash_attention_plain
            card = [t.to(dev) for t in (q, k, v)]
            got, want = kernel(*card).cpu(), plain(*card).cpu()
            cpu = plain(q, k, v)
            exact = attention64(*card, mask.to(dev)).cpu()
            top = exact.abs().max().item()
            far = {n: (x.double() - exact).abs().max().item() / top
                   for n, x in (("kernel", got), ("plain", want),
                                ("cpu", cpu))}
            rel = ((got - want).abs().max() / want.abs().max()).item()
            rel_cpu = ((got - cpu).abs().max() / cpu.abs().max()).item()
            label = (f"{name} {kind} B{b} S{s} H{h}/{hk} D{d}, q std "
                     f"{math.sqrt(dm / h):.2f}, k/v std "
                     f"{math.sqrt(dm / hk):.2f}")
            print(f"  magnitudes {label}: kernel vs plain {rel:.3e} of the "
                  f"largest |out| {top:.1f} (tol {MAG_TOL:g}), vs the plain "
                  f"version on the CPU {rel_cpu:.3e}; vs float64: "
                  f"kernel {far['kernel']:.3e}, plain on the card "
                  f"{far['plain']:.3e}, plain on the CPU {far['cpu']:.3e}")
            check(torch.isfinite(got).all() and rel <= MAG_TOL,
                  f"magnitudes {label}: kernel vs plain {rel}")
            check(far["kernel"] <= MAG_WITNESS * max(far["plain"],
                                                     far["cpu"]),
                  f"magnitudes {label}: the kernel is {far['kernel']} from "
                  f"float64, the plain versions {far['plain']} (card) and "
                  f"{far['cpu']} (CPU)")
            del card, got, want, cpu, exact
        torch.cuda.empty_cache()

    from repro_torch.kernels.ssd_scan.kernel import ssd_scan_cuda
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref
    for bc, q in ((2, 256), (1, 13)):
        x = torch.randn(bc, 24, q, 64, generator=gen)
        bm, cm = (0.3 * torch.randn(bc, 1, q, 128, generator=gen)
                  for _ in range(2))
        dt = torch.nn.functional.softplus(torch.randn(bc, 24, 1, q,
                                                      generator=gen))
        a = -torch.exp(0.2 * torch.randn(24, generator=gen))
        cs = torch.cumsum(dt * a[None, :, None, None], dim=-1).contiguous()
        args = (x, bm, cm, cs, dt)
        card = [t.to(dev) for t in args]
        outs = {"kernel": ssd_scan_cuda(*card), "plain": ssd_scan_ref(*card),
                "cpu": ssd_scan_ref(*args)}
        for i, term in enumerate(("y_diag", "s_local")):
            exact = ssd64(*card)[i].cpu()
            top = exact.abs().max().item()
            far = {n: (o[i].cpu().double() - exact).abs().max().item() / top
                   for n, o in outs.items()}
            label = f"ssd_scan mamba2 BC{bc} H24 Q{q} P64 N128 {term}"
            print(f"  magnitudes {label}: vs float64 (of the largest |out| "
                  f"{top:.2f}): kernel {far['kernel']:.3e}, plain on the "
                  f"card {far['plain']:.3e}, plain on the CPU "
                  f"{far['cpu']:.3e}")
            check(torch.isfinite(outs["kernel"][i]).all()
                  and far["kernel"] <= MAG_WITNESS * max(far["plain"],
                                                         far["cpu"]),
                  f"magnitudes {label}: the kernel is {far['kernel']} from "
                  f"float64, the plain versions {far['plain']} (card) and "
                  f"{far['cpu']} (CPU)")


#: the bf16 kernels' float64 gate: against float64 on the same bf16
#: inputs, the kernel no farther than BF16_WITNESS times the plain bf16
#: output (fp32 inside, rounded once), plus one bf16 ulp of the largest
#: output (two roundings of one value can part by an ulp)
BF16_WITNESS = 2.0
#: the timed S8192 prefills are held to float64 on their last rows (every
#: key visible to them; a float64 softmax over all 8192 rows is 17 GB)
BF16_F64_ROWS = 256


def bf16_ulp(top):
    """One bf16 ulp at magnitude ``top`` (8 significant bits)."""
    return 2.0 ** (math.floor(math.log2(top)) - 7) if top > 0 else 0.0


#: the bf16 float64 gate's worst kernel distance over the bar, by kernel
BF16_F64 = {"flash_attention_bf16": 0.0, "decode_attention_bf16": 0.0,
            "flash_attention_bwd_bf16": 0.0}


def bf16_vs_float64(name, got, plain, exact, label, floor=0.0):
    """The bf16 kernel's output ``got`` and the plain version's ``plain``
    against ``exact`` (float64 on the same bf16 inputs): the kernel within
    BF16_WITNESS times the plain version's distance plus one bf16 ulp of
    the largest |exact| (plus ``floor``)."""
    got, plain, exact = (t.double().cpu() for t in (got, plain, exact))
    top = exact.abs().max().item()
    d_k = (got - exact).abs().max().item()
    d_p = (plain - exact).abs().max().item()
    bar = BF16_WITNESS * d_p + bf16_ulp(top) + floor
    BF16_F64[name] = max(BF16_F64[name], d_k / bar if bar else 0.0)
    check(d_k <= bar, f"{name} {label}: {d_k:.3e} from float64, the plain "
          f"bf16 version {d_p:.3e} (bar {bar:.3e})")
    return d_k, d_p


def flash_mask(sq, sk, kw, dev):
    """(1, Sq, Sk) visible keys of flash_attention's options."""
    if not kw.get("causal", True):
        return torch.ones(1, sq, sk, dtype=torch.bool, device=dev)
    pos = torch.arange(sq, device=dev)
    mask = pos[None, :] <= pos[:, None]
    if kw.get("window"):
        mask &= pos[None, :] > pos[:, None] - kw["window"]
    return mask[None]


#: flash_attention_bf16's sweep (phase 2): groups of queries on a kv head,
#: and lengths about its 64-row warpgroups and 128-key tiles (64 keys at D
#: 256, ``fwd_bf16_plan``'s "keys"), one of them a multiple of neither
BF16_GROUPS = (1, 2, 4, 8, 16, 64)
BF16_EDGE_S = (63, 64, 65, 127, 128, 129, 1000)
#: flash_attention_bf16's timed shapes (phase 2): the served LMs' prefill
#: of an 8192 bucket (chatglm3-6b first: phase 21's path), moonshot's (16
#: heads of 128, G 1) and chatglm3's at a short prompt's bucket of 64
#: tokens; (B, S, H, Hk, D, options)
BF16_TIMED = {
    "chatglm3_prefill": (1, 8192, 32, 2, 128, dict(causal=True)),
    "phi3_prefill": (1, 8192, 32, 32, 96, dict(causal=True)),
    "gemma2_prefill": (1, 8192, 8, 4, 256,
                       dict(causal=True, cap=50.0, window=4096)),
    "moonshot_prefill": (1, 8192, 16, 16, 128, dict(causal=True)),
    "short_prefill": (1, 64, 32, 2, 128, dict(causal=True))}


def bf16_flash_cases():
    """(B, Sq, Sk, H, Hk, D, options) of phase 2's flash_attention_bf16
    sweep: every head dim and group of ``BF16_GROUPS`` (one kv head at G
    64, else two) at S 1, 33 and 257, bidirectional, capped and with a
    window of 7, and causal at ``BF16_EDGE_S``; at S 1000, groups 1, 4 and
    16 with a window one key shorter and one longer than a key tile; groups
    3 and 6 (which do not divide the 128-row tile, so its last rows stay
    unloaded) at S 65 and 257, causal and with a window of 7."""
    from repro_torch.kernels.flash_attention.kernel import (HEAD_DIMS,
                                                            fwd_bf16_plan)

    cases = []
    for d in HEAD_DIMS:
        for g in BF16_GROUPS:
            hk = 1 if g == 64 else 2
            for s in (1, 33, 257):
                for kw in (dict(causal=False), dict(causal=True, cap=20.0),
                           dict(causal=True, window=7)):
                    cases.append((1, s, s, g * hk, hk, d, kw))
            for s in BF16_EDGE_S:
                cases.append((1, s, s, g * hk, hk, d, dict(causal=True)))
        bk = fwd_bf16_plan(1, 1000, 1000, 2, 2, d)["keys"]
        for g in (1, 4, 16):
            for w in (bk - 1, bk + 1):
                cases.append((1, 1000, 1000, 2 * g, 2, d,
                              dict(causal=True, window=w)))
        for g in (3, 6):
            for s in (65, 257):
                for kw in (dict(causal=True), dict(causal=True, window=7)):
                    cases.append((1, s, s, 2 * g, 2, d, kw))
    return cases


def bf16_plan_match():
    """The host plan (``kernel.py::fwd_bf16_plan``) is the built library's
    (``flash_attention_bf16_config``) at every head dim; printed side by
    side."""
    from repro_torch.kernels._build import load_library
    from repro_torch.kernels.flash_attention.kernel import (
        BF16_CONFIG_KEYS, HEAD_DIMS, fwd_bf16_plan)

    fn = load_library("flash_attention").flash_attention_bf16_config
    fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    for d in HEAD_DIMS:
        got = (ctypes.c_int * len(BF16_CONFIG_KEYS))()
        check(fn(d, got) == 0, f"flash_attention_bf16_config({d}) failed")
        plan = fwd_bf16_plan(1, 8192, 8192, 32, 2, d)
        want = [plan[k] for k in BF16_CONFIG_KEYS]
        print(f"  flash_attention_bf16 D{d}: the library's "
              f"{dict(zip(BF16_CONFIG_KEYS, got))}, the plan's "
              f"{dict(zip(BF16_CONFIG_KEYS, want))}")
        check(list(got) == want, f"flash_attention_bf16 D{d}: the library "
              f"{list(got)}, the plan {want}")


#: the served long ticks' shapes (B4 S8192) whose long slot
#: ``bf16_decode_edges`` sets about the bf16 decode kernel's splits and
#: stages: (H, Hk, D, options)
BF16_EDGE_TICKS = {"chatglm3": (32, 2, 128, {}),
                   "gemma2": (8, 4, 256, dict(cap=50.0, window=4096)),
                   "phi3": (32, 32, 96, {}), "moonshot": (16, 16, 128, {})}


def bf16_decode_edges(dev):
    """decode_attention_bf16's edge cases, (B, S, H, Hk, D, lens, options,
    label): at each of ``BF16_EDGE_TICKS`` the long slot's length one key
    past and one short of a split boundary, and one key either side of a
    stage (``BF16_STAGE`` keys) inside its last split, as this card's plan
    cuts it (a last split of one key only where splits are a stage)
    (``kernel.py``'s mirror, on the wrapper's occupancy figures); at
    chatglm3's, lengths whose last cluster is partly empty; and G 3, G 16
    at D 256, G 1 at D 96, windows shorter than a split."""
    from repro_torch.kernels.decode_attention import kernel as dk

    cases = []
    for model, (h, hk, d, kw) in BF16_EDGE_TICKS.items():
        occ = dk._occupancy_bf16(dev, d, h // hk)
        nb = dk.bf16_blocks(4, hk, 8192, kw.get("window"), *occ)
        c, ncl = dk.bf16_grid(4, nb)
        found = {}
        for n_long in range(3500, 4800):
            n, chunk, used = dk.bf16_plan([7, 23, 30, n_long], ncl, c)[-1]
            if model == "chatglm3" and used % c == 0:
                continue       # a last cluster partly empty
            live = min(n_long, kw.get("window") or n_long)
            rest = live - (used - 1) * chunk     # the last split's keys
            # a stage boundary inside the split (at a split of one stage,
            # the split's own)
            st = dk.BF16_STAGE
            inner = chunk == st or 1 < rest < chunk - 1
            for key, hit in (("split+1", rest == 1),
                             ("split-1", rest == chunk - 1),
                             ("stage+1", rest % st == 1 and inner),
                             ("stage-1", rest % st == st - 1 and inner)):
                if hit and key not in found:
                    found[key] = n_long
        # a last split of one key exists only where splits are pinned at a
        # stage (the plan balances longer ones: rest > chunk / 2)
        check({"split-1", "stage+1", "stage-1"} <= set(found),
              f"decode_attention_bf16 {model}: edges {found} (clusters of "
              f"{c}, {ncl} a kv head)")
        print(f"  decode_attention_bf16 {model}: clusters of {c}, {ncl} a "
              f"kv head; the long slot's edge lengths {found}")
        for n_long in sorted(set(found.values())):
            keys = "/".join(k_ for k_, n_ in found.items() if n_ == n_long)
            cases.append((4, 8192, h, hk, d, [7, 23, 30, n_long], kw,
                          f"{model} {keys}"))
    return cases + [
        (4, 4096, 6, 2, 128, [7, 23, 30, 4000], {}, "G 3"),
        (4, 2048, 32, 2, 256, [7, 23, 30, 2000], dict(cap=50.0),
         "G 16 at D 256"),
        (2, 2048, 4, 4, 96, [1, 2047], {}, "G 1 at D 96"),
        (4, 8192, 32, 2, 128, LONG_LENS, dict(window=40),
         "a window shorter than a split"),
        (4, 8192, 8, 4, 256, LONG_LENS, dict(cap=50.0, window=100),
         "a window shorter than a split")]


def bf16_kernel_checks(compare, gen, dev, rows):
    """flash_attention_bf16 and decode_attention_bf16 on bf16 inputs: the
    flash plan against the library's figures, the flash sweep
    (``bf16_flash_cases``) and ``CROSS_SHAPES``, and the flash kernel at
    ``MAG_SHAPES``' magnitudes (a causal prefill of 2048, scores in the
    hundreds); decode at gemma2's (local and global), chatglm3's and
    phi3-mini's decode shapes (the served ticks' two classes and ragged
    slots) and the seamless cross decode.  Each held to its plain version
    (TOL) and to float64 on the same inputs (``bf16_vs_float64``); the
    flash kernel's two launches equal bit for bit at every timed shape;
    timed at the served LMs' shapes (``BF16_TIMED``) beside PyTorch's SDPA
    in bf16 (a yardstick only), bound by 2 bytes an element and 989
    TFLOP/s, the flash kernel's own ceiling (6 D operations a pair: P.V
    on two terms) beside it.  Adds rows["flash_attention_bf16"] and
    rows["decode_attention_bf16"]."""
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention.kernel import \
        decode_attention_cuda
    from repro_torch.kernels.decode_attention.ref import \
        decode_attention_plain
    from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
    from repro_torch.kernels.flash_attention.ref import flash_attention_plain

    bf = torch.bfloat16
    cgen = torch.Generator(device=dev).manual_seed(27)

    def randn(*shape, std=1.0):
        return (std * torch.randn(shape, generator=gen)).to(dev, bf)

    def randn_dev(*shape):
        return torch.randn(shape, generator=cgen, device=dev).to(bf)

    def flash_case(q, k, v, kw, label, rows64=None):
        got = flash_attention_cuda(q, k, v, **kw)
        plain = flash_attention_plain(q, k, v, **kw)
        check(got.dtype == bf, f"flash_attention_bf16 {label}: {got.dtype}")
        compare("flash_attention_bf16", got, plain, label)
        sq, sk = q.shape[1], k.shape[1]
        r0 = 0 if rows64 is None else sq - rows64
        exact = attention64(q[:, r0:], k, v,
                            flash_mask(sq, sk, kw, dev)[:, r0:],
                            kw.get("cap"))
        bf16_vs_float64("flash_attention_bf16", got[:, r0:], plain[:, r0:],
                        exact, label)
        return got

    bf16_plan_match()
    t0 = time.perf_counter()
    cases = bf16_flash_cases()
    for b, sq, sk, h, hk, d, kw in cases:
        # the edge lengths' inputs are drawn on the card (large ones at S
        # 1000 would take seconds on the CPU generator)
        draw = randn if sq in (1, 33, 257) else randn_dev
        flash_case(draw(b, sq, h, d), draw(b, sk, hk, d), draw(b, sk, hk, d),
                   kw, f"B{b} S{sq} H{h}/{hk} D{d} {kw}")
    for label, (b, sq, sk, h, hk, d, kw) in CROSS_SHAPES.items():
        flash_case(randn(b, sq, h, d), randn(b, sk, hk, d),
                   randn(b, sk, hk, d), dict(causal=False, **kw),
                   f"{label} B{b} Sq{sq} Sk{sk} H{h}/{hk} D{d}")
    for name, (dm, h, hk, d) in MAG_SHAPES.items():
        s = 2048
        q = randn(1, s, h, d, std=math.sqrt(dm / h))
        k, v = (randn(1, s, hk, d, std=math.sqrt(dm / hk)) for _ in range(2))
        flash_case(q, k, v, dict(causal=True),
                   f"magnitudes {name} prefill B1 S{s} H{h}/{hk} D{d}, q std "
                   f"{math.sqrt(dm / h):.2f}, k/v std "
                   f"{math.sqrt(dm / hk):.2f}")
        del q, k, v
    torch.cuda.empty_cache()
    print(f"  flash_attention_bf16: {len(cases)} sweep, "
          f"{len(CROSS_SHAPES)} cross and {len(MAG_SHAPES)} magnitude cases "
          f"in {time.perf_counter() - t0:.1f} s; against float64 at most "
          f"{BF16_F64['flash_attention_bf16']:.3f} of the bar")

    # timed (the 8192 buckets held to float64 on their last rows), each
    # launched twice more: equal bit for bit
    flash_rows = {}
    for which, (b, s, h, hk, d, kw) in BF16_TIMED.items():
        label = f"{which} B{b} S{s} H{h}/{hk} D{d} {kw}"
        q, k, v = randn(b, s, h, d), randn(b, s, hk, d), randn(b, s, hk, d)
        got = flash_case(q, k, v, kw, label,
                         rows64=BF16_F64_ROWS if s > BF16_F64_ROWS else None)
        check(torch.equal(got, flash_attention_cuda(q, k, v, **kw)) and
              torch.equal(got, flash_attention_cuda(q, k, v, **kw)),
              f"flash_attention_bf16 {label}: two launches differ")
        w = kw.get("window")
        pairs = (w * (w + 1) // 2 + (s - w) * w) if w else s * (s + 1) // 2
        nbytes, ops = 2 * (2 * q.numel() + 2 * k.numel()), 4 * d * pairs * h
        qh, kh, vh = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        mask = flash_mask(s, s, kw, dev)[0] if w else None
        n, reps = (2, 3) if s > 1024 else (40, 5)
        t = dict(ms=device_ms(lambda: flash_attention_cuda(q, k, v, **kw),
                              n=n, reps=reps),
                 plain_ms=device_ms(lambda: flash_attention_plain(
                     q, k, v, **kw), n=1 if s > 1024 else 8, reps=3),
                 library_ms=device_ms(lambda: F.scaled_dot_product_attention(
                     qh, kh, vh, attn_mask=mask, is_causal=mask is None,
                     enable_gqa=True), n=n, reps=reps),
                 bound=bound(nbytes, ops, BF16_OPS_S))
        flash_rows[which] = t
        print(f"  flash_attention_bf16 {label}: kernel {t['ms']:.4f} ms, "
              f"plain {t['plain_ms']:.4f} ms, SDPA bf16"
              f"{' without the cap' if kw.get('cap') else ''} "
              f"{t['library_ms']:.4f} ms, bound {t['bound'][0]:.5f} ms "
              f"({t['bound'][1]}, bf16 at {BF16_OPS_S / 1e12:.0f} TFLOP/s), "
              f"the kernel's own ceiling {1.5 * ops / BF16_OPS_S * 1e3:.5f} "
              f"ms (6 D "
              f"operations a pair); two launches equal bit for bit")
        del q, k, v, qh, kh, vh, mask, got
        torch.cuda.empty_cache()
    b, sq, sk, h, hk, d, kw = CROSS_SHAPES["seamless_prefill_cross"]
    q, k, v = randn(b, sq, h, d), randn(b, sk, hk, d), randn(b, sk, hk, d)
    qh, kh, vh = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    ops = 4 * d * sq * sk * h * b
    t = dict(ms=device_ms(lambda: flash_attention_cuda(q, k, v,
                                                       causal=False)),
             plain_ms=device_ms(lambda: flash_attention_plain(
                 q, k, v, causal=False), n=8),
             library_ms=device_ms(lambda: F.scaled_dot_product_attention(
                 qh, kh, vh, enable_gqa=True)),
             bound=bound(2 * (2 * q.numel() + 2 * k.numel()), ops,
                         BF16_OPS_S))
    flash_rows["seamless_prefill_cross"] = t
    print(f"  flash_attention_bf16 seamless_prefill_cross: kernel "
          f"{t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, SDPA bf16 "
          f"{t['library_ms']:.4f} ms, bound {t['bound'][0]:.5f} ms "
          f"({t['bound'][1]})")
    rows["flash_attention_bf16"] = {**flash_rows.pop("chatglm3_prefill"),
                                    **flash_rows}

    # decode: (B, S, H, Hk, D, lens, kw, timed label or None)
    lens, short = LONG_LENS, SHORT_LENS
    cases = [(4, 8192, 32, 2, 128, lens, {}, "chatglm3_decode"),
             (4, 8192, 32, 2, 128, short, {}, "chatglm3_short"),
             (4, 8192, 8, 4, 256, lens, dict(cap=50.0, window=4096),
              "local"),
             (4, 8192, 8, 4, 256, lens, dict(cap=50.0), "global"),
             (4, 8192, 8, 4, 256, short, dict(cap=50.0, window=4096),
              "gemma2_short"),
             (4, 8192, 32, 32, 96, lens, {}, "phi3_decode"),
             (4, 8192, 32, 32, 96, short, {}, "phi3_short"),
             (4, 8192, 16, 16, 128, lens, {}, "moonshot_decode"),
             (4, 8192, 16, 16, 128, short, {}, "moonshot_short"),
             CROSS_DECODE + ([CROSS_DECODE[1]] * CROSS_DECODE[0], {},
                             "seamless_cross_decode"),
             (4, 8192, 32, 2, 128, [1, 1, 1, 1], {}, None),
             (4, 8192, 32, 2, 128, [6, 129, 2049, 8192], {}, None),
             (2, 1000, 8, 8, 16, [999, 161], dict(window=517), None),
             (2, 64, 4, 4, 32, [17, 3], dict(cap=20.0), None),
             (3, 96, 8, 2, 64, [1, 9, 96], dict(window=8), None),
             (2, 100, 6, 2, 64, [100, 37], {}, None)]
    # the design's edges, drawn on the card (their edge name kept apart
    # from the timed labels)
    edges = [case[:-1] + (None, case[-1]) for case in bf16_decode_edges(dev)]
    dec_rows = {}
    for b, s, h, hk, d, ln, kw, which, edge in ([c + (None,) for c in cases]
                                                + edges):
        draw = randn_dev if edge else randn
        q, k, v = draw(b, 1, h, d), draw(b, s, hk, d), draw(b, s, hk, d)
        kv_len = torch.tensor(ln, dtype=torch.int32, device=dev)[:, None]
        label = (f"{edge + ': ' if edge else ''}B{b} S{s} H{h}/{hk} D{d} "
                 f"len {ln} {kw}")
        got = decode_attention_cuda(q, k, v, kv_len, **kw)
        plain = decode_attention_plain(q, k, v, kv_len, **kw)
        check(got.dtype == bf, f"decode_attention_bf16 {label}: {got.dtype}")
        check(torch.equal(got, decode_attention_cuda(q, k, v, kv_len, **kw)),
              f"decode_attention_bf16 {label}: two launches differ")
        compare("decode_attention_bf16", got, plain, label)
        kpos = torch.arange(s, device=dev)[None, None, :]
        mask = kpos < kv_len[:, :, None]
        if kw.get("window"):
            mask &= kpos > kv_len[:, :, None] - 1 - kw["window"]
        bf16_vs_float64("decode_attention_bf16", got, plain,
                        attention64(q, k, v, mask, kw.get("cap")), label)
        if which is None:
            continue
        n_live = int(mask.sum())
        nbytes = 2 * (2 * q.numel() + 2 * hk * d * n_live) + 4 * b
        qh, kh, vh = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        t = dict(
            ms=device_ms(lambda: decode_attention_cuda(q, k, v, kv_len,
                                                       **kw)),
            plain_ms=device_ms(lambda: decode_attention_plain(
                q, k, v, kv_len, **kw), n=8),
            library_ms=device_ms(lambda: F.scaled_dot_product_attention(
                qh, kh, vh, attn_mask=mask[:, None], enable_gqa=True)),
            bound=bound(nbytes, 4 * d * h * n_live, BF16_OPS_S),
            live_keys=n_live, bytes=nbytes)
        dec_rows[which] = t
        print(f"  decode_attention_bf16 {which} {label} ({n_live} live keys "
              f"x {hk} kv heads): kernel {t['ms']:.4f} ms, plain "
              f"{t['plain_ms']:.4f} ms, SDPA bf16"
              f"{' without the cap' if kw.get('cap') else ''} "
              f"{t['library_ms']:.4f} ms, bound {t['bound'][0]:.5f} ms "
              f"({t['bound'][1]}, {nbytes} B)")
    print(f"  decode_attention_bf16: {len(cases)} cases and {len(edges)} "
          f"edges within {TOL['decode_attention_bf16']} of the plain version,"
          f" two launches equal bit for bit each; against float64 at most "
          f"{BF16_F64['decode_attention_bf16']:.3f} of the bar")
    rows["decode_attention_bf16"] = {**dec_rows.pop("chatglm3_decode"),
                                     **dec_rows}


#: the bf16 training pair (phase 2), (B, Sq, Sk, H, Hk, D, options): the
#: shapes its paths launch (chatglm3-6b's micro-batch, phase 22 (a);
#: gemma2-2b's dry-run train_4k cell at a batch of one, cap 50, window
#: 4096; phi3-mini's D 96; moonshot's 16 heads of 128 at G 1; seamless's
#: training cross attention) and the tiles' edges (64 resident rows, 64
#: streamed rows, 32 at D 256; G 64; S 1; Sk below Sq; a 14-head group)
BF16_TRAIN_CASES = {
    "chatglm3_train": (8, 64, 64, 32, 2, 128, dict(causal=True)),
    "gemma2_train_4k": (1, 4096, 4096, 8, 4, 256,
                        dict(causal=True, cap=50.0, window=4096)),
    "phi3_train": (2, 512, 512, 32, 32, 96, dict(causal=True)),
    "moonshot_train": (2, 512, 512, 16, 16, 128, dict(causal=True)),
    "seamless_train_cross": (4, 128, 512, 16, 16, 64, dict(causal=False)),
    "edge G64 D64 S130": (1, 130, 130, 64, 1, 64, dict(causal=True)),
    "edge G64 D16 S33": (1, 33, 33, 64, 1, 16, dict(causal=True)),
    "edge D96 cap 20": (2, 45, 45, 4, 2, 96, dict(causal=True, cap=20.0)),
    "edge D256 window 7": (2, 63, 63, 4, 2, 256,
                           dict(causal=True, window=7)),
    "edge D32 S1": (1, 1, 1, 2, 1, 32, dict(causal=True)),
    "edge D32 cross": (2, 45, 130, 8, 4, 32, dict(causal=False)),
    "edge cross Sk<Sq": (2, 200, 77, 8, 8, 64, dict(causal=False)),
    "edge G7 B32": (32, 64, 64, 14, 2, 128, dict(causal=True)),
}
#: the cases whose delta choice is measured and the timed ones
BF16_TRAIN_PATH = ("chatglm3_train", "gemma2_train_4k", "phi3_train",
                   "moonshot_train", "seamless_train_cross")
BF16_TRAIN_TIMED = ("chatglm3_train", "gemma2_train_4k",
                    "seamless_train_cross")
#: the bf16 lse against the plain one: 2e-5 of max(1, |lse|)
LSE_BF16_TOL = 2e-5
#: the delta choice's distances from float64 (phase 2), by case
BF16_DELTA = {}


def flash_bwd_formula(q, k, v, dout, o_delta, kw, dt):
    """dq, dk, dv of flash attention by its gradient's formulas in dtype
    ``dt`` (the plain version's logits, then delta = rowsum(dO o_delta),
    dS = P (dP - delta) times the cap's derivative): the same arithmetic
    as the plain autograd but for delta's source."""
    b, sq, h, d = q.shape
    sk, hk = k.shape[1], k.shape[2]
    g = h // hk
    qg = q.to(dt).reshape(b, sq, hk, g, d)
    do = dout.to(dt).reshape(b, sq, hk, g, d)
    kk, vv = k.to(dt), v.to(dt)
    mask = flash_mask(sq, sk, kw, q.device)[:, None, None]
    cap = kw.get("cap")
    c = torch.einsum("bqhgd,bkhd->bhgqk", qg, kk) / math.sqrt(d)
    if cap is not None:
        c = cap * torch.tanh(c / cap)
    p = torch.softmax(c.masked_fill(~mask, float("-inf")), -1)
    dp = torch.einsum("bqhgd,bkhd->bhgqk", do, vv)
    delta = torch.einsum("bqhgd,bqhgd->bhgq", do,
                         o_delta.to(dt).reshape(b, sq, hk, g, d))
    ds = p * (dp - delta[..., None])
    if cap is not None:
        ds = ds * (1 - (c / cap) ** 2)
    ds = torch.where(mask, ds, torch.zeros_like(ds)) / math.sqrt(d)
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, kk).reshape(b, sq, h, d)
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, qg)
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p, do)
    return dq, dk, dv


def bwd_bf16_tiles_match():
    """The host plan's bf16 tiles (``kernel.py::bwd_bf16_tiles``) are the
    built library's (``flash_attention_bwd_bf16_config``) at every head
    dim."""
    from repro_torch.kernels._build import load_library
    from repro_torch.kernels.flash_attention.kernel import (HEAD_DIMS,
                                                            bwd_bf16_tiles)

    fn = load_library("flash_attention_bwd").flash_attention_bwd_bf16_config
    fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    keys = ("rows", "cols", "smem", "threads")
    for d in HEAD_DIMS:
        got = (ctypes.c_int * len(keys))()
        check(fn(d, got) == 0, f"flash_attention_bwd_bf16_config({d}) failed")
        want = bwd_bf16_tiles(d)
        check(list(got) == [want[k] for k in keys],
              f"flash_attention_bwd_bf16 D{d}: the library's tiles "
              f"{list(got)}, the plan's {[want[k] for k in keys]}")
    print(f"  flash_attention_bwd_bf16: the plan's tiles are the library's "
          f"at D {HEAD_DIMS}")


def bf16_train_check(label, q, k, v, dout, kw, delta):
    """The bf16 training pair at one case: ``ops.flash_attention`` on bf16
    inputs that require grad (one launch of flash_attention_lse_bf16 and
    one of flash_attention_bwd_bf16), its output equal to the serving
    kernel's bit for bit and lse within LSE_BF16_TOL of max(1, |lse|) of
    the plain one; dq, dk, dv within TOL of the plain version's autograd
    on the same bf16 inputs and within the float64 bar
    (``bf16_vs_float64``, with BWD_FLOOR of the case's largest gradient
    beside its ulp); a second run equal bit for bit.  With
    ``delta``, prints the delta choice: fp32 gradients by the formulas
    with delta from the kernel's bf16 output and from the unrounded fp32
    one, each one's distance from float64."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_lse_plain, flash_attention_plain)

    reset_launch_counts()
    got = grads_of(flash_attention, q, k, v, dout, **kw)
    torch.cuda.synchronize()
    n = launch_counts()
    check(n["flash_attention_lse_bf16"] == 1 and
          n["flash_attention_bwd_bf16"] == 1 and
          n["flash_attention_bf16"] == 0,
          f"flash_attention_bwd_bf16 {label}: launches {n}")
    again = grads_of(flash_attention, q, k, v, dout, **kw)
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          f"flash_attention_bwd_bf16 {label}: two launches differ")
    plain = grads_of(flash_attention_plain, q, k, v, dout, **kw)
    f64 = grads_of(flash64, q, k, v, dout, **kw)
    with torch.no_grad():
        check(torch.equal(got[0], flash_attention_cuda(q, k, v, **kw)),
              f"flash_attention_lse_bf16 {label}: the output is not the "
              "serving kernel's bit for bit")
        _, lse = flash_attention_cuda(q, k, v, lse=True, **kw)
        want = flash_attention_lse_plain(q, k, v, **kw)[1]
    err = (lse - want).abs()
    worst = (err / want.abs().clamp(min=1.0)).max().item()
    check(worst <= LSE_BF16_TOL, f"flash_attention_lse_bf16 {label}: lse "
          f"{worst:.3e} of max(1, |lse|) from the plain one")
    ERRS["flash_attention_lse_bf16"] = max(ERRS["flash_attention_lse_bf16"],
                                           err.max().item())
    # the float64 bar's floor: the fp32 backward's, BWD_FLOOR of the
    # case's largest gradient (where a row sees one key, dP - delta cancels
    # and the exact dq and dk are 0, so a bar relative to their own
    # magnitude is 0: the floor takes the fp32 sums' rounding there)
    floor = BWD_FLOOR * max(w.abs().max().item() for w in f64[1:])
    for name, g, p, w in zip(("dq", "dk", "dv"), got[1:], plain[1:],
                             f64[1:]):
        check(g.dtype == torch.bfloat16, f"{label} {name}: {g.dtype}")
        compare("flash_attention_bwd_bf16", g, p, f"{label} {name}")
        bf16_vs_float64("flash_attention_bwd_bf16", g, p, w,
                        f"{label} {name}", floor)
    if not delta:
        return
    with torch.no_grad():
        out32 = flash_attention_plain(q.float(), k.float(), v.float(), **kw)
        dist = {}
        for src, o in (("bf16 o", got[0]), ("fp32 o", out32)):
            grads = flash_bwd_formula(q, k, v, dout, o, kw, torch.float32)
            dist[src] = {name: (g.double() - w).abs().max().item()
                         for name, g, w in zip(("dq", "dk", "dv"), grads,
                                               f64[1:])}
        dist["plain autograd"] = {
            name: (p.double() - w).abs().max().item()
            for name, p, w in zip(("dq", "dk", "dv"), plain[1:], f64[1:])}
    BF16_DELTA[label] = dist
    print(f"  flash_attention_bwd_bf16 {label}: delta's source, fp32 "
          f"gradients by the formulas against float64: " + "; ".join(
              f"{src} " + ", ".join(f"{n} {x:.3e}" for n, x in d.items())
              for src, d in dist.items()))


def bf16_train_timing(label, b, sq, sk, h, hk, d, kw):
    """Device ms of the bf16 pair at one path shape: the backward alone
    (``autograd.grad`` of a retained graph) and forward + backward, of the
    kernels, of the plain version's autograd and of SDPA's bf16 (one call
    with ``enable_gqa``; no cap; the window as a mask; timed only), the
    backward's bound (10 D operations a visible pair at the bf16 rate; 2
    bytes an element of q, k, v, o, dO, dq, dk, dv, 4 of lse); and the lse
    forward against its plain version and SDPA's bf16 forward."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_lse_plain, flash_attention_plain)

    bf = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(b * sq + d)
    q, k, v, dout = (torch.randn(shape, generator=gen, device="cuda").to(bf)
                     for shape in ((b, sq, h, d), (b, sk, hk, d),
                                   (b, sk, hk, d), (b, sq, h, d)))
    causal, w = kw.get("causal", True), kw.get("window")
    mask = flash_mask(sq, sk, kw, q.device)[0] if w else None

    def sdpa(q, k, v):
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=mask, is_causal=causal and mask is None,
            enable_gqa=True).transpose(1, 2)

    def kernels(q, k, v):
        return flash_attention(q, k, v, **kw)

    def plain(q, k, v):
        return flash_attention_plain(q, k, v, **kw)

    big = sq * sk > 1 << 20
    n, reps = (2, 3) if big else (20, 5)
    t = {}
    for name, fn in (("ms", kernels), ("plain_ms", plain),
                     ("library_ms", sdpa)):
        leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
        out = fn(*leaves)
        t[name] = device_ms(lambda: torch.autograd.grad(
            out, leaves, dout, retain_graph=True),
            n=1 if big and name == "plain_ms" else n, reps=reps)

        def both():
            ls = [x.clone().requires_grad_(True) for x in (q, k, v)]
            torch.autograd.grad(fn(*ls), ls, dout)

        t[f"fwd_bwd_{name}"] = device_ms(
            both, n=1 if big and name == "plain_ms" else max(1, n // 2),
            reps=reps)
        del out, leaves
    pairs = b * h * visible_pairs(sq, causal, w, sk=sk)
    t["bound"] = bound(2 * (4 * q.numel() + 4 * k.numel()) + 4 * b * h * sq,
                       10 * d * pairs, BF16_OPS_S)
    t["visible_pairs"] = pairs
    with torch.no_grad():
        fwd = dict(
            ms=device_ms(lambda: flash_attention_cuda(q, k, v, lse=True,
                                                      **kw), n=n, reps=reps),
            plain_ms=device_ms(lambda: flash_attention_lse_plain(
                q, k, v, **kw), n=1 if big else 8, reps=reps),
            library_ms=device_ms(lambda: sdpa(q, k, v), n=n, reps=reps),
            bound=bound(2 * (2 * q.numel() + 2 * k.numel())
                        + 4 * b * h * sq, 4 * d * pairs, BF16_OPS_S))
    shape = f"B{b} Sq{sq} Sk{sk} H{h}/{hk} D{d} {kw}"
    print(f"  flash_attention_bwd_bf16 {label} {shape}: backward kernel "
          f"{t['ms']:.4f} ms, plain {t['plain_ms']:.4f}, SDPA bf16"
          f"{' without the cap' if kw.get('cap') else ''} "
          f"{t['library_ms']:.4f}, bound {t['bound'][0]:.5f} "
          f"({t['bound'][1]}); forward + backward {t['fwd_bwd_ms']:.4f}, "
          f"plain {t['fwd_bwd_plain_ms']:.4f}, SDPA "
          f"{t['fwd_bwd_library_ms']:.4f}")
    print(f"  flash_attention_lse_bf16 {label}: kernel {fwd['ms']:.4f} ms, "
          f"plain {fwd['plain_ms']:.4f}, SDPA bf16 {fwd['library_ms']:.4f}, "
          f"bound {fwd['bound'][0]:.5f} ({fwd['bound'][1]})")
    return t, fwd


def bf16_train_kernel_checks(dev, rows):
    """flash_attention_lse_bf16 and flash_attention_bwd_bf16 (phase 2):
    the plan's tiles against the library's, ``bf16_train_check`` at every
    case of BF16_TRAIN_CASES (the delta choice measured at the path
    shapes), then the pair timed at BF16_TRAIN_TIMED.  Adds
    rows["flash_attention_lse_bf16"] and rows["flash_attention_bwd_bf16"]."""
    from repro_torch.kernels.flash_attention.kernel import bwd_plan

    bwd_bf16_tiles_match()
    gen = torch.Generator().manual_seed(29)
    t0 = time.perf_counter()
    for label, (b, sq, sk, h, hk, d, kw) in BF16_TRAIN_CASES.items():
        q, k, v, dout = (torch.randn(shape, generator=gen).to(
            dev, torch.bfloat16) for shape in ((b, sq, h, d), (b, sk, hk, d),
                                               (b, sk, hk, d), (b, sq, h, d)))
        splits = bwd_plan(b, sq, sk, h, hk, d, bf16=True)["splits"]
        bf16_train_check(f"{label} B{b} Sq{sq} Sk{sk} H{h}/{hk} D{d} {kw} "
                         f"({splits} split(s))", q, k, v, dout, kw,
                         label in BF16_TRAIN_PATH)
        del q, k, v, dout
        torch.cuda.empty_cache()
    print(f"  flash_attention_bwd_bf16: {len(BF16_TRAIN_CASES)} cases in "
          f"{time.perf_counter() - t0:.1f} s, within "
          f"{TOL['flash_attention_bwd_bf16']} of the plain version "
          f"({ERRS['flash_attention_bwd_bf16']:.3e}), against float64 at "
          f"most {BF16_F64['flash_attention_bwd_bf16']:.3f} of the bar; lse "
          f"{ERRS['flash_attention_lse_bf16']:.3e} from the plain one")
    bwd, lse = {}, {}
    for label in BF16_TRAIN_TIMED:
        bwd[label], lse[label] = bf16_train_timing(
            label, *BF16_TRAIN_CASES[label])
        torch.cuda.empty_cache()
    top = BF16_TRAIN_TIMED[0]
    rows["flash_attention_bwd_bf16"] = {**bwd.pop(top), **bwd}
    rows["flash_attention_lse_bf16"] = {**lse.pop(top), **lse}


def int8_yardstick(x_q, w_q, sx, sw):
    """PyTorch's int8 product, ``torch._int_mm``, followed by the same two
    scale multiplies (yardstick only; the port never calls it), or None
    where K or N is not a multiple of 8 (``_int_mm`` refuses them).  It
    refuses M <= 16 too: there the rows are padded with zeros to 32, and
    the second value says so."""
    m, k = x_q.shape
    n = w_q.shape[1]
    if k % 8 or n % 8:
        return None, False
    padded = m <= 16
    if padded:
        x_q = torch.cat([x_q, x_q.new_zeros(32 - m, k)])
        sx = torch.cat([sx, sx.new_ones(32 - m, 1)])
    return (lambda: (torch._int_mm(x_q, w_q).float() * sx) * sw), padded


def int8_call(x_q, w_q, sx, sw):
    """``int8_matmul_cuda`` once, holding from the launch counts that it
    launched its pre-pass and its product once each and nothing else."""
    from repro_torch.kernels import launch_counts
    from repro_torch.kernels.int8_matmul.kernel import int8_matmul_cuda

    before = launch_counts()
    out = int8_matmul_cuda(x_q, w_q, sx, sw)
    want = {KERNELS["int8_matmul"][0], *COMPANIONS["int8_matmul"]}
    moved = {k for k, n in launch_counts().items() if n != before[k]}
    check(moved == want and all(launch_counts()[k] == before[k] + 1
                                for k in want),
          f"int8_matmul at M {x_q.shape[0]}: launched {sorted(moved)}, not "
          f"{sorted(want)} once each")
    return out


def int8_timing(label, x_q, w_q, sx, sw):
    """The kernel's, the plain version's and the yardstick's device time
    at one shape, with the bound: int8 operands and f32 scales read once,
    f32 out written once; 2 M K N int8 operations.  The kernel's time
    includes its pre-pass."""
    from repro_torch.kernels.int8_matmul.kernel import int8_matmul_cuda
    from repro_torch.kernels.int8_matmul.ref import int8_matmul_plain

    m, k = x_q.shape
    n = w_q.shape[1]
    int8_call(x_q, w_q, sx, sw)
    lib, padded = int8_yardstick(x_q, w_q, sx, sw)
    if lib is not None:
        same = torch.equal(lib()[:m], int8_matmul_plain(x_q, w_q, sx, sw))
    nbytes = m * k + k * n + 4 * (m + n) + 4 * m * n
    big = 2 * m * k * n > 1e11
    t = dict(ms=device_ms(lambda: int8_matmul_cuda(x_q, w_q, sx, sw),
                          n=4 if big else 40),
             plain_ms=device_ms(lambda: int8_matmul_plain(x_q, w_q, sx, sw),
                                n=2 if big else 8),
             library_ms=None if lib is None else device_ms(lib),
             bound=bound(nbytes, 2 * m * k * n, INT8_OPS_S),
             library_rows_padded_to_32=padded)
    print(f"  int8_matmul {label} M{m} K{k} N{n}: kernel "
          f"{t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, _int_mm + scales "
          + ("not timed (K or N not a multiple of 8)" if lib is None else
             f"{t['library_ms']:.4f} ms{' (M padded to 32)' if padded else ''}"
             f" (equal to the plain version: {same})")
          + f", bound {t['bound'][0]:.5f} ms ({t['bound'][1]}, {nbytes} B)")
    return t


def int8_checks(dev):
    """int8_matmul against its plain version on the card (equal) at the
    reference sweep's shapes, kernel_bench's 256x512x512, ragged ones (M
    1 to 4200; K off multiples of 16 and 32, N off multiples of 8) and
    chatglm3-6b's projections at a decode tick (M = 4); each of those but
    the ragged ones timed, each call's launches counted.  Returns the
    kernel's row: chatglm3-6b's w_in at M = 4, the largest weight a decode
    tick reads, with the other timed shapes under it (phase 12 adds w_in
    at a prefill's M)."""
    from repro_torch.kernels.int8_matmul.ref import (int8_matmul_plain,
                                                     quantize_colwise,
                                                     quantize_rowwise)

    gen = torch.Generator(device=dev).manual_seed(9)
    cases = [("sweep", 128, 256, 128), ("sweep", 256, 512, 256),
             ("sweep", 64, 128, 512), ("kernel_bench", 256, 512, 512),
             ("ragged", 4, 1000, 13), ("ragged", 4200, 4099, 70),
             ("ragged", 37, 129, 67), ("ragged", 1, 7, 1),
             ("ragged", 65, 4096, 4100), ("ragged", 63, 4099, 257),
             ("ragged", 200, 100, 13), ("ragged", 129, 33, 4097)]
    cases += [(f"chatglm3 {name}", 4, k, n)
              for name, (k, n) in CHATGLM3_PROJ.items()]
    out = {}
    for label, m, k, n in cases:
        x_q, sx = quantize_rowwise(torch.randn(m, k, generator=gen,
                                               device=dev))
        w_q, sw = quantize_colwise(torch.randn(k, n, generator=gen,
                                               device=dev))
        compare("int8_matmul", int8_call(x_q, w_q, sx, sw),
                int8_matmul_plain(x_q, w_q, sx, sw),
                f"{label} M{m} K{k} N{n}")
        if label != "ragged":
            out[f"{label} M{m} K{k} N{n}"] = int8_timing(label, x_q, w_q,
                                                          sx, sw)
    head = out.pop("chatglm3 w_in M4 K4096 N13696")
    return {"int8_matmul": {**head, **out}}


def sdpa_ms(q, k, v):
    """PyTorch's SDPA on the same causal GQA problem (yardstick only)."""
    import torch.nn.functional as F

    g = q.shape[2] // k.shape[2]
    qh = q.transpose(1, 2).contiguous()
    kh = k.repeat_interleave(g, dim=2).transpose(1, 2).contiguous()
    vh = v.repeat_interleave(g, dim=2).transpose(1, 2).contiguous()
    return device_ms(lambda: F.scaled_dot_product_attention(
        qh, kh, vh, is_causal=True))


# ---------------------------------------------------------------------------
# phases 3-8: the plans
# ---------------------------------------------------------------------------

def make_ctx(device):
    """Every model a Q8 plan may use, with seeded random weights: the big
    MLLM at full width, the small one, the big one pruned at rate 0.5, and
    TinyDet."""
    from repro_torch.configs.samsara_stream import (STREAM_MLLM_CONFIG,
                                                    STREAM_MLLM_SMALL_CONFIG)
    from repro_torch.core.physical import structured_prune
    from repro_torch.streaming.detector import TinyDet
    from repro_torch.streaming.mllm import StreamMLLM
    from repro_torch.streaming.operators import OpContext

    big = StreamMLLM(STREAM_MLLM_CONFIG, patch=16, device=device).init(
        torch.Generator().manual_seed(0))
    small = StreamMLLM(STREAM_MLLM_SMALL_CONFIG, patch=16,
                       device=device).init(torch.Generator().manual_seed(1))
    det = TinyDet(device=device).init(
        torch.Generator().manual_seed(DETECTOR_SEED))
    return OpContext(mllm=big, mllm_small=small,
                     mllm_pruned=structured_prune(big, 0.5), detector=det,
                     device=device)


def q8_plan(which: str, tail: bool = True):
    """Q8's plans: ``naive``; ``reduced`` (the chain the semantic and
    logical phases build for it, assembled by hand); ``unfused`` (reduced
    plus the physical phase's TinyDet cascade); ``fused`` (the same with
    its prefix in one FusedPrefixOp).  ``tail=False`` drops Q8's filter,
    so every extracted record reaches the sink."""
    from repro_torch.queries.catalog import get_query
    from repro_torch.streaming import operators as ops
    from repro_torch.streaming.fused import FusedPrefixOp
    from repro_torch.streaming.plan import Plan

    q = get_query("Q8")
    pre = [ops.SkipOp(amount=3, threshold=0.02, regions=(4, 8)),
           ops.FusedPreprocessOp(crop=(64, 0, 64, 256), factor=2),
           ops.CheapColorFilterOp("red", min_frac=0.008)]
    cascade = pre + [ops.DetectOp(threshold=0.5)]
    chain = {"naive": [], "reduced": pre, "unfused": cascade,
             "fused": [FusedPrefixOp(stage_ops=tuple(cascade))]}[which]
    rest = q.tail() if tail else []
    return Plan([ops.SourceOp("tollbooth")] + chain
                + [ops.MLLMExtractOp(q.tasks, "big")] + rest
                + [ops.SinkOp()], query="Q8")


def run_plan(plan, ctx, n_frames, micro_batch, seed):
    from repro_torch.data import TollBoothStream
    from repro_torch.streaming.runtime import StreamRuntime

    rt = StreamRuntime(plan, ctx, micro_batch=micro_batch)
    return rt.run(TollBoothStream(seed=seed), n_frames)


def path_kernels(plan, res):
    """The kernels a run of ``plan`` must have launched: those of the ops
    that received frames (an op handed no rows launches nothing)."""
    from repro_torch.streaming import operators as ops
    from repro_torch.streaming.fused import FusedPrefixOp

    kernel_of = {ops.SkipOp: "frame_diff",
                 ops.FusedPreprocessOp: "fused_preprocess",
                 FusedPrefixOp: "fused_prefix",
                 ops.MLLMExtractOp: "flash_attention"}
    return sorted({kernel_of[type(op)] for op in plan.ops
                   if type(op) in kernel_of
                   and res.op_input_counts[op.name] > 0})


def drive(name, plan, ctx, expect=()):
    """One run of ``plan`` over the stream with the launch counts zeroed
    just before and read just after; every kernel of ``expect`` and of the
    ops that received frames must have been launched."""
    from repro_torch.kernels import launch_counts, reset_launch_counts

    reset_launch_counts()
    res = run_plan(plan, ctx, N_FRAMES, MICRO_BATCH, STREAM_SEED)
    torch.cuda.synchronize()
    counts = launch_counts()
    print(f"  {name}: {res.n_frames} frames in {res.wall_s:.3f} s = "
          f"{res.fps:.1f} fps, mllm_frames {res.mllm_frames}, "
          f"outputs {len(res.outputs)}, launches {counts}")
    print(f"  {name} operator input counts: {res.op_input_counts}")
    for k in sorted(set(expect) | set(path_kernels(plan, res))):
        check(counts[KERNELS[k][0]] > 0,
              f"{name}: kernel {k} was never launched")
    check(res.n_frames == N_FRAMES, f"{name}: {res.n_frames} frames")
    return res, counts


def cross_check(ctx):
    """The naive, reduced and fused plans without Q8's filter on 64
    frames, card vs CPU (plain versions): identical extracted records; MLLM
    logits agree on a few frames at each input size."""
    from repro_torch.data import TollBoothStream

    cpu = make_ctx("cpu")
    for which, seed in (("naive", 11), ("reduced", 3), ("fused", 3)):
        a = run_plan(q8_plan(which, tail=False), ctx, 64, 8, seed)
        b = run_plan(q8_plan(which, tail=False), cpu, 64, 8, seed)
        same = (a.outputs == b.outputs and a.mllm_frames == b.mllm_frames
                and a.op_input_counts == b.op_input_counts)
        print(f"  Q8 {which} seed {seed}, 64 frames: card == CPU records: "
              f"{same} (mllm_frames {a.mllm_frames}, outputs "
              f"{len(a.outputs)})")
        check(same, f"Q8 {which}: card and CPU records differ")
    model, cpu_model = ctx.mllm, cpu.mllm
    raw, _ = TollBoothStream(seed=3).batch(16)
    x = (raw[[5, 12]].astype(np.float32) / 255.0 - 0.5) / 0.25
    crop = x[:, :, 64:128]
    for label, fr in (("128x256", x), ("64x256", crop),
                      ("32x128", crop.reshape(2, 3, 32, 2, 128, 2)
                       .mean(axis=(3, 5)))):
        fr = torch.from_numpy(np.ascontiguousarray(fr))
        with torch.inference_mode():
            got, want = model(fr.cuda()), cpu_model(fr)
        err = max((got[k].cpu() - want[k]).abs().max().item() for k in want)
        print(f"  MLLM logits {label}: card vs CPU max_abs_err {err:.3e}")
        check(all(torch.isfinite(got[k]).all() for k in got)
              and all(got[k].shape == want[k].shape for k in want),
              f"MLLM logits {label}: shape or non-finite")
        check(err < 1e-3, f"MLLM logits {label}: card vs CPU {err}")


def trace(name, plan, ctx, n_frames=128):
    """Where a plan's time goes: one profiled run (CUPTI through
    torch.profiler), device kernel time summed by name against the host
    wall clock (kernels and copies on the one stream, summed).  Returns
    the device's busy share, or None when the profiler saw no device
    activity."""
    from torch.profiler import ProfilerActivity, profile

    run_plan(plan.clone(), ctx, MICRO_BATCH, MICRO_BATCH, STREAM_SEED)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_plan(plan.clone(), ctx, n_frames, MICRO_BATCH, STREAM_SEED)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    return device_summary(prof, wall_ms, name, f"{n_frames} frames", 6)


def device_summary(prof, wall_ms, name, what, top):
    """Device kernel and copy time summed by name from a profile, against
    the host wall clock; prints the busy share, the count of device events
    and of host aten calls over ``what``, and the ``top`` names.  None when
    the profiler saw no device activity."""
    kernels, n_events, n_aten = {}, 0, 0
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            n_events += 1
            kernels[ev.name] = kernels.get(ev.name, 0.0) + \
                ev.time_range.elapsed_us() / 1e3
        elif ev.name.startswith("aten::"):
            n_aten += 1
    if not kernels:
        print(f"  {name}: the profiler saw no device activity; device "
              "busy share not measured")
        return None
    busy = sum(kernels.values())
    print(f"  {name}, {what} (profiled, wall includes the profiler): wall "
          f"{wall_ms:.1f} ms, device busy {busy:.2f} ms = "
          f"{100 * busy / wall_ms:.1f}%, idle {100 - 100 * busy / wall_ms:.1f}"
          f"%; {n_events} device kernels and copies, {n_aten} host aten "
          "calls (nested calls counted)")
    for kname, ms in sorted(kernels.items(), key=lambda kv: -kv[1])[:top]:
        print(f"    {ms:8.3f} ms  {kname[:90]}")
    return busy / wall_ms


def optimize(ctx):
    """Phase 7: the super-optimizer's three phases and the calibration for
    Q8 on the card; returns its plan and report."""
    from repro_torch.core.superopt import SuperOptimizer
    from repro_torch.data import TollBoothStream
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.queries.catalog import get_query

    reset_launch_counts()
    t0 = time.perf_counter()
    plan, report = SuperOptimizer(ctx, micro_batch=MICRO_BATCH).optimize(
        get_query("Q8"), lambda seed: TollBoothStream(seed=seed))
    torch.cuda.synchronize()
    print(f"  optimize: {time.perf_counter() - t0:.2f} s, launches while "
          f"optimizing {launch_counts()}")
    for line in report.describe().splitlines():
        print(f"  | {line}")
    print(f"  phase walls (s): {report.phase_wall_s}")
    check([p["phase"] for p in report.phases]
          == ["semantic", "logical", "physical"]
          and "calibration" in report.phase_wall_s and report.op_timings,
          "optimize: a phase or the calibration is missing")
    return plan, report


def fused_vs_unfused(ctx, fused, unfused):
    """Phase 8's equality: the fused plan and its unfused twin give the
    same records, MLLM frames and counts on every op they share, and the
    fused op takes what the twin's Skip takes; again without Q8's filter on
    64 frames, so that extracted records are compared too."""
    def same(a, b, fused_name, skip_name):
        shared = set(a.op_input_counts) & set(b.op_input_counts)
        return (a.outputs == b.outputs and a.mllm_frames == b.mllm_frames
                and a.window_results == b.window_results
                and all(a.op_input_counts[k] == b.op_input_counts[k]
                        for k in shared)
                and a.op_input_counts[fused_name]
                == b.op_input_counts[skip_name])

    fname = q8_plan("fused").ops[1].name
    ok = same(fused, unfused, fname, "skip[3,no_car]")
    a = run_plan(q8_plan("fused", tail=False), ctx, 64, 8, 3)
    b = run_plan(q8_plan("unfused", tail=False), ctx, 64, 8, 3)
    ok_records = same(a, b, fname, "skip[3,no_car]")
    print(f"  q8_fused == q8_unfused on the card: 512 frames {ok}; 64 frames"
          f" without the filter {ok_records} (outputs {len(a.outputs)}, "
          f"mllm_frames {a.mllm_frames})")
    check(ok and ok_records, "q8_fused and q8_unfused differ")
    check(a.mllm_frames > 0 and len(a.outputs) == a.mllm_frames,
          "q8_fused without the filter extracted nothing")


# ---------------------------------------------------------------------------
# phases 13-16: the catalog, multi-query sharing, the gate, obs and faults
# ---------------------------------------------------------------------------

def dataset_stream(dataset):
    """The catalog's stream of ``dataset`` at its seed."""
    from repro_torch.data import TollBoothStream, VolleyballStream

    if dataset == "tollbooth":
        return TollBoothStream(seed=STREAM_SEED)
    return VolleyballStream(seed=VOLLEYBALL_SEED)


def counted(name, expect, fn):
    """``fn()`` with the launch counts zeroed just before and read just
    after; every kernel of ``expect`` must have been launched."""
    from repro_torch.kernels import launch_counts, reset_launch_counts

    reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    counts = launch_counts()
    print(f"  {name} launches {counts}")
    for k in expect:
        check(counts[KERNELS[k][0]] > 0,
              f"{name}: kernel {k} was never launched")
    return out, counts


def same_records(a, b, by_order=False):
    """Outputs, window results, MLLM frames and operator counts equal (the
    counts in plan order where ``by_order``: a merged extract has its own
    name)."""
    ca, cb = a.op_input_counts, b.op_input_counts
    if by_order:
        ca, cb = list(ca.values()), list(cb.values())
    return (a.outputs == b.outputs and a.window_results == b.window_results
            and a.mllm_frames == b.mllm_frames and ca == cb)


def catalog_phase(ctx):
    """Phase 13: every query's naive plan over 512 frames of its dataset
    on the card (fps, MLLM frames, outputs, score), then each over 32
    frames on the card and on the CPU (plain versions): the same records.
    Returns the 512-frame runs by query and their launch counts."""
    from repro_torch.queries.catalog import QUERIES
    from repro_torch.streaming.runtime import StreamRuntime

    def drive_all():
        out = {}
        for qid, q in QUERIES.items():
            out[qid] = StreamRuntime(q.naive_plan(), ctx,
                                     micro_batch=MICRO_BATCH).run(
                dataset_stream(q.dataset), N_FRAMES)
        return out

    runs, counts = counted("catalog", ["flash_attention"], drive_all)
    for qid, r in runs.items():
        print(f"  {qid} ({QUERIES[qid].dataset}): {r.fps:.1f} fps, "
              f"mllm_frames {r.mllm_frames}, outputs {len(r.outputs)}, "
              f"windows {len(r.window_results)}, score "
              f"{QUERIES[qid].evaluate(r):.4f}")
        check(r.mllm_frames == N_FRAMES and r.n_frames == N_FRAMES,
              f"catalog {qid}: {r.mllm_frames} MLLM frames")
    cpu = make_ctx("cpu")
    for qid, q in QUERIES.items():
        a, b = (StreamRuntime(q.naive_plan(), c, micro_batch=8).run(
            dataset_stream(q.dataset), 32) for c in (ctx, cpu))
        check(same_records(a, b) and q.evaluate(a) == q.evaluate(b),
              f"catalog {qid}: card and CPU records differ on 32 frames")
    print(f"  all {len(QUERIES)} queries, 32 frames: card == CPU records, "
          "window results, counts and scores")
    return runs, counts


MQ_SETS = {"mq_tollbooth": [f"Q{i}" for i in range(1, 10)],
           "mq_volleyball": ["Q10", "Q11", "Q12", "Q13"],
           "mq_reduced": ["Q8", "Q6", "Q2"]}


def mq_plans(name):
    """The plans of one multi-query set: naive plans, or (``mq_reduced``)
    Q8's reduced prefix under Q8's, Q6's and Q2's extracts and tails."""
    from repro_torch.queries.catalog import get_query
    from repro_torch.streaming import operators as ops
    from repro_torch.streaming.plan import Plan

    if name != "mq_reduced":
        return [get_query(q).naive_plan() for q in MQ_SETS[name]]
    plans = []
    for qid in MQ_SETS[name]:
        q = get_query(qid)
        plans.append(Plan(
            [ops.SourceOp("tollbooth"),
             ops.SkipOp(amount=3, threshold=0.02, regions=(4, 8)),
             ops.FusedPreprocessOp(crop=(64, 0, 64, 256), factor=2),
             ops.CheapColorFilterOp("red", min_frac=0.008),
             ops.MLLMExtractOp(q.tasks, "big")] + q.tail() + [ops.SinkOp()],
            query=qid))
    return plans


def run_mq(name, ctx):
    from repro_torch.streaming.multiquery import MultiQueryRuntime

    ds = "volleyball" if name == "mq_volleyball" else "tollbooth"
    return MultiQueryRuntime(mq_plans(name), ctx,
                             micro_batch=MICRO_BATCH).run(
        dataset_stream(ds), N_FRAMES)


def multiquery_phase(ctx, solo):
    """Phase 14: each set through ``MultiQueryRuntime`` on the card; every
    query's result equal to its own ``StreamRuntime`` run bit for bit
    (``solo``: phase 13's naive runs; the reduced set's run here), fewer
    shared MLLM frames than the independent sum, and the path's kernels
    launched.  Returns the shared results, their launch counts and a
    summary."""
    from repro_torch.streaming.runtime import StreamRuntime

    shared, counts, summary = {}, {}, {}
    for name in MQ_SETS:
        expect = ["flash_attention"] + (
            ["frame_diff", "fused_preprocess"] if name == "mq_reduced"
            else [])
        res, counts[name] = counted(name, expect,
                                    lambda: run_mq(name, ctx))
        shared[name] = res
        if name == "mq_reduced":
            indep = {p.query: StreamRuntime(p, ctx, micro_batch=MICRO_BATCH)
                     .run(dataset_stream("tollbooth"), N_FRAMES)
                     for p in mq_plans(name)}
        else:
            indep = {q: solo[q] for q in MQ_SETS[name]}
        print("  " + res.shared_plan.replace("\n", "\n  "))
        for qid, r in res.per_query.items():
            check(same_records(r, indep[qid], by_order=True),
                  f"{name} {qid}: shared result differs from its own run")
        indep_mllm = sum(r.mllm_frames for r in indep.values())
        indep_wall = sum(r.wall_s for r in indep.values())
        indep_qfps = len(indep) * N_FRAMES / indep_wall
        check(res.mllm_frames < indep_mllm,
              f"{name}: shared MLLM frames {res.mllm_frames} not below "
              f"the independent {indep_mllm}")
        print(f"  {name}: {res.n_queries} queries, shared == independent "
              f"bit for bit; MLLM frames {res.mllm_frames} shared vs "
              f"{indep_mllm} independent; {res.fps:.1f} query-frames/s "
              f"shared (wall {res.wall_s:.3f} s) vs {indep_qfps:.1f} "
              f"independent (sum of walls {indep_wall:.3f} s)")
        summary[name] = {"queries": res.n_queries, "wall_s": res.wall_s,
                         "query_frames_s": res.fps,
                         "mllm_frames": res.mllm_frames,
                         "indep_wall_s": indep_wall,
                         "indep_query_frames_s": indep_qfps,
                         "indep_mllm_frames": indep_mllm}
    return shared, counts, summary


def gated_run(plan, ctx, gate):
    """One run of ``plan`` under ``gate`` without the warmup batch (the
    kernels and models are warm by now), so that the gate's counters
    cover exactly the measured frames."""
    from repro_torch.streaming.runtime import StreamRuntime

    rt = StreamRuntime(plan, dataclasses.replace(ctx, gate=gate),
                       micro_batch=MICRO_BATCH)
    return rt.run(dataset_stream("tollbooth"), N_FRAMES, warmup=0)


class CountingFeatures:
    """Counts a gate's own ``TemporalSignature.features`` calls."""

    def __init__(self, signature):
        self.calls = 0
        self._features = signature.features
        signature.features = self

    def __call__(self, frames):
        self.calls += 1
        return self._features(frames)


def gate_phase(ctx, naive):
    """Phase 15: the semantic gate on the card.  Q8's fused plan without
    its filter, gated, against its gated unfused twin (same records, same
    counters, no signature of the gate's own on the fused run); Q8's naive
    plan gated (hits, fewer forward frames than MLLM frames); a gate at
    threshold 0 against no gate (``naive``: phase 3's run)."""
    from repro_torch.semantic import GateConfig, SemanticGate

    def gate():
        return SemanticGate(GateConfig(threshold=GATE_THRESHOLD),
                            device=ctx.device)

    g_f, g_u = gate(), gate()
    own_f, own_u = CountingFeatures(g_f.signature), \
        CountingFeatures(g_u.signature)
    fused, fcounts = counted(
        "q8_fused_gated", ["fused_prefix", "flash_attention"],
        lambda: gated_run(q8_plan("fused", tail=False), ctx, g_f))
    unfused = gated_run(q8_plan("unfused", tail=False), ctx, g_u)
    fname = q8_plan("fused").ops[1].name
    ok = (fused.outputs == unfused.outputs
          and fused.mllm_frames == unfused.mllm_frames
          and fused.op_input_counts[fname]
          == unfused.op_input_counts["skip[3,no_car]"])
    print(f"  q8_fused_gated == q8_unfused_gated: records {ok} "
          f"(outputs {len(fused.outputs)}, mllm_frames "
          f"{fused.mllm_frames}); counters fused {g_f.counters}, unfused "
          f"{g_u.counters}; the gate's own signature calls: fused "
          f"{own_f.calls}, unfused {own_u.calls}")
    check(ok, "q8_fused_gated and q8_unfused_gated differ")
    check(g_f.counters == g_u.counters,
          "the fused and unfused gates counted differently")
    check(own_f.calls == 0 and own_u.calls > 0,
          "the fused run's gate computed a signature of its own")
    check(fused.mllm_frames > 0, "q8_fused_gated extracted nothing")

    g_n = gate()
    plan = q8_plan("naive")
    nres, ncounts = counted("q8_naive_gated", ["flash_attention"],
                            lambda: gated_run(plan, ctx, g_n))
    c = g_n.counters
    paid = c["cache_misses"] + c["revalidations"]
    print(f"  q8_naive_gated at threshold {GATE_THRESHOLD}: {c}; hit rate "
          f"{g_n.hit_rate():.4f}; forward frames {paid} of "
          f"{nres.mllm_frames} MLLM frames ({nres.mllm_frames - paid} "
          f"saved), {plan.ops[1].forwards} forwards; {nres.fps:.1f} fps "
          f"gated vs {naive.fps:.1f} ungated")
    check(c["cache_hits"] > 0 and paid < nres.mllm_frames,
          "q8_naive_gated: no cache hit or no forward saved")
    check(g_n.served() == nres.mllm_frames == N_FRAMES,
          "q8_naive_gated: the gate did not classify every frame")

    off = gated_run(q8_plan("naive"), ctx,
                    SemanticGate(GateConfig(threshold=0.0),
                                 device=ctx.device))
    check(same_records(off, naive), "a gate at threshold 0 changed q8_naive")
    print("  gate at threshold 0 == ungated q8_naive bit for bit")
    summary = {"threshold": GATE_THRESHOLD, "counters": dict(c),
               "hit_rate": g_n.hit_rate(), "forward_frames": paid,
               "mllm_frames": nres.mllm_frames,
               "forwards": plan.ops[1].forwards, "fps": nres.fps,
               "ungated_fps": naive.fps,
               "fused_gated_counters": dict(g_f.counters),
               "fused_own_signature_calls": own_f.calls,
               "unfused_own_signature_calls": own_u.calls}
    return {"q8_fused_gated": fcounts, "q8_naive_gated": ncounts}, summary


def obs_faults_phase(ctx, base):
    """Phase 16: phase 14's Q1-Q9 set observed (``base``: its unobserved
    run) equal bit for bit, its span categories, SLO table and walls, the
    Chrome trace written under build/; then Q8's reduced plan under a
    fault injector whose corrupt deliveries ``guard_stream`` absorbs."""
    from repro_torch.faults import FaultInjector, FaultRule
    from repro_torch.obs import Observability

    obs = Observability(slo_target_ms=SLO_TARGET_MS)
    observed, counts = counted(
        "mq_observed", ["flash_attention"],
        lambda: run_mq("mq_tollbooth", dataclasses.replace(ctx, obs=obs)))
    for qid, r in base.per_query.items():
        check(same_records(observed.per_query[qid], r),
              f"mq_observed {qid}: observed run differs from unobserved")
    cats = sorted({e["cat"] for e in obs.tracer.events()})
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    path = os.path.join(ROOT, "build", "mq_trace.json")
    n_ev = obs.tracer.export_chrome(path)
    print(f"  observed == unobserved, {len(base.per_query)} queries bit for "
          f"bit; span categories {cats}; {n_ev} events written to "
          f"{os.path.relpath(path, ROOT)}")
    for line in obs.slo.table().splitlines():
        print(f"  | {line}")
    print(f"  wall: observed {observed.wall_s:.3f} s, unobserved "
          f"{base.wall_s:.3f} s")
    check(obs.slo.row("mq")["frames"] == N_FRAMES,
          "mq_observed: the SLO record missed frames")

    inj = FaultInjector(seed=3, rules=[FaultRule(
        site="source", kind="corrupt", start=1, every=4, param=2)])
    clean = run_plan(q8_plan("reduced", tail=False), ctx, N_FRAMES,
                     MICRO_BATCH, STREAM_SEED)
    faulted, fcounts = counted(
        "q8_reduced_faulted", ["frame_diff", "fused_preprocess"],
        lambda: run_plan(q8_plan("reduced", tail=False),
                         dataclasses.replace(ctx, faults=inj), N_FRAMES,
                         MICRO_BATCH, STREAM_SEED))
    ok = same_records(faulted, clean) and faulted.labels == clean.labels
    print(f"  q8_reduced under {len(inj.log)} injected corrupt deliveries "
          f"(absorbed by guard_stream): records equal the unfaulted run's "
          f"{ok} (outputs {len(clean.outputs)})")
    check(len(inj.log) > 0, "the fault injector never fired")
    check(ok and len(clean.outputs) > 0,
          "q8_reduced_faulted differs from the unfaulted run")
    summary = {"observed_wall_s": observed.wall_s,
               "unobserved_wall_s": base.wall_s, "span_categories": cats,
               "trace_events": n_ev, "slo": obs.slo.row("mq"),
               "faults_fired": len(inj.log)}
    return {"mq_observed": counts, "q8_reduced_faulted": fcounts}, summary


# ---------------------------------------------------------------------------
# phase 17: the serving tier (extract server, multi-stream runtime, fleet)
# ---------------------------------------------------------------------------

#: the reference's example workload (examples/multistream_serve.py):
#: name, dataset, stream seed, queries
SERVE_FEEDS = (("tb-north", "tollbooth", 1234, ("Q2", "Q6", "Q8")),
               ("tb-south", "tollbooth", 4321, ("Q1", "Q5")),
               ("tb-east", "tollbooth", 2025, ("Q3", "Q9")),
               ("court-1", "volleyball", 1234, ("Q12", "Q13")))
#: phase 17 (a)'s two more feeds: Q8 on its reduced and its fused plan over
#: TollBooth seed 11 (frame_diff, fused_preprocess and fused_prefix under
#: the server)
SERVE_Q8 = (("q8-reduced", "reduced"), ("q8-fused", "fused"))
#: the server's coalescing ceiling and its forwards in flight
SERVE_MAX_BATCH, SERVE_INFLIGHT = 64, 2
#: phase 17 (b)'s frames a feed, card against CPU
SERVE_CHECK_FRAMES = 32
#: phase 17 (c)'s four TollBooth feeds on Q8's naive plan
GATE_FEEDS = (("tb-north", 1234), ("tb-south", 4321), ("tb-east", 2025),
              ("tb-11", STREAM_SEED))
#: phase 17 (a)'s untimed warm-up run, frames a feed
SERVE_WARMUP_FRAMES = 128
#: phase 17 (e)'s fleet optimizer validation frames
FLEET_VAL_FRAMES = 32


def serve_stream(dataset, seed):
    from repro_torch.data import TollBoothStream, VolleyballStream

    if dataset == "tollbooth":
        return TollBoothStream(seed=seed)
    return VolleyballStream(seed=seed)


def serve_plans():
    """(feed, dataset, seed, plan) for every query of phase 17 (a)."""
    from repro_torch.queries.catalog import get_query

    out = [(name, ds, seed, get_query(q).naive_plan())
           for name, ds, seed, qids in SERVE_FEEDS for q in qids]
    out += [(name, "tollbooth", STREAM_SEED, q8_plan(which))
            for name, which in SERVE_Q8]
    return out


def serve_feeds():
    from repro_torch.scheduler import Feed

    plans = {}
    for name, ds, seed, plan in serve_plans():
        plans.setdefault((name, ds, seed), []).append(plan)
    return [Feed(name, serve_stream(ds, seed), ps)
            for (name, ds, seed), ps in plans.items()]


def run_served(ctx, feeds, n_frames, **kw):
    from repro_torch.scheduler import MultiStreamRuntime

    ms = MultiStreamRuntime(feeds, ctx, micro_batch=MICRO_BATCH,
                            max_inflight=SERVE_INFLIGHT, **kw)
    check(ms.server.max_batch == SERVE_MAX_BATCH,
          f"server max_batch {ms.server.max_batch}")
    return ms, ms.run(n_frames)


def served_equal(a, b, by_order=False):
    """Two served results' per-query records equal (``same_records``) on
    every feed and query, and their MLLM frames."""
    ok = a.mllm_frames == b.mllm_frames and a.feeds.keys() == b.feeds.keys()
    for name, fa in a.feeds.items():
        fb = b.feeds[name]
        ok = ok and fa.per_query.keys() == fb.per_query.keys() and all(
            same_records(r, fb.per_query[q], by_order)
            for q, r in fa.per_query.items())
    return ok


def feed_fps(res, n_frames):
    """Feed-frames/s of a served run (every feed's frames over its wall)."""
    return res.n_feeds * n_frames / res.wall_s


def serve_solo(ctx, n_frames):
    """Each query of phase 17 (a) alone through ``StreamRuntime`` on its
    feed's stream: results by (feed, query), the forwards of their
    extracts and the sum of their walls."""
    from repro_torch.streaming import operators as ops
    from repro_torch.streaming.runtime import StreamRuntime

    out, forwards, wall = {}, 0, 0.0
    for name, ds, seed, plan in serve_plans():
        r = StreamRuntime(plan, ctx, micro_batch=MICRO_BATCH).run(
            serve_stream(ds, seed), n_frames)
        out[(name, plan.query)] = r
        forwards += sum(op.forwards for op in plan.ops
                        if isinstance(op, ops.MLLMExtractOp))
        wall += r.wall_s
    return out, forwards, wall


def serving_phase(ctx):
    """Phase 17: the serving tier on the card.  (a) the example feeds plus
    Q8's reduced and fused feeds through ``MultiStreamRuntime``, pipelined
    and lock-step, against each query's own run; (b) the same feeds card
    against CPU; (c) the gate in the server; (d) faults; (e) the fleet
    optimizer, ``from_fleet`` and the plan audit.  Returns the launch
    counts by path and a summary."""
    from repro_torch.faults import FaultInjector, FaultRule
    from repro_torch.queries.catalog import get_query
    from repro_torch.semantic import GateConfig, SemanticGate

    counts, summary = {}, {}
    pix = ["flash_attention", "frame_diff", "fused_preprocess",
           "fused_prefix"]
    t0 = time.perf_counter()

    # (a) pipelined, lock-step, independent, after an untimed warm-up
    # run: the first served run of a process pays first uses (new bucket
    # shapes, library kernels loaded lazily)
    run_served(ctx, serve_feeds(), SERVE_WARMUP_FRAMES)
    (ms, piped), counts["serve_pipelined"] = counted(
        "serve_pipelined", pix,
        lambda: run_served(ctx, serve_feeds(), N_FRAMES))
    (_, lock), counts["serve_lockstep"] = counted(
        "serve_lockstep", pix,
        lambda: run_served(ctx, serve_feeds(), N_FRAMES, pipelined=False))
    solo, solo_forwards, solo_wall = serve_solo(ctx, N_FRAMES)
    check(served_equal(piped, lock),
          "serve: pipelined and lock-step results differ")
    for (name, qid), r in solo.items():
        check(same_records(piped.feeds[name].per_query[qid], r, True),
              f"serve {name} {qid}: served result differs from its own "
              "run")
    st, lst = piped.server_stats, lock.server_stats
    n_feeds = piped.n_feeds
    print("  " + ms.describe().replace("\n", "\n  "))
    print(f"  serve, {n_feeds} feeds x {N_FRAMES} frames, {piped.n_queries}"
          f" queries: each query == its own run bit for bit, pipelined == "
          f"lock-step; feed-frames/s pipelined {feed_fps(piped, N_FRAMES):.1f}"
          f" (wall {piped.wall_s:.3f} s), lock-step "
          f"{feed_fps(lock, N_FRAMES):.1f} ({lock.wall_s:.3f} s), "
          f"independent "
          f"{n_feeds * N_FRAMES / solo_wall:.1f} (sum of {len(solo)} walls "
          f"{solo_wall:.3f} s)")
    print(f"  serve forwards: pipelined {st['forwards']} (frames "
          f"{st['frames']}, padded {st['padded_frames']}, coalesced "
          f"{st['coalesced_batches']}, max in flight "
          f"{st['max_inflight_seen']}, staging allocated/reused/skipped "
          f"{st['staging_allocated']}/{st['staging_reused']}/"
          f"{st['staging_skipped']}); lock-step {lst['forwards']} (frames "
          f"{lst['frames']}, padded {lst['padded_frames']}, coalesced "
          f"{lst['coalesced_batches']}); independent {solo_forwards}")
    check(st["forwards"] < solo_forwards,
          f"serve: {st['forwards']} forwards, not fewer than the "
          f"independent {solo_forwards}")
    check(st["max_inflight_seen"] >= 2,
          f"serve: max_inflight_seen {st['max_inflight_seen']} < 2")
    summary["a"] = {
        "feeds": n_feeds, "queries": piped.n_queries,
        "feed_frames_s": {"pipelined": feed_fps(piped, N_FRAMES),
                          "lockstep": feed_fps(lock, N_FRAMES),
                          "independent": n_feeds * N_FRAMES / solo_wall},
        "wall_s": {"pipelined": piped.wall_s, "lockstep": lock.wall_s,
                   "independent_sum": solo_wall},
        "forwards": {"pipelined": st["forwards"],
                     "lockstep": lst["forwards"],
                     "independent": solo_forwards},
        "pipelined_stats": {k: st[k] for k in (
            "frames", "padded_frames", "coalesced_batches",
            "max_inflight_seen", "dispatches", "staging_allocated",
            "staging_reused", "staging_skipped")},
        "lockstep_stats": {k: lst[k] for k in (
            "frames", "padded_frames", "coalesced_batches")}}

    # the device's busy share over 128 frames a feed, pipelined
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        run_served(ctx, serve_feeds(), 128)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t1) * 1e3
    summary["a"]["device_busy_share_128"] = device_summary(
        prof, wall_ms, "serve_pipelined", "128 frames a feed (warm-up "
        "batch included)", 8)

    parts = {"a": time.perf_counter() - t0}

    # (b) card == CPU
    cpu = make_ctx("cpu")
    _, a = run_served(ctx, serve_feeds(), SERVE_CHECK_FRAMES)
    _, b = run_served(cpu, serve_feeds(), SERVE_CHECK_FRAMES)
    ok = served_equal(a, b) and all(
        get_query(q).evaluate(r) == get_query(q).evaluate(
            b.feeds[f].per_query[q])
        for f, fr in a.feeds.items() for q, r in fr.per_query.items())
    print(f"  serve card == CPU, {SERVE_CHECK_FRAMES} frames a feed: "
          f"records, windows, counts and scores {ok}")
    check(ok, "serve: card and CPU results differ")
    del cpu

    parts["b"] = time.perf_counter() - t0 - sum(parts.values())

    # (c) the gate in the server: four TollBooth feeds on Q8's naive plan
    from repro_torch.scheduler import Feed

    def gate_feeds():
        return [Feed(name, serve_stream("tollbooth", seed),
                     [get_query("Q8").naive_plan()])
                for name, seed in GATE_FEEDS]

    def gate(threshold):
        return SemanticGate(GateConfig(threshold=threshold),
                            device=ctx.device)

    (_, gated), counts["serve_gated"] = counted(
        "serve_gated", ["flash_attention"],
        lambda: run_served(ctx, gate_feeds(), N_FRAMES,
                           gate=gate(GATE_THRESHOLD)))
    _, ungated = run_served(ctx, gate_feeds(), N_FRAMES)
    _, gated2 = run_served(ctx, gate_feeds(), N_FRAMES,
                           gate=gate(GATE_THRESHOLD))
    _, off = run_served(ctx, gate_feeds(), N_FRAMES, gate=gate(0.0))
    check(served_equal(off, ungated),
          "serve: a gate at threshold 0 changed the results")
    check(served_equal(gated2, gated)
          and gated2.server_stats["cache_hits"]
          == gated.server_stats["cache_hits"],
          "serve: two gated runs differ")
    gs, us = gated.server_stats, ungated.server_stats
    print(f"  serve_gated at {GATE_THRESHOLD}, {len(GATE_FEEDS)} feeds: "
          f"hits {gs['cache_hits']}, misses {gs['cache_misses']}, "
          f"revalidations {gs['revalidations']} (mismatches "
          f"{gs['cache_mismatches']}); forward frames {gs['frames']} of "
          f"{gated.mllm_frames}, forwards {gs['forwards']} (padded "
          f"{gs['padded_frames']}); {feed_fps(gated, N_FRAMES):.1f} then "
          f"{feed_fps(gated2, N_FRAMES):.1f} feed-frames/s.  Ungated: "
          f"forward frames {us['frames']}, "
          f"forwards {us['forwards']}, {feed_fps(ungated, N_FRAMES):.1f} "
          f"feed-frames/s.  Threshold 0 == ungated bit for bit")
    check(gs["cache_hits"] > 0 and gs["frames"] < gated.mllm_frames,
          "serve_gated: no hit or no forward frame saved")
    summary["c"] = {
        "threshold": GATE_THRESHOLD, "feeds": len(GATE_FEEDS),
        "gated": {k: gs[k] for k in ("cache_hits", "cache_misses",
                                     "revalidations", "cache_mismatches",
                                     "frames", "forwards",
                                     "padded_frames")},
        "ungated": {k: us[k] for k in ("frames", "forwards",
                                       "padded_frames")},
        "mllm_frames": gated.mllm_frames,
        "feed_frames_s": {"gated": feed_fps(gated, N_FRAMES),
                          "gated_2": feed_fps(gated2, N_FRAMES),
                          "ungated": feed_fps(ungated, N_FRAMES)}}

    parts["c"] = time.perf_counter() - t0 - sum(parts.values())

    # (d) faults: one transient forward error, injected latency, and a
    # dead source on tb-east
    sick = "tb-east"
    inj = FaultInjector(seed=17, rules=[
        FaultRule(site="forward", kind="error", feed="tb-south", start=1,
                  count=1, param=1),
        FaultRule(site="forward", kind="latency", start=0, every=8,
                  count=4, param=2),
        FaultRule(site="source", kind="corrupt", feed=sick, start=2,
                  every=1, param=99)])
    (_, faulted), counts["serve_faulted"] = counted(
        "serve_faulted", pix,
        lambda: run_served(ctx, serve_feeds(), N_FRAMES, faults=inj))
    fst = faulted.server_stats
    for name, fr in faulted.feeds.items():
        check(fr.served + fr.degraded + fr.dropped == N_FRAMES,
              f"serve_faulted {name}: served {fr.served} + degraded "
              f"{fr.degraded} + dropped {fr.dropped} != {N_FRAMES}")
        if name != sick:
            check(fr.breaker.get("trips", 0) == 0 and all(
                same_records(r, piped.feeds[name].per_query[q])
                for q, r in fr.per_query.items()),
                f"serve_faulted {name}: a healthy feed's results differ "
                "from the clean run's")
    sf = faulted.feeds[sick]
    check(sf.breaker.get("trips", 0) >= 1,
          f"serve_faulted: the breaker did not trip on {sick}")
    check(fst["retries"] >= 1 and fst["latency_faults"] >= 1,
          "serve_faulted: the forward error or the latency never fired")
    print(f"  serve_faulted: {len(inj.log)} faults fired; retries "
          f"{fst['retries']}, latency faults {fst['latency_faults']}; "
          f"{sick}: served {sf.served}, degraded {sf.degraded}, dropped "
          f"{sf.dropped}, breaker {sf.breaker}; the {n_feeds - 1} healthy "
          f"feeds == the clean run bit for bit")
    summary["d"] = {"faults_fired": len(inj.log),
                    "retries": fst["retries"],
                    "latency_faults": fst["latency_faults"],
                    "sick": {"served": sf.served, "degraded": sf.degraded,
                             "dropped": sf.dropped,
                             "breaker": dict(sf.breaker)}}

    parts["d"] = time.perf_counter() - t0 - sum(parts.values())

    # (e) the fleet optimizer, from_fleet, and the plan audit
    from repro_torch.core.fleet import FleetOptimizer, FleetQuery
    from repro_torch.obs import Observability, forward_gap
    from repro_torch.scheduler import MultiStreamRuntime
    from repro_torch.streaming.runtime import StreamRuntime

    workload = [FleetQuery(get_query(q),
                           lambda s, ds=ds: serve_stream(ds, s), feed=name)
                for name, ds, _, qids in SERVE_FEEDS for q in qids]
    t1 = time.perf_counter()
    fleet = FleetOptimizer(ctx, val_frames=FLEET_VAL_FRAMES,
                           micro_batch=MICRO_BATCH).optimize(workload)
    t_opt = time.perf_counter() - t1
    for line in fleet.describe().splitlines():
        print(f"  | {line}")
    seeds = {name: (ds, seed) for name, ds, seed, _ in SERVE_FEEDS}

    def streams():
        return {name: serve_stream(*seeds[name])
                for name in fleet.plans_by_feed}

    def fleet_run(c):
        ms = MultiStreamRuntime.from_fleet(fleet, streams(), c,
                                           micro_batch=MICRO_BATCH)
        return ms, ms.run(N_FRAMES)

    (_, fres), counts["serve_fleet"] = counted(
        "serve_fleet", ["flash_attention"], lambda: fleet_run(ctx))
    fsolo_wall = 0.0
    for name, plans in fleet.plans_by_feed.items():
        for p in plans:
            r = StreamRuntime(p.clone(), ctx, micro_batch=MICRO_BATCH).run(
                serve_stream(*seeds[name]), N_FRAMES)
            fsolo_wall += r.wall_s
            check(same_records(fres.feeds[name].per_query[p.query], r,
                               True),
                  f"serve_fleet {name} {p.query}: differs from its solo run")
    obs = Observability(slo_target_ms=SLO_TARGET_MS)
    oms, ores = fleet_run(dataclasses.replace(ctx, obs=obs))
    check(served_equal(ores, fres), "serve_fleet: observed run differs")
    for line in oms.audit().table(obs.metrics).splitlines():
        print(f"  | {line}")
    gap = forward_gap(obs.metrics)
    print(f"  serve_fleet: optimize {t_opt:.1f} s; {fres.n_queries} "
          f"queries == their solo runs bit for bit; forwards "
          f"{fres.server_stats['forwards']}; {feed_fps(fres, N_FRAMES):.1f}"
          f" feed-frames/s (solo sum of walls {fsolo_wall:.3f} s); "
          f"observed == unobserved; forward_gap {gap}; drift flags "
          f"{oms.drift_flags}")
    check(gap is not None and gap["probes"] > 0,
          "serve_fleet: no forward_device_ms probe")
    summary["e"] = {"optimize_s": t_opt, "decisions": fleet.decisions,
                    "fleet_cost_us": fleet.fleet_cost_us,
                    "forwards": fres.server_stats["forwards"],
                    "feed_frames_s": feed_fps(fres, N_FRAMES),
                    "solo_wall_s": fsolo_wall, "forward_gap": gap,
                    "drift_flags": list(oms.drift_flags)}
    summary["seconds"] = time.perf_counter() - t0
    parts["e"] = summary["seconds"] - sum(parts.values())
    summary["part_seconds"] = parts
    print(f"[17] {summary['seconds']:.1f} s: " + ", ".join(
        f"({k}) {v:.1f}" for k, v in parts.items())
        + f" (optimize {t_opt:.1f})")
    return counts, summary


# ---------------------------------------------------------------------------
# phases 9-11: LM serving
# ---------------------------------------------------------------------------

def timed_engine(lm, **kw):
    """A ``ServingEngine`` that records the host wall time of each prefill
    (with its padded length) and each batched decode step (with its count
    of active slots), each ending in ``torch.cuda.synchronize()`` (the
    engine waits for the sampled tokens at the end of both anyway)."""
    from repro_torch.kernels.decode_attention.kernel import \
        MIN_KEYS_PER_SPLIT
    from repro_torch.serving.engine import ServingEngine

    class Timed(ServingEngine):
        def _prefill(self, tokens, last_pos):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = super()._prefill(tokens, last_pos)
            torch.cuda.synchronize()
            self.prefill_ms.append((tokens.shape[1],
                                    (time.perf_counter() - t0) * 1e3))
            return out

        def _decode_step(self, tokens, active):
            torch.cuda.synchronize()
            # decode attends over every slot's lens + 1 keys
            self.decode_long.append(
                int(self.lens.max()) + 1 > MIN_KEYS_PER_SPLIT)
            t0 = time.perf_counter()
            out = super()._decode_step(tokens, active)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            self.decode_ms.append(ms)
            self.decode_active.append((int(active.sum()), ms))
            return out

    eng = Timed(lm, **kw)
    eng.prefill_ms, eng.decode_ms, eng.decode_active = [], [], []
    eng.decode_long = []
    return eng


def serve_requests(cfg, long_len):
    """The serving launcher's 8 requests (seed 0, prompts of 4-23 tokens,
    12 new tokens each) plus one of ``long_len`` prompt tokens."""
    from repro_torch.launch.serve import make_requests
    from repro_torch.serving.engine import Request

    reqs = make_requests(cfg, 8, SERVE_NEW)
    rs = np.random.RandomState(1)
    reqs.append(Request(uid=8, prompt=list(rs.randint(2, cfg.vocab_size,
                                                      long_len)),
                        max_new_tokens=SERVE_NEW))
    return reqs


def serve_phase(name, arch, dev, per_prefill=(), per_decode=(), lm=None,
                depth=None, dtype=torch.float32, build_in_dtype=False):
    """One LM at full width (at ``depth`` layers where given, else the
    config's) through ``ServingEngine(dtype=dtype)``: seeded random
    weights drawn on the card and a warm-up run (a short and a long
    request), or the given ``lm``, already warm; then the measured run of
    ``serve_requests`` with the launch counts zeroed just before and read
    just after.  At a ``dtype`` other than fp32 the weights are drawn in
    fp32 and cast once (``LM.cast_``: the fp32 model's weights, rounded),
    or, with ``build_in_dtype``, held in ``dtype`` from the start (a model
    whose fp32 weights would not fit; other numbers at the same seed).
    Each kernel of ``per_prefill`` must have launched once per layer per
    prefill, each of ``per_decode`` once per layer per decode step.
    Returns the numbers, the counts, the LM, the engine and the finished
    requests."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models.model import LM
    from repro_torch.serving.engine import Request

    cfg = get_config(arch)
    if depth is not None:
        cfg = cfg.replace(n_layers=depth)
    kw = dict(max_slots=SERVE_SLOTS, s_max=SERVE_S_MAX, eos_id=-1,
              dtype=dtype)
    if lm is None:
        t0 = time.perf_counter()
        gen = torch.Generator(device=dev).manual_seed(0)
        if build_in_dtype:
            lm = LM(cfg, device=dev, dtype=dtype).init(gen)
        else:
            lm = LM(cfg, device=dev).init(gen)
            if dtype != torch.float32:
                lm.cast_(dtype)
        torch.cuda.synchronize()
        n_params = sum(p.numel() for p in lm.parameters())
        n_bytes = sum(p.numel() * p.element_size() for p in lm.parameters())
        print(f"  {arch}: {n_params / 1e9:.3f} G parameters "
              f"({n_bytes / 1e9:.2f} GB, compute dtype {dtype}) drawn on the "
              f"card in {time.perf_counter() - t0:.2f} s; {cfg.n_layers} "
              f"layers, d_model {cfg.d_model}, vocab {cfg.vocab_size}")
        warm = timed_engine(lm, **kw)
        rs = np.random.RandomState(2)
        warm.run([Request(uid=-1, prompt=[2, 3, 4, 5], max_new_tokens=2),
                  Request(uid=-2, prompt=list(rs.randint(
                      2, cfg.vocab_size, LONG_PROMPT[arch])),
                      max_new_tokens=2)])
        del warm
        torch.cuda.empty_cache()
    n_params = sum(p.numel() for p in lm.parameters())

    eng = timed_engine(lm, **kw)
    reqs = serve_requests(cfg, LONG_PROMPT[arch])
    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    done = eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    tokens = sum(len(r.output) for r in done)
    long_ms = [ms for n, ms in eng.prefill_ms if n >= LONG_PROMPT[arch]]
    # decode throughput apart from the prefills: tokens sampled by decode
    # steps over the steps' time, and over the ticks with every slot busy
    full = [ms for n, ms in eng.decode_active if n == SERVE_SLOTS]
    res = {"requests": len(done), "tokens": tokens, "wall_s": wall,
           "tokens_per_s": tokens / wall,
           "decode_tokens_per_s": sum(n for n, _ in eng.decode_active)
           / (sum(ms for _, ms in eng.decode_active) / 1e3),
           "full_batch_ticks": len(full),
           "full_batch_decode_tokens_per_s":
               SERVE_SLOTS * len(full) / (sum(full) / 1e3) if full else None,
           "decode_steps": eng.stats["decode_steps"],
           "decode_step_ms_median": statistics.median(eng.decode_ms),
           "decode_step_ms_max": max(eng.decode_ms),
           "prefill_ms_long": long_ms[0] if long_ms else None,
           "long_prompt": LONG_PROMPT[arch],
           "prefill_ms_short_median": statistics.median(
               [ms for n, ms in eng.prefill_ms if n < LONG_PROMPT[arch]]),
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
           "stats": dict(eng.stats), "parameters": n_params}
    print(f"  {name}: served {len(done)} requests, {tokens} tokens in "
          f"{wall:.3f} s = {tokens / wall:.1f} tokens/s over the whole smoke "
          f"request set; decode alone {res['decode_tokens_per_s']:.1f} "
          f"tokens/s, {res['full_batch_ticks']} ticks with all "
          f"{SERVE_SLOTS} slots busy at "
          f"{res['full_batch_decode_tokens_per_s'] or 0:.1f} tokens/s; "
          f"{res['decode_steps']} decode steps, median "
          f"{res['decode_step_ms_median']:.3f} ms (max "
          f"{res['decode_step_ms_max']:.3f}); prefill of the "
          f"{LONG_PROMPT[arch]}-token request {res['prefill_ms_long']:.1f} ms"
          f", short prefills median {res['prefill_ms_short_median']:.1f} ms;"
          f" peak memory {res['peak_memory_gb']:.2f} GB; stats {eng.stats}")
    print(f"  {name} launches by kernel: "
          + ", ".join(f"{k} {n}" for k, n in sorted(counts.items()) if n))
    check(len(done) == len(reqs) and eng.stats["finished"] == len(reqs),
          f"{name}: {len(done)} of {len(reqs)} requests finished")
    check(all(len(r.output) == SERVE_NEW and r.done for r in done)
          and all(0 <= t < cfg.padded_vocab for r in done for t in r.output),
          f"{name}: a request's tokens are missing or out of the vocab")
    check(eng.stats["prefill_tokens"] == sum(len(r.prompt) for r in reqs),
          f"{name}: prefill_tokens {eng.stats['prefill_tokens']}")
    n_prefill = len(eng.prefill_ms)
    for kernels, per, n in ((per_prefill, "prefills", n_prefill),
                            (per_decode, "steps", res["decode_steps"])):
        want = cfg.n_layers * n
        for k in kernels:
            for sym in (KERNELS[k][0],) + COMPANIONS.get(k, ()):
                check(counts[sym] == want,
                      f"{name}: {sym} launched {counts[sym]} times, not "
                      f"{want} ({cfg.n_layers} layers x {n} {per})")
    # launches by step class, derived: the engine's steps of each class
    # (a mamba prefill of whole 256-token chunks, a decode step with a slot
    # past one split: long; the others short), classed on the host, times
    # the launches a step makes (one a layer, counted and checked above)
    n_long = {"prefills": sum(n >= SSD_CHUNK for n, _ in eng.prefill_ms),
              "steps": sum(eng.decode_long)}
    res["launches_by_step_class"] = {
        k: {"long": cfg.n_layers * n_long[per],
            "short": cfg.n_layers * (n - n_long[per])}
        for kernels, per, n in ((per_prefill, "prefills", n_prefill),
                                (per_decode, "steps", res["decode_steps"]))
        for k in kernels if k in CLASSED}
    if res["launches_by_step_class"]:
        print(f"  {name} launches by step class (long / short; {cfg.n_layers}"
              " a step, times the steps of each class): "
              + ", ".join(f"{k} {c['long']} / {c['short']}" for k, c in
                          res["launches_by_step_class"].items()))
    return res, counts, lm, eng, done


def trace_decode(name, eng, cfg, n_ticks=6):
    """Where a decode tick's time goes: four short requests admitted and
    one tick run first, then ``n_ticks`` batched decode ticks profiled
    (device kernel time by name against the host wall clock)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.serve import make_requests

    for r in make_requests(cfg, SERVE_SLOTS, n_ticks + 4):
        eng.submit(r)
    eng.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_ticks):
            eng.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    return device_summary(prof, wall_ms, name,
                          f"{n_ticks} decode ticks of {SERVE_SLOTS} slots", 8)


@contextlib.contextmanager
def plain_attention():
    """The LM's attention calls the plain versions of flash_attention and
    decode_attention on the card, for the duration of the block."""
    from repro_torch.kernels.decode_attention.ref import \
        decode_attention_plain
    from repro_torch.kernels.flash_attention.ref import flash_attention_plain
    from repro_torch.models import attention

    kernels = attention.flash_attention, attention.decode_attention
    attention.flash_attention = flash_attention_plain
    attention.decode_attention = decode_attention_plain
    try:
        yield
    finally:
        attention.flash_attention, attention.decode_attention = kernels


def decode_vs_float64(arch, run):
    """``run`` (the card's prefill and decode steps) with decode_attention's
    inputs captured: each layer's attention at the first decode step is
    computed again by the kernel, the card's plain version and the CPU's,
    and their distances from float64 are printed (not gated)."""
    from repro_torch.kernels.decode_attention.kernel import \
        decode_attention_cuda
    from repro_torch.kernels.decode_attention.ref import \
        decode_attention_plain
    from repro_torch.models import attention

    seen, kernel = [], attention.decode_attention

    def capture(q, k, v, kv_len, **kw):
        seen.append((q.clone(), k.clone(), v.clone(), kv_len.clone(), kw))
        return kernel(q, k, v, kv_len, **kw)

    attention.decode_attention = capture
    try:
        run()
    finally:
        attention.decode_attention = kernel
    for layer, (q, k, v, kv_len, kw) in enumerate(seen[:2]):
        mask = torch.arange(k.shape[1], device=q.device)[None, None, :] \
            < kv_len[:, :, None]
        exact = attention64(q, k, v, mask).cpu()
        top = exact.abs().max().item()
        outs = {"kernel": decode_attention_cuda(q, k, v, kv_len, **kw),
                "plain": decode_attention_plain(q, k, v, kv_len, **kw),
                "cpu": decode_attention_plain(q.cpu(), k.cpu(), v.cpu(),
                                              kv_len.cpu(), **kw)}
        far = {n: (o.cpu().double() - exact).abs().max().item() / top
               for n, o in outs.items()}
        print(f"  {arch} depth 2, layer {layer}'s decode attention at the "
              f"first decode step ({int(kv_len.max())} keys) vs float64 (of "
              f"the largest |out| {top:.2f}; printed, not gated): kernel "
              f"{far['kernel']:.3e}, plain on the card {far['plain']:.3e}, "
              f"plain on the CPU {far['cpu']:.3e}")


def lm_card_vs_cpu(dev):
    """The served LMs at full width and depth 2 (one gemma2 period, two
    layers of the others), the same weights on the card and the CPU: three
    requests through two slots give equal tokens, and the prefill and
    three decode steps' logits agree within LM_TOL.  The dense zoo holds
    the attention kernels' group of 16 (chatglm3, glm4) and head dim 96
    (phi3-mini) on a real path.  The same steps on the card with the
    attention kernels' plain versions are printed beside them."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import make_requests
    from repro_torch.models.model import LM
    from repro_torch.serving.engine import ServingEngine

    for arch in ("gemma2-2b", "mamba2-130m", "chatglm3-6b", "glm4-9b",
                 "phi3-mini-3.8b"):
        cfg = get_config(arch).replace(n_layers=2)
        cpu = LM(cfg, device="cpu").init(torch.Generator().manual_seed(3))
        card = LM(cfg, device=dev)
        card.load_state_dict(cpu.state_dict())
        outs = [[r.output for r in ServingEngine(
            lm, max_slots=2, s_max=64, eos_id=-1).run(
                make_requests(cfg, 3, 6))] for lm in (cpu, card)]
        prompt = torch.tensor([make_requests(cfg, 1, 1)[0].prompt])

        def steps(lm):
            """The prompt's prefill and three decode steps' logits."""
            cache = lm.init_cache(1, 64)
            lg, cache = lm.prefill(prompt, cache)
            out = [lg]
            for t in range(3):
                tok = torch.tensor([[outs[0][0][t]]])
                lg, cache = lm.decode(tok, cache,
                                      torch.tensor(prompt.shape[1] + t))
                out.append(lg)
            return [x.cpu() for x in out]

        want, got = steps(cpu), steps(card)
        if arch in DENSE_ZOO:
            decode_vs_float64(arch, lambda: steps(card))
        errs = []
        for a, b in zip(got, want):
            check(torch.isfinite(a).all() and a.shape == b.shape,
                  f"{arch}: non-finite or misshapen logits on the card")
            errs.append((a - b).abs().max().item())
        same = outs[0] == outs[1]
        print(f"  {arch} depth 2: card == CPU tokens {same} ({outs[1]}); "
              f"logits max_abs_err prefill {errs[0]:.3e}, decode "
              + ", ".join(f"{e:.3e}" for e in errs[1:])
              + f" (tol {LM_TOL:g})")
        if not cfg.has_mamba:
            with plain_attention():
                ref = [(a - b).abs().max().item()
                       for a, b in zip(steps(card), want)]
            print(f"  {arch} depth 2: the card with the attention kernels' "
                  f"plain versions (printed, not gated): prefill "
                  f"{ref[0]:.3e}, decode "
                  + ", ".join(f"{e:.3e}" for e in ref[1:]))
        check(same, f"{arch}: card and CPU tokens differ")
        check(all(e < LM_TOL for e in errs),
              f"{arch}: card vs CPU logits {errs} (tol {LM_TOL})")
        del cpu, card
    torch.cuda.empty_cache()


def layer_projections(params, qparams, layer=0):
    """Layer ``layer``'s slice of every quantized projection of a dense
    stack, as the (K, N) operands of ``matmul_int8_dynamic``: name -> (fp32
    weight, int8 codes, column scale (1, N)).  wq/wk/wv (d, H, Dh) fold
    their heads into N, whose per-Dh scale is tiled over the heads; wo
    (H, Dh, d) folds them into K.  Views of the trees: nothing is copied
    but the scales."""
    blk, qblk = params["stack"]["i0"], qparams["stack"]["i0"]
    out = {}
    for part, names in (("mixer", ("wq", "wk", "wv", "wo")),
                        ("mlp", ("w_in", "w_gate", "w_out"))):
        for name in names:
            w, q = blk[part][name][layer], qblk[part][name]
            k = w.shape[0] * w.shape[1] if name == "wo" else w.shape[0]
            w2, q2 = w.reshape(k, -1), q["q"][layer].reshape(k, -1)
            sw = q["scale"].reshape(1, -1)
            sw = sw.repeat(1, q2.shape[1] // sw.shape[1])
            check(tuple(q2.shape) == CHATGLM3_PROJ[name],
                  f"chatglm3 {name}: (K, N) {tuple(q2.shape)}")
            out[name] = (w2, q2, sw)
    return out


def chatglm3_int8(dev, rows):
    """Phase 12: chatglm3-6b at full width through the engine, then the
    reference's int8 recipe on the same weights on the card: quantize,
    layer 0's projections through matmul_int8_dynamic at M = 4 and at the
    long prompt's length (the path ``chatglm3_int8``), dequantize, the
    same requests again.  Returns the serving numbers and launch counts of
    the three paths and the int8 summary."""
    from repro_torch.bridge import flatten
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.int8_matmul.ops import matmul_int8_dynamic
    from repro_torch.kernels.int8_matmul.ref import (int8_matmul_plain,
                                                     quantize_rowwise)
    from repro_torch.serving.quantize import (dequantize_params,
                                              quantize_params_int8)

    arch, long_m = "chatglm3-6b", LONG_PROMPT["chatglm3-6b"]
    serving, counts = {}, {}
    serving["chatglm3_serve"], counts["chatglm3_serve"], lm, eng, done = \
        serve_phase("chatglm3_serve", arch, dev,
                    per_prefill=["flash_attention"],
                    per_decode=["decode_attention"])
    busy = trace_decode("chatglm3_decode", eng, lm.cfg)
    del eng
    torch.cuda.empty_cache()
    fp32_out = {r.uid: r.output for r in done}
    # the reference test's logits: two rows of 32 tokens, fp32 weights
    tokens = torch.arange(64).reshape(2, 32) % lm.cfg.vocab_size
    fp32_top1 = lm.logits_causal(tokens).argmax(-1).cpu()
    FP32_CHATGLM3.update(top1=fp32_top1, out=fp32_out)

    torch.cuda.reset_peak_memory_stats()
    params = lm.tree()
    t0 = time.perf_counter()
    qparams, stats = quantize_params_int8(params)
    torch.cuda.synchronize()
    quantize_s = time.perf_counter() - t0
    print(f"  quantize_params_int8: {stats['orig_bytes'] / 1e9:.3f} GB fp32"
          f" -> {stats['quant_bytes'] / 1e9:.3f} GB (ratio "
          f"{stats['ratio']:.4f}, bound 0.35) in {quantize_s:.2f} s")
    check(stats["ratio"] < 0.35, f"chatglm3 int8: ratio {stats['ratio']}")
    # the card's codes, scales and dequantized weights against the CPU's on
    # one stacked leaf (wk, 28 x 4096 x 2 x 128)
    leaf = qparams["stack"]["i0"]["mixer"]["wk"]
    cpu_leaf = quantize_params_int8(
        {"wk": params["stack"]["i0"]["mixer"]["wk"].cpu()})[0]["wk"]
    same = {"codes": torch.equal(leaf["q"].cpu(), cpu_leaf["q"]),
            "scales": torch.equal(leaf["scale"].cpu(), cpu_leaf["scale"]),
            "dequantized": torch.equal(
                dequantize_params({"wk": leaf})["wk"].cpu(),
                dequantize_params({"wk": cpu_leaf})["wk"])}
    print(f"  wk {tuple(leaf['q'].shape)}: card == CPU {same}")
    check(all(same.values()), f"chatglm3 int8 wk: card vs CPU {same}")
    del leaf, cpu_leaf

    # the path: every quantized projection of layer 0 at a decode tick's
    # M and a long prefill's, activations from a seed on the card
    proj = layer_projections(params, qparams)
    gen = torch.Generator(device=dev).manual_seed(10)
    xs = {(m, k): torch.randn(m, k, generator=gen, device=dev)
          for m in (SERVE_SLOTS, long_m)
          for k in sorted({w2.shape[0] for w2, _, _ in proj.values()})}
    reset_launch_counts()
    outs = {(name, m): matmul_int8_dynamic(xs[m, w2.shape[0]], q2, sw)
            for name, (w2, q2, sw) in proj.items()
            for m in (SERVE_SLOTS, long_m)}
    torch.cuda.synchronize()
    counts["chatglm3_int8"] = launch_counts()
    # each projection once at each M: a pre-pass and a product each
    for sym in (KERNELS["int8_matmul"][0],) + COMPANIONS["int8_matmul"]:
        check(counts["chatglm3_int8"][sym] == len(outs),
              f"chatglm3_int8: {sym} launched "
              f"{counts['chatglm3_int8'][sym]} times, not {len(outs)}")
    rel_max = 0.0
    for (name, m), got in outs.items():
        w2, q2, sw = proj[name]
        x = xs[m, w2.shape[0]]
        x_q, sx = quantize_rowwise(x)
        compare("int8_matmul", got, int8_matmul_plain(x_q, q2, sx, sw),
                f"chatglm3 layer 0 {name} M{m}")
        exact = x @ w2
        rel = ((got - exact).abs().max() / exact.abs().max()).item()
        rel_max = max(rel_max, rel)
        check(rel < 0.05, f"chatglm3 {name} M{m}: {rel:.4f} of the fp32 "
              "product, above 0.05")
    print(f"  chatglm3 layer 0, 7 projections x M {SERVE_SLOTS} and "
          f"{long_m} through matmul_int8_dynamic: {len(outs)} products, "
          f"equal to the plain version, at most {rel_max:.4f} of the fp32 "
          "product's largest magnitude (bound 0.05)")
    w2, q2, sw = proj["w_in"]
    x_q, sx = quantize_rowwise(xs[long_m, w2.shape[0]])
    rows["int8_matmul"][f"chatglm3 w_in prefill M{long_m} K{w2.shape[0]} "
                        f"N{w2.shape[1]}"] = int8_timing(
        "chatglm3 w_in prefill", x_q, q2, sx, sw)
    del outs, xs, proj, params, x_q, w2, q2, sw

    t0 = time.perf_counter()
    dq = dequantize_params(qparams)
    del qparams
    lm.load_state_dict(flatten(dq), assign=True)
    del dq
    torch.cuda.synchronize()
    dequantize_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.empty_cache()
    print(f"  dequantize_params into the LM in {dequantize_s:.2f} s; peak "
          f"memory while quantizing and dequantizing {peak:.2f} GB")
    int8_top1 = lm.logits_causal(tokens).argmax(-1).cpu()
    path = "chatglm3_dequant_serve"
    serving[path], counts[path], lm, eng, done = serve_phase(
        path, arch, dev, per_prefill=["flash_attention"],
        per_decode=["decode_attention"], lm=lm)
    del eng, lm
    torch.cuda.empty_cache()
    int8_out = {r.uid: r.output for r in done}
    top1 = (fp32_top1 == int8_top1).float().mean().item()
    first = sum(fp32_out[u][0] == int8_out[u][0] for u in fp32_out) \
        / len(fp32_out)
    same = sum(a == b for u in fp32_out
               for a, b in zip(fp32_out[u], int8_out[u])) \
        / sum(len(o) for o in fp32_out.values())
    print(f"  int8 weights vs fp32 (printed, not gated): top-1 agreement of "
          f"the logits on 2 x 32 tokens {top1:.4f}; first served token "
          f"equal for {first:.4f} of the requests, all served tokens "
          f"{same:.4f}")
    summary = {**stats, "quantize_s": quantize_s,
               "dequantize_s": dequantize_s, "peak_memory_gb": peak,
               "max_rel_err_vs_fp32": rel_max, "top1_agreement": top1,
               "first_token_agreement": first, "token_agreement": same,
               "decode_busy_share": busy}
    return serving, counts, summary


# ---------------------------------------------------------------------------
# phase 18: training on the card
# ---------------------------------------------------------------------------

#: (a) the backward's gate: against float64, each of dQ, dK, dV of the
#: kernel no farther than BWD_WITNESS times the fp32 plain version's
#: autograd (on the same card), plus BWD_FLOOR of the largest float64
#: gradient (a few ulps of it, where the plain version happens to land on
#: float64's rounding)
BWD_WITNESS, BWD_FLOOR = 2.0, 1e-6
#: (a) the backward's path shapes, (B, S, H, Hk, D), as pretraining's
#: batches give them (patches of 16 plus 12 task tokens): the big stream
#: MLLM's ``_make_mllm_batches`` at the full frame (128 x 256), the crop
#: (64 x 256), the crop /2 (32 x 128) and volleyball /2 (64 x 128); the small
#: one's ``_make_distill_batches`` at the crop /2 and volleyball /2 (the only
#: frames it trains on); chatglm3-6b's micro-batch of 8 x 64 tokens
BWD_PATH = {"mllm_s140": (16, 140, 8, 4, 32), "mllm_s76": (16, 76, 8, 4, 32),
            "mllm_s28": (16, 28, 8, 4, 32), "mllm_s44": (16, 44, 8, 4, 32),
            "small_s28": (16, 28, 4, 4, 32), "small_s44": (16, 44, 4, 4, 32),
            "chatglm3_b8_s64": (8, 64, 32, 2, 128)}
#: (b) pretraining's steps: the big MLLM, the distilled small one, TinyDet
#: (the reference's defaults are 1600 / 500 / 250; halved from 400 / 150 /
#: 100 to keep the script's time as phases 22 and 23 came)
PRETRAIN_STEPS = (200, 75, 50)
#: (b) losses are compared as the mean of the first and of the last
#: LOSS_WINDOW steps
LOSS_WINDOW = 20
#: (c) card == CPU: the big MLLM's steps, and its tolerance (ROADMAP,
#: "Tolerances": the big MLLM's logits drift up to 5.1e-4 in fp32); a
#: gradient leaf may instead be as far as BWD_WITNESS times the plain
#: attention's on the card (``mllm_card_vs_cpu``)
CARD_CPU_STEPS, CARD_CPU_TOL = 3, 1e-3
#: (d) the reference launcher's recipe at full width and depth
CHATGLM3_TRAIN = ("--arch", "chatglm3-6b", "--int8-opt", "--steps", "3",
                  "--batch", "16", "--seq", "64", "--grad-accum", "2")
#: (e) the replay's tolerance, the reference test's
REPLAY_RTOL, REPLAY_ATOL = 1e-4, 1e-5


def flash64(q, k, v, causal=True, cap=None, window=None):
    """flash attention in float64 from the same inputs, differentiable (the
    plain version's arithmetic, float64 throughout)."""
    from repro_torch.kernels.flash_attention.ref import flash_attention_plain

    return flash_attention_plain(q.double(), k.double(), v.double(),
                                 causal=causal, cap=cap, window=window)


def visible_pairs(s, causal=True, window=None, sk=None):
    if sk is not None and sk != s:     # rectangular: no mask
        return s * sk
    qpos = torch.arange(s)[:, None]
    kpos = torch.arange(s)[None, :]
    mask = torch.ones(s, s, dtype=torch.bool)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    return int(mask.sum())


def grads_of(fn, q, k, v, dout, **kw):
    """(out, dq, dk, dv) of ``fn`` by autograd at ``dout``."""
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    out = fn(*leaves, **kw)
    out.backward(dout.to(out.dtype))
    return [out.detach()] + [t.grad for t in leaves]


def flash_bwd_check(label, q, k, v, dout, kw):
    """The kernels' gradient (``ops.flash_attention``: the forward with its
    log-sum-exp, then the backward) against the plain version's autograd
    in fp32 on the card and in float64: within ``TOL`` of the plain one
    (relative to its largest gradient) and within the float64 gate; a
    second launch equal bit for bit.  Also the training forward's log-sum-
    exp against the plain one."""
    from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_lse_plain, flash_attention_plain)

    got = grads_of(flash_attention, q, k, v, dout, **kw)
    again = grads_of(flash_attention, q, k, v, dout, **kw)
    plain = grads_of(flash_attention_plain, q, k, v, dout, **kw)
    f64 = grads_of(flash64, q, k, v, dout, **kw)
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          f"flash_attention_bwd {label}: two launches differ")
    worst = 0.0
    for name, g, p, w in zip(("out", "dq", "dk", "dv"), got, plain, f64):
        scale = max(w.abs().max().item(), 1e-30)
        err_k = (g.double() - w).abs().max().item()
        err_p = (p.double() - w).abs().max().item()
        vs_plain = (g - p).abs().max().item()
        check(torch.isfinite(g).all(),
              f"flash_attention_bwd {label} {name}: not finite")
        if name == "out":
            continue
        tol = TOL["flash_attention_bwd"] * max(p.abs().max().item(), 1.0)
        check(vs_plain <= tol, f"flash_attention_bwd {label} {name}: "
              f"{vs_plain:.3e} from the plain version (tol {tol:.3e})")
        check(err_k <= BWD_WITNESS * err_p + BWD_FLOOR * scale,
              f"flash_attention_bwd {label} {name}: {err_k:.3e} from "
              f"float64 against the plain version's {err_p:.3e}")
        worst = max(worst, err_k / max(err_p, BWD_FLOOR * scale))
        ERRS["flash_attention_bwd"] = max(ERRS["flash_attention_bwd"],
                                          vs_plain)
    with torch.no_grad():
        out, lse = flash_attention_cuda(q, k, v, lse=True, **kw)
        want_out, want_lse = flash_attention_lse_plain(q, k, v, **kw)
    compare("flash_attention_lse", out, want_out, f"{label} out")
    compare("flash_attention_lse", lse, want_lse, f"{label} lse")
    print(f"  flash_attention_bwd {label:44s} vs plain "
          f"{ERRS['flash_attention_bwd']:.3e}, vs float64 at most "
          f"{worst:.2f}x the plain version's (gate {BWD_WITNESS:g}x + "
          f"{BWD_FLOOR:g} max|g|)")


def bwd_timing(label, b, s, h, hk, d, sk=None):
    """Device ms at one path shape: the backward alone (``autograd.grad``
    of a retained graph) and forward + backward, of the kernels, of the
    plain version's autograd and of SDPA's fp32 backward (one call with
    ``enable_gqa``, causal; timed only), with the backward's bound; and the
    training forward (with its log-sum-exp) against its plain version.
    With ``sk`` (cross attention): ``sk`` keys, bidirectional."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_lse_plain, flash_attention_plain)

    causal = sk is None
    sk = s if sk is None else sk
    gen = torch.Generator().manual_seed(b * s + d)
    q, k, v, dout = (torch.randn(shape, generator=gen).to("cuda") for shape
                     in ((b, s, h, d), (b, sk, hk, d), (b, sk, hk, d),
                         (b, s, h, d)))

    def sdpa(q, k, v):
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=causal, enable_gqa=True).transpose(1, 2)

    def kernels(q, k, v):
        return flash_attention(q, k, v, causal=causal)

    def plain(q, k, v):
        return flash_attention_plain(q, k, v, causal=causal)

    t = {}
    for name, fn in (("ms", kernels), ("plain_ms", plain),
                     ("library_ms", sdpa)):
        leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
        out = fn(*leaves)
        t[name] = device_ms(lambda: torch.autograd.grad(
            out, leaves, dout, retain_graph=True), n=20)

        def both():
            ls = [x.clone().requires_grad_(True) for x in (q, k, v)]
            torch.autograd.grad(fn(*ls), ls, dout)

        t[f"fwd_bwd_{name}"] = device_ms(both, n=10)
    # SDPA on kv heads repeated before the timing, printed beside the one
    # call: another kernel where G > 1 in fp32, and a backward without the
    # group's sum of dK and dV
    kx, vx = (x.repeat_interleave(h // hk, dim=2) for x in (k, v))
    leaves = [x.clone().requires_grad_(True) for x in (q, kx, vx)]
    out = sdpa(*leaves)
    t["library_expanded_ms"] = device_ms(lambda: torch.autograd.grad(
        out, leaves, dout, retain_graph=True), n=20)
    pairs = b * h * visible_pairs(s, causal, sk=sk)
    nbytes = 4 * (4 * q.numel() + 4 * k.numel() + b * h * s)
    t["bound"] = bound(nbytes, 10 * d * pairs, FLASH_OPS_S)
    shape = f"S{s}" if causal else f"Sq{s} Sk{sk}"
    print(f"  flash_attention_bwd {label} B{b} {shape} H{h}/{hk} D{d}: "
          f"backward kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f}, "
          f"SDPA {t['library_ms']:.4f} (on repeated kv heads "
          f"{t['library_expanded_ms']:.4f}), bound {t['bound'][0]:.5f} "
          f"({t['bound'][1]}); forward + backward {t['fwd_bwd_ms']:.4f}, "
          f"plain {t['fwd_bwd_plain_ms']:.4f}, SDPA "
          f"{t['fwd_bwd_library_ms']:.4f}")
    fwd = dict(
        ms=device_ms(lambda: flash_attention_cuda(q, k, v, lse=True,
                                                  causal=causal)),
        plain_ms=device_ms(lambda: flash_attention_lse_plain(
            q, k, v, causal=causal)),
        library_ms=device_ms(lambda: sdpa(q, k, v)),
        library_expanded_ms=device_ms(lambda: sdpa(q, kx, vx)),
        bound=bound(4 * (2 * q.numel() + 2 * k.numel() + b * h * s),
                    4 * d * pairs, FLASH_OPS_S))
    print(f"  flash_attention_lse {label}: kernel {fwd['ms']:.4f} ms, plain "
          f"{fwd['plain_ms']:.4f}, SDPA {fwd['library_ms']:.4f} (on "
          f"repeated kv heads {fwd['library_expanded_ms']:.4f}), bound "
          f"{fwd['bound'][0]:.5f} ({fwd['bound'][1]})")
    return t, fwd


def bwd_cases():
    """Phase 18 (a)'s cases, (label, (B, S, H, Hk, D), options): the path
    shapes, every head dim with groups 1, 2, 16 and 64, ragged S,
    bidirectional, capped and windowed."""
    from repro_torch.kernels.flash_attention.kernel import HEAD_DIMS

    cases = [(label, shape, dict(causal=True))
             for label, shape in BWD_PATH.items()]
    cases += [(f"D{d} G{g} S{s}", (1, s, g * (1 if g == 64 else 2),
                                   1 if g == 64 else 2, d), kw)
              for d in HEAD_DIMS for g in (1, 2, 16, 64) for s in (33, 130)
              for kw in (dict(causal=True),)]
    cases += [(f"D{d} S{s} {name}", (2, s, 8, 2, d), kw)
              for d in (32, 128, 256) for s in (45, 129)
              for name, kw in (("bidirectional", dict(causal=False)),
                               ("cap 20", dict(causal=True, cap=20.0)),
                               ("window 7", dict(causal=True, window=7)),
                               ("bidirectional window 9",
                                dict(causal=False, window=9)))]
    # the rectangular kernels (cross attention: Sq queries, Sk keys)
    cases += [(f"cross {label}", (b, sq, sk, h, hk, d),
               dict(causal=False, **kw))
              for label, (b, sq, sk, h, hk, d, kw) in CROSS_SHAPES.items()]
    return cases


def bwd_inputs(gen, dev, b, s, *dims):
    """q, k, v, dout of one backward case from the CPU generator ``gen``:
    dims (H, Hk, D), or (Sk, H, Hk, D) with ``s`` queries against Sk
    keys."""
    sk, (h, hk, d) = (s, dims) if len(dims) == 3 else (dims[0], dims[1:])
    return [torch.randn(shape, generator=gen).to(dev) for shape in
            ((b, s, h, d), (b, sk, hk, d), (b, sk, hk, d), (b, s, h, d))]


def bwd_tiles_match():
    """The host plan's tiles (``kernel.py::bwd_tiles``) are the built
    library's (``flash_attention_bwd_config``) at every head dim."""
    from repro_torch.kernels._build import load_library
    from repro_torch.kernels.flash_attention.kernel import HEAD_DIMS, bwd_tiles

    fn = load_library("flash_attention_bwd").flash_attention_bwd_config
    fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    keys = ("rows", "cols", "smem", "per_sm")
    for d in HEAD_DIMS:
        got = (ctypes.c_int * len(keys))()
        check(fn(d, got) == 0, f"flash_attention_bwd_config({d}) failed")
        want = bwd_tiles(d)
        check(list(got) == [want[k] for k in keys],
              f"flash_attention_bwd D{d}: the library's tiles {list(got)}, "
              f"the plan's {[want[k] for k in keys]}")
    print(f"  flash_attention_bwd: the plan's tiles are the library's at D "
          f"{HEAD_DIMS}")


def flash_bwd_checks(dev, rows):
    """Phase 18 (a): the plan's tiles against the library's; the backward
    at ``bwd_cases()``; then its times at the path shapes, each printed
    with the split count the wrapper's plan takes on this card."""
    from repro_torch.kernels.flash_attention.kernel import bwd_plan, bwd_tiles

    bwd_tiles_match()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator().manual_seed(18)
    for label, shape, kw in bwd_cases():
        q, k, v, dout = bwd_inputs(gen, dev, *shape)
        flash_bwd_check(f"{label} {kw}", q, k, v, dout, kw)
    bwd, lse = {}, {}
    timed = [(label, shape, None) for label, shape in BWD_PATH.items()]
    timed += [(label, (b, sq, h, hk, d), sk) for label, (b, sq, sk, h, hk, d,
                                                        _) in
              CROSS_SHAPES.items() if label in CROSS_TIMED]
    for label, shape, sk in timed:
        bwd[label], lse[label] = bwd_timing(label, *shape, sk=sk)
        b, s, h, hk, d = shape
        sk = s if sk is None else sk
        splits = bwd_plan(b, s, sk, h, hk, d, sms=sms)["splits"]
        rows_ = bwd_tiles(d)["rows"]
        print(f"  flash_attention_bwd {label}: plan {splits} split(s) on "
              f"{sms} SMs, {-(-sk // rows_) * splits * hk * b} dK/dV and "
              f"{-(-s // rows_) * h * b} dQ blocks")
    top = "mllm_s140"
    rows["flash_attention_bwd"] = {**bwd[top], **{
        k: v for k, v in bwd.items() if k != top}}
    rows["flash_attention_lse"] = {**lse[top], **{
        k: v for k, v in lse.items() if k != top}}


#: (f) the ssd_scan backward's shapes, (BC, H, G, Q, P, N): mamba2-130m's
#: training micro-batch (``MAMBA2_TRAIN``: 4 sequences of two chunks of
#: 256) and a micro-batch of 8 sequences, jamba-1.5-large's full-width SSM
#: (one sequence of two chunks: 128 heads in 8 groups, P 128, N 16), a
#: chunk of 64, a ragged one of 13, and jamba-smoke's as phase 19 (d)
#: trains it (``JAMBA_TRAIN_BATCH``: 4 sequences of two chunks of 32)
SSD_BWD_SHAPES = {"mamba2_train": (8, 24, 1, 256, 64, 128),
                  "mamba2_bc16": (16, 24, 1, 256, 64, 128),
                  "jamba_full": (2, 128, 8, 256, 128, 16),
                  "q64": (4, 8, 2, 64, 64, 32),
                  "q13": (2, 4, 2, 13, 16, 8),
                  "jamba_smoke": (8, 8, 2, 32, 16, 16)}
#: (f) the decay: dt·A as mamba2's init gives it (A_log 0: A = -1, dt =
#: softplus(~N(0, 1)) ~0.7, so cs falls ~180 over a chunk of 256 and seg
#: passes exp's range of 88), and a slow one (A = -0.01) under which every
#: tile of the triangle carries weight
SSD_BWD_DECAY = {"init": 1.0, "slow": 0.01}
SSD_GRADS = ("dx", "dB", "dC", "dcs", "ddt")


def ssd_bwd_inputs(gen, dev, bc, h, g, q, p, n, decay):
    """x, B, C, cs, dt (kernel layout) and dy, ds of one backward case from
    the CPU generator ``gen``: cs the cumsum of dt·A, A = -decay per head
    (times e^N(0, 0.2))."""
    def randn(*shape):
        return torch.randn(shape, generator=gen)

    dt = torch.nn.functional.softplus(randn(bc, h, 1, q))
    a = -decay * torch.exp(0.2 * randn(h))
    cs = torch.cumsum(dt * a[None, :, None, None], dim=-1)
    args = [randn(bc, h, q, p), 0.3 * randn(bc, g, q, n),
            0.3 * randn(bc, g, q, n), cs, dt]
    return ([t.contiguous().to(dev) for t in args],
            randn(bc, h, q, p).to(dev), randn(bc, h, n, p).to(dev))


def ssd_grads(fn, args, dy, ds):
    """(y_diag, s_local, dx, dB, dC, dcs, ddt) of ``fn`` by autograd."""
    leaves = [t.detach().clone().requires_grad_(True) for t in args]
    y, s = fn(*leaves)
    torch.autograd.backward((y, s), (dy.to(y.dtype), ds.to(s.dtype)))
    return [y.detach(), s.detach()] + [t.grad for t in leaves]


def ssd_bwd_check(label, args, dy, ds):
    """The kernels' gradient (``ops.ssd_scan`` under autograd:
    ``SSDScanFn``) against the repaired plain version's autograd in fp32 on
    the card and in float64: within ``TOL`` of the plain one (relative to
    its largest gradient) and within the float64 gate; finite; a second
    launch equal bit for bit.  Returns the largest ratio to the plain
    version's distance from float64."""
    from repro_torch.kernels.ssd_scan.ops import ssd_scan
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref

    got = ssd_grads(ssd_scan, args, dy, ds)
    again = ssd_grads(ssd_scan, args, dy, ds)
    plain = ssd_grads(ssd_scan_ref, args, dy, ds)
    f64 = ssd_grads(ssd64, [a.double() for a in args], dy, ds)
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          f"ssd_scan_bwd {label}: two launches differ")
    worst, errs = 0.0, []
    for name, g, p, w in zip(("y_diag", "s_local") + SSD_GRADS, got, plain,
                             f64):
        check(bool(torch.isfinite(g).all()),
              f"ssd_scan_bwd {label} {name}: not finite")
        check(bool(torch.isfinite(p).all()),
              f"ssd_scan_bwd {label} {name}: the plain version's is not "
              "finite")
        if name in ("y_diag", "s_local"):
            continue
        scale = max(w.abs().max().item(), 1e-30)
        err_k = (g.double() - w).abs().max().item()
        err_p = (p.double() - w).abs().max().item()
        vs_plain = (g - p).abs().max().item()
        tol = TOL["ssd_scan_bwd"] * max(p.abs().max().item(), 1.0)
        check(vs_plain <= tol, f"ssd_scan_bwd {label} {name}: "
              f"{vs_plain:.3e} from the plain version (tol {tol:.3e})")
        check(err_k <= BWD_WITNESS * err_p + BWD_FLOOR * scale,
              f"ssd_scan_bwd {label} {name}: {err_k:.3e} from float64 "
              f"against the plain version's {err_p:.3e}")
        ratio = err_k / max(err_p, BWD_FLOOR * scale)
        worst = max(worst, ratio)
        errs.append(f"{name} {vs_plain:.2e}/{ratio:.2f}x")
        ERRS["ssd_scan_bwd"] = max(ERRS["ssd_scan_bwd"], vs_plain)
    print(f"  ssd_scan_bwd {label:40s} vs plain / vs float64 against the "
          f"plain version's: {', '.join(errs)} (gate {BWD_WITNESS:g}x + "
          f"{BWD_FLOOR:g} max|g|)")
    return worst


def ssd_bwd_bound(bc, h, g, q, p, n):
    """(bytes, operations) the backward needs: each input (x, B, C, cs,
    dt, dy, ds) read once, each gradient written once; C.B^T once a
    (chunk, group) over the causal pairs, per head dy.x^T and W^T.dy, the
    head-summed dCB against B and C (once a group), and B.ds and ds.x^T
    per key and head."""
    pairs = q * (q + 1) // 2
    nbytes = 4 * (3 * bc * h * q * p + 4 * bc * g * q * n + 4 * bc * h * q
                  + bc * h * n * p)
    ops = bc * (g * 2 * n * pairs + h * 4 * p * pairs + g * 4 * n * pairs
                + h * 4 * q * n * p)
    return nbytes, ops


def ssd_bwd_timing(label, args, dy, ds):
    """Device ms at one shape: the backward alone (``autograd.grad`` of a
    retained graph) and forward + backward, of the kernels and of the plain
    version's autograd, with the bound (bytes at the card's memory rate,
    operations at 3xTF32's, a third of the TF32 rate); no single PyTorch
    call computes this gradient."""
    from repro_torch.kernels.ssd_scan.ops import ssd_scan
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref

    t = {"library_ms": None}
    for name, fn in (("ms", ssd_scan), ("plain_ms", ssd_scan_ref)):
        leaves = [x.clone().requires_grad_(True) for x in args]
        outs = fn(*leaves)
        t[name] = device_ms(lambda: torch.autograd.grad(
            outs, leaves, (dy, ds), retain_graph=True), n=10)

        def both():
            ls = [x.clone().requires_grad_(True) for x in args]
            torch.autograd.grad(fn(*ls), ls, (dy, ds))

        t[f"fwd_bwd_{name}"] = device_ms(both, n=8)
    bc, h, q, p = args[0].shape
    g, n = args[1].shape[1], args[1].shape[3]
    t["bound"] = bound(*ssd_bwd_bound(bc, h, g, q, p, n), FLASH_OPS_S)
    print(f"  ssd_scan_bwd {label} BC{bc} H{h} G{g} Q{q} P{p} N{n}: "
          f"backward kernel {t['ms']:.4f} ms, plain autograd "
          f"{t['plain_ms']:.4f} ms, no library call, bound "
          f"{t['bound'][0]:.5f} ms ({t['bound'][1]}); forward + backward "
          f"{t['fwd_bwd_ms']:.4f} ms, plain {t['fwd_bwd_plain_ms']:.4f} ms")
    return t


def ssd_bwd_smem_match():
    """The plan's shared memory (``kernel.py::bwd_smem``) against the
    library's (``ssd_scan_bwd_smem``) at every P and N the port runs and a
    few more, for 1-4 heads a split."""
    from repro_torch.kernels._build import load_library
    from repro_torch.kernels.ssd_scan.kernel import bwd_smem

    fn = load_library("ssd_scan_bwd").ssd_scan_bwd_smem
    fn.argtypes = [ctypes.c_int] * 3
    fn.restype = ctypes.c_int
    for p in (8, 13, 16, 24, 32, 64, 96, 128):
        for n in (8, 13, 16, 128, 256):
            for hs in (1, 2, 3, 4):
                check(fn(p, n, hs) == bwd_smem(p, n, hs),
                      f"ssd_scan_bwd P{p} N{n} {hs} heads: the library's "
                      f"shared memory {fn(p, n, hs)}, the plan's "
                      f"{bwd_smem(p, n, hs)}")
    print("  ssd_scan_bwd: the plan's shared memory is the library's")


def ssd_bwd_checks(dev, rows):
    """Phase 18 (f): the plan's shared memory against the library's; the
    ssd_scan backward at ``SSD_BWD_SHAPES`` under each decay of
    ``SSD_BWD_DECAY`` (``init`` passes exp's range in seg: the gradients
    must stay finite), then timed at each shape under the init decay, each
    printed with the plan the wrapper takes on this card."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.ssd_scan.kernel import bwd_plan

    ssd_bwd_smem_match()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator().manual_seed(23)
    worst = 0.0
    reset_launch_counts()
    for label, shape in SSD_BWD_SHAPES.items():
        for decay_name, decay in SSD_BWD_DECAY.items():
            args, dy, ds = ssd_bwd_inputs(gen, dev, *shape, decay)
            if decay_name == "init":
                cs = args[3][:, :, 0]
                print(f"  ssd_scan_bwd {label}: the largest seg above the "
                      f"diagonal {(cs[..., 0] - cs[..., -1]).max().item():.1f}")
            worst = max(worst, ssd_bwd_check(f"{label} {decay_name}", args,
                                             dy, ds))
            del args, dy, ds
    torch.cuda.synchronize()
    n_cases = len(SSD_BWD_SHAPES) * len(SSD_BWD_DECAY)
    check(launch_counts()["ssd_scan_bwd_f32"] == 2 * n_cases,
          f"ssd_scan_bwd: {launch_counts()['ssd_scan_bwd_f32']} launches "
          f"for {n_cases} cases checked twice")
    print(f"  ssd_scan_bwd: {n_cases} cases, vs float64 at most "
          f"{worst:.2f}x the plain version's")
    timed = {}
    for label, shape in SSD_BWD_SHAPES.items():
        args, dy, ds = ssd_bwd_inputs(gen, dev, *shape, 1.0)
        timed[label] = ssd_bwd_timing(label, args, dy, ds)
        plan = bwd_plan(*shape, sms=sms)
        print(f"  ssd_scan_bwd {label}: plan on {sms} SMs " + str(
            {k: plan[k] for k in ("splits", "blocks", "per_sm", "smem",
                                  "fused", "parts")}))
    top = "mamba2_train"
    rows["ssd_scan_bwd"] = {**timed[top], **{
        k: v for k, v in timed.items() if k != top}}


class IndexedBatches:
    """A fixed list of batches read in order; the index is the state, so a
    restored trainer replays exactly (``Trainer``'s data interface)."""

    def __init__(self, batches):
        self.batches, self.index = batches, 0

    def state(self):
        return {"index": np.asarray(self.index)}

    def set_state(self, st):
        self.index = int(st["index"])

    def next_batch(self):
        b = self.batches[self.index % len(self.batches)]
        self.index += 1
        return b


def falling(label, losses):
    first = float(np.mean(losses[:LOSS_WINDOW]))
    last = float(np.mean(losses[-LOSS_WINDOW:]))
    print(f"  {label}: {len(losses)} steps, mean loss of the first "
          f"{LOSS_WINDOW} {first:.4f}, of the last {LOSS_WINDOW} {last:.4f}")
    check(last < first, f"{label}: the loss did not fall ({first:.4f} -> "
          f"{last:.4f})")


def pretrain_phase(dev, q8_random_score):
    """Phase 18 (b): ``train_stream_models`` on the card, then Q8's naive
    plan with the trained models.  Returns the launch counts by path and a
    summary."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.queries.catalog import QUERIES
    from repro_torch.streaming.pretrain import train_stream_models

    steps = dict(zip(("mllm", "distill", "tinydet"), PRETRAIN_STEPS))
    stats = {}
    reset_launch_counts()
    t0 = time.perf_counter()
    ctx = train_stream_models(steps_mllm=steps["mllm"],
                              steps_small=steps["distill"],
                              steps_det=steps["tinydet"], cache_dir=None,
                              verbose=False, device=dev, stats=stats)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = launch_counts()
    print(f"  train_stream_models on the card: {seconds:.1f} s, launches "
          f"{ {k: v for k, v in counts.items() if v} }")
    for label, st in stats.items():
        print(f"  {label}: {st['seconds']:.2f} s, "
              f"{len(st['losses']) / st['seconds']:.2f} steps/s")
        falling(label, st["losses"])
    big = ctx.mllm.cfg.n_layers
    small = ctx.mllm_small.cfg.n_layers
    # a distillation step runs the student once: its logits feed both the
    # KL term and its supervised loss
    trained = big * steps["mllm"] + small * steps["distill"]
    want = {"flash_attention_lse_f32": trained,
            "flash_attention_bwd_f32": trained,
            "flash_attention_f32": big * steps["distill"]}   # the teacher
    for symbol, n in want.items():
        check(counts[symbol] == n, f"pretrain: {symbol} launched "
              f"{counts[symbol]} times, layers x forwards x steps is {n}")
    print(f"  launches = layers x forwards x steps: forward with lse and "
          f"backward {trained} each ({big} x {steps['mllm']} + {small} x "
          f"{steps['distill']}), the teacher's forwards {big} x "
          f"{steps['distill']}")
    run, q8_counts = drive("q8_trained", q8_plan("naive"), ctx,
                           ["flash_attention"])
    score = QUERIES["Q8"].evaluate(run)
    print(f"  Q8 naive plan, 512 frames: score {score:.4f} with the trained "
          f"models against {q8_random_score:.4f} with phase 3's random "
          f"weights (printed, not gated); {run.fps:.1f} fps")
    summary = {"seconds": seconds, "steps": steps,
               "steps_per_s": {k: len(v["losses"]) / v["seconds"]
                               for k, v in stats.items()},
               "first_last_mean_loss": {
                   k: [float(np.mean(v["losses"][:LOSS_WINDOW])),
                       float(np.mean(v["losses"][-LOSS_WINDOW:]))]
                   for k, v in stats.items()},
               "q8_score_trained": score, "q8_score_random": q8_random_score}
    return {"stream_pretrain": counts, "q8_trained": q8_counts}, summary


def train_vs_cpu(label, card, make, batches, witness_ctx, opt,
                 steps=CARD_CPU_STEPS, step_ctx=contextlib.nullcontext):
    """The first ``steps`` AdamW steps (``opt``) of ``card`` (a model
    on the card whose ``loss(batch)`` trains it) on ``batches(t)`` (CPU
    tensors); before each, a CPU copy and a second card copy that runs
    ``witness_ctx``'s plain versions (``make(device)`` builds both) take
    the card's parameters, and the step's loss and gradients are compared
    on the same parameters: the loss within CARD_CPU_TOL relative, each
    gradient leaf within CARD_CPU_TOL of its largest |g| or no farther
    from the CPU than BWD_WITNESS times the witness.  A trajectory is not
    compared over several steps: AdamW's first steps are near sign steps,
    so leaves with near-zero gradients step either way on either device.
    ``step_ctx`` wraps every loss (the bf16 step's ``cast_step``).
    Returns the launch counts of the card's steps and a summary."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.training.optimizer import adamw_init, adamw_update

    witness, cpu = make(card.device), make("cpu")
    for m in (card, witness, cpu):
        for p in m.parameters():
            p.requires_grad_(True)

    def loss_and_grads(m, batch):
        for p in m.parameters():
            p.grad = None
        dev = next(m.parameters()).device
        with step_ctx():
            loss = m.loss({k: v.to(dev) for k, v in batch.items()})
        loss.backward()
        return loss.item(), {n: p.grad for n, p in m.named_parameters()}

    params = dict(card.named_parameters())
    state = adamw_init(params, opt)
    n_steps, steps, counts = steps, [], {}
    for t in range(n_steps):
        batch = batches(t)
        state_dict = card.state_dict()
        witness.load_state_dict(state_dict)
        cpu.load_state_dict(state_dict)
        reset_launch_counts()
        loss_k, g_k = loss_and_grads(card, batch)
        torch.cuda.synchronize()
        for k, v in launch_counts().items():
            counts[k] = counts.get(k, 0) + v
        with witness_ctx():
            loss_p, g_p = loss_and_grads(witness, batch)
        loss_c, g_c = loss_and_grads(cpu, batch)
        check(math.isfinite(loss_k), f"{label} step {t + 1}: loss {loss_k}")
        rel = abs(loss_k - loss_c) / abs(loss_c)
        check(rel <= CARD_CPU_TOL, f"{label} card vs CPU step {t + 1}: "
              f"loss {loss_k} against {loss_c}")
        errs = {}
        for n, g in g_c.items():
            if g is None:
                check(g_k[n] is None, f"{label} card vs CPU: {n} has a "
                      "gradient on the card only")
                continue
            check(bool(torch.isfinite(g_k[n]).all()),
                  f"{label} step {t + 1}: the gradient of {n} is not finite")
            scale = max(g.abs().max().item(), 1e-30)
            errs[n] = ((g_k[n].cpu() - g).abs().max().item() / scale,
                       (g_p[n].cpu() - g).abs().max().item() / scale)
        for n, (e_k, e_p) in errs.items():
            check(e_k <= max(CARD_CPU_TOL, BWD_WITNESS * e_p),
                  f"{label} card vs CPU step {t + 1}: the gradient of {n} "
                  f"is {e_k:.3e} of its largest |g| from the CPU's, the "
                  f"plain versions' on the card {e_p:.3e}")
        worst = sorted(errs.items(), key=lambda kv: -kv[1][0])[:4]
        print(f"  {label} step {t + 1}: loss card {loss_k:.6f}, CPU "
              f"{loss_c:.6f} (relative {rel:.2e}; the plain versions on the "
              f"card {loss_p:.6f}); gradients from the CPU's, relative to "
              f"each leaf's largest |g|, kernels | plain, the farthest: "
              + ", ".join(f"{n} {a:.2e} | {b:.2e}" for n, (a, b) in worst))
        steps.append({"loss_card": loss_k, "loss_cpu": loss_c,
                      "loss_plain_card": loss_p,
                      "grad_rel_err": max(a for a, _ in errs.values()),
                      "grad_rel_err_plain": max(b for _, b in errs.values())})
        adamw_update(params, g_k, state, opt)
    del witness, cpu
    return counts, {"steps": steps}


def mllm_card_vs_cpu(dev):
    """Phase 18 (c): the big MLLM's first CARD_CPU_STEPS steps of
    ``_train`` (AdamW at its settings, ``_make_mllm_batches``' batches),
    card == CPU as ``train_vs_cpu`` holds them, the witness running the
    plain attention on the card: fp32 sums in another order, through the
    big MLLM's residual stream of ~200 at its random init and its norms,
    move a leaf's gradient further than its logits (the plain attention on
    the card misses 1e-3 as well)."""
    from repro_torch.configs.samsara_stream import STREAM_MLLM_CONFIG
    from repro_torch.streaming.mllm import StreamMLLM
    from repro_torch.streaming.pretrain import _make_mllm_batches
    from repro_torch.training.optimizer import OptimizerConfig

    def make(device):
        return StreamMLLM(STREAM_MLLM_CONFIG, patch=16, device=device)

    card = make(dev).init(torch.Generator().manual_seed(5))
    opt = OptimizerConfig(lr=1e-3, warmup_steps=20, total_steps=400,
                          weight_decay=0.01)          # ``_train``'s
    counts, summary = train_vs_cpu("big MLLM", card, make,
                                   _make_mllm_batches(7, device="cpu"),
                                   plain_attention, opt)
    check(counts["flash_attention_bwd_f32"] > 0,
          "card vs CPU: the backward kernel was never launched")
    return counts, summary


def chatglm3_train(smi):
    """Phase 18 (d): ``launch/train.py`` on chatglm3-6b at full width and
    depth in its own process (66.7 GB peak)."""
    from repro_torch.configs import get_config

    cfg = get_config("chatglm3-6b")
    want = cfg.n_layers * 2 * 3       # layers x micro-batches x steps
    out = launcher_train("chatglm3_train", CHATGLM3_TRAIN, smi,
                         {"flash_attention_lse_f32": want,
                          "flash_attention_bwd_f32": want})
    check(out["n_layers"] == cfg.n_layers and len(out["losses"]) == 3,
          f"chatglm3-6b trained at depth {out['n_layers']}")
    return out


def mllm_resume(dev):
    """Phase 18 (e): a stream-MLLM trainer on the card checkpoints at step
    5 and trains 5 more; a fresh trainer restored from the checkpoint
    replays those 5 losses."""
    from repro_torch.configs.samsara_stream import STREAM_MLLM_CONFIG
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.streaming.mllm import StreamMLLM
    from repro_torch.streaming.pretrain import _make_mllm_batches
    from repro_torch.training import (CheckpointManager, OptimizerConfig,
                                      TrainConfig, Trainer)

    gen = _make_mllm_batches(3, device=dev)
    batches = [gen(i) for i in range(10)]
    opt = OptimizerConfig(lr=1e-3, warmup_steps=5, total_steps=50,
                          weight_decay=0.01)
    ck_dir = os.path.join(ROOT, "build", "resume_ckpt")
    shutil.rmtree(ck_dir, ignore_errors=True)
    ck = CheckpointManager(ck_dir, keep=2, device=dev)

    def trainer(seed, steps):
        m = StreamMLLM(STREAM_MLLM_CONFIG, patch=16, device=dev).init(
            torch.Generator().manual_seed(seed))
        return Trainer(m.loss, dict(m.named_parameters()), opt,
                       TrainConfig(steps=steps, ckpt_every=5, log_every=0),
                       IndexedBatches(batches), ck)

    reset_launch_counts()
    first = trainer(0, 5)
    first.train()
    check(ck.latest_step() == 5, f"resume: checkpoints {ck.list_steps()}")
    more = first.train(5)["history"][-5:]
    second = trainer(1, 5)          # other weights: the restore sets them
    check(second.restore(5) and second.step == 5 and
          second.data.index == 5, "resume: restore")
    replay = second.train(5)["history"]
    torch.cuda.synchronize()
    counts = launch_counts()
    shutil.rmtree(ck_dir, ignore_errors=True)
    ok = np.allclose(replay, more, rtol=REPLAY_RTOL, atol=REPLAY_ATOL)
    print(f"  resume on the card: steps 6-10 {more}, replayed {replay} "
          f"(rtol {REPLAY_RTOL:g}, atol {REPLAY_ATOL:g}): "
          f"{'equal' if ok else 'DIFFERENT'}")
    check(ok, "resume: the restored trainer does not replay")
    return counts, {"losses": more, "replayed": replay}


#: (g) the launcher's recipe for mamba2-130m at full width and depth:
#: two chunks of 256 a sequence, micro-batches of 4 sequences
MAMBA2_TRAIN = ("--arch", "mamba2-130m", "--steps", "3", "--batch", "8",
                "--seq", "512", "--grad-accum", "2")
#: (g) card == CPU at depth 2: one micro-batch of the recipe's shape
MAMBA2_CPU_DEPTH, MAMBA2_CPU_BATCH = 2, (4, 512)


def _lm_train_opt():
    from repro_torch.training.optimizer import OptimizerConfig

    return OptimizerConfig(lr=1e-3, warmup_steps=5, total_steps=50)


def launcher_train(label, args, smi, want_launches, env=None):
    """``launch/train.py`` in its own process (its last line is a JSON
    summary), with ``env``'s variables set: exits 0, finite losses, and
    each symbol of ``want_launches`` launched exactly as often.  Returns
    the summary."""
    cmd = [sys.executable, "-m", "repro_torch.launch.train", *args]
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               **(env or {}))
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=600)
    seconds = time.perf_counter() - t0
    for line in proc.stdout.splitlines()[:-1]:
        print(f"    {line}")
    if proc.returncode != 0:
        print(proc.stderr[-4000:], file=sys.stderr)
    check(proc.returncode == 0, f"{label}: train.py exited {proc.returncode}")
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    check(all(math.isfinite(x) for x in out["losses"]),
          f"{label}: losses {out['losses']}")
    launches = out["launches"]
    for symbol, n in want_launches.items():
        check(launches.get(symbol, 0) == n, f"{label}: {symbol} launched "
              f"{launches.get(symbol, 0)} times, not {n}")
    peak = out["max_memory_allocated"]
    print(f"  {label}: {out['n_layers']} layers, batch {out['batch']} x "
          f"{out['seq']} in {out['grad_accum']} micro-batches, "
          f"{len(out['losses'])} steps: losses {out['losses']}, step s "
          f"{out['step_s']}, peak {peak / 1e9:.2f} GB "
          f"(max_memory_allocated), launches {launches}; {seconds:.1f} s "
          f"with start-up; {smi}")
    return out


@contextlib.contextmanager
def plain_ssd():
    """The SSD's within-chunk terms take their plain version on the card
    (autograd differentiates it) for the duration of the block."""
    from repro_torch.kernels.ssd_scan import ops
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref

    kernel = ops.ssd_scan
    ops.ssd_scan = ssd_scan_ref
    try:
        yield
    finally:
        ops.ssd_scan = kernel


def mamba2_train(dev, smi):
    """Phase 18 (g): mamba2-130m trained by ``launch/train.py`` at full
    width and depth (``mamba2_train``), then card == CPU at depth 2 on the
    first three steps (``mamba2_train_vs_cpu``)."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import LM
    from repro_torch.training import TokenStream

    cfg = get_config("mamba2-130m")
    want = cfg.n_layers * 2 * 3       # layers x micro-batches x steps
    out = launcher_train("mamba2_train", MAMBA2_TRAIN, smi,
                         {"ssd_scan_f32": want, "ssd_scan_bwd_f32": want})
    check(out["n_layers"] == cfg.n_layers and len(out["losses"]) == 3,
          f"mamba2-130m trained at depth {out['n_layers']}")
    small = cfg.replace(n_layers=MAMBA2_CPU_DEPTH)
    card = LM(small, device=dev).init(torch.Generator().manual_seed(4))
    stream = TokenStream(cfg.vocab_size, *MAMBA2_CPU_BATCH, seed=4,
                         device="cpu")
    batches = [stream.next_batch() for _ in range(CARD_CPU_STEPS)]
    counts, summary = train_vs_cpu(
        f"mamba2-130m depth {MAMBA2_CPU_DEPTH}", card,
        lambda device: LM(small, device=device), batches.__getitem__,
        plain_ssd, _lm_train_opt())
    n = MAMBA2_CPU_DEPTH * CARD_CPU_STEPS
    for symbol in ("ssd_scan_f32", "ssd_scan_bwd_f32"):
        check(counts[symbol] == n, f"mamba2 card vs CPU: {symbol} launched "
              f"{counts[symbol]} times, not {n}")
    del card
    torch.cuda.empty_cache()
    return out, counts, summary


# ---------------------------------------------------------------------------
# phase 19: the MoE family served and trained
# ---------------------------------------------------------------------------

#: (a) moonshot-v1-16b-a3b's depth on the card: 2.35 GB of fp32 weights a
#: layer (64 experts of 3 x 2048 x 1408, two shared, attention) and a 1.34
#: GB table; 20 layers (48.4 GB) leave room for the init's largest draw
#: (one stacked expert leaf, 14.8 GB), the 4 x 8192 cache (10.7 GB) and
#: an 8192-token prefill (16 layers peaked at 52.29 GB on an H100 80GB
#: HBM3 at 700 W: ~4.7 GB above weights and cache)
MOONSHOT_SERVE_DEPTH = 20
#: (c) the training depth: fp32 weights and gradients plus int8 moments,
#: ~6.4 GB a layer; batch 8 x 128 in two micro-batches
MOONSHOT_TRAIN_DEPTH, MOONSHOT_TRAIN_BATCH = 8, (8, 128)
#: (b) card == CPU: the MoE models at full width and depth 1 (qwen3-moe's
#: layer is 9.7 GB and its two tables 5 GB), jamba at its smoke width over
#: one period (one full-width period does not fit the card)
MOE_CARD_CPU = (("moonshot-v1-16b-a3b", 1), ("qwen3-moe-235b-a22b", 1),
                ("jamba-1.5-large-398b", None))
#: (d) jamba-smoke's training batch: 4 sequences of two SSD chunks of 32
JAMBA_TRAIN_BATCH = (4, 64)


@contextlib.contextmanager
def routing_log(log):
    """Every MoE routing of the block appended to ``log`` as (indices on
    the CPU, the smallest gap between a token's k-th and (k+1)-th router
    probability)."""
    from repro_torch.models import moe

    route = moe._route

    def logged(router_w, x2d, cfg):
        idx, w, aux = route(router_w, x2d, cfg)
        with torch.no_grad():
            probs = torch.softmax(x2d.float() @ router_w.float(), dim=-1)
            top = torch.topk(probs, cfg.top_k + 1, dim=-1).values
            margin = (top[:, -2] - top[:, -1]).min().item()
        log.append((idx.cpu(), margin))
        return idx, w, aux

    moe._route = logged
    try:
        yield
    finally:
        moe._route = route


def moe_card_vs_cpu(dev):
    """Phase 19 (b): ``MOE_CARD_CPU``, the same weights (drawn on the card,
    copied to the CPU) on both: three requests through two slots give
    equal tokens and equal routing indices at every MoE layer of every
    prefill and decode step (the smallest top-k margin of the run printed
    beside), and the prefill and three decode steps' logits agree within
    LM_TOL."""
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.launch.serve import make_requests
    from repro_torch.models.model import LM
    from repro_torch.serving.engine import ServingEngine

    summary = {}
    for arch, depth in MOE_CARD_CPU:
        cfg = smoke_config(arch) if depth is None else \
            get_config(arch).replace(n_layers=depth)
        card = LM(cfg, device=dev).init(
            torch.Generator(device=dev).manual_seed(5))
        cpu = LM(cfg, device="cpu")
        cpu.load_state_dict(card.state_dict())
        outs, logs = [], []
        for lm in (cpu, card):
            log = []
            with routing_log(log):
                outs.append([r.output for r in ServingEngine(
                    lm, max_slots=2, s_max=64, eos_id=-1).run(
                        make_requests(cfg, 3, 6))])
            logs.append(log)
        check(len(logs[0]) == len(logs[1]) > 0,
              f"{arch}: {len(logs[0])} routings on the CPU, "
              f"{len(logs[1])} on the card")
        differ = sum(int((a != b).sum()) for (a, _), (b, _) in
                     zip(logs[0], logs[1]))
        margin = min(m for _, m in logs[1])
        prompt = torch.tensor([make_requests(cfg, 1, 1)[0].prompt])

        def steps(lm):
            cache = lm.init_cache(1, 64)
            lg, cache = lm.prefill(prompt, cache)
            out = [lg]
            for t in range(3):
                lg, cache = lm.decode(torch.tensor([[outs[0][0][t]]]), cache,
                                      torch.tensor(prompt.shape[1] + t))
                out.append(lg)
            return [x.cpu() for x in out]

        errs = []
        for a, b in zip(steps(card), steps(cpu)):
            check(torch.isfinite(a).all() and a.shape == b.shape,
                  f"{arch}: non-finite or misshapen logits on the card")
            errs.append((a - b).abs().max().item())
        width = "smoke width" if depth is None else "full width"
        print(f"  {arch} {width}, {cfg.n_layers} layers: card == CPU tokens "
              f"{outs[0] == outs[1]} ({outs[1]}); routing indices of "
              f"{len(logs[1])} MoE calls: {differ} differ, smallest top-k "
              f"margin {margin:.3e}; logits max_abs_err prefill "
              f"{errs[0]:.3e}, decode " + ", ".join(f"{e:.3e}"
                                                    for e in errs[1:])
              + f" (tol {LM_TOL:g})")
        check(differ == 0, f"{arch}: {differ} routing indices differ")
        check(outs[0] == outs[1], f"{arch}: card and CPU tokens differ")
        check(all(e < LM_TOL for e in errs),
              f"{arch}: card vs CPU logits {errs} (tol {LM_TOL})")
        summary[arch] = {"n_layers": cfg.n_layers, "d_model": cfg.d_model,
                         "logit_err": errs, "min_topk_margin": margin,
                         "routings": len(logs[1])}
        del cpu, card
        torch.cuda.empty_cache()
    return summary


def moonshot_train(dev, smi):
    """Phase 19 (c): moonshot-v1-16b-a3b at full width and
    MOONSHOT_TRAIN_DEPTH layers through ``Trainer`` (AdamW with int8
    moments, the token stream), 3 steps: finite losses, the MoE aux loss
    of the trained weights nonzero, the attention kernels launched once a
    layer a micro-batch, peak memory under the card's 80 GB."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models.model import LM
    from repro_torch.training import (OptimizerConfig, TokenStream,
                                      TrainConfig, Trainer)

    cfg = get_config("moonshot-v1-16b-a3b").replace(
        n_layers=MOONSHOT_TRAIN_DEPTH)
    lm = LM(cfg, device=dev).init(torch.Generator(device=dev).manual_seed(6))
    data = TokenStream(cfg.vocab_size, *MOONSHOT_TRAIN_BATCH, seed=6,
                       device=dev)
    trainer = Trainer(lm.loss, dict(lm.named_parameters()),
                      OptimizerConfig(lr=1e-3, warmup_steps=5, total_steps=3,
                                      quantized_state=True),
                      TrainConfig(steps=3, grad_accum=2, log_every=0), data)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    out = trainer.train()
    torch.cuda.synchronize()
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    with torch.no_grad():
        _, aux = lm.logits_and_aux(data.next_batch()["tokens"])
    aux = aux.item()
    n_params = sum(p.numel() for p in lm.parameters())
    print(f"  moonshot_train: {cfg.n_layers} layers at full width "
          f"({n_params / 1e9:.3f} G parameters), int8 moments, batch "
          f"{MOONSHOT_TRAIN_BATCH[0]} x {MOONSHOT_TRAIN_BATCH[1]} in 2 "
          f"micro-batches, 3 steps: losses {out['history']}, step s "
          f"{out['step_times']}, MoE aux of the trained weights {aux:.5f}, "
          f"peak {peak / 1e9:.2f} GB (max_memory_allocated); {smi}")
    check(all(math.isfinite(x) for x in out["history"]) and
          len(out["history"]) == 3, f"moonshot_train: losses "
          f"{out['history']}")
    check(aux > 0 and math.isfinite(aux), f"moonshot_train: aux {aux}")
    check(peak < 80e9, f"moonshot_train: peak {peak / 1e9:.2f} GB")
    want = cfg.n_layers * 2 * 3
    for symbol in ("flash_attention_lse_f32", "flash_attention_bwd_f32"):
        check(counts[symbol] == want, f"moonshot_train: {symbol} launched "
              f"{counts[symbol]} times, not {want}")
    del trainer, lm
    torch.cuda.empty_cache()
    return counts, {"n_layers": cfg.n_layers, "parameters": n_params,
                    "losses": out["history"], "step_s": out["step_times"],
                    "aux": aux, "max_memory_allocated": peak}


def jamba_train(dev):
    """Phase 19 (d): jamba at its smoke width (one period: 7 Mamba2 layers
    of 8 heads in 2 groups, one attention layer, 4 MoE MLPs) trained on
    the card, card == CPU on its first three steps as phase 18 (g) holds
    mamba2, the witness running both the SSD's and the attention's plain
    versions on the card."""
    from repro_torch.configs import smoke_config
    from repro_torch.models.model import LM
    from repro_torch.training import TokenStream

    cfg = smoke_config("jamba-1.5-large-398b")
    card = LM(cfg, device=dev).init(torch.Generator().manual_seed(7))
    stream = TokenStream(cfg.vocab_size, *JAMBA_TRAIN_BATCH, seed=7,
                         device="cpu")
    batches = [stream.next_batch() for _ in range(CARD_CPU_STEPS)]

    @contextlib.contextmanager
    def plain_kernels():
        with plain_ssd(), plain_attention():
            yield

    counts, summary = train_vs_cpu(
        "jamba-smoke", card, lambda device: LM(cfg, device=device),
        batches.__getitem__, plain_kernels, _lm_train_opt())
    n_mamba = sum(k.startswith("mamba") for k in cfg.block_pattern) \
        * cfg.n_periods
    n_attn = cfg.n_layers - n_mamba
    for symbol, per in (("ssd_scan_f32", n_mamba),
                        ("ssd_scan_bwd_f32", n_mamba),
                        ("flash_attention_lse_f32", n_attn),
                        ("flash_attention_bwd_f32", n_attn)):
        check(counts[symbol] == per * CARD_CPU_STEPS, f"jamba_train: "
              f"{symbol} launched {counts[symbol]} times, not "
              f"{per} x {CARD_CPU_STEPS}")
    del card
    torch.cuda.empty_cache()
    return counts, summary


def moe_phase(dev, smi):
    """Phase 19: (a) moonshot served at full width (and its decode ticks
    profiled, as phase 6 profiles the other LMs'), (b) card == CPU, (c)
    moonshot trained, (d) jamba trained.  Returns the launch counts by
    path, the serving numbers and a summary."""
    t19 = time.perf_counter()
    counts, summary = {}, {}
    print(f"[19a] moonshot-v1-16b-a3b, full width, {MOONSHOT_SERVE_DEPTH} "
          f"layers, through ServingEngine(max_slots={SERVE_SLOTS}, "
          f"s_max={SERVE_S_MAX})")
    serving, counts["moonshot_serve"], lm, eng, _ = serve_phase(
        "moonshot_serve", "moonshot-v1-16b-a3b", dev,
        per_prefill=["flash_attention"], per_decode=["decode_attention"],
        depth=MOONSHOT_SERVE_DEPTH)
    print("[6] device busy share of moonshot's decode ticks")
    summary["moonshot_decode_busy_share"] = trace_decode(
        "moonshot_decode", eng, lm.cfg)
    del lm, eng
    torch.cuda.empty_cache()
    print("[19b] card vs CPU: moonshot and qwen3-moe at full width, depth "
          "1; jamba at smoke width, one period")
    summary["card_vs_cpu"] = moe_card_vs_cpu(dev)
    print(f"[19c] moonshot-v1-16b-a3b trained at full width, "
          f"{MOONSHOT_TRAIN_DEPTH} layers")
    counts["moonshot_train"], summary["moonshot_train"] = \
        moonshot_train(dev, smi)
    print("[19d] jamba-smoke trained on the card, card vs CPU")
    counts["jamba_train"], summary["jamba_train"] = jamba_train(dev)
    summary["seconds"] = time.perf_counter() - t19
    print(f"[19] {summary['seconds']:.1f} s; {smi}")
    return counts, {"moonshot_serve": serving}, summary


# ---------------------------------------------------------------------------
# phase 20: the encoder-decoder and patch-frontend families
# ---------------------------------------------------------------------------

#: (a) seamless-m4t-medium served: 4 requests, each 1024 seeded stub frames
#: (T_src, ~20 s of speech at the encoder's 20 ms stride) and a 16-token
#: prompt, one prefill with the frames, then 32 greedy decode steps
SEAMLESS_SERVE = dict(batch=4, t_src=1024, prompt=16, new=32)
#: (b) pixtral-12b's patch prefill: the reference's N_PATCHES (1024) patch
#: embeddings at seeded positions of a 2048-token prompt, 12 decode steps
PIXTRAL_PATCHES = dict(prompt=2048, patches=1024, new=12)
#: (c) card == CPU at full width, depth 2: the CPU's greedy tokens (the
#: prefill's and 7 decode steps') fed to both devices; the inputs:
#: seamless's 4 requests of 16-token prompts with SEAMLESS_CHECK_T frames,
#: pixtral one prompt of 256 tokens with 64 patches.  Under the
#: reference's init these models' attention scores have standard
#: deviations of ~64 (seamless: q and k ~8 a component over 64 dims) to
#: ~300 (pixtral), so fp32 rounding is amplified: on the CPU alone, one
#: thread against eight moves the logits by up to 2.8e-3 (pixtral) and
#: 5.2e-3 (seamless at 1024 frames), past phase 11's 1e-3 (LM_TOL).  So
#: the logits are held to a float64 run of the same model on the CPU: the
#: card's no farther than ENCDEC_WITNESS times the CPU fp32 run's (plus
#: 1e-6 of the largest logit), as phase 2 holds the dense zoo's attention;
#: the greedy tokens are compared and printed.  (a)'s 1024 frames are
#: compared too, printed only
ENCDEC_CHECK_TOKENS = 8
SEAMLESS_CHECK_T = 64
ENCDEC_WITNESS = 2.0
PIXTRAL_CHECK = dict(prompt=256, patches=64)
#: (d) training: seamless at full width and depth, batch 8 x 128 tokens
#: with 512 frames a sample, in 2 micro-batches; pixtral at full width and
#: PIXTRAL_TRAIN_DEPTH layers (40 do not fit: weights and gradients alone
#: are 98 GB), int8 moments, 8 x 128 with 64 patches a sample; card == CPU
#: on one step at depth 2 (batch 2 x 32, 64 frames or 8 patches)
SEAMLESS_TRAIN = dict(batch=8, seq=128, t_src=512)
PIXTRAL_TRAIN_DEPTH = 8
PIXTRAL_TRAIN = dict(batch=8, seq=128, patches=64)
ENCDEC_TRAIN_CHECK = dict(batch=2, seq=32, t_src=64, patches=8)


def frontend_extra(cfg, t_src=0, patches=0, seq=0):
    """``TokenStream``'s ``extra_fn`` for a model's stub frontend: seeded
    frames (B, t_src, d), or patch embeddings (B, patches, d) (0.02 a
    normal draw, as the reference's tests make them) at random positions
    below ``seq`` (repeats included: they add up)."""
    def extra(rs, b):
        if cfg.encoder_decoder:
            return {"frames": rs.standard_normal(
                (b, t_src, cfg.d_model)).astype(np.float32)}
        return {"patch_embeds": (0.02 * rs.standard_normal(
                    (b, patches, cfg.d_model))).astype(np.float32),
                "patch_pos": rs.randint(0, seq, (b, patches))}
    return extra


def greedy_steps(lm, prompt, n, feed=None, dtype=torch.float32, **inputs):
    """``lm.prefill(prompt, **inputs)`` then ``n - 1`` decode steps on the
    greedy tokens (or on ``feed``'s, (B, n), so that two devices run the
    same steps): (tokens (B, n) on the CPU, each step's logits on the CPU,
    each step's ms (the prefill first), the prefill's launch counts, the
    decode steps' launch counts)."""
    from repro_torch.kernels import launch_counts, reset_launch_counts

    cuda = lm.device.type == "cuda"
    b, p = prompt.shape
    t_src = inputs["frames"].shape[1] if "frames" in inputs else 0
    cache = lm.init_cache(b, p + n, t_src=t_src, dtype=dtype)
    dev_inputs = {k: v.to(lm.device) for k, v in inputs.items()}

    def sync():
        if cuda:
            torch.cuda.synchronize()

    sync()
    reset_launch_counts()
    t0 = time.perf_counter()
    lg, cache = lm.prefill(prompt.to(lm.device), cache, dtype=dtype,
                           **dev_inputs)
    sync()
    ms = [(time.perf_counter() - t0) * 1e3]
    pre_counts = launch_counts()
    logits, toks = [lg[:, 0].cpu()], [lg[:, 0].argmax(-1).cpu()]
    reset_launch_counts()
    for t in range(n - 1):
        tok = toks[-1] if feed is None else feed[:, t]
        t0 = time.perf_counter()
        lg, cache = lm.decode(tok[:, None].to(lm.device), cache,
                              torch.tensor(p + t), dtype=dtype)
        sync()
        ms.append((time.perf_counter() - t0) * 1e3)
        logits.append(lg[:, 0].cpu())
        toks.append(lg[:, 0].argmax(-1).cpu())
    return (torch.stack(toks, 1), logits, ms, pre_counts, launch_counts())


def seamless_inputs(cfg, batch, t_src, prompt, seed):
    rs = np.random.RandomState(seed)
    tokens = torch.from_numpy(rs.randint(2, cfg.vocab_size, (batch, prompt)))
    frames = torch.from_numpy(rs.standard_normal(
        (batch, t_src, cfg.d_model)).astype(np.float32))
    return tokens, {"frames": frames}


def pixtral_inputs(cfg, prompt, patches, seed):
    """One prompt with ``patches`` patch embeddings at seeded, distinct
    positions (an image's patches, one a position)."""
    rs = np.random.RandomState(seed)
    tokens = torch.from_numpy(rs.randint(2, cfg.vocab_size, (1, prompt)))
    pos = np.sort(rs.choice(prompt, patches, replace=False))[None]
    pe = (0.02 * rs.standard_normal((1, patches, cfg.d_model))).astype(
        np.float32)
    return tokens, {"patch_embeds": torch.from_numpy(pe),
                    "patch_pos": torch.from_numpy(pos)}


def seamless_serve(dev, smi):
    """Phase 20 (a): seamless-m4t-medium at full width and depth, seeded
    random weights drawn on the card: ``SEAMLESS_SERVE``'s requests through
    one ``prefill(frames=...)`` and greedy decode steps (a short warm-up
    run first).  The encoder's and decoder's kernels by step class: the
    prefill launches flash_attention (the encoder's bidirectional layers,
    the decoder's causal ones, its cross attention at Sq 16 against 1024
    keys) once a layer each and no decode_attention; a decode step
    launches decode_attention twice a decoder layer (self and cross) and
    no flash_attention."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention.kernel import \
        MIN_KEYS_PER_SPLIT
    from repro_torch.models.model import LM

    cfg = get_config("seamless-m4t-medium")
    t0 = time.perf_counter()
    lm = LM(cfg, device=dev).init(torch.Generator(device=dev).manual_seed(20))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in lm.parameters())
    print(f"  seamless-m4t-medium: {n_params / 1e9:.3f} G parameters (fp32, "
          f"{4 * n_params / 1e9:.2f} GB) drawn on the card in "
          f"{time.perf_counter() - t0:.2f} s; {cfg.n_encoder_layers} encoder "
          f"+ {cfg.n_layers} decoder layers, d_model {cfg.d_model}, vocab "
          f"{cfg.vocab_size}")
    a = SEAMLESS_SERVE
    tokens, inputs = seamless_inputs(cfg, a["batch"], 64, a["prompt"], 19)
    greedy_steps(lm, tokens, 3, **inputs)                  # warm-up
    tokens, inputs = seamless_inputs(cfg, a["batch"], a["t_src"],
                                     a["prompt"], 20)
    frames = inputs["frames"].to(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        enc = lm._encode(lm.tree(), frames)
    torch.cuda.synchronize()
    encode_ms = (time.perf_counter() - t0) * 1e3
    check(bool(torch.isfinite(enc).all()) and enc.shape == frames.shape,
          "seamless_serve: the encoder's output")
    del enc
    torch.cuda.reset_peak_memory_stats()
    toks, logits, ms, pre, dec = greedy_steps(lm, tokens, a["new"] + 1,
                                              frames=frames)
    peak = torch.cuda.max_memory_allocated()
    n_enc, n_dec, steps = cfg.n_encoder_layers, cfg.n_layers, a["new"]
    check(all(bool(torch.isfinite(x).all()) for x in logits)
          and toks.shape == (a["batch"], steps + 1)
          and bool(((toks >= 0) & (toks < cfg.padded_vocab)).all()),
          "seamless_serve: non-finite logits or tokens out of the vocab")
    want = {("flash_attention_f32", "prefill"): n_enc + 2 * n_dec,
            ("decode_attention_f32", "prefill"): 0,
            ("flash_attention_f32", "decode"): 0,
            ("decode_attention_f32", "decode"): 2 * n_dec * steps}
    got = {(k, c): (pre if c == "prefill" else dec)[k] for k, c in want}
    for key, n in want.items():
        check(got[key] == n, f"seamless_serve: {key[0]} launched {got[key]} "
              f"times in the {key[1]}, not {n}")
    # a decode step's self attention holds prompt + step keys, its cross
    # attention all 1024 frames: long where past one split
    long_cross = a["t_src"] > MIN_KEYS_PER_SPLIT
    long_self = a["prompt"] + steps > MIN_KEYS_PER_SPLIT
    res = {"encode_ms": encode_ms, "prefill_ms": ms[0],
           "decode_step_ms_median": statistics.median(ms[1:]),
           "decode_step_ms_max": max(ms[1:]),
           "decode_tokens_per_s": a["batch"] * steps / (sum(ms[1:]) / 1e3),
           "peak_memory_gb": peak / 1e9, "parameters": n_params,
           "launches_by_step_class": {"decode_attention": {
               "long": n_dec * steps * (long_cross + long_self),
               "short": n_dec * steps * (2 - long_cross - long_self)}},
           "launches_prefill_decode": {f"{k} {c}": n for (k, c), n in
                                       got.items()}}
    print(f"  seamless_serve: {a['batch']} requests x {a['t_src']} frames + "
          f"{a['prompt']}-token prompts: encode {encode_ms:.2f} ms, prefill "
          f"(encode, cross K/V, the prompts) {ms[0]:.2f} ms, {steps} decode "
          f"steps median {res['decode_step_ms_median']:.3f} ms (max "
          f"{res['decode_step_ms_max']:.3f}), {res['decode_tokens_per_s']:.1f}"
          f" decode tokens/s; peak {peak / 1e9:.2f} GB; {smi}")
    print("  seamless_serve launches by step class: prefill "
          f"flash_attention_f32 {got['flash_attention_f32', 'prefill']} "
          f"({n_enc} encoder, {n_dec} causal, {n_dec} cross), "
          f"decode_attention_f32 {got['decode_attention_f32', 'prefill']}; "
          f"{steps} decode steps flash_attention_f32 "
          f"{got['flash_attention_f32', 'decode']}, decode_attention_f32 "
          f"{got['decode_attention_f32', 'decode']} ({n_dec} self + {n_dec} "
          f"cross a step)")
    print(f"  seamless_serve tokens (first 8 of each request): "
          f"{toks[:, :8].tolist()}")
    counts = {k: pre[k] + dec[k] for k in pre}
    del lm
    torch.cuda.empty_cache()
    return res, counts


def pixtral_serve(dev, smi):
    """Phase 20 (b): pixtral-12b at full width and all 40 layers through
    ``ServingEngine`` as phase 9 (``serve_phase``: the launcher's 8
    requests plus one of 4200 tokens), then one ``LM.prefill`` of
    ``PIXTRAL_PATCHES`` (patch embeddings at seeded positions) and greedy
    decode steps; peak memory under 80 GB."""
    serving, counts, lm, eng, _ = serve_phase(
        "pixtral_serve", "pixtral-12b", dev,
        per_prefill=["flash_attention"], per_decode=["decode_attention"])
    del eng
    torch.cuda.empty_cache()
    b = PIXTRAL_PATCHES
    tokens, inputs = pixtral_inputs(lm.cfg, b["prompt"], b["patches"], 20)
    torch.cuda.reset_peak_memory_stats()
    toks, logits, ms, pre, dec = greedy_steps(lm, tokens, b["new"] + 1,
                                              **inputs)
    peak = torch.cuda.max_memory_allocated()
    n = lm.cfg.n_layers
    check(all(bool(torch.isfinite(x).all()) for x in logits),
          "pixtral_serve: non-finite logits after the patch prefill")
    check(pre["flash_attention_f32"] == n and
          dec["decode_attention_f32"] == n * b["new"],
          f"pixtral_serve: the patch prefill launched flash_attention_f32 "
          f"{pre['flash_attention_f32']} times, its decode steps "
          f"decode_attention_f32 {dec['decode_attention_f32']}")
    serving["patch_prefill_ms"] = ms[0]
    serving["patch_decode_step_ms_median"] = statistics.median(ms[1:])
    serving["patch_peak_memory_gb"] = peak / 1e9
    print(f"  pixtral_serve patch prefill: {b['patches']} patch embeddings "
          f"in a {b['prompt']}-token prompt {ms[0]:.1f} ms, {b['new']} decode"
          f" steps median {serving['patch_decode_step_ms_median']:.3f} ms, "
          f"peak {peak / 1e9:.2f} GB; tokens {toks[0].tolist()}; {smi}")
    for gb in (serving["peak_memory_gb"], peak / 1e9):
        check(gb < 80, f"pixtral_serve: peak {gb:.2f} GB")
    for k in counts:
        counts[k] += pre[k] + dec[k]
    del lm
    torch.cuda.empty_cache()
    return serving, counts


def f64_logits(lm64, tokens, fed, inputs):
    """The float64 model's logits at the steps ``greedy_steps`` runs with
    ``feed=fed``: one causal forward over the prompt and the fed tokens,
    read at the prompt's last position and each fed one."""
    p, n = tokens.shape[1], fed.shape[1]
    full = torch.cat([tokens, fed[:, :n - 1]], dim=1)
    on = {k: v.double() if v.is_floating_point() else v
          for k, v in inputs.items()}
    lg = lm64.logits_causal(full, **on)
    return [lg[:, p - 1 + t] for t in range(n)]


def vs_float64(card, cpu, cpu64, tokens, inputs):
    """The CPU's greedy steps, the card's and the card's with the plain
    attention on the CPU's tokens: each one's largest logit distance from
    the float64 model's, the largest |logit|, and whether the card's
    tokens are the CPU's."""
    want, want_lg = greedy_steps(cpu, tokens, ENCDEC_CHECK_TOKENS,
                                 **inputs)[:2]
    got, got_lg = greedy_steps(card, tokens, ENCDEC_CHECK_TOKENS, feed=want,
                               **inputs)[:2]
    with plain_attention():
        plain_lg = greedy_steps(card, tokens, ENCDEC_CHECK_TOKENS,
                                feed=want, **inputs)[1]
    exact = f64_logits(cpu64, tokens, want, inputs)
    check(all(bool(torch.isfinite(x).all()) for x in got_lg),
          "non-finite logits on the card")
    dist = {name: max((x.double() - e).abs().max().item()
                      for x, e in zip(lg, exact))
            for name, lg in (("card", got_lg), ("plain", plain_lg),
                             ("cpu", want_lg))}
    dist["card_vs_cpu"] = max((x - w).abs().max().item()
                              for x, w in zip(got_lg, want_lg))
    dist["top"] = max(e.abs().max().item() for e in exact)
    dist["same_tokens"] = torch.equal(got, want)
    return dist, want


def encdec_card_vs_cpu(dev):
    """Phase 20 (c): seamless (2 encoder and 2 decoder layers) and pixtral
    (2 layers) at full width, the same weights (drawn on the card, copied
    to the CPU in fp32 and in float64) and inputs (frames, patches): the
    CPU's greedy steps fed to the card; the card's logits no farther from
    the float64 model's than ENCDEC_WITNESS times the CPU's fp32 logits
    (plus 1e-6 of the largest); the greedy tokens compared; the card with
    the attention kernels' plain versions printed beside."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import LM

    summary = {}
    a = SEAMLESS_SERVE
    for arch in ("seamless-m4t-medium", "pixtral-12b"):
        cfg = get_config(arch).replace(n_layers=2)
        runs = []
        if cfg.encoder_decoder:
            cfg = cfg.replace(n_encoder_layers=2)
            for t_src in (SEAMLESS_CHECK_T, a["t_src"]):
                runs.append((t_src == SEAMLESS_CHECK_T, f"{t_src} frames",
                             *seamless_inputs(cfg, a["batch"], t_src,
                                              a["prompt"], 22)))
        else:
            runs.append((True, f"{PIXTRAL_CHECK['patches']} patches in "
                         f"{PIXTRAL_CHECK['prompt']} tokens",
                         *pixtral_inputs(cfg, PIXTRAL_CHECK["prompt"],
                                         PIXTRAL_CHECK["patches"], 22)))
        card = LM(cfg, device=dev).init(
            torch.Generator(device=dev).manual_seed(22))
        cpu = LM(cfg, device="cpu")
        cpu.load_state_dict(card.state_dict())
        cpu64 = LM(cfg, device="cpu")
        cpu64.load_state_dict(card.state_dict())
        cpu64.double()
        summary[arch] = {}
        for gated, what, tokens, inputs in runs:
            dist, want = vs_float64(card, cpu, cpu64, tokens, inputs)
            bar = ENCDEC_WITNESS * dist["cpu"] + 1e-6 * dist["top"]
            print(f"  {arch} depth 2 at full width, {what}"
                  f"{'' if gated else ' (printed, not gated)'}: logits from "
                  f"float64 (largest |logit| {dist['top']:.3f}): card "
                  f"{dist['card']:.3e}, CPU fp32 {dist['cpu']:.3e} (gate "
                  f"{ENCDEC_WITNESS:g}x + 1e-6 of the largest: {bar:.3e}), "
                  f"the plain attention on the card {dist['plain']:.3e}; "
                  f"card from CPU {dist['card_vs_cpu']:.3e}; greedy tokens "
                  f"equal {dist['same_tokens']} ({want.tolist()})")
            if gated:
                check(dist["card"] <= bar, f"{arch} {what}: the card's "
                      f"logits {dist['card']:.3e} from float64, the CPU's "
                      f"{dist['cpu']:.3e}")
            summary[arch][what] = dist
        del card, cpu, cpu64
        torch.cuda.empty_cache()
    return summary


def encdec_train(dev, smi, arch):
    """Phase 20 (d): ``arch`` trained through ``Trainer`` at full width
    (seamless at full depth, fp32 moments; pixtral at PIXTRAL_TRAIN_DEPTH
    layers, int8 moments), 3 steps of 2 micro-batches on a ``TokenStream``
    whose batches carry frames or patches (its ``extra_fn``): finite
    losses, the forward-with-lse and backward launched once an attention
    layer (encoder, decoder, cross) a micro-batch, peak under 80 GB; then
    one step card == CPU at depth 2 (``train_vs_cpu``)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models.model import LM
    from repro_torch.training import (OptimizerConfig, TokenStream,
                                      TrainConfig, Trainer)

    seamless = arch.startswith("seamless")
    cfg = get_config(arch)
    if seamless:
        t = SEAMLESS_TRAIN
        extra = frontend_extra(cfg, t_src=t["t_src"])
        attn_layers = cfg.n_encoder_layers + 2 * cfg.n_layers
    else:
        t = PIXTRAL_TRAIN
        cfg = cfg.replace(n_layers=PIXTRAL_TRAIN_DEPTH)
        extra = frontend_extra(cfg, patches=t["patches"], seq=t["seq"])
        attn_layers = cfg.n_layers
    lm = LM(cfg, device=dev).init(torch.Generator(device=dev).manual_seed(21))
    data = TokenStream(cfg.vocab_size, t["batch"], t["seq"], seed=21,
                       extra_fn=extra, device=dev)
    trainer = Trainer(lm.loss, dict(lm.named_parameters()),
                      OptimizerConfig(lr=1e-3, warmup_steps=5, total_steps=3,
                                      quantized_state=not seamless),
                      TrainConfig(steps=3, grad_accum=2, log_every=0), data)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    out = trainer.train()
    torch.cuda.synchronize()
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    n_params = sum(p.numel() for p in lm.parameters())
    what = (f"{cfg.n_encoder_layers} + {cfg.n_layers} layers, batch "
            f"{t['batch']} x {t['seq']} with {t['t_src']} frames" if seamless
            else f"{cfg.n_layers} layers, int8 moments, batch {t['batch']} x "
            f"{t['seq']} with {t['patches']} patches a sample")
    print(f"  {arch} trained at full width ({n_params / 1e9:.3f} G "
          f"parameters), {what}, 2 micro-batches, 3 steps: losses "
          f"{out['history']}, step s {out['step_times']}, peak "
          f"{peak / 1e9:.2f} GB (max_memory_allocated); {smi}")
    check(len(out["history"]) == 3 and
          all(math.isfinite(x) for x in out["history"]),
          f"{arch} training: losses {out['history']}")
    check(peak < 80e9, f"{arch} training: peak {peak / 1e9:.2f} GB")
    want = attn_layers * 2 * 3
    for symbol in ("flash_attention_lse_f32", "flash_attention_bwd_f32"):
        check(counts[symbol] == want, f"{arch} training: {symbol} launched "
              f"{counts[symbol]} times, not {want}")
    summary = {"n_layers": cfg.n_layers, "parameters": n_params,
               "losses": out["history"], "step_s": out["step_times"],
               "max_memory_allocated": peak}
    del trainer, lm, data
    torch.cuda.empty_cache()

    # one step card == CPU at depth 2
    c = ENCDEC_TRAIN_CHECK
    small = get_config(arch).replace(n_layers=2)
    if seamless:
        small = small.replace(n_encoder_layers=2)
    stream = TokenStream(small.vocab_size, c["batch"], c["seq"], seed=23,
                         extra_fn=frontend_extra(small, t_src=c["t_src"],
                                                 patches=c["patches"],
                                                 seq=c["seq"]),
                         device="cpu")
    batch = stream.next_batch()
    card = LM(small, device=dev).init(
        torch.Generator(device=dev).manual_seed(23))
    more, summary["card_vs_cpu"] = train_vs_cpu(
        f"{arch} depth 2", card, lambda device: LM(small, device=device),
        lambda _: batch, plain_attention, _lm_train_opt(), steps=1)
    n = (small.n_encoder_layers + 2 * small.n_layers) if seamless \
        else small.n_layers
    for symbol in ("flash_attention_lse_f32", "flash_attention_bwd_f32"):
        check(more[symbol] == n, f"{arch} depth 2 card vs CPU: {symbol} "
              f"launched {more[symbol]} times, not {n}")
    for k, v in more.items():
        counts[k] = counts.get(k, 0) + v
    del card
    torch.cuda.empty_cache()
    return counts, summary


def encdec_phase(dev, smi):
    """Phase 20: (a) seamless-m4t-medium served, (b) pixtral-12b served,
    (c) card == CPU at depth 2, (d) both trained.  Returns the launch
    counts by path, the serving numbers and a summary."""
    t20 = time.perf_counter()
    counts, summary, serving = {}, {}, {}
    print("[20a] seamless-m4t-medium, full width and depth: prefill with "
          "frames, greedy decode")
    serving["seamless_serve"], counts["seamless_serve"] = \
        seamless_serve(dev, smi)
    print(f"[20b] pixtral-12b, full width, 40 layers, through ServingEngine"
          f"(max_slots={SERVE_SLOTS}, s_max={SERVE_S_MAX}), then a patch "
          "prefill")
    serving["pixtral_serve"], counts["pixtral_serve"] = \
        pixtral_serve(dev, smi)
    print("[20c] card vs CPU: seamless and pixtral at full width, depth 2")
    summary["card_vs_cpu"] = encdec_card_vs_cpu(dev)
    print("[20d] seamless trained at full width and depth; pixtral at full "
          f"width, {PIXTRAL_TRAIN_DEPTH} layers; card vs CPU at depth 2")
    for path, arch in (("seamless_train", "seamless-m4t-medium"),
                       ("pixtral_train", "pixtral-12b")):
        counts[path], summary[path] = encdec_train(dev, smi, arch)
    summary["seconds"] = time.perf_counter() - t20
    print(f"[20] {summary['seconds']:.1f} s; {smi}")
    return counts, serving, summary


# ---------------------------------------------------------------------------
# phase 21: the LM zoo in bf16
# ---------------------------------------------------------------------------

#: phase 12's fp32 chatglm3-6b run, read by phase 21 (a): the top-1 of its
#: logits on the reference test's 2 x 32 tokens and its served tokens
FP32_CHATGLM3 = {}
#: (b) moonshot-v1-16b-a3b served in bf16 at all its layers (~28.6 G
#: parameters, ~57 GB in bf16; 20 layers in fp32 at phase 19); its peak
#: must stay under the card's 80 GB
MOONSHOT_BF16_DEPTH = 48
PEAK_LIMIT_GB = 80.0
#: (c) card == CPU at bf16, full width, depth 2 (seamless: 2 encoder and 2
#: decoder layers): the same bf16-rounded weights on both devices, the CPU
#: bf16 run's greedy tokens fed to the card; the logits held to an fp32
#: run of the same rounded weights on the CPU: the card no farther than
#: BF16_LM_WITNESS times the CPU bf16 run (plus 1e-6 of the largest
#: logit), as phase 20 (c) holds fp32 to float64.  bf16 rounds each
#: product's output to 8 bits, so the card and the CPU (other GEMM
#: orders) part by bf16 ulps, far past phase 11's 1e-3
BF16_CARD_CPU = ("gemma2-2b", "chatglm3-6b", "phi3-mini-3.8b", "mamba2-130m",
                 "seamless-m4t-medium")
BF16_LM_WITNESS = 2.0
BF16_CHECK = dict(batch=2, prompt=16, tokens=8, t_src=64)
#: (d) the bf16 step (REPRO_CAST_BF16_STEP=1): mamba2-130m through
#: launch/train.py as 18 (g), then chatglm3-6b at full width and depth 2,
#: batch 2 x 32, card == CPU on three steps as 18 (g) holds them
BF16_STEP_ENV = {"REPRO_CAST_BF16_STEP": "1"}
BF16_STEP_CPU = dict(depth=2, batch=2, seq=32)


def chatglm3_bf16(dev, fp32_serving):
    """Phase 21 (a): chatglm3-6b at full width and depth, phase 12's seeded
    weights cast once to bf16, through ``ServingEngine(dtype=bf16)`` on
    phase 12's requests (flash_attention_bf16 a layer a prefill,
    decode_attention_bf16 a layer a decode step), its decode ticks
    profiled; printed beside phase 12's fp32 run, with the top-1 agreement
    of the logits and of the served tokens (not gated)."""
    bf = torch.bfloat16
    serving, counts, lm, eng, done = serve_phase(
        "chatglm3_bf16_serve", "chatglm3-6b", dev,
        per_prefill=["flash_attention_bf16"],
        per_decode=["decode_attention_bf16"], dtype=bf)
    print("[6] device busy share of chatglm3-6b's bf16 decode ticks")
    busy = trace_decode("chatglm3_bf16_decode", eng, lm.cfg)
    del eng
    torch.cuda.empty_cache()
    tokens = torch.arange(64).reshape(2, 32) % lm.cfg.vocab_size
    top1 = lm.logits_causal(tokens, dtype=bf).argmax(-1).cpu()
    agree = (top1 == FP32_CHATGLM3["top1"]).float().mean().item()
    out = {r.uid: r.output for r in done}
    ref = FP32_CHATGLM3["out"]
    first = sum(ref[u][0] == out[u][0] for u in ref) / len(ref)
    same = sum(a == b for u in ref for a, b in zip(ref[u], out[u])) \
        / sum(len(o) for o in ref.values())
    f = fp32_serving
    print(f"  chatglm3 bf16 against phase 12's fp32 run: prefill of "
          f"{LONG_PROMPT['chatglm3-6b']} tokens {serving['prefill_ms_long']:.1f}"
          f" ms (fp32 {f['prefill_ms_long']:.1f}), decode step median "
          f"{serving['decode_step_ms_median']:.3f} ms (fp32 "
          f"{f['decode_step_ms_median']:.3f}), decode tokens/s "
          f"{serving['decode_tokens_per_s']:.1f} (fp32 "
          f"{f['decode_tokens_per_s']:.1f}), peak "
          f"{serving['peak_memory_gb']:.2f} GB (fp32 "
          f"{f['peak_memory_gb']:.2f}); top-1 agreement of the logits on "
          f"2 x 32 tokens {agree:.4f}, first served token {first:.4f}, all "
          f"served tokens {same:.4f} (printed, not gated)")
    del lm
    torch.cuda.empty_cache()
    return serving, counts, {"decode_busy_share": busy,
                             "top1_agreement": agree,
                             "first_token_agreement": first,
                             "token_agreement": same}


def moonshot_bf16(dev):
    """Phase 21 (b): moonshot-v1-16b-a3b at full width and
    MOONSHOT_BF16_DEPTH layers, built in bf16 (each leaf drawn in fp32 and
    rounded), through the engine as phase 9; peak under PEAK_LIMIT_GB."""
    serving, counts, lm, eng, _ = serve_phase(
        "moonshot_bf16_serve", "moonshot-v1-16b-a3b", dev,
        per_prefill=["flash_attention_bf16"],
        per_decode=["decode_attention_bf16"], depth=MOONSHOT_BF16_DEPTH,
        dtype=torch.bfloat16, build_in_dtype=True)
    check(serving["peak_memory_gb"] < PEAK_LIMIT_GB,
          f"moonshot bf16: peak {serving['peak_memory_gb']:.2f} GB")
    print("[6] device busy share of moonshot's bf16 decode ticks")
    busy = trace_decode("moonshot_bf16_decode", eng, lm.cfg)
    del lm, eng
    torch.cuda.empty_cache()
    return serving, counts, {"decode_busy_share": busy}


def bf16_card_vs_cpu(dev):
    """Phase 21 (c): BF16_CARD_CPU at full width, depth 2, weights drawn
    on the card in fp32, cast to bf16 and copied to the CPU (a bf16 model)
    and, upcast, to an fp32 CPU model: the CPU bf16 run's greedy steps
    (a prefill and BF16_CHECK["tokens"] - 1 decode steps) fed to the card;
    the card's logits no farther from the fp32 run's than BF16_LM_WITNESS
    times the CPU bf16 run's (plus 1e-6 of the largest); tokens printed."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import LM

    bf, c, summary = torch.bfloat16, BF16_CHECK, {}
    for i, arch in enumerate(BF16_CARD_CPU):
        cfg = get_config(arch).replace(n_layers=2)
        inputs = {}
        if cfg.encoder_decoder:
            cfg = cfg.replace(n_encoder_layers=2)
            tokens, inputs = seamless_inputs(cfg, c["batch"], c["t_src"],
                                             c["prompt"], 23 + i)
        else:
            tokens = torch.from_numpy(np.random.RandomState(23 + i).randint(
                2, cfg.vocab_size, (c["batch"], c["prompt"])))
        card = LM(cfg, device=dev).init(
            torch.Generator(device=dev).manual_seed(23 + i)).cast_(bf)
        cpu = LM(cfg, device="cpu", dtype=bf)
        cpu.load_state_dict(card.state_dict())
        cpu32 = LM(cfg, device="cpu")
        cpu32.load_state_dict(card.state_dict())
        want, want_lg = greedy_steps(cpu, tokens, c["tokens"], dtype=bf,
                                     **inputs)[:2]
        got, got_lg = greedy_steps(card, tokens, c["tokens"], feed=want,
                                   dtype=bf, **inputs)[:2]
        exact = greedy_steps(cpu32, tokens, c["tokens"], feed=want,
                             **inputs)[1]
        check(all(bool(torch.isfinite(x).all()) for x in got_lg),
              f"{arch} bf16: non-finite logits on the card")
        dist = {name: max((x.float() - e).abs().max().item()
                          for x, e in zip(lg, exact))
                for name, lg in (("card", got_lg), ("cpu", want_lg))}
        dist["card_vs_cpu"] = max((x.float() - w.float()).abs().max().item()
                                  for x, w in zip(got_lg, want_lg))
        dist["top"] = max(e.abs().max().item() for e in exact)
        dist["same_tokens"] = torch.equal(got, want)
        bar = BF16_LM_WITNESS * dist["cpu"] + 1e-6 * dist["top"]
        print(f"  {arch} depth 2, bf16: logits from the fp32 run of the same "
              f"bf16 weights (largest |logit| {dist['top']:.3f}): card "
              f"{dist['card']:.3e}, CPU bf16 {dist['cpu']:.3e} (gate "
              f"{BF16_LM_WITNESS:g}x + 1e-6 of the largest: {bar:.3e}); card "
              f"from CPU {dist['card_vs_cpu']:.3e}; the card's greedy tokens "
              f"equal the CPU's {dist['same_tokens']} (CPU {want.tolist()}, "
              f"card {got.tolist()})")
        check(dist["card"] <= bar, f"{arch} bf16: the card's logits "
              f"{dist['card']:.3e} from the fp32 run, the CPU's "
              f"{dist['cpu']:.3e}")
        summary[arch] = dist
        del card, cpu, cpu32
        torch.cuda.empty_cache()
    return summary


def bf16_step_train(dev, smi):
    """Phase 21 (d): the bf16 step (REPRO_CAST_BF16_STEP=1): mamba2-130m
    through launch/train.py at full width and depth as 18 (g) (finite
    losses; ssd_scan's forward and backward a layer a micro-batch), then
    chatglm3-6b at full width and depth 2 card == CPU on three steps, every
    loss under ``cast_step`` (``chatglm3_bf16_step_vs_cpu``)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import launch_counts
    from repro_torch.models.model import LM
    from repro_torch.models.param import cast_step
    from repro_torch.training import TokenStream

    cfg = get_config("mamba2-130m")
    want = cfg.n_layers * 2 * 3       # layers x micro-batches x steps
    out = launcher_train("mamba2_bf16_step_train", MAMBA2_TRAIN, smi,
                         {"ssd_scan_f32": want, "ssd_scan_bwd_f32": want},
                         env=BF16_STEP_ENV)
    check(len(out["losses"]) == 3, f"mamba2 bf16 step: {out['losses']}")
    counts = {"mamba2_bf16_step_train": {
        k: out["launches"].get(k, 0) for k in launch_counts()}}
    b = BF16_STEP_CPU
    small = get_config("chatglm3-6b").replace(n_layers=b["depth"])
    card = LM(small, device=dev).init(
        torch.Generator(device=dev).manual_seed(5))
    stream = TokenStream(small.vocab_size, b["batch"], b["seq"], seed=5,
                         device="cpu")
    batches = [stream.next_batch() for _ in range(CARD_CPU_STEPS)]
    counts["chatglm3_bf16_step_vs_cpu"], summary = train_vs_cpu(
        f"chatglm3-6b depth {b['depth']}, bf16 step", card,
        lambda device: LM(small, device=device), batches.__getitem__,
        plain_attention, _lm_train_opt(),
        step_ctx=lambda: cast_step(torch.bfloat16))
    n = b["depth"] * CARD_CPU_STEPS
    for sym in ("flash_attention_lse_f32", "flash_attention_bwd_f32"):
        check(counts["chatglm3_bf16_step_vs_cpu"][sym] == n,
              f"chatglm3 bf16 step: {sym} launched "
              f"{counts['chatglm3_bf16_step_vs_cpu'][sym]} times, not {n}")
    del card
    torch.cuda.empty_cache()
    return counts, {"mamba2_bf16_step_train": {k: out[k] for k in (
        "n_layers", "losses", "step_s", "max_memory_allocated")},
        "chatglm3_bf16_step_vs_cpu": summary}


def bf16_phase(dev, smi, fp32_serving):
    """Phase 21: the LM zoo in bf16, (a) through (d).  Returns the launch
    counts by path, the serving numbers and a summary."""
    t21 = time.perf_counter()
    counts, serving, summary = {}, {}, {}
    print("[21a] chatglm3-6b in bf16, full width and depth, through "
          f"ServingEngine(max_slots={SERVE_SLOTS}, s_max={SERVE_S_MAX}, "
          "dtype=bfloat16)")
    serving["chatglm3_bf16_serve"], counts["chatglm3_bf16_serve"], \
        summary["chatglm3_bf16_serve"] = chatglm3_bf16(dev, fp32_serving)
    print(f"[21b] moonshot-v1-16b-a3b in bf16, full width, "
          f"{MOONSHOT_BF16_DEPTH} layers")
    serving["moonshot_bf16_serve"], counts["moonshot_bf16_serve"], \
        summary["moonshot_bf16_serve"] = moonshot_bf16(dev)
    print("[21c] card vs CPU at bf16: five LMs at full width, depth 2")
    summary["card_vs_cpu"] = bf16_card_vs_cpu(dev)
    print("[21d] the bf16 step: mamba2-130m through launch/train.py, "
          "chatglm3-6b depth 2 card vs CPU")
    more, summary["bf16_step"] = bf16_step_train(dev, smi)
    counts.update(more)
    summary["seconds"] = time.perf_counter() - t21
    print(f"[21] {summary['seconds']:.1f} s; {smi}")
    return counts, serving, summary


# ---------------------------------------------------------------------------
# phase 22: bf16 training on the card
# ---------------------------------------------------------------------------

#: (a), (b): ``Trainer`` with the loss at bf16 (the launcher's AdamW, int8
#: moments for chatglm3, 2 micro-batches) for ``steps`` steps on one batch
#: of the token stream repeated, the learning rate warmed up over
#: ``warmup`` steps, then a cosine to 0.  chatglm3-6b's weights are
#: ``conditioned`` (its attention at the reference's init saturates, and
#: its bf16 loss did not fall: 11.903 to 11.906 over 20 steps at lr 1e-3,
#: NVIDIA H100 80GB HBM3, 700 W); its (a) runs the same recipe twice more
#: as controls, in fp32 and in bf16 with the attention's plain versions
BF16_TRAIN = {
    "chatglm3-6b": dict(batch=16, seq=64, int8=True, lr=3e-5, warmup=2,
                        steps=8, conditioned=True),
    "mamba2-130m": dict(batch=8, seq=512, int8=False, lr=1e-3, warmup=10,
                        steps=10, conditioned=False)}
#: (a)'s gate: the bf16 kernels' loss falls at least this share of the fp32
#: control's fall over the same steps
BF16_FALL_SHARE = 0.5


def conditioned(lm):
    """``lm``'s attention projections rescaled in place to std 1/sqrt(their
    true fan-in).  The reference's init reads a weight's fan-in from its
    second-to-last axis: for wq, wk, wv (d_model, heads, head_dim) that is
    the head count, for wo (heads, head_dim, d_model) the head dim, so at
    chatglm3-6b's width q and k come out 10-20 times too large and the
    softmax saturates.  bf16 rounding then changes which key a query
    takes: at chatglm3's shapes with d_model 1024, depth 2, on the CPU,
    the bf16 gradients lay 17-152% of a leaf's largest |g| from fp32's at
    the reference's init, 1.0-2.3% after the rescale."""
    with torch.no_grad():
        for name, p in lm.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf in ("wq", "wk", "wv"):
                p.mul_((p.shape[-2] / p.shape[-3]) ** 0.5)
            elif leaf == "wo":
                p.mul_(p.shape[-3] ** -0.5)
    return lm


class RepeatedBatch:
    """A data iterator (``Trainer``'s) that yields ``stream``'s first batch
    at every step."""

    def __init__(self, stream):
        self.stream, self.batch = stream, stream.next_batch()

    def next_batch(self):
        return self.batch

    def state(self):
        return self.stream.state()

    def set_state(self, state):
        self.stream.set_state(state)


def bf16_train_run(label, arch, dev, dtype=torch.bfloat16):
    """``arch`` at full width and depth (seed 0 on the card, ``conditioned``
    where BF16_TRAIN says) trained by ``Trainer`` with the loss at
    ``dtype`` on BF16_TRAIN's recipe.  Returns the launch counts and a
    summary (losses, step seconds, peak)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models.model import LM
    from repro_torch.training import (OptimizerConfig, TokenStream,
                                      TrainConfig, Trainer)

    r = BF16_TRAIN[arch]
    cfg = get_config(arch)
    lm = LM(cfg, device=dev).init(torch.Generator(device=dev).manual_seed(0))
    if r["conditioned"]:
        conditioned(lm)
    data = RepeatedBatch(TokenStream(cfg.vocab_size, r["batch"], r["seq"],
                                     device=dev))
    trainer = Trainer(lambda b: lm.loss(b, dtype=dtype),
                      dict(lm.named_parameters()),
                      OptimizerConfig(lr=r["lr"], warmup_steps=r["warmup"],
                                      total_steps=r["steps"],
                                      quantized_state=r["int8"]),
                      TrainConfig(steps=r["steps"], grad_accum=2,
                                  log_every=0), data)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    out = trainer.train()
    torch.cuda.synchronize()
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    losses = out["history"]
    print(f"  {label}: {cfg.n_layers} layers at full width"
          f"{', conditioned' if r['conditioned'] else ''}, "
          f"{'int8' if r['int8'] else 'fp32'} moments, batch {r['batch']} x "
          f"{r['seq']} repeated, 2 micro-batches, {r['steps']} steps at lr "
          f"{r['lr']:g} (warm-up {r['warmup']}), the loss at "
          f"{str(dtype).split('.')[-1]}: losses {losses}, step s "
          f"{out['step_times']}, peak {peak / 1e9:.2f} GB "
          f"(max_memory_allocated)")
    check(all(math.isfinite(x) for x in losses) and
          len(losses) == r["steps"], f"{label}: losses {losses}")
    check(peak / 1e9 < PEAK_LIMIT_GB, f"{label}: peak {peak / 1e9:.2f} GB")
    del trainer, lm, data
    torch.cuda.empty_cache()
    return counts, {"n_layers": cfg.n_layers, "losses": losses,
                    "step_s": out["step_times"],
                    "max_memory_allocated": peak}


def launched(label, counts, want, steps):
    """Each symbol of ``want`` launched ``want[symbol]`` times a step."""
    for symbol, k in want.items():
        check(counts[symbol] == k * steps, f"{label}: {symbol} launched "
              f"{counts[symbol]} times, not {k * steps}")


def chatglm3_bf16_train(dev, smi, fp32):
    """(a): chatglm3-6b's bf16 run on the kernels, then its two controls on
    the same weights and batch: fp32 (flash_attention's fp32 pair) and bf16
    with the attention's plain versions.  Gates: each loss falls from the
    first step to the last, the kernels' by at least BF16_FALL_SHARE of
    the fp32 control's fall; the kernels' losses are printed beside the
    controls' and phase 18 (d)'s fp32 launcher run.  Returns the kernels'
    run's launch counts and a summary."""
    from repro_torch.configs import get_config

    layers = get_config("chatglm3-6b").n_layers * 2   # x micro-batches
    steps = BF16_TRAIN["chatglm3-6b"]["steps"]
    counts, summary = bf16_train_run("chatglm3_bf16_train", "chatglm3-6b",
                                     dev)
    launched("chatglm3_bf16_train", counts,
             {"flash_attention_lse_bf16": layers,
              "flash_attention_bwd_bf16": layers,
              "flash_attention_lse_f32": 0, "flash_attention_bwd_f32": 0},
             steps)
    c32, summary["control_fp32"] = bf16_train_run(
        "chatglm3_fp32_control", "chatglm3-6b", dev, torch.float32)
    launched("chatglm3_fp32_control", c32,
             {"flash_attention_lse_f32": layers,
              "flash_attention_bwd_f32": layers}, steps)
    with plain_attention():
        cplain, summary["control_bf16_plain"] = bf16_train_run(
            "chatglm3_bf16_plain_control", "chatglm3-6b", dev)
    launched("chatglm3_bf16_plain_control", cplain,
             {"flash_attention_lse_bf16": 0, "flash_attention_bwd_bf16": 0},
             steps)
    fall = {k: v["losses"][0] - v["losses"][-1] for k, v in (
        ("kernels", summary), ("fp32", summary["control_fp32"]),
        ("plain", summary["control_bf16_plain"]))}
    dist = {k: max(abs(a - b) for a, b in zip(
        v["losses"], summary["control_fp32"]["losses"]))
        for k, v in (("kernels", summary),
                     ("plain", summary["control_bf16_plain"]))}
    summary["fall"], summary["from_fp32"] = fall, dist
    print(f"  chatglm3-6b: the loss's fall over {steps} steps: bf16 kernels "
          f"{fall['kernels']:.4f}, fp32 control {fall['fp32']:.4f}, bf16 "
          f"plain control {fall['plain']:.4f} (gate: each above 0, the "
          f"kernels' at least {BF16_FALL_SHARE:g} of fp32's); the largest "
          f"step's distance from the fp32 control's loss: kernels "
          f"{dist['kernels']:.4e}, plain {dist['plain']:.4e}; phase 18 (d)'s "
          f"fp32 launcher run (reference init, lr 1e-3, fresh batches): "
          f"losses {fp32['losses']}, step s {fp32['step_s']}, peak "
          f"{fp32['max_memory_allocated'] / 1e9:.2f} GB; {smi}")
    check(fall["fp32"] > 0 and fall["plain"] > 0,
          f"chatglm3-6b's controls: the loss did not fall ({fall})")
    check(fall["kernels"] >= BF16_FALL_SHARE * fall["fp32"],
          f"chatglm3-6b at bf16: the loss fell {fall['kernels']:.4f}, the "
          f"fp32 control's {fall['fp32']:.4f}")
    return counts, summary


#: (c) card == CPU at bf16: chatglm3-6b at full width, depth 2, batch 2 x
#: 32, two steps, ``conditioned``, held as phase 21 (c) holds bf16 logits:
#: each gradient leaf no farther from an fp32 run's on the CPU (the same
#: weights) than BF16_LM_WITNESS times the CPU bf16 run's.  At the
#: reference's init the bf16 gradients lay 35-163% of a leaf's largest |g|
#: from fp32's, on either device, and the witness could not tell a wrong
#: kernel from rounding
BF16_TRAIN_CPU = dict(depth=2, batch=2, seq=32, steps=2)


def bf16_grads_vs_fp32(label, card, make, batches, opt, steps):
    """The first ``steps`` AdamW steps of ``card`` with the loss at bf16;
    before each, a CPU copy of its parameters gives the bf16 loss and
    gradients and the fp32 ones: each gradient leaf of the card no farther
    from the fp32 one than BF16_LM_WITNESS times the CPU bf16 run's (plus
    1e-6 of the leaf's largest |g|), and the loss within CARD_CPU_TOL
    relative of the fp32 loss or that witness.  Returns the launch counts
    of the card's steps and a summary."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.training.optimizer import adamw_init, adamw_update

    cpu = make("cpu")
    for m in (card, cpu):
        for p in m.parameters():
            p.requires_grad_(True)

    def loss_and_grads(m, batch, dtype):
        for p in m.parameters():
            p.grad = None
        dev = next(m.parameters()).device
        loss = m.loss({k: v.to(dev) for k, v in batch.items()}, dtype=dtype)
        loss.backward()
        return loss.item(), {n: p.grad.cpu() for n, p in
                             m.named_parameters()}

    params = dict(card.named_parameters())
    state = adamw_init(params, opt)
    counts, out = {}, []
    for t in range(steps):
        batch = batches(t)
        cpu.load_state_dict(card.state_dict())
        reset_launch_counts()
        loss_k, g_k = loss_and_grads(card, batch, torch.bfloat16)
        torch.cuda.synchronize()
        for k, v in launch_counts().items():
            counts[k] = counts.get(k, 0) + v
        loss_c, g_c = loss_and_grads(cpu, batch, torch.bfloat16)
        loss_32, g_32 = loss_and_grads(cpu, batch, torch.float32)
        rel_k = abs(loss_k - loss_32) / abs(loss_32)
        rel_c = abs(loss_c - loss_32) / abs(loss_32)
        check(math.isfinite(loss_k) and rel_k <= max(
            CARD_CPU_TOL, BF16_LM_WITNESS * rel_c), f"{label} step {t + 1}: "
            f"loss card {loss_k}, CPU bf16 {loss_c}, fp32 {loss_32}")
        worst = []
        for n, g in g_32.items():
            scale = max(g.abs().max().item(), 1e-30)
            d_k = (g_k[n] - g).abs().max().item() / scale
            d_c = (g_c[n] - g).abs().max().item() / scale
            check(math.isfinite(d_k) and
                  d_k <= BF16_LM_WITNESS * d_c + 1e-6,
                  f"{label} step {t + 1}: the gradient of {n} is {d_k:.3e} "
                  f"of its largest |g| from the fp32 one, the CPU bf16 "
                  f"run's {d_c:.3e}")
            worst.append((d_k / max(d_c, 1e-30), n, d_k, d_c))
        worst.sort(reverse=True)
        print(f"  {label} step {t + 1}: loss card {loss_k:.6f}, CPU bf16 "
              f"{loss_c:.6f}, fp32 {loss_32:.6f}; gradients from the fp32 "
              f"ones, relative to each leaf's largest |g|, card | CPU bf16, "
              f"the nearest the gate: " + ", ".join(
                  f"{n} {a:.2e} | {b:.2e}" for _, n, a, b in worst[:3]))
        out.append({"loss_card": loss_k, "loss_cpu_bf16": loss_c,
                    "loss_fp32": loss_32,
                    "worst_ratio": worst[0][0]})
        adamw_update(params, {n: p.grad for n, p in params.items()}, state,
                     opt)
    del cpu
    return counts, {"steps": out}


def bf16_train_phase(dev, smi, fp32):
    """Phase 22: ``LM.loss(batch, dtype=torch.bfloat16)`` trained on the
    card, fp32 masters, gradients back in fp32: (a) chatglm3-6b at full
    width and depth, int8 moments, ``conditioned``, beside its fp32 and
    plain-attention controls (``chatglm3_bf16_train``:
    flash_attention_lse_bf16 and flash_attention_bwd_bf16 a layer a
    micro-batch); (b) mamba2-130m (``mamba2_bf16_train``: the SSD computes
    in fp32 inside, so ssd_scan's forward and backward), its loss falling;
    (c) chatglm3-6b at depth 2, ``conditioned``, card == CPU at bf16 on two
    steps against an fp32 run with the CPU bf16 run's witness
    (``bf16_grads_vs_fp32``, ``chatglm3_bf16_train_vs_cpu``).  ``fp32`` is
    phase 18's training summary.  Returns the launch counts by path and a
    summary."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import LM
    from repro_torch.training import TokenStream

    t22 = time.perf_counter()
    counts, summary = {}, {}
    print("[22a] chatglm3-6b: LM.loss at bf16 through Trainer, full width "
          "and depth, int8 moments, beside its fp32 and plain controls")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    counts["chatglm3_bf16_train"], summary["chatglm3_bf16_train"] = \
        chatglm3_bf16_train(dev, smi, fp32["chatglm3_train"])
    print("[22b] mamba2-130m: LM.loss at bf16 through Trainer")
    layers = get_config("mamba2-130m").n_layers * 2
    counts["mamba2_bf16_train"], out = bf16_train_run(
        "mamba2_bf16_train", "mamba2-130m", dev)
    summary["mamba2_bf16_train"] = out
    launched("mamba2_bf16_train", counts["mamba2_bf16_train"],
             {"ssd_scan_f32": layers, "ssd_scan_bwd_f32": layers},
             BF16_TRAIN["mamba2-130m"]["steps"])
    m32 = fp32["mamba2_train"]
    print(f"  mamba2_bf16_train: the loss fell {out['losses'][0]:.4f} -> "
          f"{out['losses'][-1]:.4f} (gate: below the first); phase 18 (g)'s "
          f"fp32 launcher run: losses {m32['losses']}, step s "
          f"{m32['step_s']}, peak {m32['max_memory_allocated'] / 1e9:.2f} "
          f"GB; {smi}")
    check(out["losses"][-1] < out["losses"][0],
          f"mamba2-130m at bf16: the loss did not fall ({out['losses']})")
    print("[22c] chatglm3-6b at depth 2, conditioned: card vs CPU at bf16")
    b = BF16_TRAIN_CPU
    small = get_config("chatglm3-6b").replace(n_layers=b["depth"])
    card = conditioned(LM(small, device=dev).init(
        torch.Generator(device=dev).manual_seed(6)))
    stream = TokenStream(small.vocab_size, b["batch"], b["seq"], seed=6,
                         device="cpu")
    batches = [stream.next_batch() for _ in range(b["steps"])]
    counts["chatglm3_bf16_train_vs_cpu"], summary["card_vs_cpu"] = \
        bf16_grads_vs_fp32(f"chatglm3-6b depth {b['depth']}, loss at bf16",
                           card, lambda device: LM(small, device=device),
                           batches.__getitem__, _lm_train_opt(), b["steps"])
    launched("chatglm3 bf16 card vs CPU", counts["chatglm3_bf16_train_vs_cpu"],
             {"flash_attention_lse_bf16": b["depth"],
              "flash_attention_bwd_bf16": b["depth"]}, b["steps"])
    del card
    torch.cuda.empty_cache()
    summary["seconds"] = time.perf_counter() - t22
    print(f"[22] {summary['seconds']:.1f} s; {smi}")
    return counts, summary


# ---------------------------------------------------------------------------
# phase 23: the dry run, the roofline and the pipeline on one card
# ---------------------------------------------------------------------------

#: (a) the archs whose every applicable cell runs on the card where it
#: fits (``launch/dryrun.py::run_cell``)
DRYRUN_CARD = ("gemma2-2b", "mamba2-130m", "phi3-mini-3.8b", "chatglm3-6b")
#: a cell's report statuses the phase takes: a run on the card, or its
#: analytic bytes over the card's
DRYRUN_STATUSES = ("ok", "does_not_fit_one_card")


def gpipe_world_of_one(dev):
    """``gpipe`` on a world of one on the card (``launch/mesh.py``'s
    process group, NCCL): one stage over every micro-batch equals the
    stack run straight, bit for bit."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.distribution import PipelineConfig, gpipe
    from repro_torch.launch.mesh import make_test_mesh

    mesh = make_test_mesh(1, 1, device=dev)
    check(dist.get_world_size() == 1 and dist.get_backend() == "nccl",
          f"the card's world: {dist.get_world_size()} ranks, "
          f"{dist.get_backend()}")
    pod = init_device_mesh("cuda", (1,), mesh_dim_names=("pod",))
    gen = torch.Generator(device=dev).manual_seed(23)
    w = 0.3 * torch.randn(1, 256, 256, generator=gen, device=dev)
    x = torch.randn(64, 256, generator=gen, device=dev)
    cfg = PipelineConfig(microbatches=8)
    y = gpipe(lambda p, h: torch.tanh(h @ p), pod, cfg)(w, x)
    want = torch.cat([torch.tanh(c @ w[0]) for c in x.split(8)])
    check(torch.equal(y, want), "gpipe on a world of one differs from the "
          "stack")
    print(f"  gpipe on a world of one ({mesh}, NCCL): {cfg.microbatches} "
          f"micro-batches equal to the stack bit for bit; bubble "
          f"{cfg.bubble_fraction(1):.3f} (at 4 stages "
          f"{cfg.bubble_fraction(4):.3f})")
    dist.destroy_process_group()


#: (b) the meta counts of every assigned arch run beside the other phases
#: in a process of their own (CPU work), into reports/dryrun_torch_meta/
DRYRUN_META_TAG = "meta"


def start_meta_counts():
    """``launch/dryrun.py --all --meta-only`` in its own process (two
    threads), its log in build/dryrun_meta.log; phase 23 waits for it."""
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    log = open(os.path.join(ROOT, "build", "dryrun_meta.log"), "w")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="2")
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--all",
         "--meta-only", "--tag", DRYRUN_META_TAG], cwd=ROOT, env=env,
        stdout=log, stderr=subprocess.STDOUT)


def dryrun_phase(dev, smi, meta):
    """Phase 23: (a) ``run_cell`` for every applicable cell of
    DRYRUN_CARD: the meta count, then the step at a batch of one on the
    card where its bytes fit (``dryrun``: the kernels of each step), or
    why not; (b) the meta count of every ASSIGNED arch's cells, from
    ``meta`` (``start_meta_counts``' process); (c) the roofline table over
    (a)'s reports and (b)'s for the other archs, at the H100's named
    peaks; (d) ``gpipe`` on a world of one.  Returns the launch counts
    and a summary."""
    from repro_torch.common.config import applicable_cells
    from repro_torch.configs import ASSIGNED, get_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import dryrun, roofline

    t23 = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    for path in glob.glob(os.path.join(dryrun.REPORT_DIR, "*.json")):
        os.remove(path)
    print("[23a] the dry run's cells on the card: " + ", ".join(DRYRUN_CARD))
    reports = {}
    reset_launch_counts()
    for arch in DRYRUN_CARD:
        for cell in applicable_cells(get_config(arch)):
            r = dryrun.run_cell(arch, cell, device=str(dev))
            check(r["status"] in DRYRUN_STATUSES, f"dry run {arch} {cell}: "
                  f"{r['status']} {r.get('error', '')}")
            reports[(arch, cell)] = r
            torch.cuda.empty_cache()
    torch.cuda.synchronize()
    counts = {"dryrun": launch_counts()}
    ran = [r for r in reports.values() if r["status"] == "ok"]
    # the kernels of the steps that ran: bf16 prefill and decode on every
    # attention arch, the SSD on mamba2, the bf16 training pair where an
    # attention arch's train_4k ran
    want = ["flash_attention_bf16", "decode_attention_bf16", "ssd_scan_f32"]
    if any(r["kind"] == "train" and r["arch"] != "mamba2-130m"
           for r in ran):
        want += ["flash_attention_lse_bf16", "flash_attention_bwd_bf16"]
    for k in want:
        check(counts["dryrun"][k] > 0, f"dry run: {k} never launched")
    print(f"  {len(ran)} of {len(reports)} cells ran on the card; launches "
          f"{ {k: v for k, v in counts['dryrun'].items() if v} }")
    print("[23b] the meta count of every assigned arch (its own process, "
          "started in phase 1)")
    t0 = time.perf_counter()
    rc = meta.wait(timeout=600)
    meta_dir = f"{dryrun.REPORT_DIR}_{DRYRUN_META_TAG}"
    with open(os.path.join(ROOT, "build", "dryrun_meta.log")) as f:
        for line in f.read().splitlines():
            print(f"    {line}")
    check(rc == 0, f"dryrun --all --meta-only exited {rc}")
    print(f"  waited {time.perf_counter() - t0:.1f} s for it")
    for arch in ASSIGNED:
        for cell in applicable_cells(get_config(arch)):
            with open(os.path.join(meta_dir, f"{arch}__{cell}__"
                                   f"{dryrun.MESH_NAME}.json")) as f:
                r = json.load(f)
            check(r["status"] == "meta_only", f"dry run {arch} {cell}: "
                  f"{r['status']} {r.get('error', '')}")
            if (arch, cell) in reports:
                check(r["flops"] == reports[(arch, cell)]["flops"],
                      f"dry run {arch} {cell}: two counts differ")
            else:
                reports[(arch, cell)] = r
    print("[23c] the roofline (H100 SXM: "
          f"{roofline.PEAK_FLOPS / 1e12:.0f} TFLOP/s bf16, "
          f"{roofline.HBM_BW / 1e12:.2f} TB/s HBM, "
          f"{roofline.LINK_BW / 1e9:.0f} GB/s NVLink)")
    rows = roofline.load_all(dryrun.REPORT_DIR) + [
        row for row in roofline.load_all(meta_dir)
        if row["arch"] not in DRYRUN_CARD]
    check(len(rows) == len(reports), f"roofline: {len(rows)} rows for "
          f"{len(reports)} reports")
    print(roofline.table(rows))
    print("[23d] gpipe on a world of one")
    gpipe_world_of_one(dev)
    summary = {"cells": {f"{a} {c}": {k: r.get(k) for k in (
        "status", "flops", "bytes_batch1", "card")}
        for (a, c), r in reports.items()},
        "roofline": rows, "seconds": time.perf_counter() - t23}
    print(f"[23] {summary['seconds']:.1f} s; {smi}")
    return counts, summary


def training_phase(dev, rows, q8_random_score, smi):
    """Phase 18: (a) the flash_attention backward, (f) the ssd_scan
    backward, (g) mamba2-130m's training steps at full width and card ==
    CPU, (d) chatglm3-6b's training steps at full width, (b) the stream
    models trained on the card, (c) card == CPU, (e) resume.  Returns the
    launch counts by path and a summary."""
    t18 = time.perf_counter()
    # a restored trainer replays only if every kernel repeats: cuDNN's
    # default convolution backward sums with atomics
    torch.backends.cudnn.deterministic = True
    print("[18a] flash_attention's backward against its plain version and "
          "float64")
    flash_bwd_checks(dev, rows)
    print("[18f] ssd_scan's backward against its plain version and float64")
    ssd_bwd_checks(dev, rows)
    counts, summary = {}, {}
    print("[18g] mamba2-130m: launch/train.py at full width and depth, then "
          "card vs CPU at depth 2")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    out, counts["mamba2_train_vs_cpu"], summary["mamba2_train_vs_cpu"] = \
        mamba2_train(dev, smi)
    from repro_torch.kernels import launch_counts
    counts["mamba2_train"] = {k: out["launches"].get(k, 0)
                              for k in launch_counts()}
    summary["mamba2_train"] = {k: out[k] for k in (
        "n_layers", "losses", "step_s", "max_memory_allocated")}
    print("[18d] chatglm3-6b: launch/train.py at full width and depth")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    out = chatglm3_train(smi)
    counts["chatglm3_train"] = {k: out["launches"].get(k, 0)
                                for k in launch_counts()}
    summary["chatglm3_train"] = {k: out[k] for k in (
        "n_layers", "losses", "step_s", "max_memory_allocated")}
    print("[18b] the stream models trained on the card")
    more, summary["pretrain"] = pretrain_phase(dev, q8_random_score)
    counts.update(more)
    print("[18c] card vs CPU: the big MLLM's first steps")
    counts["mllm_train_vs_cpu"], summary["card_vs_cpu"] = \
        mllm_card_vs_cpu(dev)
    print("[18e] resume on the card")
    counts["mllm_resume"], summary["resume"] = mllm_resume(dev)
    summary["seconds"] = time.perf_counter() - t18
    print(f"[18] {summary['seconds']:.1f} s; {smi}")
    return counts, summary


def stamp(t_start, what):
    """The wall time since the script started, after ``what``."""
    print(f"[time] {what} done at {time.perf_counter() - t_start:.1f} s")


def main() -> int:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    try:
        from repro_torch.kernels import build
    except ImportError as e:
        print(f"chip_smoke: the port is not importable ({e}); run from the "
              "repository root", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    runs, counts, busy, serving = {}, {}, {}, {}
    meta = None
    try:
        smi = smi_line()
        print(f"[1] card: {smi}; torch {torch.__version__}, "
              f"CUDA {torch.version.cuda}")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        print("[1] TF32 off for matmuls and convolutions (fp32 throughout)")
        t0 = time.perf_counter()
        report = build(force=True)
        print(f"[1] built {sorted(report)} in "
              f"{time.perf_counter() - t0:.2f} s (parallel nvcc)")
        for name, r in sorted(report.items()):
            for line in str(r["log"]).splitlines():
                if "registers" in line or "spill" in line:
                    print(f"    {name}: {line.strip()}")
        no_stack(report, "fused_preprocess")
        sass_mma_counts()
        meta = start_meta_counts()
        print("[1] the dry run's meta counts started in their own process "
              "(phase 23 reads them)")

        print("[2] kernels vs their plain PyTorch versions on the card")
        rows = kernel_checks(dev)
        stamp(t_start, "phases 1-2")

        ctx = make_ctx(dev)
        print("[3] Q8 naive plan, full width (samsara-stream-mllm, PATCH 16)")
        runs["q8_naive"], counts["q8_naive"] = drive(
            "q8_naive", q8_plan("naive"), ctx, ["flash_attention"])
        check(runs["q8_naive"].mllm_frames == N_FRAMES,
              f"naive: mllm_frames {runs['q8_naive'].mllm_frames}")
        print("[4] Q8 reduced plan")
        runs["q8_reduced"], counts["q8_reduced"] = drive(
            "q8_reduced", q8_plan("reduced"), ctx,
            ["frame_diff", "fused_preprocess", "flash_attention"])
        check(0 < runs["q8_reduced"].mllm_frames < N_FRAMES,
              f"reduced: mllm_frames {runs['q8_reduced'].mllm_frames}")
        print(f"[4] reduced/naive: "
              f"{runs['q8_reduced'].fps / runs['q8_naive'].fps:.2f}x fps, "
              f"{runs['q8_reduced'].mllm_frames}/"
              f"{runs['q8_naive'].mllm_frames} MLLM frames")

        print("[5] card vs CPU on 64 frames")
        cross_check(ctx)
        print("[6] device busy share (torch.profiler)")
        for which in ("naive", "reduced", "fused"):
            busy[f"q8_{which}"] = trace(f"q8_{which}", q8_plan(which), ctx)

        print("[7] SuperOptimizer(ctx).optimize(Q8) on the card")
        plan, opt_report = optimize(ctx)
        runs["q8_optimized"], counts["q8_optimized"] = drive(
            "q8_optimized", plan, ctx)

        print("[8] Q8 fused plan (reduced + TinyDet cascade in one "
              "FusedPrefixOp) vs its unfused twin")
        runs["q8_fused"], counts["q8_fused"] = drive(
            "q8_fused", q8_plan("fused"), ctx,
            ["fused_prefix", "flash_attention"])
        check(runs["q8_fused"].mllm_frames > 0,
              "q8_fused: the cascade kept no frame")
        runs["q8_unfused"], counts["q8_unfused"] = drive(
            "q8_unfused", q8_plan("unfused"), ctx,
            ["frame_diff", "fused_preprocess", "flash_attention"])
        fused_vs_unfused(ctx, runs["q8_fused"], runs["q8_unfused"])

        stamp(t_start, "phases 3-8")
        t13 = time.perf_counter()
        print("[13] the catalog: every query's naive plan on its dataset")
        catalog, counts["catalog"] = catalog_phase(ctx)
        print("[14] multi-query shared execution (MultiQueryRuntime)")
        shared, mq_counts, mq_summary = multiquery_phase(ctx, catalog)
        counts.update(mq_counts)
        print("[15] the semantic gate")
        gate_counts, gate_summary = gate_phase(ctx, runs["q8_naive"])
        counts.update(gate_counts)
        print("[16] observability and faults")
        of_counts, of_summary = obs_faults_phase(ctx,
                                                 shared["mq_tollbooth"])
        counts.update(of_counts)
        print(f"[13-16] {time.perf_counter() - t13:.1f} s")
        print("[17] the serving tier: SharedExtractServer, "
              "MultiStreamRuntime, the gate in the server, faults, fleet")
        serve_counts, serve_summary = serving_phase(ctx)
        counts.update(serve_counts)
        stamp(t_start, "phases 13-17")
        del ctx
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

        print("[9] gemma2-2b, full width, through ServingEngine(max_slots=4, "
              "s_max=8192)")
        serving["gemma2_serve"], counts["gemma2_serve"], lm, eng, _ = \
            serve_phase("gemma2_serve", "gemma2-2b", dev,
                        per_prefill=["flash_attention"],
                        per_decode=["decode_attention"])
        print("[6] device busy share of gemma2-2b's decode ticks")
        busy["gemma2_decode"] = trace_decode("gemma2_decode", eng, lm.cfg)
        del lm, eng
        torch.cuda.empty_cache()
        print("[10] mamba2-130m, full width, through the same engine")
        serving["mamba2_serve"], counts["mamba2_serve"], lm, eng, _ = \
            serve_phase("mamba2_serve", "mamba2-130m", dev,
                        per_prefill=["ssd_scan"])
        print("[6] device busy share of mamba2-130m's decode ticks")
        busy["mamba2_decode"] = trace_decode("mamba2_decode", eng, lm.cfg)
        del lm, eng
        torch.cuda.empty_cache()
        print("[11] card vs CPU: the served LMs at full width, depth 2")
        lm_card_vs_cpu(dev)
        torch.cuda.synchronize()
        print("[12] chatglm3-6b, full width, through ServingEngine"
              "(max_slots=4, s_max=8192), then its int8 weights")
        more, more_counts, int8_summary = chatglm3_int8(dev, rows)
        serving.update(more)
        counts.update(more_counts)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        stamp(t_start, "phases 9-12")
        from repro_torch.queries.catalog import QUERIES

        print("[18] training on the card")
        train_counts, train_summary = training_phase(
            dev, rows, QUERIES["Q8"].evaluate(runs["q8_naive"]), smi)
        counts.update(train_counts)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        print("[19] the MoE family served and trained")
        moe_counts, moe_serving, moe_summary = moe_phase(dev, smi)
        counts.update(moe_counts)
        serving.update(moe_serving)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        print("[20] the encoder-decoder and patch-frontend families")
        encdec_counts, encdec_serving, encdec_summary = encdec_phase(dev, smi)
        counts.update(encdec_counts)
        serving.update(encdec_serving)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        print("[21] the LM zoo in bf16")
        bf16_counts, bf16_serving, bf16_summary = bf16_phase(
            dev, smi, serving["chatglm3_serve"])
        counts.update(bf16_counts)
        serving.update(bf16_serving)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        print("[22] bf16 training: LM.loss at bf16 on the card")
        bf16_train_counts, bf16_train_summary = bf16_train_phase(
            dev, smi, train_summary)
        counts.update(bf16_train_counts)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        print("[23] the dry run, the roofline and gpipe on one card")
        dryrun_counts, dryrun_summary = dryrun_phase(dev, smi, meta)
        counts.update(dryrun_counts)
    except (SmokeFailure, RuntimeError, ValueError, KeyError, OSError,
            subprocess.SubprocessError) as e:
        print(f"chip_smoke: FAILED: {type(e).__name__}: {e}",
              file=sys.stderr)
        return 1
    finally:
        if meta is not None and meta.poll() is None:
            meta.kill()
            meta.wait()

    kernels = []
    for name, (symbol, source, replaces) in KERNELS.items():
        t = rows[name]
        by_path = {p: counts[p][symbol] for p in PATHS}
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            **({"launches_by_step_class": {c: sum(
                r["launches_by_step_class"][name][c]
                for r in serving.values()
                if name in r.get("launches_by_step_class", {}))
                for c in ("long", "short")}} if name in CLASSED else {}),
            **({"companion_launches": {
                c: sum(counts[p][c] for p in PATHS)
                for c in COMPANIONS[name]}} if name in COMPANIONS else {}),
            "max_abs_err": ERRS[name], **timing(t),
            **{k: timing(v) if isinstance(v, dict) and "ms" in v else v
               for k, v in t.items() if k not in TIMING_KEYS}})
    physical = opt_report.phases[-1]
    print(json.dumps({"q8": {
        **{p: {"fps": r.fps, "wall_s": r.wall_s,
               "mllm_frames": r.mllm_frames} for p, r in runs.items()},
        "optimized_plan": opt_report.final_plan,
        "optimizer": {"phase_wall_s": opt_report.phase_wall_s,
                      "model": physical["model_selection"]["chosen"],
                      "fused_prefix": physical["fused_prefix"]},
        "device_busy_share": busy,
        "frames": N_FRAMES, "micro_batch": MICRO_BATCH,
        "stream_seed": STREAM_SEED, "detector_seed": DETECTOR_SEED}},
        default=str))
    print(json.dumps({"catalog": {
        qid: {"fps": r.fps, "mllm_frames": r.mllm_frames,
              "outputs": len(r.outputs)} for qid, r in catalog.items()},
        "multiquery": mq_summary, "gate": gate_summary,
        "obs_faults": of_summary, "serving_tier": serve_summary},
        default=str))
    print(json.dumps({"serving": {**serving, "device_busy_share": {
        k: busy[k] for k in ("gemma2_decode", "mamba2_decode")},
        "chatglm3_int8": int8_summary,
        "slots": SERVE_SLOTS, "s_max": SERVE_S_MAX,
        "new_tokens": SERVE_NEW}}))
    print(json.dumps({"training": train_summary}, default=str))
    print(json.dumps({"moe": moe_summary}, default=str))
    print(json.dumps({"encdec": encdec_summary}, default=str))
    print(json.dumps({"bf16": {**bf16_summary, "kernels_vs_float64":
                               BF16_F64, "bwd_delta": BF16_DELTA}},
                     default=str))
    print(json.dumps({"bf16_train": bf16_train_summary}, default=str))
    print(json.dumps({"dryrun": dryrun_summary}, default=str))
    print(f"[total] {time.perf_counter() - t_start:.1f} s (phase 17 "
          f"{serve_summary['seconds']:.1f} s, phase 18 "
          f"{train_summary['seconds']:.1f} s, phase 19 "
          f"{moe_summary['seconds']:.1f} s, phase 20 "
          f"{encdec_summary['seconds']:.1f} s, phase 21 "
          f"{bf16_summary['seconds']:.1f} s, phase 22 "
          f"{bf16_train_summary['seconds']:.1f} s, phase 23 "
          f"{dryrun_summary['seconds']:.1f} s)")
    print(smi_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
