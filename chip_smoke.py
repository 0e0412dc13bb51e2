#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of the stream processor once on one GPU.

    python3 chip_smoke.py          # from the repository root, on a CUDA host

Phases (any failure exits non-zero and prints no result line):
  1. set-up: the card's name and power limit, TF32 off for matmuls and
     convolutions, the hand-written kernels built from ``src/repro_torch/
     kernels/csrc`` (one ``nvcc`` per source, in parallel), and the
     tensor-core instructions in the built libraries counted with
     ``cuobjdump --dump-sass`` (HMMA in flash_attention's, IMMA in
     int8_matmul's; none fails);
  2. kernel checks: each kernel against its plain PyTorch version on the
     card, at the main path's shapes and at ragged ones, with its device
     time, its roofline bound and a yardstick: PyTorch's SDPA for
     attention (prefill and decode; it cannot soft-cap, so it runs
     without the cap), the unfused chain (frame_diff + fused_preprocess
     kernels, colour and signature in PyTorch) for fused_prefix (timed
     only here; the port never calls SDPA); decode_attention at gemma2's,
     chatglm3-6b's (a group of 16) and phi3-mini's (D 96) decode shapes
     and ragged ones, ssd_scan at mamba2's chunks and the reference
     sweep's grouped shape, flash_attention at every head dim with groups
     of 1, 2, 16 and 64, ragged S, bidirectional, capped and windowed, and
     at gemma2's, chatglm3-6b's and phi3-mini's prefill of an 8192 bucket
     (bound at the 3xTF32 rate, the fp32 CUDA cores' beside it); the last
     two again at
     chatglm3's and phi3's magnitudes (q, k, v as the reference's init
     makes them: scores in the hundreds), held to the plain version and
     to float64 beside it (card and CPU); int8_matmul (exact: equal to
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
     plain versions printed beside them;
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

Each phase that drives a plan zeroes the kernels' launch counts first and
reads them after; a kernel of the plan that was never launched fails the
run.  The last lines are the card's ``nvidia-smi`` name/power line, one
``{"kernels": [...]}`` JSON line, and ``{"ok": true, "device": ...}``.
"""
from __future__ import annotations

import contextlib
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
TOL = {"frame_diff": 1e-6, "fused_preprocess": 1e-5, "flash_attention": 2e-5,
       "fused_prefix": 1e-5, "decode_attention": 2e-5, "ssd_scan": 1e-4,
       "int8_matmul": 0.0}
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
    "decode_attention": ("decode_attention_partials_f32",
                         "src/repro_torch/kernels/csrc/decode_attention.cu",
                         "src/repro/kernels/decode_attention/kernel.py:69"),
    "ssd_scan": ("ssd_scan_f32", "src/repro_torch/kernels/csrc/ssd_scan.cu",
                 "src/repro/kernels/ssd_scan/kernel.py:55"),
    "int8_matmul": ("int8_mma_f32",
                    "src/repro_torch/kernels/csrc/int8_matmul.cu",
                    "src/repro/kernels/int8_matmul/kernel.py:36"),
}
#: a kernel's other launches, each its own C entry point with its own
#: count, made once with every launch of the kernel's entry above
COMPANIONS = {"decode_attention": ("decode_attention_combine_f32",),
              "ssd_scan": ("ssd_cb_f32",),
              "int8_matmul": ("int8_transpose_kn",)}
#: the tensor-core instruction each built library must hold (phase 1)
SASS_MMA = {"flash_attention": "HMMA", "int8_matmul": "IMMA"}
#: the paths driven end to end, by the name used in ``launches_by_path``
PATHS = ("q8_naive", "q8_reduced", "q8_fused", "q8_unfused", "q8_optimized",
         "gemma2_serve", "mamba2_serve", "chatglm3_serve", "chatglm3_int8",
         "chatglm3_dequant_serve")
#: the serving phases: 8 requests of the launcher's generator plus a long
#: one; s_max and slots as a deployment of gemma2-2b on one card would
SERVE_SLOTS, SERVE_S_MAX, SERVE_NEW = 4, 8192, 12
LONG_PROMPT = {"gemma2-2b": 4200, "mamba2-130m": 512, "chatglm3-6b": 4200}
#: chatglm3-6b's quantized projections as (K, N) matrices, the operands of
#: matmul_int8_dynamic (wq/wk/wv (d, H, Dh) and wo (H, Dh, d) reshaped)
CHATGLM3_PROJ = {"wq": (4096, 4096), "wk": (4096, 256), "wv": (4096, 256),
                 "wo": (4096, 4096), "w_in": (4096, 13696),
                 "w_gate": (4096, 13696), "w_out": (13696, 4096)}
#: card == CPU: the logits' tolerance.  fp32 on both, but cuBLAS and the
#: CPU's BLAS sum d_model (up to 4096) products in other orders; the dense
#: zoo (no soft-cap) has scores in the hundreds, so decode_attention sums
#: each score in the plain version's order and flash_attention nearer
#: float64 than the plain version (3xTF32 with staged sums)
LM_TOL = 1e-3


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


TIMING_KEYS = ("ms", "plain_ms", "library_ms", "bound")


def timing(t):
    """A timing dict as the kernels line writes it."""
    return {"ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound"][0], "bound_by": t["bound"][1],
            "library_ms": t["library_ms"]}


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


def sass_mma_counts():
    """Phase 1: each library of ``SASS_MMA`` holds its tensor-core
    instruction (``cuobjdump --dump-sass``); a count of 0 fails."""
    from repro_torch.kernels._build import library_path, nvcc

    exe = shutil.which("cuobjdump") or os.path.join(
        os.path.dirname(nvcc()), "cuobjdump")
    for name, op in SASS_MMA.items():
        sass = subprocess.run([exe, "--dump-sass", str(library_path(name))],
                              capture_output=True, text=True, timeout=300,
                              check=True).stdout
        n = len(re.findall(rf"\b{op}\b", sass))
        print(f"[1] {name}: {n} {op} instructions (cuobjdump --dump-sass)")
        check(n > 0, f"{name}: no {op} instruction in its library")


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
        library_ms=None, bound=bound(nbytes, 3 * a.numel()))

    # fused_preprocess: the reduced plan's crop, then odd offsets
    for crop, f, grey in [((64, 0, 64, 256), 2, False),
                          ((0, 0, 128, 256), 1, False),
                          ((33, 17, 30, 98), 2, True),
                          ((1, 3, 63, 125), 1, False),
                          ((5, 7, 96, 60), 3, False)]:
        x = frames((16, 3, 128, 256))
        compare("fused_preprocess",
                fused_preprocess_cuda(x, crop=crop, factor=f, grey=grey),
                fused_preprocess_ref(x, crop=crop, factor=f, grey=grey),
                f"crop {crop} /{f}{' grey' if grey else ''}")
    x = frames((16, 3, 128, 256))
    path = dict(crop=(64, 0, 64, 256), factor=2)
    n_in, n_out = 16 * 3 * 64 * 256, 16 * 3 * 32 * 128
    rows["fused_preprocess"] = dict(
        ms=device_ms(lambda: fused_preprocess_cuda(x, **path)),
        plain_ms=device_ms(lambda: fused_preprocess_ref(x, **path)),
        library_ms=None, bound=bound(n_in + 4 * n_out, n_in + 2 * n_out))

    # flash attention in model layout: the MLLM's S (full frame 140, crop
    # 76, crop/2 28) and ragged S, G = 2 (big) and 1 (small)
    def qkv(b, s, h, hk, d):
        return [torch.randn(shape, generator=gen).to(dev) for shape in
                ((b, s, h, d), (b, s, hk, d), (b, s, hk, d))]

    cases = [(16, s, 4 * g, 4, 32, dict(causal=True))
             for s in (140, 76, 28, 1, 257) for g in (2, 1)]
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
    rows["flash_attention"] = shapes[140]
    rows["fused_prefix"] = prefix_checks(compare, frames)
    lm_kernel_checks(compare, gen, dev, rows)
    magnitude_checks(gen, dev)
    rows.update(int8_checks(dev))
    for name in ("frame_diff", "fused_preprocess"):
        t = rows[name]
        print(f"  {name} at the path's shape: kernel {t['ms']:.4f} ms, plain "
              f"{t['plain_ms']:.4f} ms, bound {t['bound'][0]:.5f} ms "
              f"({t['bound'][1]})")
    return rows


RED, BLUE = (190., 40., 40.), (40., 40., 190.)
#: the main path's prefix: Skip's diff, the preprocess, colour on its result
PATH_SPEC = (("diff", (4, 8)), ("preprocess", (64, 0, 64, 256), 2, False),
             ("color", RED, None))
PREFIX_CASES = [   # (label, spec, batch, dtype)
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
    ("grey preprocess", (("diff", (4, 8)),
                         ("preprocess", (64, 0, 64, 256), 2, True),
                         ("color", BLUE, None)), 4, torch.uint8),
    ("odd crop", (("diff", (2, 2)), ("crop", (3, 5, 90, 150)),
                  ("preprocess", (1, 0, 87, 147), 3, True),
                  ("color", BLUE, None), ("crop", (2, 4, 20, 30))),
     4, torch.uint8),
    ("two preprocess", (("preprocess", (0, 0, 128, 256), 2, False),
                        ("preprocess", (0, 0, 64, 128), 2, False)),
     4, torch.float32),
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
    from repro_torch.kernels.fused_prefix.kernel import (fused_prefix_cuda,
                                                         prefix_kernel)
    from repro_torch.kernels.fused_prefix.ref import (color_frac,
                                                      fused_prefix_ref,
                                                      project_rowwise,
                                                      signature_feats)
    from repro_torch.kernels.fused_preprocess.kernel import \
        fused_preprocess_cuda

    names = ("d", "fracs", "x", "feats", "emb")
    for label, spec, b, dtype in PREFIX_CASES:
        f, p = (frames((b, 3, 128, 256)).to(dtype) for _ in range(2))
        spec, proj = with_signature(spec, (3, 128, 256))
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
    spec, proj = with_signature(PATH_SPEC, (3, 128, 256))
    proj = proj.cuda()
    gy, gx = spec[-1][1]

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
                                    + 16 * emb_d), 2 * 16 * sig_d * emb_d))
    print(f"  fused_prefix B16 path spec: kernel {t['ms']:.4f} ms, plain "
          f"{t['plain_ms']:.4f} ms, unfused chain "
          f"{t['unfused_chain_ms']:.4f} ms, bound {t['bound'][0]:.5f} ms "
          f"({t['bound'][1]}, {nbytes} B); projection after it "
          f"{t['projection_ms']:.4f} ms, bound "
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

    from repro_torch.kernels.decode_attention.kernel import (
        decode_attention_cuda, decode_combine, decode_partials)
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
    # slots of an 8192-row cache, timed
    lens = [7, 30, 4100, 4250]
    gemma = (4, 8192, 8, 4, 256, lens)
    timed_shapes = {(4, 8192, 8, 4, 256): "gemma2",
                    (4, 8192, 32, 2, 128): "chatglm3_decode",
                    (4, 8192, 32, 32, 96): "phi3_decode"}
    cases = [gemma + (dict(cap=50.0, window=4096),),
             gemma + (dict(cap=50.0),),
             (4, 8192, 32, 2, 128, lens, {}),
             (4, 8192, 32, 32, 96, lens, {}),
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
        if which is None:
            continue
        n_live = sum(live(lens, kw.get("window")))
        nbytes = 4 * (2 * q.numel() + 2 * hk * d * n_live + b)
        ops = 4 * d * (h // hk) * hk * n_live
        parts = decode_partials(q, k, v, kv_len, **kw)
        # PyTorch's SDPA on the same GQA problem with the same visible keys
        # as a boolean mask, without the soft-cap (SDPA cannot take one)
        kpos = torch.arange(s, device=dev)[None, :]
        mask = kpos < kv_len
        if kw.get("window"):
            mask &= kpos > kv_len - 1 - kw["window"]
        qh, kh, vh = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        t = dict(
            ms=device_ms(lambda: decode_attention_cuda(q, k, v, kv_len, **kw)),
            partials_ms=device_ms(lambda: decode_partials(q, k, v, kv_len,
                                                          **kw)),
            combine_ms=device_ms(lambda: decode_combine(*parts, h)),
            plain_ms=device_ms(lambda: decode_attention_plain(q, k, v, kv_len,
                                                              **kw), n=8),
            library_ms=device_ms(lambda: F.scaled_dot_product_attention(
                qh, kh, vh, attn_mask=mask[:, None, None, :],
                enable_gqa=True)),
            bound=bound(nbytes, ops), live_keys=n_live, bytes=nbytes)
        if which == "gemma2":
            which = "local" if kw.get("window") else "global"
        timed[which] = t
        print(f"  decode_attention {which} decode B4 S8192 H{h}/{hk} D{d} "
              f"{kw} ({n_live} live keys x {hk} kv heads): kernel "
              f"{t['ms']:.4f} ms "
              f"(partials {t['partials_ms']:.4f}, combine "
              f"{t['combine_ms']:.4f}), plain {t['plain_ms']:.4f} ms, SDPA "
              f"without the cap {t['library_ms']:.4f} ms, bound "
              f"{t['bound'][0]:.5f} ms ({t['bound'][1]}, {nbytes} B)")
    rows["decode_attention"] = {**timed["local"], "global": timed["global"],
                                "chatglm3_decode": timed["chatglm3_decode"],
                                "phi3_decode": timed["phi3_decode"]}

    # ssd_scan: (BC, H, G, Q, P, N)
    ssd_rows = {}
    for bc, h, g, q, p, n in [(2, 24, 1, 256, 64, 128), (1, 24, 1, 13, 64, 128),
                              (4, 8, 4, 64, 16, 8), (2, 4, 2, 32, 16, 8)]:
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
        if h != 24:
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


def attention64(q, k, v, mask):
    """float64 attention in model layout, the value both fp32 versions are
    measured against: q (B, Sq, H, D), k/v (B, S, Hk, D), mask (B, Sq, S)
    of the visible keys."""
    b, sq, h, d = q.shape
    hk = k.shape[2]
    qg = q.double().reshape(b, sq, hk, h // hk, d)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.double()) / math.sqrt(d)
    logits = logits.masked_fill(~mask[:, None, None], float("-inf"))
    out = torch.einsum("bhgqk,bkhd->bqhgd", torch.softmax(logits, -1),
                       v.double())
    return out.reshape(b, sq, h, d)


def magnitude_checks(gen, dev):
    """decode_attention and flash_attention at chatglm3-6b's (a group of
    16) and phi3-mini's (D 96) shapes with q, k, v at the magnitudes the
    model gives them (``MAG_SHAPES``): the decode shape of phase 2 (4 slots
    of 8192, lengths 7/30/4100/4250) and a causal prefill of 2048.  The
    kernel is held to its plain version within ``MAG_TOL`` of the largest
    magnitude, and to float64 within ``MAG_WITNESS`` times the farther of
    the plain version on the card and on the CPU."""
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
# phases 9-11: LM serving
# ---------------------------------------------------------------------------

def timed_engine(lm, **kw):
    """A ``ServingEngine`` that records the host wall time of each prefill
    (with its padded length) and each batched decode step (with its count
    of active slots), each ending in ``torch.cuda.synchronize()`` (the
    engine waits for the sampled tokens at the end of both anyway)."""
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
            t0 = time.perf_counter()
            out = super()._decode_step(tokens, active)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            self.decode_ms.append(ms)
            self.decode_active.append((int(active.sum()), ms))
            return out

    eng = Timed(lm, **kw)
    eng.prefill_ms, eng.decode_ms, eng.decode_active = [], [], []
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


def serve_phase(name, arch, dev, per_prefill=(), per_decode=(), lm=None):
    """One LM at full width through ``ServingEngine``: seeded random
    weights drawn on the card and a warm-up run (a short and a long
    request), or the given ``lm``, already warm; then the measured run of
    ``serve_requests`` with the launch counts zeroed just before and read
    just after.  Each kernel of ``per_prefill`` must have launched once per
    layer per prefill, each of ``per_decode`` once per layer per decode
    step.  Returns the numbers, the counts, the LM, the engine and the
    finished requests."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models.model import LM
    from repro_torch.serving.engine import Request

    cfg = get_config(arch)
    kw = dict(max_slots=SERVE_SLOTS, s_max=SERVE_S_MAX, eos_id=-1)
    if lm is None:
        t0 = time.perf_counter()
        lm = LM(cfg, device=dev).init(
            torch.Generator(device=dev).manual_seed(0))
        torch.cuda.synchronize()
        n_params = sum(p.numel() for p in lm.parameters())
        print(f"  {arch}: {n_params / 1e9:.3f} G parameters (fp32, "
              f"{4 * n_params / 1e9:.2f} GB) drawn on the card in "
              f"{time.perf_counter() - t0:.2f} s; {cfg.n_layers} layers, "
              f"d_model {cfg.d_model}, vocab {cfg.vocab_size}")
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


def main() -> int:
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
        sass_mma_counts()

        print("[2] kernels vs their plain PyTorch versions on the card")
        rows = kernel_checks(dev)

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
    except (SmokeFailure, RuntimeError, ValueError, KeyError,
            subprocess.SubprocessError) as e:
        print(f"chip_smoke: FAILED: {type(e).__name__}: {e}",
              file=sys.stderr)
        return 1

    kernels = []
    for name, (symbol, source, replaces) in KERNELS.items():
        t = rows[name]
        by_path = {p: counts[p][symbol] for p in PATHS}
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": sum(by_path.values()),
            "launches_by_path": by_path,
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
    print(json.dumps({"serving": {**serving, "device_busy_share": {
        k: busy[k] for k in ("gemma2_decode", "mamba2_decode")},
        "chatglm3_int8": int8_summary,
        "slots": SERVE_SLOTS, "s_max": SERVE_S_MAX,
        "new_tokens": SERVE_NEW}}))
    print(smi_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
