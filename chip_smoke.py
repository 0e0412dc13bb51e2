#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of the stream processor once on one GPU.

    python3 chip_smoke.py          # from the repository root, on a CUDA host

Phases (any failure exits non-zero and prints no result line):
  1. set-up: the card's name and power limit, TF32 off for matmuls and
     convolutions, the hand-written kernels built from ``src/repro_torch/
     kernels/csrc`` (one ``nvcc`` per source, in parallel);
  2. kernel checks: each kernel against its plain PyTorch version on the
     card, at the main path's shapes and at ragged ones, with its device
     time, its roofline bound and a yardstick: PyTorch's SDPA for
     attention, the unfused chain (frame_diff + fused_preprocess kernels,
     colour and signature in PyTorch) for fused_prefix (timed only here;
     the port never calls SDPA);
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
     its unfused twin: same records, MLLM frames and operator counts.

Each phase that drives a plan zeroes the kernels' launch counts first and
reads them after; a kernel of the plan that was never launched fails the
run.  The last lines are the card's ``nvidia-smi`` name/power line, one
``{"kernels": [...]}`` JSON line, and ``{"ok": true, "device": ...}``.
"""
from __future__ import annotations

import json
import os
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
# fused_prefix: its diff is exact and its colour counts are exact (the
# distance is rounded as in the plain version); the preprocess divides
# where PyTorch multiplies by a reciprocal, and patch means sum in another
# order: a few ulps, well inside 1e-5
TOL = {"frame_diff": 1e-6, "fused_preprocess": 1e-5, "flash_attention": 2e-5,
       "fused_prefix": 1e-5}
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
}
#: the plans driven end to end, by the name used in ``launches_by_path``
PATHS = ("q8_naive", "q8_reduced", "q8_fused", "q8_unfused", "q8_optimized")


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


def bound(nbytes: float, ops: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_S * 1e3, ops / FP32_OPS_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations")


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def kernel_checks(dev):
    from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.kernels.frame_diff.kernel import frame_diff_cuda
    from repro_torch.kernels.frame_diff.ref import frame_diff_ref
    from repro_torch.kernels.fused_preprocess.kernel import \
        fused_preprocess_cuda
    from repro_torch.kernels.fused_preprocess.ref import fused_preprocess_ref

    gen = torch.Generator().manual_seed(0)
    errs = {k: 0.0 for k in KERNELS}
    rows = {}

    def compare(name, got, want, label):
        got, want = got.float().cpu(), want.float().cpu()
        check(got.shape == want.shape and torch.isfinite(got).all(),
              f"{name} {label}: shape {tuple(got.shape)} or non-finite")
        err = (got - want).abs().max().item() if got.numel() else 0.0
        tol = TOL[name]
        bad = ((got - want).abs() > tol + tol * want.abs()).sum().item()
        print(f"  {name:17s} {label:44s} max_abs_err {err:.3e}"
              f" (tol {tol:g})")
        check(bad == 0, f"{name} {label}: {bad} values outside {tol}")
        errs[name] = max(errs[name], err)

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

    def flash_ref(q, k, v, **kw):
        b, s, h, d = q.shape
        hk = k.shape[2]
        out = flash_attention_ref(
            q.permute(0, 2, 1, 3).reshape(b, hk, h // hk, s, d),
            k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3), **kw)
        return out.reshape(b, h, s, d).permute(0, 2, 1, 3)

    cases = [(16, s, 4 * g, 4, 32, dict(causal=True))
             for s in (140, 76, 28, 1, 257) for g in (2, 1)]
    cases += [(4, 140, 8, 4, 32, dict(causal=False)),
              (4, 140, 8, 4, 32, dict(causal=True, cap=20.0)),
              (4, 140, 8, 4, 32, dict(causal=True, window=35)),
              (2, 257, 8, 2, 64, dict(causal=True)),
              (2, 100, 16, 2, 128, dict(causal=True))]
    for b, s, h, hk, d, kw in cases:
        q, k, v = qkv(b, s, h, hk, d)
        compare("flash_attention", flash_attention_cuda(q, k, v, **kw),
                flash_ref(q, k, v, **kw),
                f"B{b} S{s} H{h}/{hk} D{d} {kw}")
    shapes = {}
    for s in (140, 76, 28):
        q, k, v = qkv(16, s, 8, 4, 32)
        pairs = s * (s + 1) // 2
        t = dict(
            ms=device_ms(lambda: flash_attention_cuda(q, k, v)),
            plain_ms=device_ms(lambda: flash_ref(q, k, v)),
            library_ms=sdpa_ms(q, k, v),
            bound=bound(4 * (2 * q.numel() + 2 * k.numel()),
                        4 * 32 * pairs * 16 * 8))
        shapes[s] = t
        print(f"  flash_attention B16 S{s} H8/4 D32: kernel {t['ms']:.4f} ms"
              f", plain {t['plain_ms']:.4f} ms, SDPA {t['library_ms']}, "
              f"bound {t['bound'][0]:.5f} ms ({t['bound'][1]})")
    rows["flash_attention"] = shapes[140]
    rows["fused_prefix"] = prefix_checks(compare, frames)
    for name in ("frame_diff", "fused_preprocess"):
        t = rows[name]
        print(f"  {name} at the path's shape: kernel {t['ms']:.4f} ms, plain "
              f"{t['plain_ms']:.4f} ms, bound {t['bound'][0]:.5f} ms "
              f"({t['bound'][1]})")
    return rows, errs


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
    kernels = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            kernels[ev.name] = kernels.get(ev.name, 0.0) + \
                ev.time_range.elapsed_us() / 1e3
    busy = sum(kernels.values())
    if not kernels:
        print(f"  {name}: the profiler saw no device activity; device "
              "busy share not measured")
        return None
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:6]
    print(f"  {name}, {n_frames} frames (profiled, wall includes the "
          f"profiler): wall {wall_ms:.1f} ms, device busy {busy:.2f} ms = "
          f"{100 * busy / wall_ms:.1f}%, idle {100 - 100 * busy / wall_ms:.1f}%")
    for kname, ms in top:
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
    runs, counts, busy = {}, {}, {}
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

        print("[2] kernels vs their plain PyTorch versions on the card")
        rows, errs = kernel_checks(dev)

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
        torch.cuda.synchronize()
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
            "max_abs_err": errs[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound"][0],
            "bound_by": t["bound"][1], "library_ms": t["library_ms"],
            "unfused_chain_ms": t.get("unfused_chain_ms"),
            "projection_ms": t.get("projection_ms")})
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
    print(smi_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
