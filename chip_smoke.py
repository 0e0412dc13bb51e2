#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of the stream processor once on one GPU.

    python3 chip_smoke.py          # from the repository root, on a CUDA host

Phases (any failure exits non-zero and prints no result line):
  1. set-up: the card's name and power limit, TF32 off for matmuls and
     convolutions, the hand-written kernels built from ``src/repro_torch/
     kernels/csrc`` (one ``nvcc`` per source, in parallel);
  2. kernel checks: each kernel against its plain PyTorch version on the
     card, at the main path's shapes and at ragged ones, with its device
     time, its roofline bound and, for attention, PyTorch's SDPA as a
     yardstick (timed only here; the port never calls it);
  3. Q8's naive plan: Source -> MLLM extract (full width: 4 layers,
     d_model 256, 8/4 heads, PATCH 16, seeded random weights) -> filter
     -> Sink over 512 TollBooth frames, micro-batch 16;
  4. Q8's reduced plan: Source -> Skip -> fused preprocess -> red-pixel
     filter -> MLLM extract -> filter -> Sink over the same stream;
  5. cross-check: both plans, without Q8's filter so that every extracted
     record reaches the sink, on 64 frames on the card and on the CPU (the
     plain versions) give the same records, and the MLLM's logits agree;
  6. trace: one profiled run of each plan, device kernel time by name and
     the device's busy share of the wall clock.

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
HBM_BYTES_S = 3.35e12        # H100 SXM device memory (data sheet)
FP32_OPS_S = 67e12           # H100 SXM fp32 outside the tensor cores
TOL = {"frame_diff": 1e-6, "fused_preprocess": 1e-5, "flash_attention": 2e-5}
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
}


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
    waits for the card (a host copy) defeats the sleep: that is an error."""
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
    for name in ("frame_diff", "fused_preprocess"):
        t = rows[name]
        print(f"  {name} at the path's shape: kernel {t['ms']:.4f} ms, plain "
              f"{t['plain_ms']:.4f} ms, bound {t['bound'][0]:.5f} ms "
              f"({t['bound'][1]})")
    return rows, errs


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
# phases 3-5: the plans
# ---------------------------------------------------------------------------

def make_model(device):
    from repro_torch.configs.samsara_stream import STREAM_MLLM_CONFIG
    from repro_torch.streaming.mllm import StreamMLLM

    return StreamMLLM(STREAM_MLLM_CONFIG, patch=16, device=device).init(
        torch.Generator().manual_seed(0))


def q8_plans(tail: bool = True):
    """Q8's naive plan and its reduced plan (the chain the semantic and
    logical phases build for it, assembled by hand).  ``tail=False`` drops
    Q8's filter, so every extracted record reaches the sink."""
    from repro_torch.queries.catalog import get_query
    from repro_torch.streaming import operators as ops
    from repro_torch.streaming.plan import Plan

    q = get_query("Q8")
    pre = [ops.SkipOp(amount=3, threshold=0.02, regions=(4, 8)),
           ops.FusedPreprocessOp(crop=(64, 0, 64, 256), factor=2),
           ops.CheapColorFilterOp("red", min_frac=0.008)]
    rest = q.tail() if tail else []
    return {which: Plan([ops.SourceOp("tollbooth")] + chain
                        + [ops.MLLMExtractOp(q.tasks, "big")] + rest
                        + [ops.SinkOp()], query="Q8")
            for which, chain in (("naive", []), ("reduced", pre))}


def run_plan(which, model, n_frames, micro_batch, seed, tail=True):
    from repro_torch.data import TollBoothStream
    from repro_torch.streaming.operators import OpContext
    from repro_torch.streaming.runtime import StreamRuntime

    ctx = OpContext(mllm=model, device=model.device)
    rt = StreamRuntime(q8_plans(tail)[which], ctx, micro_batch=micro_batch)
    return rt.run(TollBoothStream(seed=seed), n_frames)


def drive(which, model, expect):
    from repro_torch.kernels import launch_counts, reset_launch_counts

    reset_launch_counts()
    res = run_plan(which, model, N_FRAMES, MICRO_BATCH, STREAM_SEED)
    torch.cuda.synchronize()
    counts = launch_counts()
    print(f"  Q8 {which}: {res.n_frames} frames in {res.wall_s:.3f} s = "
          f"{res.fps:.1f} fps, mllm_frames {res.mllm_frames}, "
          f"outputs {len(res.outputs)}, launches {counts}")
    print(f"  Q8 {which} operator input counts: {res.op_input_counts}")
    for name in expect:
        check(counts[KERNELS[name][0]] > 0,
              f"Q8 {which}: kernel {name} was never launched")
    check(res.n_frames == N_FRAMES, f"Q8 {which}: {res.n_frames} frames")
    return res, counts


def cross_check(model):
    """Both plans without Q8's filter on 64 frames, card vs CPU (plain
    versions): identical extracted records; MLLM logits agree on a few
    frames at each input size."""
    from repro_torch.data import TollBoothStream

    cpu = make_model("cpu")
    for which, seed in (("naive", 11), ("reduced", 3)):
        a = run_plan(which, model, 64, 8, seed, tail=False)
        b = run_plan(which, cpu, 64, 8, seed, tail=False)
        same = (a.outputs == b.outputs and a.mllm_frames == b.mllm_frames
                and a.op_input_counts == b.op_input_counts)
        print(f"  Q8 {which} seed {seed}, 64 frames: card == CPU records: "
              f"{same} (mllm_frames {a.mllm_frames}, outputs "
              f"{len(a.outputs)})")
        check(same, f"Q8 {which}: card and CPU records differ")
    raw, _ = TollBoothStream(seed=3).batch(16)
    x = (raw[[5, 12]].astype(np.float32) / 255.0 - 0.5) / 0.25
    crop = x[:, :, 64:128]
    for label, fr in (("128x256", x), ("64x256", crop),
                      ("32x128", crop.reshape(2, 3, 32, 2, 128, 2)
                       .mean(axis=(3, 5)))):
        fr = torch.from_numpy(np.ascontiguousarray(fr))
        with torch.inference_mode():
            got, want = model(fr.cuda()), cpu(fr)
        err = max((got[k].cpu() - want[k]).abs().max().item() for k in want)
        print(f"  MLLM logits {label}: card vs CPU max_abs_err {err:.3e}")
        check(all(torch.isfinite(got[k]).all() for k in got)
              and all(got[k].shape == want[k].shape for k in want),
              f"MLLM logits {label}: shape or non-finite")
        check(err < 1e-3, f"MLLM logits {label}: card vs CPU {err}")


def trace(which, model, n_frames=128):
    """Where a plan's time goes: one profiled run (CUPTI through
    torch.profiler), device kernel time summed by name against the host
    wall clock (kernels and copies on the one stream, summed).  Returns
    the device's busy share, or None when the profiler saw no device
    activity."""
    from torch.profiler import ProfilerActivity, profile

    run_plan(which, model, MICRO_BATCH, MICRO_BATCH, STREAM_SEED)   # warm
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_plan(which, model, n_frames, MICRO_BATCH, STREAM_SEED)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            kernels[ev.name] = kernels.get(ev.name, 0.0) + \
                ev.time_range.elapsed_us() / 1e3
    busy = sum(kernels.values())
    if not kernels:
        print(f"  Q8 {which}: the profiler saw no device activity; device "
              "busy share not measured")
        return None
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:6]
    print(f"  Q8 {which}, {n_frames} frames (profiled, wall includes the "
          f"profiler): wall {wall_ms:.1f} ms, device busy {busy:.2f} ms = "
          f"{100 * busy / wall_ms:.1f}%, idle {100 - 100 * busy / wall_ms:.1f}%")
    for name, ms in top:
        print(f"    {ms:8.3f} ms  {name[:90]}")
    return busy / wall_ms


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

        model = make_model(dev)
        print("[3] Q8 naive plan, full width (samsara-stream-mllm, PATCH 16)")
        naive, naive_counts = drive("naive", model, ["flash_attention"])
        check(naive.mllm_frames == N_FRAMES,
              f"naive: mllm_frames {naive.mllm_frames}")
        print("[4] Q8 reduced plan")
        reduced, reduced_counts = drive("reduced", model, list(KERNELS))
        check(0 < reduced.mllm_frames < N_FRAMES,
              f"reduced: mllm_frames {reduced.mllm_frames}")
        torch.cuda.synchronize()
        print(f"[4] reduced/naive: {reduced.fps / naive.fps:.2f}x fps, "
              f"{reduced.mllm_frames}/{naive.mllm_frames} MLLM frames")

        print("[5] card vs CPU on 64 frames")
        cross_check(model)
        print("[6] device busy share (torch.profiler)")
        busy = {which: trace(which, model) for which in ("naive", "reduced")}
        torch.cuda.synchronize()
    except (SmokeFailure, RuntimeError, ValueError,
            subprocess.SubprocessError) as e:
        print(f"chip_smoke: FAILED: {type(e).__name__}: {e}",
              file=sys.stderr)
        return 1

    kernels = []
    for name, (symbol, source, replaces) in KERNELS.items():
        t = rows[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": naive_counts[symbol] + reduced_counts[symbol],
            "launches_by_path": {"q8_naive": naive_counts[symbol],
                                 "q8_reduced": reduced_counts[symbol]},
            "max_abs_err": errs[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound"][0],
            "bound_by": t["bound"][1], "library_ms": t["library_ms"]})
    print(json.dumps({"q8": {
        "naive": {"fps": naive.fps, "wall_s": naive.wall_s,
                  "mllm_frames": naive.mllm_frames},
        "reduced": {"fps": reduced.fps, "wall_s": reduced.wall_s,
                    "mllm_frames": reduced.mllm_frames},
        "device_busy_share": busy,
        "frames": N_FRAMES, "micro_batch": MICRO_BATCH,
        "stream_seed": STREAM_SEED}}))
    print(smi_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
