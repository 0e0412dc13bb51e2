#!/usr/bin/env python3
"""Time the stream MLLM's forward and Q8's naive plan of several trees.

    python scripts/mllm_forward_compare.py                # this tree
    python scripts/mllm_forward_compare.py --tree OLD     # OLD, this, this, OLD

A tree is a checkout of the repository (for example the parent commit
unpacked with ``git archive`` into a gitignored directory); each builds its
own kernels under its ``build/kernels``.  Every run is a process of its
own, in turns: the other trees and this one, then the same in reverse
order.  Each run draws ``chip_smoke.make_ctx``'s models (the big MLLM at
full width, ``samsara-stream-mllm``, seeded random weights) and prints:

* the MLLM forward on 16 and 64 normalized TollBooth frames (the solo
  micro-batch and the extract server's largest bucket): the device time
  of its kernels and copies and their count (``torch.profiler``), and
  host ms of one forward waited for;
* the plate head alone at the same batches, as one product of a frame's
  six rows (``task_h @ w``) and as six one-row batched products stacked:
  device ms (``chip_smoke.device_ms``) and device events;
* Q8's naive plan over 512 frames, micro-batch 16 (fps of two runs, as
  phase 3 drives it), and phase 6's profiled 128-frame run of it: host
  wall, device busy ms and share, device events.

TF32 is off, as in ``chip_smoke.py``.  Prints one JSON line at the end.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCHES = (16, 64)


def profiled(fn, reps=5):
    """Device ms (kernels and copies summed) and device events per call of
    ``fn``, from torch.profiler over ``reps`` calls.  The forward waits
    for the card inside (``chip_smoke.device_ms`` refuses it), so its
    device time is read from the profile."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA]
    return (sum(e.time_range.elapsed_us() for e in ev) / 1e3 / reps,
            len(ev) / reps)


def host_ms(fn, reps=20):
    """Median host time of one call of ``fn`` waited for on the card."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def worker(tree: str) -> dict:
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    import chip_smoke as cs       # puts the tree's src first on the path
    import torch

    import repro_torch
    from repro_torch.data import TollBoothStream
    from repro_torch.kernels import build

    assert os.path.samefile(os.path.dirname(cs.__file__), tree)
    assert repro_torch.__file__.startswith(os.path.join(tree, "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build(["flash_attention", "frame_diff", "fused_preprocess",
           "fused_prefix"])
    dev = torch.device("cuda")
    ctx = cs.make_ctx(dev)
    m = ctx.mllm
    raw, _ = TollBoothStream(seed=4321).batch(64)
    x64 = (torch.from_numpy(raw).to(dev).float() / 255.0 - 0.5) / 0.25
    gen = torch.Generator(device="cuda").manual_seed(0)
    w = torch.randn(m.cfg.d_model, 36, device=dev, generator=gen)
    out = {}
    with torch.inference_mode():
        for b in BATCHES:
            x = x64[:b].contiguous()
            h = torch.randn(b, 6, m.cfg.d_model, device=dev, generator=gen)

            def six():
                return torch.stack(
                    [torch.bmm(h[:, j:j + 1], w.expand(b, *w.shape))[:, 0]
                     for j in range(6)], dim=1)

            busy, events = profiled(lambda: m(x))
            out[f"forward_b{b}"] = {"device_busy_ms": busy,
                                    "host_ms": host_ms(lambda: m(x)),
                                    "device_events": events}
            out[f"plate_one_b{b}"] = {
                "device_ms": cs.device_ms(lambda: h @ w),
                "device_events": profiled(lambda: h @ w)[1]}
            out[f"plate_six_b{b}"] = {
                "device_ms": cs.device_ms(six, n=20),
                "device_events": profiled(six)[1]}
    fps = []
    for _ in range(2):
        res = cs.run_plan(cs.q8_plan("naive"), ctx, cs.N_FRAMES,
                          cs.MICRO_BATCH, cs.STREAM_SEED)
        fps.append(res.fps)
    out["q8_naive_fps"] = fps

    from torch.profiler import ProfilerActivity, profile

    plan = cs.q8_plan("naive")
    cs.run_plan(plan.clone(), ctx, cs.MICRO_BATCH, cs.MICRO_BATCH,
                cs.STREAM_SEED)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        cs.run_plan(plan.clone(), ctx, 128, cs.MICRO_BATCH, cs.STREAM_SEED)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    dev_ev = [ev for ev in prof.events()
              if ev.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(ev.time_range.elapsed_us() for ev in dev_ev) / 1e3
    out["q8_naive_trace_128"] = {"wall_ms": wall, "busy_ms": busy,
                                 "busy_share": busy / wall,
                                 "device_events": len(dev_ev)}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", action="append", default=[],
                    help="another checkout to time (repeatable)")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        print(json.dumps(worker(args.worker)))
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"card: {smi}")
    runs = [os.path.abspath(t) for t in args.tree] + [ROOT]
    results = {}
    for tree in runs + runs[::-1]:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--worker", tree],
            capture_output=True, text=True)
        if proc.returncode:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            return 1
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        results.setdefault(os.path.relpath(tree, ROOT), []).append(res)
    for key in results[os.path.relpath(ROOT, ROOT)][0]:
        print(f"{key}:")
        for label, rs in results.items():
            print(f"  {label:20s} " + " | ".join(json.dumps(r[key])
                                                  for r in rs))
    print(json.dumps({"card": smi, "runs": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
