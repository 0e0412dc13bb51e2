#!/usr/bin/env python3
"""Does a frame's MLLM output depend on the batch it is computed in?

    python scripts/batch_invariance.py      # on a CUDA host, repo root

The extract server coalesces frames of many feeds into one forward (up to
64 frames) where the solo path runs a micro-batch (4-16 frames), and each
query's records must equal its solo run's bit for bit.  This script holds
the stream MLLM at full width (``samsara-stream-mllm``, seeded random
weights as ``chip_smoke.make_ctx`` draws them) to that on the card:

1. every stage of the forward (stem, patch projection, each block, final
   norm, each head) for the first B of 64 TollBooth frames, B in 4, 8, 16
   and 32, against the same rows of the 64-frame forward (max abs
   difference; 0 is bit for bit);
2. the same products as plain GEMMs (``x @ w``, one GEMM of B*140 rows)
   and as per-frame batched GEMMs (``layers.frame_matmul``), and the
   plate head's per-frame product of six rows against one-row products;
3. argmax disagreements of the extract over 512 frames, in batches of 4
   against batches of 64;
4. the cost of the other remedy, cuBLAS without split-K
   (``CUBLAS_WORKSPACE_CONFIG=:0:0``, process-wide), on the LMs' decode
   products at M 4 (CUDA events, median of 5 windows of 20 calls), in a
   child process each way.

Prints one JSON line per part.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

#: LM decode products, (K, N) at M = 4 slots
DECODE_SHAPES = {"chatglm3_wq": (4096, 4096), "chatglm3_wk": (4096, 256),
                 "chatglm3_w_in": (4096, 13696),
                 "chatglm3_w_out": (13696, 4096), "gemma2_q": (2304, 2048),
                 "gemma2_w_in": (2304, 9216), "gemma2_w_out": (9216, 2304)}
BATCHES = (4, 8, 16, 32)


def event_ms(fn, n=20, reps=5):
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        for _ in range(n):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / n)
    return sorted(times)[reps // 2]


def decode_costs():
    """Part 4 in this process's cuBLAS configuration."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    for name, (k, n) in DECODE_SHAPES.items():
        w = torch.randn(k, n, device="cuda", generator=g)
        a = torch.randn(4, k, device="cuda", generator=g)
        out[name] = event_ms(lambda: a @ w)
    return out


def stages(m, x):
    """Every stage of ``StreamMLLM.forward`` on frames ``x``, by name."""
    import torch

    from repro_torch.models import blocks
    from repro_torch.models.layers import apply_norm, frame_matmul
    from repro_torch.streaming.mllm import SCALAR_TASKS

    res = {}
    with torch.inference_mode():
        res["stem"] = m._stem(x)
        patches = m._patchify(res["stem"])
        n_p = patches.shape[1]
        h = frame_matmul(patches, m.patch_proj) + m.patch_pos_emb[:n_p][None]
        res["patch_proj"] = h
        h = torch.cat([h, m.task_tokens[None].expand(x.shape[0], -1, -1)], 1)
        pos = torch.arange(h.shape[1], device=h.device)[None, :]
        bb = m.backbone.tree()
        for i in range(bb["stack"]["i0"]["pre_norm"]["scale"].shape[0]):
            p = blocks._period(bb["stack"], i)["i0"]
            h = blocks.apply_block(m.cfg, m.cfg.block_pattern[0], p, h,
                                   mode="causal", positions=pos,
                                   mm=frame_matmul)
            res[f"block{i}"] = h
        h = apply_norm(bb["final_norm"]["scale"], h)
        res["final_norm"] = h
        out = m(x)
        for name in SCALAR_TASKS + ("plate",):
            res[f"head_{name}"] = out[name]
    return res


def invariance():
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import chip_smoke
    from repro_torch.data import TollBoothStream
    from repro_torch.models.layers import frame_matmul
    from repro_torch.streaming.mllm import make_extract_fn

    m = chip_smoke.make_ctx(torch.device("cuda")).mllm
    raw, _ = TollBoothStream(seed=4321).batch(512)
    x = (torch.from_numpy(raw).cuda().float() / 255.0 - 0.5) / 0.25
    big = stages(m, x[:64])
    part1 = {}
    for b in BATCHES:
        small = stages(m, x[:b])
        part1[b] = {k: (small[k] - big[k][:b]).abs().max().item()
                    for k in small}
    print(json.dumps({"stages_vs_64": part1}), flush=True)

    g = torch.Generator(device="cuda").manual_seed(0)
    part2 = {}
    for rows, (k, n) in ((140, (256, 256)), (140, (256, 128)),
                         (140, (256, 768)), (140, (768, 256)),
                         (128, (768, 256)), (6, (256, 36)), (1, (256, 36)),
                         (1, (256, 2))):
        a = torch.randn(64, rows, k, device="cuda", generator=g)
        w = torch.randn(k, n, device="cuda", generator=g)
        plain, framed = a @ w, frame_matmul(a, w)
        part2[f"rows{rows}_{k}x{n}"] = {
            "plain": {b: ((a[:b] @ w) - plain[:b]).abs().max().item()
                      for b in BATCHES},
            "frame_matmul": {b: (frame_matmul(a[:b], w)
                                 - framed[:b]).abs().max().item()
                             for b in BATCHES}}
    print(json.dumps({"products_vs_64": part2}), flush=True)

    run = make_extract_fn(m)
    f = torch.from_numpy(raw).cuda()
    a = {k: torch.cat([run(f[i:i + 4])[k] for i in range(0, 512, 4)])
         for k in run(f[:4])}
    b = {k: torch.cat([run(f[i:i + 64])[k] for i in range(0, 512, 64)])
         for k in a}
    print(json.dumps({"argmax_disagreements_4_vs_64": {
        k: int((a[k] != b[k]).sum().item()) for k in a}}), flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("batch_invariance: needs a CUDA device", file=sys.stderr)
        return 2
    if sys.argv[1:] == ["--decode-costs"]:
        print("COSTS " + json.dumps(decode_costs()))
        return 0
    print(json.dumps({"device": torch.cuda.get_device_name(0)}))
    invariance()
    costs = {}
    for label, env in (("split_k_allowed", {}),
                       ("no_split_k", {"CUBLAS_WORKSPACE_CONFIG": ":0:0"})):
        r = subprocess.run([sys.executable, __file__, "--decode-costs"],
                           env={**os.environ, **env}, capture_output=True,
                           text=True, timeout=600, check=True)
        line = [ln for ln in r.stdout.splitlines()
                if ln.startswith("COSTS ")][0]
        costs[label] = json.loads(line[len("COSTS "):])
    print(json.dumps({"decode_ms_at_m4": costs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
