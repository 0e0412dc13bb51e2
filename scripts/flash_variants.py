"""Time variants of the flash_attention kernel against each other on one card.

    python scripts/flash_variants.py [variants.json]     # on a CUDA host
    python scripts/flash_variants.py scripts/flash_three_terms.json

A variant is the source ``src/repro_torch/kernels/csrc/flash_attention.cu``
with text substitutions, ``{"name": [[old, new], ...], ...}`` (default: the
source as it is, ``{"current": []}``).  Each is built into
``build/flash_variants/`` (gitignored, one ``nvcc`` each, in parallel) and
bound with ctypes.  For each the script prints ptxas' registers and spills
per head dim, the largest error against the plain version over a few
ragged cases (tolerance 2e-5, as ``chip_smoke.py``), the distance from
float64 at chatglm3-6b's and phi3-mini's magnitudes (a causal prefill of
2048, as ``chip_smoke.py``'s phase 2), and the device time at the prefill
shapes ``chip_smoke.py`` times (an 8192 bucket: phi3-mini, chatglm3-6b,
gemma2-2b's windowed D 256) and the stream MLLM's, in turns (every
variant, then every variant in reverse order; the lower time printed).
``scripts/flash_three_terms.json`` holds the source as it is and P.V in
three terms (hi*hi, mid*hi, hi*mid) instead of six.
"""
from __future__ import annotations

import ctypes
import json
import math
import os
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels._build import CSRC, NVCC_FLAGS, nvcc  # noqa: E402
from repro_torch.kernels.flash_attention.ref import \
    flash_attention_plain  # noqa: E402

OUT = os.path.join(ROOT, "build", "flash_variants")
CASES = [(1, 257, 32, 32, 96, {}), (1, 300, 32, 2, 128, {}),
         (1, 300, 8, 4, 256, dict(cap=50.0, window=100)),
         (2, 33, 64, 1, 16, dict(window=5)), (16, 140, 8, 4, 32, {}),
         (1, 129, 64, 1, 64, dict(causal=False))]


def build(name, subs, source):
    for old, new in subs:
        if old not in source:
            raise SystemExit(f"{name}: {old[:60]!r} is not in the source")
        source = source.replace(old, new)
    src, lib = (os.path.join(OUT, f) for f in (f"{name}.cu", f"lib{name}.so"))
    with open(src, "w") as f:
        f.write(source)
    out = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", lib, src],
                         capture_output=True, text=True)
    if out.returncode:
        raise SystemExit(f"{name}: nvcc failed\n{out.stdout}{out.stderr}")
    regs, d = [], None
    for line in (out.stdout + out.stderr).splitlines():
        m = re.search(r"entry function '.*?ILi(\d+)E", line)
        d = m.group(1) if m else d
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and d and m.group(1) != "0":
            regs.append(f"D{d} spills {m.group(1)} B")
        m = re.search(r"Used (\d+) registers", line)
        if m and d:
            regs.append(f"D{d} {m.group(1)} registers")
    fn = ctypes.CDLL(lib).flash_attention_f32
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    return name, fn, regs


def run(fn, q, k, v, causal=True, cap=None, window=None):
    o = torch.empty_like(q)
    b, s, h, d = q.shape
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, s, h,
            k.shape[2], d, int(causal), 0.0 if cap is None else cap,
            0 if window is None else window,
            torch.cuda.current_stream().cuda_stream)
    if rc:
        raise SystemExit(f"launch failed with CUDA error {rc}")
    return o


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_variants: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    variants = {"current": []}
    if len(sys.argv) > 1:
        with open(sys.argv[1]) as f:
            variants = json.load(f)
    os.makedirs(OUT, exist_ok=True)
    with open(CSRC / "flash_attention.cu") as f:
        source = f.read()
    with ThreadPoolExecutor(len(variants)) as ex:
        built = list(ex.map(lambda kv: build(*kv, source), variants.items()))
    fns = {}
    for name, fn, regs in built:
        print(f"{name}: {', '.join(regs)}")
        fns[name] = fn
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)

    def qkv(b, s, h, hk, d, std_q=1.0, std_kv=1.0):
        return [(std * torch.randn(shape, generator=gen)).to(dev)
                for std, shape in ((std_q, (b, s, h, d)),
                                   (std_kv, (b, s, hk, d)),
                                   (std_kv, (b, s, hk, d)))]

    worst = {n: 0.0 for n in fns}
    for b, s, h, hk, d, kw in CASES:
        q, k, v = qkv(b, s, h, hk, d)
        want = flash_attention_plain(q, k, v, **kw)
        for n, fn in fns.items():
            worst[n] = max(worst[n], (run(fn, q, k, v, **kw) - want).abs()
                           .max().item())
    print("largest error against the plain version (tolerance 2e-5):",
          worst)
    for name, (dm, h, hk, d) in cs.MAG_SHAPES.items():
        card = qkv(1, 2048, h, hk, d, math.sqrt(dm / h), math.sqrt(dm / hk))
        mask = torch.ones(2048, 2048, dtype=torch.bool, device=dev).tril()
        exact = cs.attention64(*card, mask[None]).cpu()
        top = exact.abs().max().item()
        far = {n: (run(fn, *card).cpu().double() - exact).abs().max().item()
               / top for n, fn in fns.items()}
        plain = (flash_attention_plain(*card).cpu().double() - exact).abs() \
            .max().item() / top
        print(f"{name} prefill 2048 at its magnitudes, from float64 "
              f"(relative to the largest |out|): plain {plain:.4g}, {far}")
        del card, exact
    for label, shape, kw, n in (
            ("phi3 prefill B1 S8192 H32/32 D96", (1, 8192, 32, 32, 96), {}, 2),
            ("chatglm3 prefill B1 S8192 H32/2 D128", (1, 8192, 32, 2, 128),
             {}, 2),
            ("gemma2 prefill B1 S8192 H8/4 D256 cap 50 window 4096",
             (1, 8192, 8, 4, 256), dict(cap=50.0, window=4096), 2),
            ("stream B16 S140 H8/4 D32", (16, 140, 8, 4, 32), {}, 40)):
        q, k, v = qkv(*shape)
        times = {}
        for name in list(fns) + list(fns)[::-1]:
            times.setdefault(name, []).append(cs.device_ms(
                lambda: run(fns[name], q, k, v, **kw), n=n, reps=3))
        print(f"{label}: " + ", ".join(f"{n} {min(t):.4f} ms"
                                       for n, t in times.items()))
        del q, k, v
        torch.cuda.empty_cache()
    print(cs.smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
