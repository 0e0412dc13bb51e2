"""Time decode_attention and ssd_scan of several source trees on one card.

    python scripts/decode_ssd_compare.py                   # this tree
    python scripts/decode_ssd_compare.py --tree OLD        # OLD, this, this, OLD
    python scripts/decode_ssd_compare.py --waves 1 --waves 2   # budgets
    python scripts/decode_ssd_compare.py --bf16 --tree OLD [--sweep]

A tree is a checkout of the repository (for example the parent commit
unpacked with ``git archive`` into a gitignored directory); each builds its
own kernels under its ``build/kernels``.  Every run is a process of its
own, in turns: the other trees and this one, then the same in reverse
order.  Each run checks
both kernels against its tree's plain version (``chip_smoke.TOL``) and
prints the device time (``chip_smoke.device_ms``) at ``chip_smoke.py``'s
phase 2 shapes: decode_attention at gemma2-2b's local and global layers,
chatglm3-6b and phi3-mini-3.8b over 4 slots of an 8192-row cache, at the
served paths' long tick (one long slot beside three short ones,
``LONG_LENS``), at a tick with two long slots and at a tick of four short
slots (``SHORT_LENS``), and ssd_scan at mamba2-130m's 512-token prefill
(two chunks of 256) and a 13-token one, with ssd_scan's distance from
float64 (``chip_smoke.ssd64``) beside its plain version's, as a share of
the largest |output|.  ``--waves W`` runs this tree with
decode_attention's budget of blocks at W times the blocks the card holds
at once, whatever the instance (a probe of ``grid_waves``).  ``--sweep``
adds, for every tree whose wrapper has ``split_blocks``, decode_attention's
time against the long slot's length beside three short slots, with the
wrapper's plan and with one split a sequence (no merge): the time a block
takes for its tiles apart from its fixed cost.

``--bf16`` times decode_attention_bf16 instead, at phase 2's bf16 decode
shapes (``BF16``: chatglm3-6b's, gemma2-2b's local and global and
phi3-mini's long and short ticks, seamless's cross decode) and
moonshot-v1-16b-a3b's (16 kv heads of 128, a group of 1), each held to
the plain version within ``chip_smoke.TOL``; and, at the fp32 shapes
above, times decode_attention_f32 and prints a hash of its outputs, so
that two trees' fp32 kernels can be shown equal bit for bit.  Its
``--sweep`` is decode_attention_bf16's, at chatglm3's, phi3's and
moonshot's shapes.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

DECODE = {"gemma2": (8, 4, 256, dict(cap=50.0, window=4096)),
          "gemma2 global": (8, 4, 256, dict(cap=50.0)),
          "chatglm3": (32, 2, 128, {}), "phi3": (32, 32, 96, {})}


TWO_LONG = [7, 30, 4100, 4250]
SWEEP = (128, 512, 1024, 2048, 4206)
#: decode_attention_bf16's timed shapes: (H, Hk, D, options, ticks)
BF16 = {"chatglm3": (32, 2, 128, {}, ("long", "short")),
        "gemma2": (8, 4, 256, dict(cap=50.0, window=4096),
                   ("long", "short")),
        "gemma2 global": (8, 4, 256, dict(cap=50.0), ("long",)),
        "phi3": (32, 32, 96, {}, ("long", "short")),
        "moonshot": (16, 16, 128, {}, ("long", "short"))}
BF16_SWEEP = ("chatglm3", "phi3", "moonshot")


def digest(t) -> str:
    """The first 16 hex digits of the SHA-256 of a tensor's bytes."""
    import torch
    raw = t.contiguous().cpu().view(-1).view(torch.uint8)
    return hashlib.sha256(raw.numpy().tobytes()).hexdigest()[:16]


def bf16_worker(tree: str, sweep: bool) -> dict:
    """decode_attention_bf16's times and decode_attention_f32's output
    hashes and times in ``tree`` (see the module's docstring)."""
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    sys.path.insert(0, os.path.join(os.path.abspath(tree), "src"))
    import torch

    from repro_torch.kernels import build
    from repro_torch.kernels._build import CSRC
    from repro_torch.kernels.decode_attention import kernel as dk
    from repro_torch.kernels.decode_attention.ref import \
        decode_attention_plain

    build([n for n in ("decode_attention", "decode_attention_bf16")
           if (CSRC / f"{n}.cu").exists()])
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    out = {}

    def randn(dtype, *shape):
        return torch.randn(shape, generator=gen).to(dev, dtype)

    def case(name, dtype, b, s, h, hk, d, lens, kw):
        q = randn(dtype, b, 1, h, d)
        k, v = randn(dtype, b, s, hk, d), randn(dtype, b, s, hk, d)
        kv_len = torch.tensor(lens, dtype=torch.int32, device=dev)[:, None]

        def fn():
            return dk.decode_attention_cuda(q, k, v, kv_len, **kw)

        got = fn()
        want = decode_attention_plain(q, k, v, kv_len, **kw)
        tol = cs.TOL[name]
        err = (got.float() - want.float()).abs()
        if (err > tol + tol * want.float().abs()).any() \
                or not torch.isfinite(got).all():
            raise SystemExit(f"{tree}: {name} off by {err.max().item()}")
        return fn, got, err.max().item()

    ticks = {"long": cs.LONG_LENS, "short": cs.SHORT_LENS,
             "two long": TWO_LONG}
    with torch.no_grad():
        for model, (h, hk, d, kw) in DECODE.items():
            for cls in ("long", "two long", "short"):
                fn, got, err = case("decode_attention", torch.float32, 4,
                                    8192, h, hk, d, ticks[cls], kw)
                out[f"fp32 {model} {cls}"] = (cs.device_ms(fn), err)
                out[f"fp32 {model} {cls} hash"] = (digest(got), 0.0)
        for model, (h, hk, d, kw, classes) in BF16.items():
            for cls in classes:
                fn, _, err = case("decode_attention_bf16", torch.bfloat16,
                                  4, 8192, h, hk, d, ticks[cls], kw)
                out[f"bf16 {model} {cls}"] = (cs.device_ms(fn), err)
        b, s, h, hk, d = cs.CROSS_DECODE
        fn, _, err = case("decode_attention_bf16", torch.bfloat16, b, s, h,
                          hk, d, [s] * b, {})
        out["bf16 seamless cross"] = (cs.device_ms(fn), err)
        if not sweep:
            return out
        # one split a sequence: each tree's budget function set to one
        # block (a tree without the bf16 plan takes split_blocks for both)
        budgets = [n for n in ("split_blocks", "bf16_blocks")
                   if hasattr(dk, n)]
        saved = {n: getattr(dk, n) for n in budgets}
        for model in BF16_SWEEP:
            h, hk, d, kw, _ = BF16[model]
            for n_long in SWEEP:
                fn, _, _ = case("decode_attention_bf16", torch.bfloat16, 4,
                                8192, h, hk, d, [7, 23, 30, n_long], kw)
                for how in ("plan", "one split"):
                    if how == "one split":
                        for n in budgets:
                            setattr(dk, n, lambda *a: 1)
                    out[f"sweep bf16 {model} L{n_long} {how}"] = (
                        cs.device_ms(fn), 0.0)
                    for n, f in saved.items():
                        setattr(dk, n, f)
    return out


def worker(tree: str, waves: int, sweep: bool) -> dict:
    sys.path.insert(0, ROOT)
    import chip_smoke as cs       # puts this tree's src first on the path
    sys.path.insert(0, os.path.join(os.path.abspath(tree), "src"))
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import build
    from repro_torch.kernels.decode_attention import kernel as dk
    from repro_torch.kernels.decode_attention.ref import \
        decode_attention_plain
    from repro_torch.kernels.ssd_scan.kernel import ssd_scan_cuda
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref

    build(["decode_attention", "ssd_scan"])
    if waves:
        dk.grid_waves = lambda per_sm: waves
    sweep = sweep and hasattr(dk, "split_blocks")
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    out = {}

    def randn(*shape):
        return torch.randn(shape, generator=gen).to(dev)

    def check(name, got, want):
        err = (got - want).abs().max().item()
        tol = cs.TOL[name]
        bad = ((got - want).abs() > tol + tol * want.abs()).sum().item()
        if bad or not torch.isfinite(got).all():
            raise SystemExit(f"{tree}: {name} off by {err}")
        return err

    with torch.no_grad():
        for model, (h, hk, d, kw) in DECODE.items():
            for cls, lens in (("long", cs.LONG_LENS), ("two long", TWO_LONG),
                              ("short", cs.SHORT_LENS)):
                q, k, v = (randn(4, 1, h, d), randn(4, 8192, hk, d),
                           randn(4, 8192, hk, d))
                kv_len = torch.tensor(lens, dtype=torch.int32,
                                      device=dev)[:, None]

                def fn():
                    return dk.decode_attention_cuda(q, k, v, kv_len, **kw)

                err = check("decode_attention", fn(),
                            decode_attention_plain(q, k, v, kv_len, **kw))
                out[f"decode {model} {cls}"] = (cs.device_ms(fn), err)
            if not sweep or model == "gemma2":
                continue
            plan = dk.split_blocks
            for n_long in SWEEP:
                kv_len = torch.tensor([7, 23, 30, n_long], dtype=torch.int32,
                                      device=dev)[:, None]
                for how in ("plan", "one split"):
                    if how == "one split":
                        dk.split_blocks = lambda *a: 1
                    out[f"sweep {model} L{n_long} {how}"] = (
                        cs.device_ms(fn), 0.0)
                    dk.split_blocks = plan
        for bc, q in ((2, 256), (1, 13)):
            x = randn(bc, 24, q, 64)
            bm, cm = 0.3 * randn(bc, 1, q, 128), 0.3 * randn(bc, 1, q, 128)
            dt = F.softplus(randn(bc, 24, 1, q))
            a = -torch.exp(0.2 * randn(24))
            cs_ = torch.cumsum(dt * a[None, :, None, None], -1).contiguous()
            args = (x, bm, cm, cs_, dt)
            got, want = ssd_scan_cuda(*args), ssd_scan_ref(*args)
            err = max(check("ssd_scan", g_, w_) for g_, w_ in
                      zip(got, want))
            out[f"ssd Q{q}"] = (cs.device_ms(lambda: ssd_scan_cuda(*args)),
                                err)
            for term, g_, w_, e_ in zip(("y_diag", "s_local"), got, want,
                                        cs.ssd64(*args)):
                top = e_.abs().max().item()
                out[f"ssd Q{q} {term} vs float64, kernel (plain)"] = tuple(
                    (t.double() - e_).abs().max().item() / top
                    for t in (g_, w_))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", action="append", default=[],
                    help="another checkout to time (repeatable)")
    ap.add_argument("--waves", type=int, action="append", default=[],
                    help="this tree's decode budget in waves (repeatable; "
                         "default: the kernel's own rule)")
    ap.add_argument("--sweep", action="store_true",
                    help="time decode against the long slot's length")
    ap.add_argument("--bf16", action="store_true",
                    help="decode_attention_bf16's times and the fp32 "
                         "kernel's output hashes")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        print(json.dumps(
            bf16_worker(args.worker, args.sweep) if args.bf16 else
            worker(args.worker, (args.waves or [0])[0], args.sweep)))
        return 0
    runs = [(t, 0) for t in args.tree] + [(ROOT, w) for w in args.waves or [0]]
    results = {}
    for tree, waves in runs + runs[::-1]:
        label = os.path.relpath(tree, ROOT) + (f" waves {waves}"
                                               if waves else "")
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--worker", tree,
             "--waves", str(waves)] + (["--sweep"] if args.sweep else [])
            + (["--bf16"] if args.bf16 else []),
            capture_output=True, text=True)
        if proc.returncode:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            return 1
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        results.setdefault(label, []).append(res)
    shapes = list(dict.fromkeys(k for rs in results.values() for k in rs[0]))
    print("ms per call (the two turns) and max_abs_err against the plain "
          "version, per run")
    for shape in shapes:
        print(f"{shape}:")
        for label, rs in results.items():
            if shape not in rs[0]:
                continue
            if shape.endswith("hash"):
                print(f"  {label:50s} "
                      + ", ".join(r[shape][0] for r in rs))
                continue
            if "float64" in shape:
                print(f"  {label:50s} {rs[0][shape][0]:.3e} "
                      f"({rs[0][shape][1]:.3e})")
                continue
            ms = ", ".join(f"{r[shape][0]:.4f}" for r in rs)
            print(f"  {label:50s} {ms}  (err {rs[0][shape][1]:.2e})")
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
