"""Time decode_attention and ssd_scan of several source trees on one card.

    python scripts/decode_ssd_compare.py                   # this tree
    python scripts/decode_ssd_compare.py --tree OLD        # OLD, this, this, OLD
    python scripts/decode_ssd_compare.py --waves 1 --waves 2   # budgets

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
"""
from __future__ import annotations

import argparse
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
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        print(json.dumps(worker(args.worker, (args.waves or [0])[0],
                                args.sweep)))
        return 0
    runs = [(t, 0) for t in args.tree] + [(ROOT, w) for w in args.waves or [0]]
    results = {}
    for tree, waves in runs + runs[::-1]:
        label = os.path.relpath(tree, ROOT) + (f" waves {waves}"
                                               if waves else "")
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--worker", tree,
             "--waves", str(waves)] + (["--sweep"] if args.sweep else []),
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
