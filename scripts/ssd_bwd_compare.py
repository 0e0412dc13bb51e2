"""Time ssd_scan's backward of several source trees on one card.

    python scripts/ssd_bwd_compare.py                # this tree
    python scripts/ssd_bwd_compare.py --tree OLD     # OLD, this, this, OLD
    python scripts/ssd_bwd_compare.py --splits       # split counts
    python scripts/ssd_bwd_compare.py --profile      # each launch's time

A tree is a checkout of the repository (for example the parent commit
unpacked with ``git archive`` into a gitignored directory); each builds its
own ssd_scan and ssd_scan_bwd under its ``build/kernels``.  Every run is a
process of its own, in turns: the other trees and this one, then the same
in reverse order.  Each run checks its tree's backward against the plain
version's autograd at every ``chip_smoke.SSD_BWD_SHAPES`` shape (1e-4 of
the largest gradient, at least 1: ``chip_smoke.TOL``) and prints its
device time there (``chip_smoke.device_ms``): the backward alone
(``autograd.grad`` of a retained graph) and forward + backward.  It hashes
the forward's output (``ssd_scan_f32``'s y_diag and s_local) at every
shape: the script prints whether every run of every tree gave the same
bits, and exits non-zero if not or if a check fails.

``--splits`` times this tree's backward with the split count forced to
every count whose split fits a block (1 up to the heads of a group), each
checked against the plain version first, then timed in turns and in
reverse order, and names the plan's count and the fastest.

``--profile`` prints the device time of each of the backward's two
launches (``torch.profiler``, 20 backward calls) with the plan's choice.
"""
from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _digest(t) -> str:
    return hashlib.sha256(t.detach().cpu().numpy().tobytes()).hexdigest()


def _inputs(cs, shape, dev):
    import torch

    gen = torch.Generator().manual_seed(sum(shape))
    return cs.ssd_bwd_inputs(gen, dev, *shape, 1.0)


def _grad_err(fn, plain, args, dy, ds):
    import torch

    got, want = [], []
    for f, into in ((fn, got), (plain, want)):
        leaves = [x.clone().requires_grad_(True) for x in args]
        torch.autograd.backward(f(*leaves), (dy, ds))
        into += [x.grad for x in leaves]
    return max((g - w).abs().max().item() / max(w.abs().max().item(), 1.0)
               for g, w in zip(got, want))


def _bwd_ms(cs, fn, args, dy, ds):
    import torch

    leaves = [x.clone().requires_grad_(True) for x in args]
    outs = fn(*leaves)
    bwd = cs.device_ms(lambda: torch.autograd.grad(
        outs, leaves, (dy, ds), retain_graph=True), n=20)

    def both():
        ls = [x.clone().requires_grad_(True) for x in args]
        torch.autograd.grad(fn(*ls), ls, (dy, ds))

    return bwd, cs.device_ms(both, n=10)


def worker(tree: str) -> dict:
    sys.path.insert(0, ROOT)
    import chip_smoke as cs       # puts this tree's src first on the path
    sys.path.insert(0, os.path.join(os.path.abspath(tree), "src"))
    import torch

    from repro_torch.kernels import build
    from repro_torch.kernels.ssd_scan.kernel import ssd_scan_cuda
    from repro_torch.kernels.ssd_scan.ops import ssd_scan
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref

    build(["ssd_scan", "ssd_scan_bwd"], force=True)
    dev = torch.device("cuda")
    out = {"times": {}, "digests": {}}
    for label, shape in cs.SSD_BWD_SHAPES.items():
        args, dy, ds = _inputs(cs, shape, dev)
        err = _grad_err(ssd_scan, ssd_scan_ref, args, dy, ds)
        if err > cs.TOL["ssd_scan_bwd"]:
            raise SystemExit(f"{tree}: ssd_scan_bwd {label} off by "
                             f"{err:.3e} of the largest gradient")
        bwd, both = _bwd_ms(cs, ssd_scan, args, dy, ds)
        out["times"][label] = {"bwd": bwd, "fwd_bwd": both, "err": err}
        with torch.no_grad():
            out["digests"][label] = [_digest(t) for t in ssd_scan_cuda(*args)]
        del args, dy, ds
    return out


def compare(trees) -> int:
    runs = list(trees) + [ROOT]
    results = {}
    for tree in runs + runs[::-1]:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--worker", tree], capture_output=True,
                              text=True)
        if proc.returncode:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            return 1
        results.setdefault(os.path.relpath(tree, ROOT), []).append(
            json.loads(proc.stdout.strip().splitlines()[-1]))
    this = results["."]
    print("ssd_scan_bwd device ms per call (the two turns): the backward "
          "alone, forward + backward; max error against the plain "
          "autograd, relative to the largest gradient")
    best = {}
    for shape in this[0]["times"]:
        print(f"{shape}:")
        for label, rs in results.items():
            t = [r["times"][shape] for r in rs]
            best[label, shape] = min(x["bwd"] for x in t)
            bwd = ", ".join("%.4f" % x["bwd"] for x in t)
            both = ", ".join("%.4f" % x["fwd_bwd"] for x in t)
            print(f"  {label:30s} backward {bwd}; forward + backward {both}"
                  f" (err {t[0]['err']:.2e})")
    for label in results:
        if label == ".":
            continue
        for shape in this[0]["times"]:
            ratio = best[".", shape] / best[label, shape]
            print(f"{shape}: this tree / {label} = {ratio:.3f} (the better "
                  f"turn of each)")
    ok = True
    for shape, digest in this[0]["digests"].items():
        eq = all(r["digests"][shape] == digest for rs in results.values()
                 for r in rs)
        ok &= eq
        print(f"forward {shape}: y_diag and s_local equal in every run of "
              f"every tree, bit for bit (sha256): {eq}")
    print(json.dumps({k: [r["times"] for r in v] for k, v in
                      results.items()}))
    return 0 if ok else 1


def sweep() -> int:
    """This tree's backward at every ``SSD_BWD_SHAPES`` shape with the
    split count forced to each count that fits a block."""
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    import torch

    from repro_torch.kernels import build
    from repro_torch.kernels.ssd_scan import kernel as kmod
    from repro_torch.kernels.ssd_scan.ops import ssd_scan
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref

    build(["ssd_scan", "ssd_scan_bwd"], force=True)
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    real = kmod.bwd_plan

    @contextlib.contextmanager
    def forced(splits):
        kmod.bwd_plan = lambda *a, **kw: real(*a, **{**kw, "splits": splits})
        try:
            yield
        finally:
            kmod.bwd_plan = real

    times = {}
    for label, shape in cs.SSD_BWD_SHAPES.items():
        plan = real(*shape, sms=sms)["splits"]
        counts = []
        for n in range(1, shape[1] // shape[2] + 1):
            try:
                real(*shape, sms=sms, splits=n)
            except ValueError:        # the split does not fit a block
                continue
            counts.append(n)
        args, dy, ds = _inputs(cs, shape, dev)
        for n in counts:
            with forced(n):
                err = _grad_err(ssd_scan, ssd_scan_ref, args, dy, ds)
            if err > cs.TOL["ssd_scan_bwd"]:
                raise SystemExit(f"{label} at {n} splits: off by {err:.3e} "
                                 f"of the largest gradient")
        t = times[label] = {n: [] for n in counts}
        for n in counts + counts[::-1]:
            with forced(n):
                t[n].append(_bwd_ms(cs, ssd_scan, args, dy, ds)[0])
        fastest = min(counts, key=lambda n: min(t[n]))
        print(f"{label} backward ms by split count (the better turn): "
              + ", ".join(f"{n} {min(v):.4f}" for n, v in t.items())
              + f"; the plan's {plan}, the fastest {fastest}; the plan's / "
              f"the fastest = {min(t[plan]) / min(t[fastest]):.3f}")
        del args, dy, ds
    print(cs.smi_line())
    print(json.dumps(times))
    return 0


def profile() -> int:
    """Each launch's device time in this tree's backward at every
    ``SSD_BWD_SHAPES`` shape (``torch.profiler``, 20 backward calls)."""
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    from repro_torch.kernels import build
    from repro_torch.kernels.ssd_scan.kernel import bwd_plan
    from repro_torch.kernels.ssd_scan.ops import ssd_scan

    report = build(["ssd_scan", "ssd_scan_bwd"], force=True)
    print("\n".join(ln.strip() for ln in str(
        report["ssd_scan_bwd"]["log"]).splitlines()
        if "registers" in ln or "spill" in ln or "entry function" in ln))
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for label, shape in cs.SSD_BWD_SHAPES.items():
        args, dy, ds = _inputs(cs, shape, dev)
        leaves = [x.clone().requires_grad_(True) for x in args]
        outs = ssd_scan(*leaves)
        for _ in range(3):
            torch.autograd.grad(outs, leaves, (dy, ds), retain_graph=True)
        torch.cuda.synchronize()
        with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                torch.autograd.grad(outs, leaves, (dy, ds),
                                    retain_graph=True)
            torch.cuda.synchronize()
        rows = [(e.key, e.device_time_total / e.count, e.count)
                for e in prof.key_averages() if e.device_time_total > 0]
        plan = bwd_plan(*shape, sms=sms)
        print(f"{label} {shape} splits {plan['splits']} blocks "
              f"{plan['blocks']}: " + ", ".join(
                  f"{key[:40]} {us:.2f} us x{n // 20}" for key, us, n in
                  sorted(rows, key=lambda r: -r[1])))
        del args, dy, ds, leaves, outs
    print(cs.smi_line())
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", action="append", default=[],
                    help="another checkout to time (repeatable)")
    ap.add_argument("--splits", action="store_true",
                    help="time every split count that fits")
    ap.add_argument("--profile", action="store_true",
                    help="each launch's device time (torch.profiler)")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("ssd_bwd_compare: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    if args.worker:
        print(json.dumps(worker(args.worker)))
        return 0
    if args.splits:
        return sweep()
    if args.profile:
        return profile()
    sys.path.insert(0, ROOT)
    import chip_smoke as cs

    print(cs.smi_line())
    rc = compare(args.tree)
    print(cs.smi_line())
    return rc


if __name__ == "__main__":
    sys.exit(main())
