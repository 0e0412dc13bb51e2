"""Time the pixel kernels of several source trees on one card.

    python scripts/pixel_compare.py                # this tree
    python scripts/pixel_compare.py --tree OLD     # OLD, this, this, OLD

A tree is a checkout of the repository (for example the parent commit
unpacked with ``git archive`` into a gitignored directory); each builds its
own kernels under its ``build/kernels``.  Every run is a process of its own,
in turns: the other trees and this one, then the same in reverse order.
Each run checks its tree's frame_diff, fused_preprocess and fused_prefix
against the tree's plain versions (``chip_smoke.TOL``) and prints their
device time (``chip_smoke.device_ms``) at ``chip_smoke.py``'s phase 2
shapes, the main paths': frame_diff on 16 uint8 3x128x256 frame pairs in
4x8 regions, fused_preprocess on 16 frames at each of
``chip_smoke.PREPROCESS_TIMED`` (the reduced and optimized plans' crops
/2, and the reduced crop in grey), and
fused_prefix's launch on the path spec with its signature (uint8 and
float32 frames), cut after each stage and with its preprocess alone, and
the unfused chain.  This tree's
runs add the launch floor (``chip_smoke.floor_ms``: an empty kernel on each
kernel's grid; fused_preprocess's from ``preprocess_plan``).  Every run
hashes fused_preprocess's output at each timed shape; the script prints
whether every run of every tree gave the same bits, and exits non-zero if
not.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def worker(tree: str) -> dict:
    sys.path.insert(0, ROOT)
    import chip_smoke as cs       # puts this tree's src first on the path
    sys.path.insert(0, os.path.join(os.path.abspath(tree), "src"))
    import torch

    from repro_torch.kernels import build
    from repro_torch.kernels.frame_diff.kernel import frame_diff_cuda
    from repro_torch.kernels.frame_diff.ref import frame_diff_ref
    from repro_torch.kernels.fused_prefix.kernel import prefix_kernel
    from repro_torch.kernels.fused_prefix.ref import (color_frac,
                                                      fused_prefix_ref,
                                                      signature_feats)
    from repro_torch.kernels.fused_preprocess.kernel import \
        fused_preprocess_cuda
    from repro_torch.kernels.fused_preprocess.ref import fused_preprocess_ref

    this = os.path.samefile(tree, ROOT)
    build(["frame_diff", "fused_preprocess", "fused_prefix"]
          + (["launch_floor"] if this else []))
    gen = torch.Generator().manual_seed(0)
    f, p = (torch.randint(0, 256, (16, 3, 128, 256), generator=gen,
                          dtype=torch.uint8).cuda() for _ in range(2))
    out = {}

    def check(name, got, want):
        got, want = got.float(), want.float()
        err = (got - want).abs().max().item()
        tol = cs.TOL[name]
        bad = ((got - want).abs() > tol + tol * want.abs()).sum().item()
        if bad or not torch.isfinite(got).all():
            raise SystemExit(f"{tree}: {name} off by {err}")
        return err

    err = check("frame_diff", frame_diff_cuda(f, p, regions=(4, 8)),
                frame_diff_ref(f, p, regions=(4, 8)))
    out["frame_diff B16 4x8"] = (cs.device_ms(
        lambda: frame_diff_cuda(f, p, regions=(4, 8))), err)
    digests = {}
    for name, (crop, factor, grey) in cs.PREPROCESS_TIMED.items():
        kw = dict(crop=crop, factor=factor, grey=grey)
        got = fused_preprocess_cuda(f, **kw)
        err = check("fused_preprocess", got, fused_preprocess_ref(f, **kw))
        label = (f"fused_preprocess B16 {crop[2]}x{crop[3]}/{factor}"
                 f"{' grey' if grey else ''}")
        digests[label] = hashlib.sha256(got.cpu().numpy().tobytes()
                                        ).hexdigest()
        out[label] = (cs.device_ms(lambda: fused_preprocess_cuda(f, **kw)),
                      err)
    path = dict(crop=(64, 0, 64, 256), factor=2)
    spec, _ = cs.with_signature(cs.PATH_SPEC, (3, 128, 256))
    gy, gx = spec[-1][1]
    for dtype in (torch.uint8, torch.float32):
        a, b = f.to(dtype), p.to(dtype)
        got = prefix_kernel(a, b, spec=spec)
        want = fused_prefix_ref(a, b, spec=spec[:-1])
        err = max(check("fused_prefix", g_, w_) for g_, w_ in
                  ((got[0], want[0]), (got[1][0], want[1][0]),
                   (got[2], want[2]),
                   (got[3], signature_feats(want[2], gy, gx))))
        label = f"fused_prefix B16 path {str(dtype)[6:]}"
        out[label] = (cs.device_ms(lambda: prefix_kernel(a, b, spec=spec)),
                      err)
    for k in range(1, len(spec)):       # the stage cut (uint8)
        out[f"fused_prefix B16 path cut after {spec[k - 1][0]}"] = (
            cs.device_ms(lambda k=k: prefix_kernel(f, p, spec=spec[:k])),
            0.0)
    # the preprocess without the diff (no predecessor frames to load)
    out["fused_prefix B16 path preprocess alone"] = (cs.device_ms(
        lambda: prefix_kernel(f, spec=spec[1:2])), 0.0)

    def unfused():
        frame_diff_cuda(f, p, regions=(4, 8))
        x = fused_preprocess_cuda(f, **path)
        color_frac(x, cs.RED)
        signature_feats(x, gy, gx)

    out["unfused chain B16 path"] = (cs.device_ms(unfused, n=8), 0.0)
    if this:
        from repro_torch.kernels.fused_preprocess.kernel import \
            preprocess_plan
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        grids = [("frame_diff", (128, 128)),
                 ("fused_prefix", (16 * 8, 512, 8))]
        for name, (crop, factor, grey) in cs.PREPROCESS_TIMED.items():
            plan = preprocess_plan(tuple(f.shape), crop, factor, grey,
                                   sms=sms)
            grids.append((f"fused_preprocess {name}", (
                plan["grid"][0] * plan["grid"][1], plan["threads"])))
        for label, grid in grids:
            out[f"launch floor, {label}'s grid"] = (cs.floor_ms(*grid), 0.0)
    return {"times": out, "digests": digests}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", action="append", default=[],
                    help="another checkout to time (repeatable)")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        print(json.dumps(worker(args.worker)))
        return 0
    runs = list(args.tree) + [ROOT]
    results, digests = {}, {}
    for tree in runs + runs[::-1]:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--worker", tree],
            capture_output=True, text=True)
        if proc.returncode:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            return 1
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        label = os.path.relpath(tree, ROOT)
        results.setdefault(label, []).append(res["times"])
        digests.setdefault(label, []).append(res["digests"])
    shapes = list(dict.fromkeys(k for rs in results.values() for k in rs[0]))
    print("ms per call (the two turns) and max_abs_err against the plain "
          "version, per run")
    for shape in shapes:
        print(f"{shape}:")
        for label, rs in results.items():
            if shape in rs[0]:
                ms = ", ".join(f"{r[shape][0]:.4f}" for r in rs)
                print(f"  {label:30s} {ms}  (err {rs[0][shape][1]:.2e})")
    # fused_preprocess's output at every timed shape, bit for bit (the
    # inputs come from one seed in every run)
    this = digests.pop(".")
    same = True
    for shape, digest in this[0].items():
        eq = all(d[shape] == digest for ds in [this, *digests.values()]
                 for d in ds)
        same &= eq
        print(f"{shape}: output equal in every run of every tree, bit for "
              f"bit (sha256): {eq}")
    print(json.dumps(results))
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
