"""Where a fused_prefix launch spends its time, block by block, on the card.

    python scripts/prefix_probe.py

Builds ``csrc/fused_prefix.cu`` with ``-DFUSED_PREFIX_PROBE`` into
``build/probe/`` (the committed kernel with marks: at each one the block
meets a barrier and its thread 0 records ``clock64()``), launches it through
the port's own wrapper on ``chip_smoke.py``'s path spec (16 3x128x256 frames
and predecessors, uint8 and float32, with the signature stage), checks it
against the plain version, and prints for each phase (the loads issued,
their wait, each stage's cluster.sync() and work, the last sync, the
combining) the median and the largest SM cycles over the blocks, then the
blocks' start spread and the launch's span on %globaltimer (ns), and how
many SMs the blocks ran on.  The
barriers at the marks add their own cost: read the shares, not the total.
"""
from __future__ import annotations

import ctypes
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MARKS = 40          # kMarks in the source


def build_probe() -> str:
    from repro_torch.kernels._build import CSRC, NVCC_FLAGS, nvcc

    out = os.path.join(ROOT, "build", "probe", "libfused_prefix_probe.so")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    subprocess.run([nvcc(), *NVCC_FLAGS, "-DFUSED_PREFIX_PROBE", "-o", out,
                    str(CSRC / "fused_prefix.cu")], check=True,
                   capture_output=True, text=True)
    return out


def main() -> int:
    sys.path.insert(0, ROOT)
    import chip_smoke as cs       # puts this tree's src first on the path
    import torch

    from repro_torch.kernels.fused_prefix import kernel as pk
    from repro_torch.kernels.fused_prefix.ref import (fused_prefix_ref,
                                                      signature_feats)

    lib = ctypes.CDLL(build_probe())
    fn = lib.fused_prefix_launch
    fn.argtypes = pk.KERNEL.argtypes
    fn.restype = ctypes.c_int
    pk.KERNEL._fn = fn            # the wrapper now launches the probe build
    set_marks = lib.fused_prefix_probe
    set_marks.argtypes = [ctypes.c_void_p]
    set_marks.restype = ctypes.c_int
    print(cs.smi_line())
    spec, _ = cs.with_signature(cs.PATH_SPEC, (3, 128, 256))
    gen = torch.Generator().manual_seed(0)
    f8, p8 = (torch.randint(0, 256, (16, 3, 128, 256), generator=gen,
                            dtype=torch.uint8).cuda() for _ in range(2))
    stages = pk.cluster_plan(pk.compile_spec(spec, (3, 128, 256))[0],
                             (3, 128, 256), 1)["stages"]
    kinds = {pk.DIFF: "diff", pk.COLOR: "colour", pk.PREPROCESS: "preprocess",
             pk.SIGNATURE: "signature", pk.COPY: "copy"}
    phases = [("loads issued", 0, 1), ("loads landed", 1, 2)]
    prev = 2
    for i, st in enumerate(stages):
        phases += [(f"sync before {kinds[st['kind']]}", prev, 3 + 2 * i),
                   (kinds[st["kind"]], 3 + 2 * i, 4 + 2 * i)]
        prev = 4 + 2 * i
    phases += [("last cluster.sync", prev, 35), ("combine and store x", 35,
                                                 36)]
    sig = 3 + 2 * next(i for i, st in enumerate(stages)
                       if st["kind"] == pk.SIGNATURE)
    phases += [("  signature: max pass", sig, 30),
               ("  signature: its cluster.sync", 30, 31),
               ("  signature: patch sums", 31, sig + 1)]
    for dtype in (torch.uint8, torch.float32):
        f, p = f8.to(dtype), p8.to(dtype)
        marks = torch.zeros((16 * pk.BLOCKS, MARKS), dtype=torch.int64,
                            device="cuda")
        for _ in range(5):        # warm, then the last launch is read
            rc = set_marks(marks.data_ptr())
            cs.check(rc == 0, f"fused_prefix_probe: CUDA error {rc}")
            got = pk.prefix_kernel(f, p, spec=spec)
        torch.cuda.synchronize()
        want = fused_prefix_ref(f, p, spec=spec[:-1])
        gy, gx = spec[-1][1]
        tol = dict(atol=cs.TOL["fused_prefix"], rtol=cs.TOL["fused_prefix"])
        cs.check(all(torch.allclose(a.float(), b.float(), **tol) for a, b in
                     ((got[0], want[0]), (got[1][0], want[1][0]),
                      (got[2], want[2]),
                      (got[3], signature_feats(want[2], gy, gx)))),
                 "probe build differs from the plain version")
        m = marks.cpu().tolist()
        print(f"fused_prefix B16 path {str(dtype)[6:]}: SM cycles a phase "
              "over the 128 blocks, median (largest)")
        for label, a, b in phases:
            d = [row[b] - row[a] for row in m]
            print(f"  {label:28s} {statistics.median(d):9.0f} ({max(d)})")
        sms = [row[37] for row in m]
        print(f"  the 128 blocks ran on {len(set(sms))} SMs, at most "
              f"{max(sms.count(x) for x in set(sms))} on one")
        total = [row[36] - row[0] for row in m]
        wall = [row[39] - row[38] for row in m]
        starts = [row[38] for row in m]
        print(f"  {'total':28s} {statistics.median(total):9.0f} "
              f"({max(total)}); a block's span {statistics.median(wall)} ns "
              f"median; starts spread over {max(starts) - min(starts)} ns; "
              f"the launch spans {max(r[39] for r in m) - min(starts)} ns")
    set_marks(None)
    return 0


if __name__ == "__main__":
    sys.exit(main())
