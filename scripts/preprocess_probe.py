#!/usr/bin/env python3
"""Where fused_preprocess's time goes: variants of its kernel timed on one
card, in turns.

    python scripts/preprocess_probe.py

Each variant is ``src/repro_torch/kernels/csrc/fused_preprocess.cu`` and
``preprocess.cuh`` edited as text, compiled on its own (``nvcc`` with the
port's flags, all variants at once) into ``build/probe/<variant>/``, bound
with the committed wrapper's arguments and launched from
``preprocess_plan`` (with its ``V`` or ``THREADS`` set where the variant
says).  A variant that keeps the arithmetic must give the committed
kernel's output bit for bit (checked); the others are timed only, as
bounds on what their part of the kernel costs:

  committed    the kernel as it is
  v8           eight outputs a thread (two float4 stores)
  threads128   bands sized for 128 threads a block
  threads512   bands sized for 512 threads a block
  ieeediv      every division through preprocess.cuh's ``/`` (its check and
               slow-path branch a division), not on the fast path
  sums         each output its window's integer sum, no division or
               normalization (timed only)
  nocompute    stage the band, then store zeros (timed only)
  nostage      compute from shared memory that was never filled (timed
               only)
  stores       neither stage nor compute: store zeros (timed only)
  setup        neither stage, compute nor store: the block's set-up and
               loops alone (timed only)

Every variant runs at ``chip_smoke.PREPROCESS_TIMED``'s shapes on 16 uint8
3x128x256 frames (``chip_smoke.device_ms``), the variants in turns and then
in reverse order, beside the launch floor on each grid.  Prints a line a
shape and variant, then one JSON object.
"""
from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROBE_DIR = os.path.join(ROOT, "build", "probe")

FAST = "v[k] = output<F, kGrey, true>("
LOOP = "        for (int k = 0; k < kV; ++k)\n          "
NOCOMPUTE = [(LOOP + FAST,
              "        for (int k = 0; k < kV; ++k) v[k] = 0.0f;\n"
              "        if (false)\n" + LOOP + FAST)]
NOSTAGE = [("      stage_word(sm + c * chan",
            "      if (false) stage_word(sm + c * chan")]
NOSTORE = [("            *reinterpret_cast<float4*>(o + ox + k) =",
            "            if (false) *reinterpret_cast<float4*>(o + ox + k) ="),
           ("            if (ox + k < g.Wo) o[ox + k] = v[k];",
            "            if (false) o[ox + k] = v[k];")]
#: name -> (edits of the .cu, edits of the .cuh, plan settings, exact)
VARIANTS = {
    "committed": ([], [], {}, True),
    "v8": ([("constexpr int kV = 4;", "constexpr int kV = 8;")], [],
           {"V": 8}, True),
    "threads128": ([], [], {"THREADS": 128}, True),
    "threads512": ([], [], {"THREADS": 512}, True),
    "ieeediv": ([(FAST, "v[k] = output<F, kGrey, false>(")], [], {}, True),
    "sums": ([("      ok &= __float_as_uint(x) == 0u || ordinary(x);\n"
               "      n[c] = div_fast(x, ch.sd[c], ch.rsd[c]);",
               "      n[c] = (float)s;")], [], {}, False),
    "nocompute": (NOCOMPUTE, [], {}, False),
    "nostage": (NOSTAGE, [], {}, False),
    "stores": (NOSTAGE + NOCOMPUTE, [], {}, False),
    "setup": (NOSTAGE + NOCOMPUTE + NOSTORE, [], {}, False),
}


def edit(text: str, edits) -> str:
    for old, new in edits:
        if old not in text:
            raise SystemExit(f"preprocess_probe: {old!r} is not in the "
                             "source; the probe needs updating")
        text = text.replace(old, new)
    return text


def build_variants():
    """Compile every variant at once; returns {name: library path}."""
    from repro_torch.kernels._build import CSRC, NVCC_FLAGS, nvcc

    cu = (CSRC / "fused_preprocess.cu").read_text()
    cuh = (CSRC / "preprocess.cuh").read_text()
    procs = {}
    for name, (cu_edits, cuh_edits, _, _) in VARIANTS.items():
        d = os.path.join(PROBE_DIR, name)
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "fused_preprocess.cu"), "w") as fh:
            fh.write(edit(cu, cu_edits))
        with open(os.path.join(d, "preprocess.cuh"), "w") as fh:
            fh.write(edit(cuh, cuh_edits))
        lib = os.path.join(d, "libfused_preprocess.so")
        procs[name] = (subprocess.Popen(
            [nvcc(), *NVCC_FLAGS, "-o", lib,
             os.path.join(d, "fused_preprocess.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for variant {name}:\n{log}")
        libs[name] = lib
    return libs


def main() -> int:
    sys.path.insert(0, ROOT)
    import chip_smoke as cs       # puts this tree's src first on the path
    import torch

    from repro_torch.kernels.fused_preprocess import kernel as kp
    from repro_torch.kernels.fused_preprocess.ref import fused_preprocess_ref

    if not torch.cuda.is_available():
        print("preprocess_probe: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    print(cs.smi_line())
    libs = build_variants()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator().manual_seed(0)
    x = torch.randint(0, 256, (16, 3, 128, 256), generator=gen,
                      dtype=torch.uint8).cuda()
    b, c, h, w = x.shape
    defaults = {"V": kp.V, "THREADS": kp.THREADS}
    calls, grids, committed = {}, {}, {}
    for name, (_, _, settings, exact) in VARIANTS.items():
        fn = getattr(ctypes.CDLL(libs[name]), "fused_preprocess_u8")
        fn.argtypes, fn.restype = kp.KERNEL.argtypes, ctypes.c_int
        for key, value in {**defaults, **settings}.items():
            setattr(kp, key, value)
        for shape, (crop, f, grey) in cs.PREPROCESS_TIMED.items():
            plan = kp.preprocess_plan(tuple(x.shape), crop, f, grey, sms=sms)
            out = torch.empty((b, 1 if grey else c, crop[2] // f,
                               crop[3] // f), device="cuda")
            args = (x.data_ptr(), out.data_ptr(), b, c, h, w, *crop, f,
                    int(grey), plan["rows"], plan["tx"], plan["xa"],
                    plan["words"], plan["unit"], plan["pitch"],
                    0.5, 0.5, 0.5, 0.0, 0.25, 0.25, 0.25, 1.0)

            def call(fn=fn, args=args, out=out):   # out stays alive
                rc = fn(*args, torch.cuda.current_stream().cuda_stream)
                if rc:
                    raise SystemExit(f"preprocess_probe: CUDA error {rc}")

            call()
            torch.cuda.synchronize()
            if name == "committed":
                want = fused_preprocess_ref(x, crop=crop, factor=f,
                                            grey=grey)
                err = (out - want).abs().max().item()
                if err > 1e-5:
                    raise SystemExit(f"committed {shape}: off by {err}")
                committed[shape] = out.clone()
            elif exact and not torch.equal(out, committed[shape]):
                raise SystemExit(f"variant {name} {shape}: not the "
                                 "committed kernel's output bit for bit")
            calls[name, shape] = call
            grids[name, shape] = (plan["grid"][0] * plan["grid"][1],
                                  plan["threads"])
    for key, value in defaults.items():
        setattr(kp, key, value)
    order = list(calls)
    times = {key: [] for key in order}
    for key in order + order[::-1]:
        times[key].append(cs.device_ms(calls[key]))
    floors = {g: cs.floor_ms(*g) for g in sorted(set(grids.values()))}
    result = {}
    for shape in cs.PREPROCESS_TIMED:
        print(f"{shape}:")
        for name in VARIANTS:
            t, g = times[name, shape], grids[name, shape]
            print(f"  {name:11s} {t[0]:.4f}, {t[1]:.4f} ms  ({g[0]} blocks "
                  f"of {g[1]}; floor {floors[g]:.4f})")
            result[f"{shape} {name}"] = {"ms": t, "blocks": g[0],
                                         "threads": g[1],
                                         "floor_ms": floors[g]}
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
