"""Time flash_attention's backward of several source trees on one card.

    python scripts/flash_bwd_compare.py                # this tree
    python scripts/flash_bwd_compare.py --tree OLD     # OLD, this, this, OLD
    python scripts/flash_bwd_compare.py --variants     # split-term counts
    python scripts/flash_bwd_compare.py --splits       # split counts
    python scripts/flash_bwd_compare.py --profile      # each kernel's time
    python scripts/flash_bwd_compare.py --bf16 --tree OLD   # bf16 forward

A tree is a checkout of the repository (for example the parent commit
unpacked with ``git archive`` into a gitignored directory); each builds its
own flash_attention and flash_attention_bwd under its ``build/kernels``.
Every run is a process of its own, in turns: the other trees and this one,
then the same in reverse order.  Each run checks its tree's backward
against the plain version's autograd at every ``chip_smoke.BWD_PATH``
shape (2e-5 of the largest gradient, ``chip_smoke.TOL``) and prints its
device time there (``chip_smoke.device_ms``): the backward alone
(``autograd.grad`` of a retained graph) and forward + backward.  It hashes
the forward's output (the serving entry point, and the training one with
its log-sum-exp; at the ``BWD_PATH`` shapes also the backward's dq, dk
and dv) at every ``BWD_PATH`` shape and at phase 2's timed
prefill shapes (the stream MLLM's B16 S140/76/28 and the server's B32/B64
buckets, gemma2's, chatglm3's and phi3's prefill of 8192): the script
prints whether every run of every tree gave the same bits, and exits
non-zero if not.  It prints ptxas' registers and spills for the forward's
functions (by name and template, whatever their parameter lists) beside
the other trees' where they differ, and the backward's of each tree.  SDPA's fp32 backward is timed once (the first run of
this tree), in one ``enable_gqa`` call and on kv heads repeated before the
timing.  This tree's runs also time the rectangular kernels (cross
attention, Sq queries against Sk keys, ``chip_smoke.CROSS_TIMED``), which
an older tree may not have, beside SDPA's.

``--variants`` builds this tree's backward with other counts of split
terms for P^T.dO, dS^T.Q and dS.K (``-DBWD_PDO_TERMS`` etc.: 3 or 6) into
``build/flash_bwd_variants/``, runs each through phase 18 (a)'s cases and
gates unchanged (``chip_smoke.flash_bwd_check``: 2e-5 from the plain
version, no farther from float64 than twice the plain version's autograd
plus 1e-6 of the largest gradient, two launches equal bit for bit), and
times each at the ``BWD_PATH`` shapes, in turns.  The counts are
compile-time macros of the source (3 by default) so that this mode can
build the others.

``--splits`` times this tree's backward with the split count of the
group's heads forced to 1, 2, 4, 8 and 16 (up to the group) at every
``BWD_PATH`` shape, beside the plan's own choice.

``--bf16`` times the bf16 serving forward (``flash_attention_bf16``)
instead, at phase 2's timed bf16 shapes (``chip_smoke.BF16_TIMED`` and
seamless's prefill cross attention), of the other trees and this one in
turns as above: each run checks its output against the plain version
(``chip_smoke.TOL``: 2e-2, absolute plus relative) and that two launches
are equal bit for bit, hashes the output at each shape (the script prints
whether every run of every tree gave the same bits), and prints ptxas'
registers and spills for the bf16 functions of its flash_attention
library; SDPA's bf16 time is printed once (this tree's first run).  Exits
non-zero if a check fails or the bits differ.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import hashlib
import json
import os
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the forward's timed prefill shapes of phase 2, (B, S, H, Hk, D, options)
PREFILL = {"mllm_b16_s140": (16, 140, 8, 4, 32, {}),
           "mllm_b16_s76": (16, 76, 8, 4, 32, {}),
           "mllm_b16_s28": (16, 28, 8, 4, 32, {}),
           "server_b32_s140": (32, 140, 8, 4, 32, {}),
           "server_b64_s140": (64, 140, 8, 4, 32, {}),
           "gemma2_s8192": (1, 8192, 8, 4, 256, dict(cap=50.0, window=4096)),
           "chatglm3_s8192": (1, 8192, 32, 2, 128, {}),
           "phi3_s8192": (1, 8192, 32, 32, 96, {})}
#: --splits: the split counts forced at each shape (up to its group)
SPLITS = (1, 2, 4, 8, 16)
#: --variants: name -> terms of (P^T.dO, dS^T.Q, dS.K)
VARIANTS = {"333": (3, 3, 3), "633": (6, 3, 3), "363": (3, 6, 3),
            "336": (3, 3, 6), "666": (6, 6, 6)}


def _digest(t) -> str:
    """A tensor's bytes hashed (any dtype: bf16 has no numpy type)."""
    raw = t.detach().cpu().contiguous().view(-1).view(torch_uint8())
    return hashlib.sha256(raw.numpy().tobytes()).hexdigest()


def torch_uint8():
    import torch

    return torch.uint8


def _ptxas(log: str) -> dict:
    """ptxas' report of a build's log: each entry function's registers,
    stack frame and spills."""
    out, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            # the anonymous namespace's mangled name carries a hash of the
            # source file: drop it, so trees compare by function
            name = re.sub(r"_GLOBAL__N__\w+?_cu_[0-9a-f]{8}", "_GLOBAL__N_",
                          m.group(1))
            # and its parameter list, so that a kernel that gained an
            # argument compares by name and template
            name = re.sub(r"(EE+)v.*$", r"\1", name)
            out[name] = []
        elif name and re.search(r"registers|spill", ln):
            out[name].append(re.sub(r"^.*?: *", "", ln.strip()))
    return out


def _inputs(shape, dev):
    import torch

    b, s, h, hk, d = shape
    gen = torch.Generator().manual_seed(b * s + d)   # chip_smoke.bwd_timing's
    return [torch.randn(x, generator=gen).to(dev) for x in
            ((b, s, h, d), (b, s, hk, d), (b, s, hk, d), (b, s, h, d))]


def _grad_err(fn, plain, q, k, v, dout):
    import torch

    got, want = [], []
    for f, into in ((fn, got), (plain, want)):
        leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
        f(*leaves).backward(dout)
        into += [x.grad for x in leaves]
    return max((g - w).abs().max().item() / max(w.abs().max().item(), 1.0)
               for g, w in zip(got, want))


def _bwd_ms(cs, fn, q, k, v, dout):
    import torch

    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    out = fn(*leaves)
    bwd = cs.device_ms(lambda: torch.autograd.grad(
        out, leaves, dout, retain_graph=True), n=20)

    def both():
        ls = [x.clone().requires_grad_(True) for x in (q, k, v)]
        torch.autograd.grad(fn(*ls), ls, dout)

    return bwd, cs.device_ms(both, n=10)


def _cross_times(cs, out, sdpa: bool) -> None:
    """This tree's rectangular backward (``causal=False``) at
    ``CROSS_TIMED``, checked against the plain autograd first; SDPA's fp32
    backward beside it where ``sdpa``."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import flash_attention_plain

    def kernels(q, k, v):
        return flash_attention(q, k, v, causal=False)

    def plain(q, k, v):
        return flash_attention_plain(q, k, v, causal=False)

    def one_call(q, k, v):
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            enable_gqa=True).transpose(1, 2)

    for label in cs.CROSS_TIMED:
        b, sq, sk, h, hk, d, _ = cs.CROSS_SHAPES[label]
        gen = torch.Generator().manual_seed(b * sq + d)
        q, k, v, dout = cs.bwd_inputs(gen, "cuda", b, sq, sk, h, hk, d)
        err = _grad_err(kernels, plain, q, k, v, dout)
        if err > cs.TOL["flash_attention_bwd"]:
            raise SystemExit(f"flash_attention_bwd {label} off by "
                             f"{err:.3e} of the largest gradient")
        bwd, both = _bwd_ms(cs, kernels, q, k, v, dout)
        out["cross"][label] = {"bwd": bwd, "fwd_bwd": both, "err": err}
        if sdpa:
            out["cross"][label]["sdpa"], out["cross"][label][
                "sdpa_fwd_bwd"] = _bwd_ms(cs, one_call, q, k, v, dout)


def worker(tree: str, sdpa: bool) -> dict:
    sys.path.insert(0, ROOT)
    import chip_smoke as cs       # puts this tree's src first on the path
    sys.path.insert(0, os.path.join(os.path.abspath(tree), "src"))
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import flash_attention_plain

    torch.backends.cuda.matmul.allow_tf32 = False
    report = build(["flash_attention", "flash_attention_bwd"], force=True)
    dev = torch.device("cuda")
    out = {"times": {}, "digests": {}, "cross": {},
           "ptxas": _ptxas(str(report["flash_attention"]["log"])),
           "ptxas_bwd": _ptxas(str(report["flash_attention_bwd"]["log"]))}

    def digests(label, q, k, v, kw):
        with torch.no_grad():
            o = flash_attention_cuda(q, k, v, **kw)
            o2, lse = flash_attention_cuda(q, k, v, lse=True, **kw)
        out["digests"][label] = [_digest(o), _digest(o2), _digest(lse)]

    for label, shape in cs.BWD_PATH.items():
        q, k, v, dout = _inputs(shape, dev)
        err = _grad_err(flash_attention, flash_attention_plain, q, k, v,
                        dout)
        if err > cs.TOL["flash_attention_bwd"]:
            raise SystemExit(f"{tree}: flash_attention_bwd {label} off by "
                             f"{err:.3e} of the largest gradient")
        bwd, both = _bwd_ms(cs, flash_attention, q, k, v, dout)
        out["times"][label] = {"bwd": bwd, "fwd_bwd": both, "err": err}
        digests(label, q, k, v, {})
        leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
        flash_attention(*leaves).backward(dout)
        out["digests"][label] += [_digest(x.grad) for x in leaves]
        if sdpa:
            b, s, h, hk, d = shape

            def one_call(q, k, v):
                return F.scaled_dot_product_attention(
                    q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                    is_causal=True, enable_gqa=True).transpose(1, 2)

            kx, vx = (x.repeat_interleave(h // hk, dim=2) for x in (k, v))
            out["times"][label]["sdpa"] = _bwd_ms(cs, one_call, q, k, v,
                                                  dout)[0]
            out["times"][label]["sdpa_repeated"] = _bwd_ms(
                cs, one_call, q, kx, vx, dout)[0]
        del q, k, v, dout
    gen = torch.Generator(device="cuda").manual_seed(2)
    for label, (b, s, h, hk, d, kw) in PREFILL.items():
        q, k, v = (torch.randn(x, generator=gen, device="cuda") for x in
                   ((b, s, h, d), (b, s, hk, d), (b, s, hk, d)))
        digests(label, q, k, v, kw)
        del q, k, v
        torch.cuda.empty_cache()
    if os.path.samefile(tree, ROOT):
        _cross_times(cs, out, sdpa)
    return out


def _bf16_shapes(cs) -> dict:
    """label -> (B, Sq, Sk, H, Hk, D, options) of the bf16 timed shapes."""
    shapes = {k: (b, s, s, h, hk, d, kw)
              for k, (b, s, h, hk, d, kw) in cs.BF16_TIMED.items()}
    b, sq, sk, h, hk, d, kw = cs.CROSS_SHAPES["seamless_prefill_cross"]
    shapes["seamless_prefill_cross"] = (b, sq, sk, h, hk, d,
                                        dict(causal=False, **kw))
    return shapes


def bf16_worker(tree: str, sdpa: bool) -> dict:
    sys.path.insert(0, ROOT)
    import chip_smoke as cs       # puts this tree's src first on the path
    sys.path.insert(0, os.path.join(os.path.abspath(tree), "src"))
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
    from repro_torch.kernels.flash_attention.ref import flash_attention_plain

    report = build(["flash_attention"], force=True)
    ptxas = {k: v for k, v in _ptxas(str(report["flash_attention"]["log"]))
             .items() if "bf16" in k}
    out = {"times": {}, "errs": {}, "sdpa": {}, "ptxas": ptxas,
           "failed": [], "digests": {}}
    gen = torch.Generator(device="cuda").manual_seed(27)
    tol = cs.TOL["flash_attention_bf16"]
    for label, (b, sq, sk, h, hk, d, kw) in _bf16_shapes(cs).items():
        q, k, v = (torch.randn(x, generator=gen, device="cuda").to(
            torch.bfloat16) for x in ((b, sq, h, d), (b, sk, hk, d),
                                      (b, sk, hk, d)))
        got = flash_attention_cuda(q, k, v, **kw)
        want = flash_attention_plain(q, k, v, **kw).float()
        bad = ((got.float() - want).abs() > tol + tol * want.abs()).sum()
        out["errs"][label] = (got.float() - want).abs().max().item()
        out["digests"][label] = _digest(got)
        if bad or not torch.equal(got, flash_attention_cuda(q, k, v, **kw)):
            out["failed"].append(f"{label}: {int(bad)} values outside "
                                 f"{tol}, or two launches differ")
        big = sq > 1024
        n, reps = (2, 3) if big else (40, 5)
        out["times"][label] = cs.device_ms(
            lambda: flash_attention_cuda(q, k, v, **kw), n=n, reps=reps)
        if sdpa:
            qh, kh, vh = (x.transpose(1, 2) for x in (q, k, v))
            w = kw.get("window")
            mask = cs.flash_mask(sq, sk, kw, "cuda")[0] if w else None
            causal = kw.get("causal", True) and mask is None
            out["sdpa"][label] = cs.device_ms(
                lambda: F.scaled_dot_product_attention(
                    qh, kh, vh, attn_mask=mask, is_causal=causal,
                    enable_gqa=True), n=n, reps=reps)
        del q, k, v, got, want
        torch.cuda.empty_cache()
    return out


def compare_bf16(trees) -> int:
    results = _turns(trees, "--bf16-worker")
    if results is None:
        return 1
    this = results["."]
    sdpa = next(r["sdpa"] for r in this if r["sdpa"])
    print("flash_attention_bf16 device ms per call (the two turns); max "
          "error against the plain version")
    ok = True
    for shape in this[0]["times"]:
        print(f"{shape}: SDPA bf16 {sdpa[shape]:.4f}")
        for label, rs in results.items():
            t = ", ".join("%.4f" % r["times"][shape] for r in rs)
            print(f"  {label:30s} {t} (err {rs[0]['errs'][shape]:.2e})")
        for label, rs in results.items():
            if label != ".":
                ratio = min(r["times"][shape] for r in this) / min(
                    r["times"][shape] for r in rs)
                print(f"  this tree / {label} = {ratio:.3f} (the better "
                      f"turn of each)")
    digests = {json.dumps(r["digests"], sort_keys=True)
               for rs in results.values() for r in rs}
    print(f"flash_attention_bf16's outputs: every run of every tree gave "
          f"the same bits: {len(digests) == 1}")
    ok = len(digests) == 1
    for label, rs in results.items():
        for r in rs:
            for f in r["failed"]:
                ok = False
                print(f"FAILED {label}: {f}")
        print(f"bf16 functions' ptxas, {label}:")
        for fn, lines in sorted(rs[0]["ptxas"].items()):
            print(f"  {fn}: {'; '.join(lines)}")
    print(json.dumps({k: [r["times"] for r in v] for k, v in
                      results.items()}))
    return 0 if ok else 1


def _turns(trees, flag: str):
    """Each tree's worker (``flag`` TREE, a process of its own) in turns:
    the other trees and this one, then in reverse order, this tree's first
    run also timing SDPA.  {label: [result, result]}, or None where a run
    failed (its output printed)."""
    runs = list(trees) + [ROOT]
    results, first_here = {}, True
    for tree in runs + runs[::-1]:
        here = os.path.samefile(tree, ROOT)
        args = [sys.executable, os.path.abspath(__file__), flag, tree]
        if here and first_here:
            args.append("--sdpa")
            first_here = False
        proc = subprocess.run(args, capture_output=True, text=True)
        if proc.returncode:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            return None
        label = os.path.relpath(tree, ROOT)
        results.setdefault(label, []).append(
            json.loads(proc.stdout.strip().splitlines()[-1]))
    return results


def compare(trees) -> int:
    results = _turns(trees, "--worker")
    if results is None:
        return 1
    this = results["."]
    sdpa = next(r["times"] for r in this if "sdpa" in
                next(iter(r["times"].values())))
    print("flash_attention_bwd device ms per call (the two turns): the "
          "backward alone, forward + backward; max error against the plain "
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
        print(f"  SDPA fp32 backward: one enable_gqa call "
              f"{sdpa[shape]['sdpa']:.4f}, on repeated kv heads "
              f"{sdpa[shape]['sdpa_repeated']:.4f}")
    for label in results:
        if label == ".":
            continue
        for shape in this[0]["times"]:
            ratio = best[".", shape] / best[label, shape]
            both = min(r["times"][shape]["fwd_bwd"] for r in this) / min(
                r["times"][shape]["fwd_bwd"] for r in results[label])
            print(f"{shape}: this tree / {label} = {ratio:.3f} backward, "
                  f"{both:.3f} forward + backward (the better turn of each)")
    cross_sdpa = next(r["cross"] for r in this if any(
        "sdpa" in c for c in r["cross"].values()))
    for shape in this[0]["cross"]:
        t = [r["cross"][shape] for r in this]
        c = cross_sdpa[shape]
        print(f"{shape} (this tree, causal=False): backward "
              + ", ".join("%.4f" % x["bwd"] for x in t)
              + "; forward + backward "
              + ", ".join("%.4f" % x["fwd_bwd"] for x in t)
              + f" (err {t[0]['err']:.2e}); SDPA fp32 one enable_gqa call: "
              f"backward {c['sdpa']:.4f}, forward + backward "
              f"{c['sdpa_fwd_bwd']:.4f}")
    print(f"chatglm3_b8_s64: this tree {best['.', 'chatglm3_b8_s64']:.4f} "
          f"ms against SDPA on repeated kv heads "
          f"{sdpa['chatglm3_b8_s64']['sdpa_repeated']:.4f}")
    # the forward's (and the backward's) bits and ptxas report, every run
    # of every tree
    ok = True
    ref = this[0]
    for shape, digest in ref["digests"].items():
        eq = all(r["digests"][shape] == digest for rs in results.values()
                 for r in rs)
        ok &= eq
        what = "output, lse, dq, dk and dv" if shape in ref["times"] \
            else "output and lse"
        print(f"{shape}: {what} equal in every run of every tree, bit for "
              f"bit (sha256): {eq}")
    same = all(r["ptxas"] == ref["ptxas"] for rs in results.values()
               for r in rs)
    print(f"forward's ptxas registers and spills equal in every tree: "
          f"{same} (printed, not gated: a kernel that gained an argument "
          f"allocates anew)")
    for fn, lines in sorted(ref["ptxas"].items()):
        others = {label: rs[0]["ptxas"].get(fn) for label, rs in
                  results.items() if label != "."}
        print(f"  {fn}: {'; '.join(lines)}" + "".join(
            f" [{label}: {'; '.join(o) if o else 'missing'}]"
            for label, o in others.items() if o != lines))
    for label, rs in results.items():
        print(f"backward's ptxas, {label}:")
        for fn, lines in sorted(rs[0]["ptxas_bwd"].items()):
            print(f"  {fn}: {'; '.join(lines)}")
    print(json.dumps({k: [{**r["times"], **r["cross"]} for r in v]
                      for k, v in results.items()}))
    return 0 if ok else 1


class _Bound:
    """A variant library's entry point in ``CudaKernel``'s place."""

    def __init__(self, fn):
        self.fn = fn

    def launch(self, dev, *args):
        import torch

        rc = self.fn(*args, torch.cuda.current_stream(dev).cuda_stream)
        if rc:
            raise RuntimeError(f"variant: CUDA error {rc} at launch")


def _build_variant(name, terms, out_dir):
    from repro_torch.kernels._build import CSRC, NVCC_FLAGS, nvcc

    lib = os.path.join(out_dir, f"libflash_bwd_{name}.so")
    defs = [f"-DBWD_{p}_TERMS={t}" for p, t in zip(("PDO", "DSQ", "DSK"),
                                                   terms)]
    proc = subprocess.run([nvcc(), *NVCC_FLAGS, *defs, "-o", lib,
                           str(CSRC / "flash_attention_bwd.cu")],
                          capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"{name}: nvcc failed\n{proc.stdout}{proc.stderr}")
    from repro_torch.kernels.flash_attention.kernel import KERNEL_BWD

    fn = ctypes.CDLL(lib).flash_attention_bwd_f32
    fn.argtypes = KERNEL_BWD.argtypes
    fn.restype = ctypes.c_int
    regs = [ln.strip() for ln in (proc.stdout + proc.stderr).splitlines()
            if "registers" in ln or "spill" in ln]
    return name, fn, regs


def variants() -> int:
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    import torch

    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import kernel as kmod
    from repro_torch.kernels.flash_attention.ops import flash_attention

    torch.backends.cuda.matmul.allow_tf32 = False
    build(["flash_attention"], force=True)
    out_dir = os.path.join(ROOT, "build", "flash_bwd_variants")
    os.makedirs(out_dir, exist_ok=True)
    with ThreadPoolExecutor(len(VARIANTS)) as ex:
        built = list(ex.map(lambda kv: _build_variant(*kv, out_dir),
                            VARIANTS.items()))
    fns = {}
    for name, fn, regs in built:
        print(f"{name} (terms of P^T.dO, dS^T.Q, dS.K): "
              f"{'; '.join(sorted(set(regs)))[:600]}")
        fns[name] = _Bound(fn)
    dev = torch.device("cuda")
    real = kmod.KERNEL_BWD

    @contextlib.contextmanager
    def using(name):
        kmod.KERNEL_BWD = fns[name]
        try:
            yield
        finally:
            kmod.KERNEL_BWD = real

    summary = {}
    for name in fns:
        gen = torch.Generator().manual_seed(18)     # phase 18 (a)'s inputs
        failed = []
        with using(name):
            for label, shape, kw in cs.bwd_cases():
                q, k, v, dout = cs.bwd_inputs(gen, dev, *shape)
                try:
                    cs.flash_bwd_check(f"{label} {kw}", q, k, v, dout, kw)
                except cs.SmokeFailure as e:
                    failed.append(str(e))
        summary[name] = {"failed": failed}
        print(f"{name}: {len(failed)} of {len(cs.bwd_cases())} cases fail "
              f"phase 18 (a)'s gates")
        for f in failed:
            print(f"  {f}")
    times = {}
    for label, shape in cs.BWD_PATH.items():
        q, k, v, dout = _inputs(shape, dev)
        for name in list(fns) + list(fns)[::-1]:
            with using(name):
                times.setdefault(label, {}).setdefault(name, []).append(
                    _bwd_ms(cs, flash_attention, q, k, v, dout)[0])
        print(f"{label} backward ms: " + ", ".join(
            f"{n} {min(t):.4f}" for n, t in times[label].items()))
    print(cs.smi_line())
    print(json.dumps({"gates": summary, "times": times}))
    return 0 if not summary["333"]["failed"] else 1


def profile() -> int:
    """Each kernel's device time in this tree's backward at every
    ``BWD_PATH`` shape (``torch.profiler``, 20 backward calls)."""
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention.kernel import bwd_plan
    from repro_torch.kernels.flash_attention.ops import flash_attention

    report = build(["flash_attention", "flash_attention_bwd"], force=True)
    for fn, lines in sorted(_ptxas(str(report["flash_attention_bwd"]
                                       ["log"])).items()):
        print(f"{fn}: {'; '.join(lines)}")
    dev = torch.device("cuda")
    for label, shape in cs.BWD_PATH.items():
        q, k, v, dout = _inputs(shape, dev)
        leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
        out = flash_attention(*leaves)
        for _ in range(3):
            torch.autograd.grad(out, leaves, dout, retain_graph=True)
        torch.cuda.synchronize()
        with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                torch.autograd.grad(out, leaves, dout, retain_graph=True)
            torch.cuda.synchronize()
        rows = [(e.key, e.device_time_total / e.count, e.count)
                for e in prof.key_averages() if e.device_time_total > 0]
        plan = bwd_plan(*shape)
        print(f"{label} {shape} splits {plan['splits']}: " + ", ".join(
            f"{key[:40]} {us:.2f} us x{n // 20}" for key, us, n in
            sorted(rows, key=lambda r: -r[1])))
    print(cs.smi_line())
    return 0


def sweep() -> int:
    """This tree's backward at every ``BWD_PATH`` shape with the split count
    forced to each of ``SPLITS`` up to the group (``kernel.bwd_plan``
    replaced for the run), each checked against the plain version's
    autograd first, then timed in turns and in reverse order: what the
    split alone gives (one split against the best) and whether the plan's
    own choice is the fastest."""
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    import torch

    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import kernel as kmod
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import flash_attention_plain

    torch.backends.cuda.matmul.allow_tf32 = False
    build(["flash_attention", "flash_attention_bwd"], force=True)
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    real = kmod.bwd_plan

    @contextlib.contextmanager
    def forced(n):
        kmod.bwd_plan = lambda b, s, h, hk, d, **kw: dict(
            splits=n, scratch=2 * n * b * s * hk * d if n > 1 else 0)
        try:
            yield
        finally:
            kmod.bwd_plan = real

    times = {}
    for label, shape in cs.BWD_PATH.items():
        b, s, h, hk, d = shape
        counts = [n for n in SPLITS if n <= h // hk]
        q, k, v, dout = _inputs(shape, dev)
        for n in counts:
            with forced(n):
                err = _grad_err(flash_attention, flash_attention_plain, q, k,
                                v, dout)
            if err > cs.TOL["flash_attention_bwd"]:
                raise SystemExit(f"{label} at {n} splits: off by {err:.3e} "
                                 f"of the largest gradient")
        t = times[label] = {n: [] for n in counts}
        for n in counts + counts[::-1]:
            with forced(n):
                t[n].append(_bwd_ms(cs, flash_attention, q, k, v, dout)[0])
        plan = real(*shape, sms=sms)["splits"]
        best = min(counts, key=lambda n: min(t[n]))
        print(f"{label} backward ms by split count (the better turn): "
              + ", ".join(f"{n} {min(t[n]):.4f}" for n in counts)
              + f"; the plan's {plan}, the fastest {best}; one split / the "
              f"fastest = {min(t[1]) / min(t[best]):.3f}")
    print(cs.smi_line())
    print(json.dumps(times))
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", action="append", default=[],
                    help="another checkout to time (repeatable)")
    ap.add_argument("--variants", action="store_true",
                    help="gate and time the split-term counts")
    ap.add_argument("--profile", action="store_true",
                    help="each kernel's device time (torch.profiler)")
    ap.add_argument("--splits", action="store_true",
                    help="time the split counts of SPLITS")
    ap.add_argument("--bf16", action="store_true",
                    help="time the bf16 forward instead")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    ap.add_argument("--bf16-worker", help=argparse.SUPPRESS)
    ap.add_argument("--sdpa", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("flash_bwd_compare: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    if args.worker:
        print(json.dumps(worker(args.worker, args.sdpa)))
        return 0
    if args.bf16_worker:
        print(json.dumps(bf16_worker(args.bf16_worker, args.sdpa)))
        return 0
    if args.variants:
        return variants()
    if args.profile:
        return profile()
    if args.splits:
        return sweep()
    sys.path.insert(0, ROOT)
    import chip_smoke as cs

    print(cs.smi_line())
    rc = (compare_bf16 if args.bf16 else compare)(args.tree)
    print(cs.smi_line())
    return rc


if __name__ == "__main__":
    sys.exit(main())
