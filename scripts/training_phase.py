#!/usr/bin/env python3
"""chip_smoke.py's phase 18 (training on the card), part by part, without
phases 1-17: a quicker check of the training path on a CUDA host.

    python scripts/training_phase.py            # (a) (f) (g) (d) (b) (c) (e)
    python scripts/training_phase.py f g        # only those parts

Builds the kernels, then runs each named part of ``chip_smoke.py``'s
phase 18 with its own gates: (a) the flash_attention backward against its
plain version and float64, with its times; (f) the ssd_scan backward the
same way; (g) mamba2-130m's training steps at full width, then card == CPU
at depth 2; (d) chatglm3-6b's training steps at full width; (b) the stream
models trained on the card and Q8's naive plan with them; (c) card == CPU;
(e) resume.  A failed part is
reported and the next one runs; the exit code is 1 if any failed.
"""
import json
import os
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def mamba2(dev, smi):
    """(g)'s steps and its card == CPU summary."""
    out, _, vs_cpu = cs.mamba2_train(dev, smi)
    return {"losses": out["losses"], "step_s": out["step_s"],
            "launches": out["launches"], "vs_cpu": vs_cpu}


def main(names) -> int:
    if not torch.cuda.is_available():
        print("training_phase: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    smi = cs.smi_line()
    print(f"{smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True     # as chip_smoke's phase 18
    build(force=True)
    print(f"built in {time.perf_counter() - t0:.1f} s")
    dev = torch.device("cuda")
    rows = {}
    parts = {"a": lambda: cs.flash_bwd_checks(dev, rows),
             "f": lambda: cs.ssd_bwd_checks(dev, rows),
             "g": lambda: mamba2(dev, smi),
             "d": lambda: cs.chatglm3_train(smi),
             "b": lambda: cs.pretrain_phase(dev, float("nan"))[1],
             "c": lambda: cs.mllm_card_vs_cpu(dev)[1],
             "e": lambda: cs.mllm_resume(dev)[1]}
    failed = []
    for name in names or list(parts):
        t = time.perf_counter()
        try:
            out = parts[name]()
            print(f"[{name}] ok in {time.perf_counter() - t:.1f} s: "
                  f"{json.dumps(out, default=str)[:2000]}")
        except Exception:
            failed.append(name)
            print(f"[{name}] FAILED in {time.perf_counter() - t:.1f} s")
            traceback.print_exc(file=sys.stdout)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    for name, t in rows.items():
        print(name, json.dumps({**cs.timing(t), **{
            k: cs.timing(v) if isinstance(v, dict) and "ms" in v else v
            for k, v in t.items() if k not in cs.TIMING_KEYS}}))
    print(f"total {time.perf_counter() - t0:.1f} s; failed {failed}; {smi}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
