"""Serving launcher: the continuous-batching engine for an arch the port
serves, with seeded random weights.

  PYTHONPATH=src python -m repro_torch.launch.serve \
      --s-max 8192                # chatglm3-6b on a CUDA card (~26 GB)
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-2b \
      --smoke --device cpu        # plain versions, any host

Counterpart of ``repro/launch/serve.py``: the same flags and requests
(``numpy.random.RandomState(0)``: prompts of 4-23 tokens from
[2, vocab)), plus ``--device`` (default CUDA) and ``--seed`` (the
weights' ``torch.Generator`` seed, drawn on the CPU).
"""
from __future__ import annotations

import argparse
import time
from typing import List

import numpy as np
import torch

from repro_torch.common.config import ArchConfig
from repro_torch.configs import get_config, smoke_config
from repro_torch.models.model import LM
from repro_torch.serving.engine import Request, ServingEngine


def make_requests(cfg: ArchConfig, n: int, max_new: int,
                  seed: int = 0) -> List[Request]:
    """The reference launcher's requests."""
    rs = np.random.RandomState(seed)
    return [Request(uid=i,
                    prompt=list(rs.randint(2, cfg.vocab_size,
                                           rs.randint(4, 24))),
                    max_new_tokens=max_new)
            for i in range(n)]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="chatglm3-6b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--s-max", type=int, default=256)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    lm = LM(cfg, device=args.device).init(
        torch.Generator().manual_seed(args.seed))
    engine = ServingEngine(lm, max_slots=args.slots, s_max=args.s_max,
                           eos_id=-1)
    reqs = make_requests(cfg, args.requests, args.max_new)
    t0 = time.perf_counter()
    done = engine.run(reqs)
    if lm.device.type == "cuda":
        torch.cuda.synchronize(lm.device)
    dt = time.perf_counter() - t0
    tokens = sum(len(r.output) for r in done)
    print(f"served {len(done)} requests, {tokens} tokens in {dt:.2f}s "
          f"({tokens/dt:.1f} tok/s); stats={engine.stats}")
    for r in done[:4]:
        print(f"  req{r.uid}: prompt[:6]={r.prompt[:6]} out={r.output}")


if __name__ == "__main__":
    main()
