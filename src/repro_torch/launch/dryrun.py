"""Dry run: every (arch x shape) cell's operation count and its fit on one
card.

Counterpart of ``repro/launch/dryrun.py``, which lowers and compiles each
cell for 512 placeholder TPU devices.  The port has one H100 and no
compiler to ask, so for each applicable cell it:

  (a) counts the step's floating-point operations: the step runs on
      ``meta`` tensors (``launch/specs.py``: shapes without storage) at
      the cell's global batch under ``torch.utils.flop_counter.
      FlopCounterMode``.  The step runs eagerly, every period of the
      stack and every micro-batch, so the count is the whole step's (a
      train step's recomputed forward included); the reference's 1- and
      2-period extrapolation (its scanned modules' cost analysis counts a
      loop body once) has nothing to correct here;
  (b) where the analytic bytes at a batch of one (parameters, optimizer
      state by ``quantized_opt``, gradients, the cache) fit the card, runs
      the step on the card at the cell's sequence length and records the
      peak memory (``torch.cuda.max_memory_allocated``), the wall time of
      a step after a first one and the kernels' launches; otherwise the
      status is ``"does_not_fit_one_card"`` with the bytes.  A cell whose
      run raises anything (running out of memory too) is ``"error"`` with
      the exception, never ok.

The train step is the reference's: ``make_train_step`` over ``LM.loss``
at bf16 (fp32 masters, the weights cast at use, fp32 gradients), each
period recomputed in the backward where ``cfg.remat`` says (every full
config; ``LM.loss(..., remat=True)``), AdamW
with int8 moments where ``quantized_opt`` says, ``cfg.grad_accum``
micro-batches at the global batch (one at a batch of one); prefill and
decode run the LM at bf16 (``LM(cfg, dtype=torch.bfloat16)``).  The
world is one process: collective bytes are 0 and each report says
``"world": 1``.  Reports go to ``reports/dryrun_torch/<arch>__<cell>__
world1.json`` (``--tag T``: ``reports/dryrun_torch_T/``).

Usage:
  python -m repro_torch.launch.dryrun --arch gemma2-2b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--meta-only] [--tag T]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.common.config import SHAPE_CELLS, ArchConfig, \
    applicable_cells
from repro_torch.configs import ASSIGNED, get_config
from repro_torch.kernels import launch_counts
from repro_torch.launch.specs import (N_PATCHES, T_SRC_CAP, _tree_bytes,
                                      cell_spec, quantized_opt)
from repro_torch.models.model import LM
from repro_torch.training.optimizer import OptimizerConfig, adamw_init
from repro_torch.training.trainer import make_train_step

REPORT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                          "reports", "dryrun_torch")
MESH_NAME = "world1"
#: an H100's 80 GB: a cell whose analytic bytes at a batch of one fit runs
#: on the card (its activations and workspace come on top)
CARD_BYTES = 80 * 10 ** 9


def _inputs(cfg: ArchConfig, kind: str, b: int, s: int,
            device: torch.device, gen: Optional[torch.Generator]
            ) -> Dict[str, torch.Tensor]:
    """A full-sequence step's batch: random tokens (and labels, and the
    stub frontends' inputs at bf16) on ``device``, or empty meta tensors."""
    def ints(*shape, high):
        if device.type == "meta":
            return torch.empty(shape, dtype=torch.int64, device=device)
        return torch.randint(0, high, shape, generator=gen, device=device)

    def embeds(*shape):
        if device.type == "meta":
            return torch.empty(shape, dtype=torch.bfloat16, device=device)
        return torch.randn(shape, generator=gen, device=device).to(
            torch.bfloat16)

    batch = {"tokens": ints(b, s, high=cfg.vocab_size)}
    if kind == "train":
        batch["labels"] = ints(b, s, high=cfg.vocab_size)
    if cfg.frontend == "patch":
        batch["patch_embeds"] = embeds(b, N_PATCHES, cfg.d_model)
        batch["patch_pos"] = ints(b, N_PATCHES, high=s)
    if cfg.frontend == "audio":
        batch["frames"] = embeds(b, min(s, T_SRC_CAP), cfg.d_model)
    return batch


def build_step(cfg: ArchConfig, cell_name: str, device: torch.device,
               batch_override: Optional[int] = None,
               gen: Optional[torch.Generator] = None
               ) -> Tuple[Callable[[], Any], Dict[str, Any]]:
    """``(step, state)``: ``step()`` runs the cell's step once on
    ``device`` (``meta``: shapes only) at the cell's global batch or
    ``batch_override``; ``state`` holds the model and its inputs.  On the
    card the weights are drawn from ``gen``."""
    cell = SHAPE_CELLS[cell_name]
    b = batch_override or cell.global_batch
    s = cell.seq_len
    bf16 = torch.bfloat16
    if cell.kind == "train":
        lm = LM(cfg, device=device)
        if device.type != "meta":
            lm.init(gen)
        params = dict(lm.named_parameters())
        for p in params.values():
            p.requires_grad_(True)
        opt_cfg = OptimizerConfig(quantized_state=quantized_opt(cfg))
        accum = cfg.grad_accum if b % cfg.grad_accum == 0 else 1
        train = make_train_step(
            lambda batch: lm.loss(batch, dtype=bf16, remat=cfg.remat),
            params, opt_cfg, grad_accum=accum)
        state = {"lm": lm, "opt": adamw_init(params, opt_cfg),
                 "batch": _inputs(cfg, "train", b, s, device, gen)}

        def step():
            state["opt"], metrics = train(state["opt"], state["batch"])
            return metrics["loss"]
        return step, state

    lm = LM(cfg, device=device, dtype=bf16)
    if device.type != "meta":
        lm.init(gen)
    t_src = (min(s, T_SRC_CAP) if cell.kind == "prefill" else T_SRC_CAP) \
        if cfg.encoder_decoder else 0
    cache = lm.init_cache(b, s, t_src, dtype=bf16)
    state = {"lm": lm, "cache": cache}
    if cell.kind == "prefill":
        batch = _inputs(cfg, "prefill", b, s, device, gen)
        extra = {k: batch[k] for k in ("frames", "patch_embeds",
                                       "patch_pos") if k in batch}
        state["batch"] = batch

        def step():
            return lm.prefill(batch["tokens"], cache, dtype=bf16,
                              **extra)[0]
        return step, state

    tokens = _inputs(cfg, "decode", b, 1, device, gen)["tokens"]
    lens = torch.full((b,), s - 1, dtype=torch.int64, device=device)

    def step():
        return lm.decode(tokens, cache, lens, dtype=bf16)[0]
    return step, state


def count_flops(cfg: ArchConfig, cell_name: str,
                batch_override: Optional[int] = None) -> float:
    """(a): the step's operations on meta tensors.  The counter counts
    products (matmuls, convolutions, attention), not elementwise work, so
    a train step of ``grad_accum`` equal micro-batches counts that many
    times one micro-batch's loss and backward, and AdamW's update (all
    elementwise) counts nothing: one micro-batch's loss and backward
    (with its periods' recomputed forward where ``cfg.remat``) run."""
    cell = SHAPE_CELLS[cell_name]
    b = batch_override or cell.global_batch
    dev = torch.device("meta")
    if cell.kind != "train":
        step, _ = build_step(cfg, cell_name, dev, b)
        with FlopCounterMode(display=False) as counter:
            step()
        return float(counter.get_total_flops())
    accum = cfg.grad_accum if b % cfg.grad_accum == 0 else 1
    lm = LM(cfg, device=dev)
    for p in lm.parameters():
        p.requires_grad_(True)
    batch = _inputs(cfg, "train", b // accum, cell.seq_len, dev, None)
    with FlopCounterMode(display=False) as counter:
        lm.loss(batch, dtype=torch.bfloat16, remat=cfg.remat).backward()
    return float(counter.get_total_flops()) * accum


def analytic_bytes(cfg: ArchConfig, cell_name: str,
                   batch: int = 1) -> Dict[str, int]:
    """What the step must hold at ``batch``: the parameters (fp32 masters
    to train, bf16 to serve), the optimizer state, the gradients (fp32)
    and the cache (bf16), from the cell's abstract inputs."""
    spec = cell_spec(cfg, cell_name, None, batch_override=batch)
    if spec.step_kind == "train":
        params, opt_state, _ = spec.args
        p = _tree_bytes(params)
        return {"params": p, "optimizer": _tree_bytes(opt_state),
                "gradients": p, "cache": 0}
    # prefill's args are (params, batch, cache), decode's (params, tokens,
    # cache, cur)
    return {"params": _tree_bytes(spec.args[0]), "optimizer": 0,
            "gradients": 0, "cache": _tree_bytes(spec.args[2])}


def run_on_card(cfg: ArchConfig, cell_name: str, device: torch.device,
                seed: int = 0) -> Dict[str, Any]:
    """(b): the step at a batch of one on the card: two runs (the first
    builds and warms), the second timed, with its kernels' launches (the
    counts' rise over it); peak memory over both."""
    gen = torch.Generator(device=device).manual_seed(seed)
    torch.cuda.reset_peak_memory_stats(device)
    step, state = build_step(cfg, cell_name, device, batch_override=1,
                             gen=gen)
    out = step()
    torch.cuda.synchronize(device)
    before = launch_counts()
    t0 = time.perf_counter()
    out = step()
    torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    launches = {k: v - before[k] for k, v in launch_counts().items()
                if v > before[k]}
    finite = bool(torch.isfinite(out.float()).all())
    peak = torch.cuda.max_memory_allocated(device)
    del step, state, out
    torch.cuda.empty_cache()
    return {"peak_bytes": int(peak), "step_s": wall, "launches": launches,
            "finite": finite}


def run_cell(arch: str, cell_name: str, *, device: Optional[str] = None,
             card: bool = True, verbose: bool = True, save: bool = True,
             tag: str = "") -> Dict[str, Any]:
    """(a) and, with ``card``, (b) for one cell; the report (also written
    to ``REPORT_DIR``)."""
    cfg = get_config(arch)
    cell = SHAPE_CELLS[cell_name]
    result: Dict[str, Any] = {
        "arch": arch, "cell": cell_name, "mesh": MESH_NAME, "world": 1,
        "chips": 1, "kind": cell.kind, "seq_len": cell.seq_len,
        "global_batch": cell.global_batch, "status": "ok",
        "collective_bytes": 0}
    t0 = time.perf_counter()
    try:
        result["flops"] = count_flops(cfg, cell_name)
        result["flops_s"] = time.perf_counter() - t0
        need = analytic_bytes(cfg, cell_name)
        result["bytes_batch1"] = need
        total = sum(need.values())
        if not card:
            result["status"] = "meta_only"
        elif total > CARD_BYTES:
            result["status"] = "does_not_fit_one_card"
        else:
            run = run_on_card(cfg, cell_name,
                              torch.device(device or "cuda"))
            result["card"] = run
            if not run["finite"]:
                result["status"] = "error"
                result["error"] = "non-finite output"
        if verbose:
            run = result.get("card", {})
            print(f"[{result['status']}] {arch:24s} {cell_name:12s} "
                  f"flops={result['flops']:.4e} bytes@1={total / 1e9:.2f}GB"
                  + (f" peak={run['peak_bytes'] / 1e9:.2f}GB "
                     f"step={run['step_s']:.4f}s" if run else ""),
                  flush=True)
    except Exception as e:  # noqa: BLE001 - report and continue
        result["status"] = "error"
        result["error"] = f"{type(e).__name__}: {e}"
        result["traceback"] = traceback.format_exc()[-2000:]
        if verbose:
            print(f"[error] {arch} {cell_name}: {result['error'][:300]}",
                  flush=True)
    result["total_s"] = time.perf_counter() - t0
    if save:
        out_dir = REPORT_DIR if not tag else REPORT_DIR + "_" + tag
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir,
                            f"{arch}__{cell_name}__{MESH_NAME}.json")
        with open(path, "w") as f:
            json.dump(result, f, indent=1)
    return result


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--meta-only", action="store_true",
                    help="count operations only; run nothing on the card")
    ap.add_argument("--device", default=None)
    ap.add_argument("--tag", default="",
                    help="save reports under reports/dryrun_torch_<tag>/")
    args = ap.parse_args()
    if args.all:
        cells = [(a, c) for a in ASSIGNED
                 for c in applicable_cells(get_config(a))]
    else:
        assert args.arch and args.shape, "--arch and --shape (or --all)"
        cells = [(args.arch, args.shape)]
    failures = 0
    for arch, cell in cells:
        r = run_cell(arch, cell, device=args.device,
                     card=not args.meta_only, tag=args.tag)
        failures += r["status"] == "error"
    print(f"dry-run complete; failures={failures}")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
