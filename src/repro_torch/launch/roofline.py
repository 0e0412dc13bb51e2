"""Roofline over the dry run's reports, at an H100 SXM's peaks.

Counterpart of ``repro/launch/roofline.py``.  For each (arch x shape)
cell of ``launch/dryrun.py``'s reports (``reports/dryrun_torch/``), the
three roofline terms of the cell's whole step on ``chips`` cards:

  compute_s    = FLOPs             / (chips x PEAK_FLOPS)
  memory_s     = HBM bytes floor   / (chips x HBM_BW)
  collective_s = collective bytes  / (chips x LINK_BW)

The peaks are the H100 SXM5 datasheet's: ``PEAK_FLOPS`` 989e12 dense
bf16 FLOP/s (tensor cores, no sparsity), ``HBM_BW`` 3.35e12 B/s of HBM3,
``LINK_BW`` 450e9 B/s of NVLink 4 a direction.  The FLOPs are the dry
run's count on meta tensors (every product of the step: the plain
attention's full S x S scores, masked or not); ``MODEL_FLOPS`` is the
usual 6 N_active D (train) / 2 N_active D (prefill, decode) estimate, so
their ratio shows masked-attention and recompute waste.  The memory floor
is the reference's analytic minimum traffic (``memory_floor_bytes``,
unchanged, so it counts KV heads as the reference's 16-way tensor
parallelism replicates them).  HBM per chip is the measured peak where
the cell ran on the card (at a batch of one), else not given.  The port's
world is one process: collective_s is 0.

Usage: python -m repro_torch.launch.roofline [--json out.json]
"""
from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Any, Dict, List, Optional

from repro_torch.common.config import SHAPE_CELLS, AttentionConfig
from repro_torch.common.utils import pad_to_multiple
from repro_torch.configs import get_config

PEAK_FLOPS = 989e12          # bf16 dense FLOP/s, H100 SXM5
HBM_BW = 3.35e12             # B/s of HBM3, H100 SXM5
LINK_BW = 450e9              # B/s of NVLink 4, one direction, H100 SXM5

REPORT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                          "reports", "dryrun_torch")


def model_flops(arch: str, cell_name: str) -> float:
    cfg = get_config(arch)
    cell = SHAPE_CELLS[cell_name]
    n_active = cfg.n_params_active()
    if cell.kind == "train":
        tokens = cell.global_batch * cell.seq_len
        return 6.0 * n_active * tokens
    if cell.kind == "prefill":
        tokens = cell.global_batch * cell.seq_len
        return 2.0 * n_active * tokens
    # decode: one token a sequence
    return 2.0 * n_active * cell.global_batch


def replicated_kv_heads(att: AttentionConfig, tp: int) -> int:
    """The KV heads the reference lays out under ``tp``-way tensor
    parallelism (its ``head_layout``): the kv heads themselves where they
    divide evenly, else the smallest multiple of ``tp`` that divides the
    padded query heads and replicates each kv head evenly."""
    hq_p = pad_to_multiple(att.n_heads, tp)
    if att.n_kv_heads % tp == 0 and hq_p % att.n_kv_heads == 0:
        return att.n_kv_heads
    m = tp
    while m <= hq_p:
        if hq_p % m == 0 and m % att.n_kv_heads == 0 and \
                m >= att.n_kv_heads:
            return m
        m += tp
    return hq_p


def memory_floor_bytes(arch: str, cell_name: str) -> float:
    """The reference's analytic minimum HBM traffic (global bytes) of one
    step:
      train:   params (fp32 r+w) + moments r+w + grads (bf16 w+r) +
               layer-boundary activations per micro-batch (save + read)
      prefill: params (bf16) + KV cache write + activations once
      decode:  params (bf16) + a full KV-cache read
    """
    from repro_torch.launch.specs import quantized_opt
    from repro_torch.models.model import param_count_estimate

    cfg = get_config(arch)
    cell = SHAPE_CELLS[cell_name]
    n = param_count_estimate(cfg)
    d = cfg.d_model
    if cell.kind == "train":
        mstate = 2.0 if quantized_opt(cfg) else 8.0
        pbytes = n * (4 + 4 + mstate * 2 + 2 + 2)  # p r/w, m+v r/w, g w+r
        mb = cell.global_batch // cfg.grad_accum
        act = (mb * cell.seq_len * d * 2) * cfg.n_layers * 2 * cfg.grad_accum
        return pbytes + act
    # serving cells: bf16 params
    pbytes = 2 * n
    if not cfg.has_attention:
        kv = 0.0
    else:
        hkv_e = replicated_kv_heads(cfg.attention, 16)
        n_attn = sum(1 for k in cfg.block_pattern
                     if k.split("+")[0].startswith("attn")) * cfg.n_periods
        kv = (cell.global_batch * cell.seq_len * hkv_e
              * cfg.attention.head_dim * 2 * 2) * n_attn
    if cell.kind == "prefill":
        act = cell.global_batch * cell.seq_len * d * 2 * cfg.n_layers
        return pbytes + kv + act
    return pbytes + kv  # decode reads the cache once


def analyze_report(rep: Dict[str, Any]) -> Optional[Dict[str, Any]]:
    """A report's roofline row; None for a cell without a count (an
    error)."""
    if rep.get("status") == "error" or "flops" not in rep:
        return None
    chips = rep["chips"]
    g_flops = rep["flops"]
    g_coll = rep.get("collective_bytes", 0)
    g_bytes_floor = memory_floor_bytes(rep["arch"], rep["cell"])
    terms = {"compute_s": g_flops / (chips * PEAK_FLOPS),
             "memory_s": g_bytes_floor / (chips * HBM_BW),
             "collective_s": g_coll / (chips * LINK_BW)}
    dominant = max(terms, key=terms.get)
    mf = model_flops(rep["arch"], rep["cell"])
    bound_s = max(terms.values())
    card = rep.get("card")
    return {
        "arch": rep["arch"], "cell": rep["cell"], "mesh": rep["mesh"],
        "chips": chips, "status": rep["status"],
        "global_flops": g_flops,
        "global_bytes_floor": g_bytes_floor,
        "global_collective_bytes": g_coll,
        **{k: round(v, 6) for k, v in terms.items()},
        "dominant": dominant.replace("_s", ""),
        "model_flops": mf,
        "useful_flops_ratio": round(mf / g_flops, 4) if g_flops else None,
        "roofline_fraction": round(mf / (chips * PEAK_FLOPS) / bound_s, 4)
        if bound_s else None,
        "hbm_per_chip_gib": round(card["peak_bytes"] / 2 ** 30, 2)
        if card else None,
        "card_step_s_batch1": card["step_s"] if card else None,
    }


def load_all(report_dir: str = REPORT_DIR) -> List[Dict[str, Any]]:
    rows = []
    for path in sorted(glob.glob(os.path.join(report_dir, "*.json"))):
        with open(path) as f:
            rep = json.load(f)
        row = analyze_report(rep)
        if row:
            rows.append(row)
    return rows


def what_would_help(row: Dict[str, Any]) -> str:
    d = row["dominant"]
    if d == "collective":
        return ("collective-bound: restructure sharding/schedule (gather "
                "weights once a step, bf16 gathers)")
    if d == "compute":
        ratio = row["useful_flops_ratio"] or 0
        if ratio < 0.6:
            return ("compute-bound with a low useful-FLOP ratio: cut "
                    "masked-attention and recompute waste")
        return "compute-bound near roofline: raise arithmetic intensity"
    return "memory-bound: fuse elementwise chains, widen tiles, bf16/int8"


def table(rows: List[Dict[str, Any]]) -> str:
    hdr = (f"{'arch':24s} {'cell':12s} {'compute_s':>10s} {'memory_s':>10s} "
           f"{'coll_s':>10s} {'dom':>10s} {'useful':>7s} {'roofline':>8s} "
           f"{'HBM/chip':>9s}")
    lines = [hdr, "-" * len(hdr)]
    for r in rows:
        hbm = "-" if r["hbm_per_chip_gib"] is None \
            else f"{r['hbm_per_chip_gib']:.2f}G"
        lines.append(
            f"{r['arch']:24s} {r['cell']:12s} {r['compute_s']:10.4f} "
            f"{r['memory_s']:10.4f} {r['collective_s']:10.4f} "
            f"{r['dominant']:>10s} "
            f"{(r['useful_flops_ratio'] or 0):7.3f} "
            f"{(r['roofline_fraction'] or 0):8.3f} {hbm:>9s}")
    return "\n".join(lines)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--json", default=None)
    ap.add_argument("--dir", default=REPORT_DIR)
    args = ap.parse_args()
    rows = load_all(args.dir)
    print(table(rows))
    print()
    for r in rows:
        print(f"{r['arch']:24s} {r['cell']:12s} -> {what_would_help(r)}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(rows, f, indent=1)


if __name__ == "__main__":
    main()
