"""Physical optimization — implementation selection for the MLLM operator.

Counterpart of ``repro/core/physical.py``.  §3.2.3's levers:
  * detector cascade: TinyDet prefilters frames before the MLLM (YOLO role);
  * accuracy-constrained model selection: candidates {big, distilled-small,
    pruned} are evaluated on the validation sample; the cheapest variant
    within ``min_rel_accuracy`` of the big model wins;
  * structured pruning: magnitude-based FFN-column pruning that *actually
    shrinks* the matrices (d_ff -> d_ff·(1-rate)), not masking;
  * fused prefix: the surviving-frame prefix as one ``FusedPrefixOp``
    device pass when calibration says it wins.
Model selection and fusion are priced from measured timings, so they
may differ between runs and devices.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Tuple

import torch

from repro_torch.core.phases import SAMPLE_FRAMES, SAMPLE_SEED
from repro_torch.streaming.fused import FUSABLE, FusedPrefixOp, fusable_segment
from repro_torch.streaming.mllm import StreamMLLM
from repro_torch.streaming.operators import (
    DetectOp,
    MLLMExtractOp,
    OpContext,
)
from repro_torch.streaming.plan import Plan


# ---------------------------------------------------------------------------
# structured pruning
# ---------------------------------------------------------------------------

@torch.no_grad()
def structured_prune(mllm: StreamMLLM, rate: float = 0.5) -> StreamMLLM:
    """Prune FFN hidden columns by joint |w_in|·|w_out| magnitude.

    Returns a new ``StreamMLLM`` on the same device whose config has
    d_ff' = d_ff·(1-rate) (every layer keeps the same count), with the
    kept columns of ``w_in``/``w_gate`` and rows of ``w_out`` copied in and
    every other parameter copied as it is.  The kept indices are the
    reference's: ``argsort(-score)`` on the same scores, first d_ff', then
    sorted."""
    params = dict(mllm.named_parameters())
    f = mllm.cfg.d_ff
    keep = int(f * (1.0 - rate))
    idx = {}
    for name, w_in in params.items():
        if name.endswith(".mlp.w_in"):                   # (L, d, f)
            w_out = params[name[:-len("w_in")] + "w_out"]  # (L, f, d)
            score = torch.linalg.vector_norm(w_in, dim=1) \
                * torch.linalg.vector_norm(w_out, dim=2)  # (L, f)
            order = torch.argsort(-score, dim=-1, stable=True)[:, :keep]
            idx[name[:-len("w_in")]] = torch.sort(order, dim=-1).values
    new = StreamMLLM(dataclasses.replace(mllm.cfg, d_ff=keep),
                     patch=mllm.patch, device=mllm.device,
                     in_ch=mllm.conv1.shape[1],
                     max_patches=mllm.patch_pos_emb.shape[0])
    for name, p in new.named_parameters():
        src = params[name]
        owner, _, leaf = name.rpartition(".")
        if owner + "." in idx and leaf in ("w_in", "w_gate"):
            src = torch.take_along_dim(src, idx[owner + "."][:, None, :],
                                       dim=2)
        elif owner + "." in idx and leaf == "w_out":
            src = torch.take_along_dim(src, idx[owner + "."][:, :, None],
                                       dim=1)
        p.copy_(src)
    return new


# ---------------------------------------------------------------------------
# physical optimizer
# ---------------------------------------------------------------------------

class PhysicalOptimizer:
    name = "physical"

    def __init__(self, ctx: OpContext, min_rel_accuracy: float = 0.90):
        self.ctx = ctx
        self.min_rel = min_rel_accuracy

    # -- OptimizationPhase adapter (repro_torch.core.phases) -------------
    def run(self, plan: Plan, pctx) -> Tuple[Plan, Dict[str, Any]]:
        return self.optimize(plan, pctx.query, pctx.stream_factory,
                             pctx.run_fn, val_frames=pctx.val_frames,
                             catalog=pctx.catalog,
                             sample=pctx.sample_frames())

    def optimize(self, plan: Plan, query, stream_factory, run_fn,
                 val_frames: int = 512, catalog=None, sample=None
                 ) -> Tuple[Plan, Dict[str, Any]]:
        report: Dict[str, Any] = {"phase": "physical", "decisions": []}
        new = plan.clone()

        # ---- detector cascade before the MLLM (cost-gated) ----------------
        if query.dataset == "tollbooth":
            det = DetectOp(threshold=0.5)
            new.insert_before(MLLMExtractOp, det,
                              note="physical: TinyDet cascade")
            report["decisions"].append(
                "cascade: TinyDet (≈50k params) prefilters car-less frames "
                "before the MLLM (the YOLOv8 role)")

        # ---- accuracy-constrained model selection --------------------------
        candidates = ["big", "small"]
        if self.ctx.mllm_pruned is not None:
            candidates.append("pruned")
        accs: Dict[str, float] = {}
        costs: Dict[str, float] = {}
        base_plan = new.clone()
        for cand in candidates:
            p = base_plan.clone()
            mi = p.index_of(MLLMExtractOp)
            p.ops[mi].model = cand
            t0 = time.perf_counter()
            res = run_fn(p, stream_factory(303), val_frames)
            costs[cand] = time.perf_counter() - t0
            accs[cand] = query.evaluate(res)
            if catalog is not None:
                catalog.record_run(p.ops, res.wall_s, res.mllm_frames)
        base = max(accs["big"], 1e-9)
        viable = [c for c in candidates
                  if accs[c] >= self.min_rel * base]
        best = min(viable, key=lambda c: costs[c]) if viable else "big"
        report["model_selection"] = {
            "accuracies": accs, "wall_s": costs,
            "constraint": f">= {self.min_rel:.0%} of big-model accuracy",
            "viable": viable or ["big"],
            "chosen": best,
        }
        mi = new.index_of(MLLMExtractOp)
        new.ops[mi].model = best
        new.notes.append(f"physical: model={best}")
        report["decisions"].append(
            f"model selection: '{best}' — accuracy {accs[best]:.3f} vs big "
            f"{accs['big']:.3f} (constraint {self.min_rel:.0%}), "
            f"wall {costs[best]:.2f}s vs {costs['big']:.2f}s")
        report["decisions"].append(
            "quantization: int8 weight path available for the chosen model "
            "(serving/quantize.py + the int8_matmul CUDA kernel); applied "
            "when the accuracy constraint still holds")

        # ---- fused prefix execution (calibrated one-pass choice) -----------
        self._fuse_prefix(new, report, catalog, stream_factory, sample)
        return new, report

    # ------------------------------------------------------------------
    def _fuse_prefix(self, plan: Plan, report: Dict[str, Any], catalog,
                     stream_factory, sample) -> None:
        """Replace the plan's surviving-frame prefix with a single
        ``FusedPrefixOp`` device pass — but only when the calibrated cost
        model says the fused call beats the unfused op sequence on a
        sample micro-batch.

        Both alternatives are timed through ``catalog.calibrate_chain``
        (fresh descriptor copies, so plan state is untouched) and
        compared at the sample batch size with the fitted
        ``T(n) = overhead + marginal·n`` model, survivor fractions
        shrinking n down the unfused chain.  No catalog → no fusion:
        this decision is always measurement-backed, never a guess."""
        report["fused_prefix"] = {"fused": False, "reason": "no catalog"}
        if catalog is None:
            return
        mi = plan.index_of(MLLMExtractOp)
        if mi is None:
            report["fused_prefix"] = {"fused": False, "reason": "no extract"}
            return
        start = mi
        while start > 0 and isinstance(plan.ops[start - 1], FUSABLE):
            start -= 1
        # every member is FUSABLE; trim from the left until the ordering
        # constraints (Skip first, Detect last) hold too
        while start < mi and not fusable_segment(plan.ops[start:mi]):
            start += 1
        seg = plan.ops[start:mi]
        if len(seg) < 2:
            report["fused_prefix"] = {
                "fused": False, "reason": "segment too short",
                "segment": [o.name for o in seg]}
            return
        if sample is None:
            sample, _ = stream_factory(SAMPLE_SEED).batch(SAMPLE_FRAMES)

        def copies(ops):
            return [type(o)(**{f.name: getattr(o, f.name)
                               for f in dataclasses.fields(o) if f.init})
                    for o in ops]

        cand = FusedPrefixOp(stage_ops=tuple(copies(seg)))
        unfused_probe = copies(seg)
        catalog.calibrate_chain(unfused_probe, sample, self.ctx)
        catalog.calibrate_chain([cand], sample, self.ctx)

        n = sample.shape[0]
        unfused_us = _chain_cost_us(unfused_probe, n)
        fused_us = _chain_cost_us([cand], n)
        info = {"segment": [o.name for o in seg], "batch": n,
                "fused_us": fused_us, "unfused_us": unfused_us,
                # fitted T(n) terms, so the audit layer can re-price the
                # decision at the batch size serving actually observed
                "fused_marginal_us": cand.cost_us,
                "fused_overhead_us": cand.overhead_us,
                "fused": fused_us <= unfused_us}
        report["fused_prefix"] = info
        if not info["fused"]:
            report["decisions"].append(
                f"fused prefix: refused — calibrated {fused_us:.0f}µs vs "
                f"{unfused_us:.0f}µs unfused at batch {n}")
            return
        fop = FusedPrefixOp(stage_ops=tuple(seg))
        fop.cost_us = cand.cost_us
        fop.overhead_us = cand.overhead_us
        fop.pass_rate = cand.pass_rate
        plan.ops[start:mi] = [fop]
        plan.notes.append(f"physical: fused prefix ({len(seg)} ops -> 1 "
                          "device pass)")
        report["decisions"].append(
            f"fused prefix: {'+'.join(o.name for o in seg)} -> one device "
            f"pass — calibrated {fused_us:.0f}µs vs {unfused_us:.0f}µs "
            f"unfused at batch {n} (gate signature included for free)")


def _chain_cost_us(ops: List[Any], n: int) -> float:
    """Expected chain wall time at batch size ``n`` under the calibrated
    ``T = overhead + marginal·rows`` model, rows shrinking by each op's
    measured survivor fraction."""
    rows, total = float(n), 0.0
    for op in ops:
        total += max(op.overhead_us, 0.0) + max(op.cost_us, 0.0) * rows
        rows *= min(max(op.pass_rate, 0.0), 1.0)
    return total
