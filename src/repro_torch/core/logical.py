"""Logical optimization — relational rewrites mapped to multimodal operators.

Counterpart of ``repro/core/logical.py``.

Following §3.2.2's three steps:
  (1) Data-model reconciliation: an image is a relation
      (row_id, col_id, r, g, b) with (row_id, col_id) as the composite key.
  (2) Operation mapping:  Crop ≙ selection on the key / projection,
      Downscale ≙ group-by-aggregate, Greyscale ≙ projection,
      MLLM-Extract ≙ expensive UDF, attribute Filter ≙ selection.
  (3) Optimization-rule mapping, cost-gated:
      R1 predicate split + pushdown  — a conjunctive filter with a cheaply
         approximable conjunct (color) splits; the cheap half becomes a
         pixel-statistics filter *before* the MLLM UDF.
      R2 projection pushdown        — Crop commutes before Downscale
         (select-before-aggregate): same output, fewer pixels aggregated.
      R3 operator fusion            — adjacent Crop/Downscale/Greyscale
         collapse into FusedPreprocessOp (one pass over device memory:
         the ``fused_preprocess`` CUDA kernel).

The cost model is *measured*: each candidate operator is timed per-frame on
a sample batch, and a pushdown is applied only when
    cost(cheap_filter) < (1 - selectivity) · cost(downstream MLLM)
— the paper's warning that an expensive early filter can increase cost.
R1 is therefore decided by timings and may differ between runs and
devices; R2 and R3 are deterministic.
"""
from __future__ import annotations

import time
from typing import Any, Dict, Tuple

import numpy as np

from repro_torch.streaming.operators import (
    CheapColorFilterOp,
    CropOp,
    DownscaleOp,
    FusedPreprocessOp,
    GreyscaleOp,
    MLLMExtractOp,
    OpContext,
)
from repro_torch.streaming.plan import Plan

RECONCILIATION = (
    "image(frame_id) ≅ relation pixels(row_id, col_id, r, g, b) "
    "with key (row_id, col_id); "
    "Crop ≅ σ_{y0<=row<y1 ∧ x0<=col<x1}; Downscale(f) ≅ "
    "γ_{row/f, col/f; avg(r),avg(g),avg(b)}; Greyscale ≅ π_{lum(r,g,b)}; "
    "MLLM-Extract ≅ expensive UDF; attribute Filter ≅ σ over UDF output"
)


def _time_op(op, frames: np.ndarray, ctx: OpContext, reps: int = 3,
             catalog=None) -> float:
    """Measured µs/frame for one operator on a sample batch; the sample
    flows into ``catalog`` (a CostCatalog) when one is given."""
    batch = {"frames": frames, "idx": np.arange(frames.shape[0])}
    op.open(ctx)
    op.process(dict(batch))  # warmup: one-time set-up (kernel builds)
    t0 = time.perf_counter()
    for _ in range(reps):
        op.process(dict(batch))
    dt = (time.perf_counter() - t0) / reps
    us = dt / frames.shape[0] * 1e6
    if catalog is not None:
        # average cost (overhead folded in): a coarse estimate — the
        # calibration pass's decomposed marginal+overhead fit outranks it
        catalog.record_op(op, us, direct=False)
    return us


class LogicalOptimizer:
    name = "logical"

    def __init__(self, ctx: OpContext):
        self.ctx = ctx

    # -- OptimizationPhase adapter (repro_torch.core.phases) -------------
    def run(self, plan: Plan, pctx) -> Tuple[Plan, Dict[str, Any]]:
        return self.optimize(plan, pctx.query, pctx.sample_frames(),
                             catalog=pctx.catalog)

    def optimize(self, plan: Plan, query, sample_frames: np.ndarray,
                 catalog=None) -> Tuple[Plan, Dict[str, Any]]:
        report: Dict[str, Any] = {"phase": "logical",
                                  "reconciliation": RECONCILIATION,
                                  "rules": []}
        new = plan.clone()

        # R2: projection pushdown — Crop before Downscale
        ci, di = new.index_of(CropOp), new.index_of(DownscaleOp)
        if ci is not None and di is not None and di < ci:
            op = new.ops.pop(ci)
            new.ops.insert(di, op)
            report["rules"].append(
                "R2 projection-pushdown: moved Crop before Downscale "
                "(σ-before-γ: aggregate fewer pixels)")

        # R1: predicate split + cheap-filter pushdown (cost-gated)
        if query.filter_color is not None:
            mi = new.index_of(MLLMExtractOp)
            crop_op = new.ops[new.index_of(CropOp)] if \
                new.index_of(CropOp) is not None else None
            cheap = CheapColorFilterOp(color=query.filter_color,
                                       min_frac=0.008)
            # measure costs on the sample (post-reduction frame sizes approx)
            mllm_op = new.ops[mi]
            cheap_cost = _time_op(cheap, sample_frames[:8], self.ctx,
                                  catalog=catalog)
            mllm_cost = _time_op(MLLMExtractOp(tasks=mllm_op.tasks,
                                               model=mllm_op.model),
                                 _shrink(sample_frames[:8]), self.ctx,
                                 catalog=catalog)
            # selectivity of the color predicate measured on the sample
            cheap.open(self.ctx)
            test = cheap.process({"frames": sample_frames,
                                  "idx": np.arange(sample_frames.shape[0])})
            selectivity = len(test["idx"]) / sample_frames.shape[0]
            saving = (1 - selectivity) * mllm_cost
            if cheap_cost < saving:
                new.insert_before(MLLMExtractOp, cheap,
                                  note="logical: predicate split + pushdown")
                report["rules"].append(
                    f"R1 predicate-split: σ(color={query.filter_color} ∧ "
                    f"plate…) splits; cheap color filter pushed before the "
                    f"MLLM UDF (cost {cheap_cost:.0f}µs/frame < saving "
                    f"{saving:.0f}µs/frame at selectivity "
                    f"{selectivity:.0%})")
            else:
                report["rules"].append(
                    f"R1 rejected by cost model: cheap filter "
                    f"{cheap_cost:.0f}µs/frame >= expected saving "
                    f"{saving:.0f}µs/frame")

        # R3: fuse the preprocessing chain into one kernel pass
        fused = self._fuse_preprocess(new, report)

        return fused, report

    def _fuse_preprocess(self, plan: Plan, report) -> Plan:
        ops = plan.ops
        idxs = [i for i, op in enumerate(ops)
                if isinstance(op, (CropOp, DownscaleOp, GreyscaleOp))]
        if not idxs:
            return plan
        # collapse a contiguous run of preprocessing ops
        first = idxs[0]
        crop, factor, grey = None, 1, False
        run = []
        for i in idxs:
            if i != first + len(run):
                break
            run.append(i)
            op = ops[i]
            if isinstance(op, CropOp):
                crop = op.region
            elif isinstance(op, DownscaleOp):
                factor *= op.factor
            elif isinstance(op, GreyscaleOp):
                grey = True
        if len(run) < 2 and factor == 1 and not grey:
            return plan
        fused = FusedPreprocessOp(
            crop=crop if crop is not None else (0, 0) + (
                self.ctx.frame_shape[1], self.ctx.frame_shape[2]),
            factor=factor, grey=grey)
        for i in reversed(run):
            plan.ops.pop(i)
        plan.ops.insert(first, fused)
        report["rules"].append(
            f"R3 fusion: {len(run)} preprocessing ops -> {fused.name} "
            "(single pass over device memory: the fused_preprocess kernel)")
        plan.notes.append("logical: fused preprocessing")
        return plan


def _shrink(frames: np.ndarray) -> np.ndarray:
    """Approximate post-reduction MLLM input for cost measurement."""
    x = frames[:, :, 64:, :].astype(np.float32)
    b, c, h, w = x.shape
    x = x.reshape(b, c, h // 2, 2, w // 2, 2).mean(axis=(3, 5))
    return ((x / 255.0 - 0.5) / 0.25).astype(np.float32)
