"""Semantic query optimization — the paper's new optimization phase.

Counterpart of ``repro/core/semantic.py``; numpy and the port's operators
only, decisions identical to the reference's on the same sample.

Three-stage procedure (Figure 3), with an *empirical validation* loop:

  (1) World-knowledge extraction: measure the stream sample (per-region
      frame-diff activity, active-region bbox, empty-frame fraction, object
      dwell times) and combine with query metadata into a symbolic
      ``SceneKnowledge`` — the reasoning context a human expert (or the
      paper's LLM agent) would build.
  (2) Operator selection: instantiate data-reduction operators from the
      catalog whose semantic preconditions hold (Skip/Crop/Downscale;
      Greyscale is *rejected* whenever the query needs color — the paper's
      flagship example of semantic reasoning).
  (3) Plan update: insert the operators at dependency-correct points
      (Skip directly after the source; Crop before Downscale).

The reasoning engine here is a deterministic knowledge base over measured
statistics (the container has no LLM); ``SemanticReasoner`` is the documented
plug-point where the paper drops in an MLLM.

Validation: run naive vs. rewritten plan on a held-out sample; while the
query-level accuracy drop exceeds ``tolerance``, back off the most aggressive
operator (downscale factor, then skip amount, then crop) and re-validate —
the self-correcting hypothesize/test/refine loop from §3.2.1.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.catalog import CATALOG
from repro_torch.streaming.operators import (
    CropOp,
    DownscaleOp,
    GreyscaleOp,
    SkipOp,
)
from repro_torch.streaming.plan import Plan


@dataclasses.dataclass
class SceneKnowledge:
    """Symbolic scene representation (stage 1 output)."""

    empty_fraction: float
    active_bbox: Optional[Tuple[int, int, int, int]]   # y0,x0,h,w
    active_area_frac: float
    min_dwell: int                # min consecutive active frames per object
    median_dwell: float
    mean_region_activity: np.ndarray
    metadata: Dict[str, Any]
    facts: List[str] = dataclasses.field(default_factory=list)

    def describe(self) -> str:
        return "\n".join("  - " + f for f in self.facts)


def extract_knowledge(sample_frames: np.ndarray, metadata: Dict[str, Any],
                      regions: Tuple[int, int] = (8, 16),
                      diff_threshold: float = 0.02) -> SceneKnowledge:
    """Stage 1: measure the sample; emit symbolic facts."""
    n, c, h, w = sample_frames.shape
    ry, rx = regions
    rh, rw = h // ry, w // rx
    x = sample_frames.astype(np.float32) / 255.0
    d = np.abs(x[1:] - x[:-1]).mean(axis=1)            # (n-1, h, w)
    dr = d.reshape(n - 1, ry, rh, rx, rw).mean(axis=(2, 4))  # (n-1, ry, rx)

    mean_act = dr.mean(axis=0)                          # (ry, rx)
    frame_active = dr.max(axis=(1, 2)) > diff_threshold
    empty_frac = 1.0 - frame_active.mean()

    # active bbox over regions with meaningful average activity
    act_regions = mean_act > max(diff_threshold * 0.5,
                                 mean_act.mean() + mean_act.std())
    if act_regions.any():
        ys, xs = np.where(act_regions)
        y0, y1 = ys.min() * rh, (ys.max() + 1) * rh
        x0, x1 = xs.min() * rw, (xs.max() + 1) * rw
        # quantize outward to 32px tiles
        y0, x0 = (y0 // 32) * 32, (x0 // 32) * 32
        y1, x1 = min(h, -(-y1 // 32) * 32), min(w, -(-x1 // 32) * 32)
        bbox = (int(y0), int(x0), int(y1 - y0), int(x1 - x0))
        area_frac = (y1 - y0) * (x1 - x0) / (h * w)
    else:
        bbox, area_frac = None, 1.0

    # dwell: lengths of consecutive active runs
    runs, cur = [], 0
    for a in frame_active:
        if a:
            cur += 1
        elif cur:
            runs.append(cur)
            cur = 0
    if cur:
        runs.append(cur)
    min_dwell = int(min(runs)) if runs else 1
    med_dwell = float(np.median(runs)) if runs else 1.0

    facts = [
        f"{empty_frac:.0%} of frames show no activity (empty-road prior)",
        f"activity is confined to bbox {bbox} "
        f"({area_frac:.0%} of the frame)" if bbox else
        "activity spans the whole frame (moving camera?)",
        f"objects dwell >= {min_dwell} frames (median {med_dwell:.0f}) — "
        "temporal continuity bound",
        f"stream metadata: fps={metadata.get('fps')}, "
        f"v_max={metadata.get('v_max_kmh', 'n/a')} km/h, "
        f"scene='{metadata.get('scene', '')}'",
    ]
    return SceneKnowledge(empty_fraction=float(empty_frac), active_bbox=bbox,
                          active_area_frac=float(area_frac),
                          min_dwell=min_dwell, median_dwell=med_dwell,
                          mean_region_activity=mean_act, metadata=metadata,
                          facts=facts)


class SemanticReasoner:
    """Stage 2: operator selection from the catalog.

    Deterministic knowledge-base stand-in for the paper's LLM agent —
    same inputs (SceneKnowledge + query intent), same outputs (a list of
    (operator, rationale) selections and explicit rejections).
    Swap this class for an MLLM-backed reasoner on a connected deployment.
    """

    def select(self, know: SceneKnowledge, query) -> Tuple[List, List[str]]:
        chosen, log = [], []

        # cross-frame reasoning: Skip
        if know.empty_fraction > 0.10 and know.min_dwell >= 3:
            amount = max(1, know.min_dwell // 3)
            chosen.append(SkipOp(amount=amount, condition="no_car",
                                 roi=know.active_bbox))
            log.append(
                f"SELECT Skip({amount}, no_car): {know.empty_fraction:.0%} "
                f"empty frames; objects dwell >= {know.min_dwell} frames so "
                f"re-checking every {amount+1} frames cannot miss a pass "
                f"[{CATALOG['skip']['precondition']}]")
        else:
            log.append(
                f"REJECT Skip: empty fraction {know.empty_fraction:.0%} too "
                "low or dwell too short (moving-camera stream)")

        # intra-frame reasoning: Crop
        if know.active_bbox is not None and know.active_area_frac < 0.7:
            chosen.append(CropOp(region=know.active_bbox))
            log.append(
                f"SELECT Crop{know.active_bbox}: activity confined to "
                f"{know.active_area_frac:.0%} of the frame "
                f"[{CATALOG['crop']['precondition']}]")
        else:
            log.append("REJECT Crop: no stable region of interest")

        # Downscale — resolution-sensitive features gate the factor
        if not query.needs_plate:
            chosen.append(DownscaleOp(factor=2))
            log.append(
                "SELECT Downscale(2): query reads "
                + ("color/brand blobs" if query.dataset == "tollbooth"
                   else "coarse motion")
                + ", which survive 2x area pooling "
                f"[{CATALOG['downscale']['precondition']}]")
        else:
            chosen.append(DownscaleOp(factor=2))
            log.append(
                "TENTATIVE Downscale(2): plate glyphs may not survive — "
                "flagged for empirical validation (back off on failure)")

        # Greyscale — the paper's explicit semantic rejection
        if query.needs_color:
            log.append(
                "REJECT Greyscale: the query predicate depends on color — "
                "removing chroma would change query semantics "
                f"[{CATALOG['greyscale']['precondition']}]")
        elif query.dataset == "tollbooth" and not query.needs_color:
            log.append(
                "REJECT Greyscale: downstream extraction (brand/plate) was "
                "trained on RGB statistics; chroma carries contrast")
        return chosen, log


class SemanticOptimizer:
    name = "semantic"

    def __init__(self, tolerance: float = 0.10, sample_frames: int = 256,
                 val_frames: int = 512):
        self.tolerance = tolerance
        self.sample_frames = sample_frames
        self.val_frames = val_frames
        self.reasoner = SemanticReasoner()

    # -- OptimizationPhase adapter (repro_torch.core.phases) -------------
    def run(self, plan: Plan, pctx) -> Tuple[Plan, Dict[str, Any]]:
        return self.optimize(plan, pctx.query, pctx.stream_factory,
                             pctx.run_fn, catalog=pctx.catalog)

    # ------------------------------------------------------------------
    def optimize(self, plan: Plan, query, stream_factory, run_fn,
                 catalog=None) -> Tuple[Plan, Dict[str, Any]]:
        """run_fn(plan, stream, n) -> RunResult; stream_factory(seed).
        ``catalog`` (a CostCatalog) receives the validation runs' wall
        clocks as run-derived model-cost samples."""
        report: Dict[str, Any] = {"phase": "semantic"}

        # (1) world knowledge from a sample
        sample_stream = stream_factory(101)
        frames, _ = sample_stream.batch(self.sample_frames)
        know = extract_knowledge(frames, sample_stream.metadata)
        report["knowledge"] = know.facts

        # (2) operator selection
        chosen, log = self.reasoner.select(know, query)
        report["selection_log"] = log

        # (3) plan update: Skip after source, then Crop, then Downscale
        new = plan.clone()
        order = {SkipOp: 0, CropOp: 1, DownscaleOp: 2, GreyscaleOp: 3}
        for op in sorted(chosen, key=lambda o: order[type(o)], reverse=True):
            new.insert_after_source(op, note=f"semantic: +{op.name}")

        # (4) empirical validation loop (self-correcting rewrites)
        def validated_run(p):
            res = run_fn(p, stream_factory(202), self.val_frames)
            if catalog is not None:
                catalog.record_run(p.ops, res.wall_s, res.mllm_frames)
            return res

        naive_acc = query.evaluate(validated_run(plan))
        attempts = []
        for round_i in range(4):
            acc = query.evaluate(validated_run(new))
            attempts.append({"plan": new.describe(), "accuracy": acc})
            if acc >= naive_acc - self.tolerance:
                break
            backed_off = self._back_off(new)
            report.setdefault("backoffs", []).append(backed_off)
            if backed_off is None:
                break
        report["naive_accuracy"] = naive_acc
        report["validation"] = attempts
        return new, report

    def _back_off(self, plan: Plan) -> Optional[str]:
        """Weaken the most aggressive reduction, strongest first."""
        i = plan.index_of(DownscaleOp)
        if i is not None:
            op = plan.ops[i]
            if op.factor > 2:
                op.factor //= 2
                return f"downscale factor -> {op.factor}"
            plan.ops.pop(i)
            return "removed downscale"
        i = plan.index_of(SkipOp)
        if i is not None:
            op = plan.ops[i]
            if op.amount > 1:
                op.amount //= 2
                return f"skip amount -> {op.amount}"
            plan.ops.pop(i)
            return "removed skip"
        i = plan.index_of(CropOp)
        if i is not None:
            plan.ops.pop(i)
            return "removed crop"
        return None
