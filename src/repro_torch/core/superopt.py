"""Saṃsāra: the super-optimizer orchestrator.

Counterpart of ``repro/core/superopt.py``.  Spends large *offline* effort
specializing one long-running query to one stream: semantic -> logical ->
physical, each phase validated empirically, producing an
``OptimizationReport`` whose artifacts (knowledge facts, selection log,
rewrite rules, model-selection table) are the inspectable equivalent of
the paper's Figures 2-4.

Phases are driven through the common ``OptimizationPhase`` interface
(``repro_torch.core.phases``): each phase's wall clock is timed here, every
measurement the phases take flows into a shared ``CostCatalog``, and a
final calibration pass stamps the optimized plan's operators with measured
``cost_us``/``pass_rate``.

The reference's observability spans and gauges around each phase reduce to
nothing here: the port has no copy of ``repro.obs`` yet, so they wait for
its slice.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.core.costs import CostCatalog, op_cost_key
from repro_torch.core.logical import LogicalOptimizer
from repro_torch.core.phases import OptimizationPhase, PhaseContext
from repro_torch.core.physical import PhysicalOptimizer
from repro_torch.core.semantic import SemanticOptimizer
from repro_torch.streaming.operators import OpContext
from repro_torch.streaming.plan import Plan
from repro_torch.streaming.runtime import StreamRuntime


@dataclasses.dataclass
class OptimizationReport:
    query: str
    naive_plan: str
    phases: List[Dict[str, Any]]
    final_plan: str
    #: wall-clock seconds spent inside each phase, keyed by phase name
    phase_wall_s: Dict[str, float] = dataclasses.field(default_factory=dict)
    #: calibrated per-op timings for the final plan (one row per op:
    #: name, catalog key, measured µs/frame, survivor fraction)
    op_timings: List[Dict[str, Any]] = dataclasses.field(default_factory=list)

    def describe(self) -> str:
        lines = [f"=== Saṃsāra optimization report: {self.query} ===",
                 f"naive:  {self.naive_plan}"]
        for ph in self.phases:
            wall = self.phase_wall_s.get(ph.get("phase", ""), None)
            head = f"--- phase: {ph['phase']}" + \
                (f" ({wall:.2f}s) ---" if wall is not None else " ---")
            lines.append(head)
            for key in ("knowledge", "selection_log", "rules", "decisions"):
                for item in ph.get(key, []):
                    lines.append(f"  {item}")
            if "model_selection" in ph:
                lines.append(f"  model selection: {ph['model_selection']}")
            if "validation" in ph:
                for att in ph["validation"]:
                    lines.append(f"  validate: acc={att['accuracy']:.3f} "
                                 f"{att['plan']}")
        lines.append(f"final:  {self.final_plan}")
        for row in self.op_timings:
            lines.append(f"  calibrated: {row['op']:<40s} "
                         f"{row['us']:>10.1f}µs/frame  "
                         f"pass={row['pass_rate']:.2f}")
        return "\n".join(lines)

    def to_rows(self) -> List[Dict[str, Any]]:
        """Structured rows: phase walls and calibrated op timings."""
        rows = [{"kind": "phase_wall", "query": self.query,
                 "phase": ph, "wall_s": w}
                for ph, w in self.phase_wall_s.items()]
        rows += [{"kind": "op_timing", "query": self.query, **row}
                 for row in self.op_timings]
        return rows


class SuperOptimizer:
    def __init__(self, ctx: OpContext, tolerance: float = 0.10,
                 min_rel_accuracy: float = 0.90, micro_batch: int = 16,
                 val_frames: int = 512,
                 catalog: Optional[CostCatalog] = None):
        self.ctx = ctx
        self.micro_batch = micro_batch
        self.val_frames = val_frames
        #: shared measurement sink: pass one catalog across queries to
        #: accumulate a workload-wide cost model
        self.catalog = catalog if catalog is not None else CostCatalog()
        self.semantic = SemanticOptimizer(tolerance=tolerance,
                                          val_frames=val_frames)
        self.logical = LogicalOptimizer(ctx)
        self.physical = PhysicalOptimizer(ctx,
                                          min_rel_accuracy=min_rel_accuracy)
        #: the phase registry, every entry an OptimizationPhase
        self.phase_registry: Dict[str, OptimizationPhase] = {
            p.name: p for p in (self.semantic, self.logical, self.physical)}

    # ------------------------------------------------------------------
    def _run(self, plan: Plan, stream, n: int):
        rt = StreamRuntime(plan, self.ctx, micro_batch=self.micro_batch)
        return rt.run(stream, n)

    def optimize(self, query, stream_factory,
                 phases: Tuple[str, ...] = ("semantic", "logical",
                                            "physical"),
                 calibrate: bool = True
                 ) -> Tuple[Plan, OptimizationReport]:
        plan = query.naive_plan()
        pctx = PhaseContext(query=query, stream_factory=stream_factory,
                            run_fn=self._run, val_frames=self.val_frames,
                            catalog=self.catalog)
        report_phases: List[Dict[str, Any]] = []
        phase_wall_s: Dict[str, float] = {}
        naive_desc = plan.describe()

        for name in phases:
            phase = self.phase_registry[name]
            t0 = time.perf_counter()
            plan, rep = phase.run(plan, pctx)
            phase_wall_s[name] = time.perf_counter() - t0
            report_phases.append(rep)

        op_timings: List[Dict[str, Any]] = []
        if calibrate:
            t0 = time.perf_counter()
            op_timings = self.calibrate(plan, pctx)
            phase_wall_s["calibration"] = time.perf_counter() - t0

        report = OptimizationReport(
            query=query.qid, naive_plan=naive_desc,
            phases=report_phases, final_plan=plan.describe(),
            phase_wall_s=phase_wall_s, op_timings=op_timings)
        return plan, report

    def calibrate(self, plan: Plan, pctx: PhaseContext
                  ) -> List[Dict[str, Any]]:
        """Measure every op of ``plan`` on its actual chain input, stamping
        ``cost_us``/``pass_rate`` in place; returns the timing rows."""
        self.catalog.calibrate_chain(plan.ops, pctx.sample_frames(),
                                     self.ctx)
        self.catalog.stamp(plan.ops)        # chains cut short by a filter
        return [{"op": op.name, "key": op_cost_key(op), "us": op.cost_us,
                 "pass_rate": op.pass_rate} for op in plan.ops
                if op.cost_us >= 0]
