"""Optimizer audit loop: predicted-vs-measured cost reconciliation.

Counterpart of ``repro/obs/audit.py``.  The planner stack
(``SharingTreePlanner``, ``FleetOptimizer``) decides share-vs-solo from a
``CostCatalog`` calibrated offline; ``PlanAudit`` checks whether the
predicted savings were realized:

  * it holds the planner's recorded decisions: per-feed sharing forests
    (each ``SharingGroup`` carries the predicted shared / independent
    per-frame cost that justified it) and, when available, the per-query
    ``OptimizationReport``'s fused-prefix verdicts;
  * ``verify_predictions()`` re-derives every group's predicted cost
    through the same ``chain_cost_us`` model the planner used;
  * ``measured_costs(metrics)`` joins the serving run's measured
    surfaces (``op_wall_us/<key>`` + ``op_frames/<key>`` +
    ``op_rows_out/<key>`` from the prefix executor and the
    device-probed ``forward_device_ms/<variant>`` histograms from the
    extract server) into catalog-keyed marginal-cost/pass-rate
    measurements;
  * ``rows(metrics)`` prices each decision both ways into a per-decision
    table: predicted saving, realized saving, drift ratio, and a flag
    when realized cost exceeds prediction beyond ``tolerance``;
  * ``reconcile(metrics, catalog)`` EMA-feeds the measurements back into
    the catalog (``CostCatalog.reconcile``).

``forward_gap`` reads the device-probed forward time against the
observed one.  Everything of ``repro_torch`` outside ``repro_torch.obs``
is imported lazily: the scheduler and core layers import this package at
module scope, and a top-level import back into them would cycle.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional


def _hist_totals(metrics) -> Dict[str, Dict[str, float]]:
    """Histogram name → {sum, count} and counter name → value, read off
    the registry's reporting surface (no private attribute reach-ins)."""
    hists: Dict[str, Dict[str, float]] = {}
    counters: Dict[str, float] = {}
    for r in metrics.to_rows():
        if r["kind"] == "histogram":
            hists[r["name"]] = {"sum": r["mean"] * r["count"],
                                "count": r["count"]}
        elif r["kind"] == "counter":
            counters[r["name"]] = r["value"]
    return {"hists": hists, "counters": counters}


def forward_gap(metrics) -> Optional[Dict[str, float]]:
    """Device-vs-observed forward gap: how much of the recorded
    ``forward_ms`` (launch → *observed* completion, poll-quantized) is
    actually poll latency rather than device time, per the sampled
    ``forward_device_ms`` probes.  None until both surfaces have data."""
    obs_h = metrics.histogram("forward_ms")
    dev_h = metrics.histogram("forward_device_ms")
    if not obs_h.count or not dev_h.count:
        return None
    observed = obs_h.mean()
    device = dev_h.mean()
    return {
        "observed_ms": observed,
        "device_ms": device,
        "gap_ms": observed - device,
        "gap_frac": (observed - device) / observed if observed else 0.0,
        "probes": dev_h.count,
        "forwards": obs_h.count,
    }


class PlanAudit:
    """Join planner decisions against serving-time measurements.

    ``forests`` maps feed name → ``SharingForest`` (a single forest is
    also accepted); ``reports`` optionally maps query id →
    ``OptimizationReport`` for fused-prefix decision rows.  The pricing
    parameters (``catalog``, ``micro_batch``, ``gate_hit_rate``) must be
    the ones the planner decided with — ``from_runtime`` /
    ``from_fleet`` capture them for you."""

    def __init__(self, forests: Any, reports: Optional[Dict] = None,
                 catalog=None, micro_batch: int = 16,
                 gate_hit_rate: float = 0.0, tolerance: float = 0.5):
        if hasattr(forests, "streams"):       # a bare SharingForest
            forests = {"": forests}
        self.forests: Dict[str, Any] = dict(forests)
        self.reports = dict(reports) if reports else {}
        self.catalog = catalog
        self.micro_batch = micro_batch
        self.gate_hit_rate = gate_hit_rate
        self.tolerance = tolerance

    # -- constructors ---------------------------------------------------
    @classmethod
    def from_runtime(cls, runtime, tolerance: float = 0.5) -> "PlanAudit":
        """Audit a live ``MultiStreamRuntime``: its forests, priced with
        its planner's catalog / micro-batch / gate-hit-rate."""
        planner = runtime.planner
        return cls(runtime.forests,
                   catalog=getattr(planner, "catalog", None),
                   micro_batch=getattr(planner, "micro_batch", 16),
                   gate_hit_rate=getattr(planner, "gate_hit_rate", 0.0),
                   tolerance=tolerance)

    @classmethod
    def from_fleet(cls, fleet, tolerance: float = 0.5) -> "PlanAudit":
        """Audit a ``FleetResult``: its per-feed forests plus the solo
        optimization reports (fused-prefix decisions ride along)."""
        return cls(fleet.forests, reports=fleet.reports,
                   catalog=fleet.catalog, tolerance=tolerance)

    # -- predicted side -------------------------------------------------
    def _predict_group(self, group) -> Dict[str, float]:
        """Re-price one sharing group exactly as ``SharingTreePlanner.
        _group`` did — same cost function, same parameters."""
        from repro_torch.scheduler.sharing_tree import chain_cost_us, chain_reach
        exe = group.execution
        h = self.gate_hit_rate
        p_reach = chain_reach(exe.prefix, self.catalog)
        shared = chain_cost_us(exe.prefix, self.catalog, self.micro_batch,
                               gate_hit_rate=h) \
            + sum(chain_cost_us(tail, self.catalog, self.micro_batch,
                                reach=p_reach, gate_hit_rate=h)
                  for tail in exe.tails)
        # the independent side was priced over the original *member
        # plans*; a factored group's member chains are prefix + tail,
        # which the factorization preserves op-for-op
        indep = sum(chain_cost_us(list(exe.prefix) + list(tail),
                                  self.catalog, self.micro_batch,
                                  gate_hit_rate=h)
                    for tail in exe.tails)
        return {"shared": shared, "indep": indep}

    def verify_predictions(self) -> float:
        """Max relative error between each group's stored predicted cost
        and this audit's re-derivation — ~0 when the audit prices plans
        identically to the planner (the trust precondition; nonzero
        means the catalog mutated since planning and the stored
        prediction is stale)."""
        worst = 0.0
        for forest in self.forests.values():
            for g in forest.groups():
                p = self._predict_group(g)
                for stored, derived in ((g.shared_cost_us, p["shared"]),
                                        (g.indep_cost_us, p["indep"])):
                    if stored:
                        worst = max(worst,
                                    abs(stored - derived) / abs(stored))
                    elif derived:
                        worst = max(worst, 1.0)
        return worst

    # -- measured side --------------------------------------------------
    def measured_costs(self, metrics) -> Dict[str, Dict[str, float]]:
        """Catalog-keyed serving measurements, ready for
        ``CostCatalog.reconcile``: marginal µs/frame (and survivor
        fraction where countable) per op key.

        Prefix ops: ``op_wall_us/<key>`` per-invocation walls over
        ``op_frames/<key>`` input frames (→ marginal), with
        ``op_rows_out/<key>`` survivors (→ pass rate).  Extracts: the
        device-probed ``forward_device_ms/<variant>`` over
        ``forward_device_frames/<variant>`` — device-accurate, not the
        poll-quantized observed span."""
        t = _hist_totals(metrics)
        hists, counters = t["hists"], t["counters"]
        measured: Dict[str, Dict[str, float]] = {}
        for name, h in hists.items():
            if name.startswith("op_wall_us/"):
                key = name[len("op_wall_us/"):]
                frames = counters.get(f"op_frames/{key}", 0)
                if frames <= 0 or h["count"] <= 0:
                    continue
                m: Dict[str, float] = {"us": h["sum"] / frames,
                                       "frames": frames}
                rows_out = counters.get(f"op_rows_out/{key}")
                if rows_out is not None:
                    m["pass_rate"] = min(1.0, rows_out / frames)
                measured[key] = m
            elif name.startswith("forward_device_ms/"):
                variant = name[len("forward_device_ms/"):]
                frames = counters.get(
                    f"forward_device_frames/{variant}", 0)
                if frames <= 0 or h["count"] <= 0:
                    continue
                measured[f"mllm[{variant}]"] = {
                    "us": h["sum"] * 1e3 / frames, "frames": frames}
        return measured

    def _measured_chain(self, ops, measured: Dict[str, Dict[str, float]],
                        reach: float = 1.0) -> float:
        """``chain_cost_us`` with measured marginals/pass-rates patched
        in wherever the run produced them (predicted values fill the
        gaps, so a partially-measured chain still prices end to end)."""
        from repro_torch.core.costs import op_cost_key
        from repro_torch.scheduler.sharing_tree import (
            op_cost_us,
            op_overhead_us,
            op_pass_rate,
        )
        from repro_torch.streaming.operators import MLLMExtractOp
        discount = 1.0 - min(max(self.gate_hit_rate, 0.0), 1.0)
        total = 0.0
        for op in ops:
            m = measured.get(op_cost_key(op))
            us = m["us"] if m is not None else op_cost_us(op, self.catalog)
            if discount < 1.0 and isinstance(op, MLLMExtractOp) \
                    and m is None:
                # measured extract cost already reflects gating (cached
                # frames never reached the device) — only the predicted
                # fallback still needs the discount
                us *= discount
            total += reach * us
            over = op_overhead_us(op, self.catalog)
            if over > 0.0:
                mb = reach * self.micro_batch
                total += over * min(1.0, mb) / self.micro_batch
            pr = m.get("pass_rate") if m is not None else None
            reach *= pr if pr is not None else op_pass_rate(
                op, self.catalog)
        return total

    # -- the per-decision table -----------------------------------------
    def rows(self, metrics=None) -> List[Dict[str, Any]]:
        """One row per planner decision.  Sharing rows always; with
        ``metrics`` the measured side and drift join in; fused-prefix
        rows when optimization reports were supplied."""
        from repro_torch.scheduler.sharing_tree import chain_reach
        measured = self.measured_costs(metrics) \
            if metrics is not None else {}
        rows: List[Dict[str, Any]] = []
        for feed, forest in sorted(self.forests.items()):
            for g in forest.groups():
                exe = g.execution
                row: Dict[str, Any] = {
                    "kind": "share" if g.is_shared else "solo",
                    "feed": feed,
                    "decision": "+".join(exe.queries),
                    "n_queries": len(exe.queries),
                    "predicted_shared_us": g.shared_cost_us,
                    "predicted_indep_us": g.indep_cost_us,
                    "predicted_saving_us": g.saving_us,
                }
                if measured:
                    p_reach = chain_reach(exe.prefix, self.catalog)
                    m_shared = self._measured_chain(exe.prefix, measured) \
                        + sum(self._measured_chain(t, measured,
                                                   reach=p_reach)
                              for t in exe.tails)
                    m_indep = sum(
                        self._measured_chain(
                            list(exe.prefix) + list(t), measured)
                        for t in exe.tails)
                    drift = m_shared / g.shared_cost_us \
                        if g.shared_cost_us else 1.0
                    row.update({
                        "measured_shared_us": m_shared,
                        "measured_indep_us": m_indep,
                        "realized_saving_us": m_indep - m_shared,
                        "drift": drift,
                        "flagged": drift > 1.0 + self.tolerance,
                    })
                rows.append(row)
        rows.extend(self._fusion_rows(measured))
        return rows

    def _fusion_rows(self, measured: Dict[str, Dict[str, float]]
                     ) -> List[Dict[str, Any]]:
        fused_seen = set()
        rows: List[Dict[str, Any]] = []
        for qid, report in sorted(self.reports.items()):
            for phase in getattr(report, "phases", []):
                info = phase.get("fused_prefix") if isinstance(phase, dict) \
                    else None
                if not info or "fused_us" not in info:
                    continue
                seg = tuple(info.get("segment", ()))
                if seg in fused_seen:
                    continue          # one row per distinct fused segment
                fused_seen.add(seg)
                row = {
                    "kind": "fuse" if info["fused"] else "unfuse",
                    "feed": "",
                    "decision": "+".join(seg) or qid,
                    "n_queries": 1,
                    "predicted_shared_us": info["fused_us"],
                    "predicted_indep_us": info["unfused_us"],
                    "predicted_saving_us":
                        info["unfused_us"] - info["fused_us"],
                }
                m = measured.get("FusedPrefixOp")
                if m is not None and info["fused"] and \
                        info.get("fused_marginal_us") is not None:
                    n = info["batch"]
                    predicted = info.get("fused_overhead_us", 0.0) \
                        + info["fused_marginal_us"] * n
                    realized = m["us"] * n
                    drift = realized / predicted if predicted else 1.0
                    row.update({
                        "measured_shared_us": realized,
                        "drift": drift,
                        "flagged": drift > 1.0 + self.tolerance,
                    })
                rows.append(row)
        return rows

    # -- reconciliation --------------------------------------------------
    def reconcile(self, metrics, catalog=None) -> List[str]:
        """Feed the run's measurements back into the catalog (EMA, like
        gate hit rates); returns the drift-flagged keys."""
        catalog = catalog if catalog is not None else self.catalog
        if catalog is None or not hasattr(catalog, "reconcile"):
            return []
        measured = self.measured_costs(metrics)
        if not measured:
            return []
        return catalog.reconcile(measured, tolerance=self.tolerance)

    # -- rendering --------------------------------------------------------
    def table(self, metrics=None) -> str:
        """The per-decision audit table (what flight report embeds)."""
        rows = self.rows(metrics)
        head = (f"{'kind':<6} {'feed':<10} {'decision':<28} "
                f"{'pred shared':>12} {'pred indep':>11} {'pred save':>10} "
                f"{'real save':>10} {'drift':>6} {'flag':>4}")
        lines = [head, "-" * len(head)]
        for r in rows:
            dec = r["decision"]
            if len(dec) > 28:
                dec = dec[:25] + "..."
            real = r.get("realized_saving_us")
            lines.append(
                f"{r['kind']:<6} {r['feed']:<10} {dec:<28} "
                f"{r['predicted_shared_us']:>10.0f}µs "
                f"{r['predicted_indep_us']:>9.0f}µs "
                f"{r['predicted_saving_us']:>8.0f}µs "
                + (f"{real:>8.0f}µs " if real is not None
                   else f"{'—':>10} ")
                + f"{r.get('drift', 1.0):>5.2f}x "
                + ("FLAG" if r.get("flagged") else "  ok"))
        return "\n".join(lines)
