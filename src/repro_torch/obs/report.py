"""Flight report: one markdown summary of a serving run's health.

Counterpart of ``repro/obs/report.py``.

``write_flight_report`` renders the run's observability surfaces — the
per-feed SLO table, the optimizer's per-decision audit table with drift
flags, the device-vs-observed forward gap, and headline metrics — into
a single markdown file.  ``audit`` is a ``PlanAudit`` (or any object
with a ``table(metrics)`` method).

Every section is optional (pass None to skip): the report renders
whatever the caller measured, never demands surfaces a given run didn't
produce.
"""
from __future__ import annotations

import os
from typing import Any, Dict, List, Optional


def _code_block(text: str) -> List[str]:
    return ["```", text, "```", ""]


def render_flight_report(title: str = "Serving flight report",
                         slo=None, audit=None, metrics=None,
                         flagged: Optional[List[str]] = None,
                         gap: Optional[Dict[str, Any]] = None,
                         notes: Optional[List[str]] = None) -> str:
    """Render the report body (see ``write_flight_report`` for args)."""
    lines: List[str] = [f"# {title}", ""]
    if notes:
        lines += [f"- {n}" for n in notes] + [""]

    if metrics is not None:
        fps = metrics.gauge("run/fps").value
        wall = metrics.gauge("run/wall_s").value
        forwards = metrics.counter("server/forwards").value
        frames = metrics.counter("server/frames").value
        if fps or wall or forwards:
            lines += ["## Headline", "",
                      f"- wall: {wall:.2f} s, throughput: "
                      f"{fps:.1f} query-frames/s",
                      f"- forwards: {forwards} ({frames} model frames)"]
            dropped = metrics.counter("tracer/dropped_events").value
            if dropped:
                lines.append(f"- **trace truncated**: {dropped} events "
                             "dropped by the tracer ring")
            lines.append("")

    if slo is not None:
        lines += ["## SLO attainment", ""]
        lines += _code_block(slo.table())

    if audit is not None:
        lines += ["## Optimizer audit (predicted vs measured)", ""]
        lines += _code_block(audit.table(metrics))
        if gap is None and metrics is not None:
            from repro_torch.obs.audit import forward_gap
            gap = forward_gap(metrics)

    if gap is not None:
        lines += ["## Forward timing: device vs observed", "",
                  f"- observed (launch → polled completion): "
                  f"{gap['observed_ms']:.2f} ms mean over "
                  f"{gap['forwards']} forwards",
                  f"- device (launch → probed completion): "
                  f"{gap['device_ms']:.2f} ms mean over "
                  f"{gap['probes']} probes",
                  f"- gap: {gap['gap_ms']:.2f} ms "
                  f"({gap['gap_frac']:.0%} of the observed span is poll "
                  "latency, not device time)", ""]

    if flagged is not None:
        lines += ["## Cost-model drift flags", ""]
        if flagged:
            lines += [f"- `{k}`: realized cost drifted beyond tolerance; "
                      "catalog entry EMA-corrected" for k in flagged]
        else:
            lines.append("- none: every reconciled entry was within "
                         "tolerance")
        lines.append("")

    return "\n".join(lines)


def write_flight_report(path: str = "reports/flight_report.md",
                        **kw) -> str:
    """Render and write the flight report; returns the path.

    Keyword args (all optional): ``slo`` (an ``SLOTracker``), ``audit``
    (a ``PlanAudit``), ``metrics`` (the run's ``Metrics`` registry —
    enables the measured audit columns, headline numbers and the forward
    gap), ``flagged`` (drift-flagged catalog keys from ``reconcile``),
    ``gap`` (a ``forward_gap`` dict, derived from ``metrics`` when
    omitted), ``notes`` (free-form bullet lines), ``title``."""
    body = render_flight_report(**kw)
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        f.write(body)
    return path
