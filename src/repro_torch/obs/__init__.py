"""Observability: frame-lifecycle tracing, metrics, SLO accounting.

Counterpart of ``repro/obs/``, a copy of its own (the port imports nothing
of the JAX package).  ``Observability`` bundles a ``Tracer`` (ring-buffer
span recording, Perfetto-exportable), a ``Metrics`` registry (counters,
gauges, log-binned histograms with p50/p95/p99) and an ``SLOTracker``
(per-feed frame latency, staleness, violation budget) behind one object
threaded through ``OpContext.obs``.

The default everywhere is ``NULL_OBS``: ``enabled`` is False, the tracer
is the no-op ``NullTracer``, and every instrumented call site guards its
clock reads with ``if obs.enabled:``, so un-observed runs pay only empty
attribute checks and stay bitwise identical to uninstrumented ones
(``tests/test_torch_obs.py``).  Spans read the host clock; nothing here
synchronizes the card.

Usage::

    obs = Observability()                       # tracing + metrics + SLO
    ctx = dataclasses.replace(ctx, obs=obs)
    MultiQueryRuntime(plans, ctx).run(stream, 256)
    print(obs.slo.table())
    obs.tracer.export_chrome("build/trace.json")   # open in Perfetto

The canonical span phases (the ``cat`` field of every span):

    ingest -> prefix -> gate -> queue -> staging -> dispatch
           -> forward -> resume -> tail
"""
from __future__ import annotations

import time
from typing import Optional

from repro_torch.obs.audit import PlanAudit, forward_gap
from repro_torch.obs.metrics import Counter, Gauge, Histogram, Metrics
from repro_torch.obs.report import write_flight_report
from repro_torch.obs.slo import SLOTracker
from repro_torch.obs.tracer import NULL_TRACER, NullTracer, Tracer

#: the span categories instrumented across the serving stack, in
#: lifecycle order (export sanity checks assert against this list)
PHASES = ("ingest", "prefix", "gate", "queue", "staging", "dispatch",
          "forward", "resume", "tail")

#: the additional categories the fault-tolerance tier emits (instants,
#: not lifecycle spans): injected faults and retries, circuit-breaker
#: trips/probes/recoveries, degraded-mode serving — kept out of PHASES
#: so a fault-free trace still covers exactly the lifecycle categories
FAULT_PHASES = ("fault", "retry", "quarantine", "degraded")


class Observability:
    """Tracer + metrics + SLO tracker, one handle (see module docs)."""

    enabled = True

    def __init__(self, tracer: Optional[NullTracer] = None,
                 metrics: Optional[Metrics] = None,
                 capacity: int = 65536, slo_target_ms: float = 100.0):
        self.tracer = tracer if tracer is not None \
            else Tracer(capacity=capacity)
        self.metrics = metrics if metrics is not None else Metrics()
        self.slo = SLOTracker(self.metrics, target_ms=slo_target_ms)

    def now(self) -> int:
        """Monotonic ns stamp for lifecycle accounting (real even when
        the tracer is a ``NullTracer`` — latency histograms don't require
        span recording)."""
        return time.perf_counter_ns()


class _NullObservability(Observability):
    """The inert default: ``enabled`` False, no clock reads, no state.

    One process-wide instance (``NULL_OBS``) backs every un-observed
    context; its metrics registry exists (cold-path readers need not
    null-check) but instrumented hot paths skip it entirely."""

    enabled = False

    def __init__(self) -> None:
        super().__init__(tracer=NULL_TRACER)

    def now(self) -> int:
        return 0


NULL_OBS = _NullObservability()


def resolve_obs(*candidates) -> Observability:
    """First non-None observability among ``candidates``, else NULL_OBS —
    the one lookup rule every component uses (explicit arg outranks
    context, context outranks the inert default)."""
    for c in candidates:
        if c is not None:
            return c
    return NULL_OBS

__all__ = [
    "Counter", "Gauge", "Histogram", "Metrics", "NULL_OBS", "NULL_TRACER",
    "NullTracer", "Observability", "PHASES", "FAULT_PHASES", "PlanAudit",
    "SLOTracker", "Tracer", "forward_gap", "resolve_obs", "write_flight_report",
]
