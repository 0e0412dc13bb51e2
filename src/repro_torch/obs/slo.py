"""Per-feed SLO accounting: frame latency, staleness, violation budget.

Counterpart of ``repro/obs/slo.py``.

The serving claim the paper stakes out is *latency under load*, not just
throughput: a query's answers are worthless if they arrive long after
the frames they describe.  ``SLOTracker`` gives each feed:

  * **frame latency** — emit − ingest of the frame's own micro-batch:
    the time a frame spends inside the serving stack (prefix ops, gate
    consult, server queue-wait, device forward, resume, tail);
  * **staleness** — emit − newest arrival: how far the feed's freshest
    served answer lags behind its stream head.  Under pipelined serving
    staleness exceeds latency whenever new frames arrive while older
    ones are still in flight — the backlog the per-feed backpressure
    budget bounds;
  * **violations** — emitted frames whose latency exceeded the feed's
    target (one target per tracker; per-feed overrides via
    ``set_target``).

Distributions live in the shared ``Metrics`` registry (histograms
``frame_latency_ms/<feed>`` and ``staleness_ms/<feed>``, counters
``frames_emitted/<feed>`` / ``slo_violations/<feed>``), so the SLO view
is a *reader* of the same registry everything else reports into.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

from repro_torch.obs.metrics import Metrics


class SLOTracker:
    """Per-feed latency/staleness accounting over a ``Metrics`` registry."""

    def __init__(self, metrics: Metrics, target_ms: float = 100.0):
        self.metrics = metrics
        self.target_ms = target_ms
        self._targets: Dict[str, float] = {}
        self._feeds: List[str] = []

    def set_target(self, feed: str, target_ms: float) -> None:
        self._targets[feed] = target_ms

    def target(self, feed: str) -> float:
        return self._targets.get(feed, self.target_ms)

    # -- recording (called at emit) -------------------------------------
    def record(self, feed: str, latency_ms: float,
               staleness_ms: Optional[float] = None, n: int = 1) -> None:
        """Account ``n`` frames emitted with the given latency (ms) and
        optional staleness (ms)."""
        if feed not in self._feeds:
            self._feeds.append(feed)
        m = self.metrics
        m.observe(f"frame_latency_ms/{feed}", latency_ms, n)
        if staleness_ms is not None:
            m.observe(f"staleness_ms/{feed}", staleness_ms, n)
        m.inc(f"frames_emitted/{feed}", n)
        if latency_ms > self.target(feed):
            m.inc(f"slo_violations/{feed}", n)

    def record_degraded(self, feed: str, n: int = 1) -> None:
        """Account ``n`` frames answered in degraded mode — a stale
        keyframe answer served while the feed's circuit was open.  They
        count against availability, not against the latency SLO (a
        marked-stale answer makes no latency promise)."""
        if feed not in self._feeds:
            self._feeds.append(feed)
        self.metrics.inc(f"frames_degraded/{feed}", n)

    def record_dropped(self, feed: str, n: int = 1) -> None:
        """Account ``n`` frames dropped during an outage (no stale
        answer was available) — exact loss accounting."""
        if feed not in self._feeds:
            self._feeds.append(feed)
        self.metrics.inc(f"frames_dropped/{feed}", n)

    # -- reporting ------------------------------------------------------
    def feeds(self) -> List[str]:
        return list(self._feeds)

    def row(self, feed: str) -> Dict[str, Any]:
        m = self.metrics
        lat = m.histogram(f"frame_latency_ms/{feed}")
        stale = m.histogram(f"staleness_ms/{feed}")
        emitted = m.counter(f"frames_emitted/{feed}").value
        viol = m.counter(f"slo_violations/{feed}").value
        degraded = m.counter(f"frames_degraded/{feed}").value
        dropped = m.counter(f"frames_dropped/{feed}").value
        accounted = emitted + degraded + dropped
        return {
            "feed": feed, "frames": emitted,
            "p50_ms": lat.percentile(50), "p95_ms": lat.percentile(95),
            "p99_ms": lat.percentile(99), "mean_ms": lat.mean(),
            "stale_p50_ms": stale.percentile(50),
            "stale_p99_ms": stale.percentile(99),
            "target_ms": self.target(feed), "violations": viol,
            "attainment": 1.0 - viol / emitted if emitted else 1.0,
            # degraded-mode accounting: availability = fully served /
            # everything the feed had to answer for
            "degraded": degraded, "dropped": dropped,
            "availability": emitted / accounted if accounted else 1.0,
        }

    def rows(self) -> List[Dict[str, Any]]:
        return [self.row(f) for f in self._feeds]

    def combined(self) -> Dict[str, Any]:
        """Workload-wide percentiles: one histogram merged across feeds
        (bin-exact — every per-feed histogram shares the binning)."""
        m = self.metrics
        agg = None
        emitted = viol = 0
        for feed in self._feeds:
            h = m.histogram(f"frame_latency_ms/{feed}")
            if agg is None:
                agg = type(h)()
            agg.merge(h)
            emitted += m.counter(f"frames_emitted/{feed}").value
            viol += m.counter(f"slo_violations/{feed}").value
        if agg is None:
            return {"frames": 0, "p50_ms": 0.0, "p95_ms": 0.0,
                    "p99_ms": 0.0, "violations": 0, "attainment": 1.0}
        return {"frames": emitted, "p50_ms": agg.percentile(50),
                "p95_ms": agg.percentile(95), "p99_ms": agg.percentile(99),
                "violations": viol,
                "attainment": 1.0 - viol / emitted if emitted else 1.0}

    def table(self) -> str:
        """The per-feed SLO table."""
        head = (f"{'feed':<12} {'frames':>7} {'p50':>8} {'p95':>8} "
                f"{'p99':>8} {'stale p50':>10} {'stale p99':>10} "
                f"{'target':>7} {'viol':>5} {'attain':>7} "
                f"{'degr':>5} {'drop':>5} {'avail':>7}")
        lines = [head, "-" * len(head)]
        for r in self.rows():
            lines.append(
                f"{r['feed']:<12} {r['frames']:>7d} "
                f"{r['p50_ms']:>7.1f}ms {r['p95_ms']:>7.1f}ms "
                f"{r['p99_ms']:>7.1f}ms {r['stale_p50_ms']:>8.1f}ms "
                f"{r['stale_p99_ms']:>8.1f}ms {r['target_ms']:>6.0f}ms "
                f"{r['violations']:>5d} {r['attainment']:>6.1%} "
                f"{r['degraded']:>5d} {r['dropped']:>5d} "
                f"{r['availability']:>6.1%}")
        c = self.combined()
        lines.append(
            f"{'ALL':<12} {c['frames']:>7d} {c['p50_ms']:>7.1f}ms "
            f"{c['p95_ms']:>7.1f}ms {c['p99_ms']:>7.1f}ms "
            f"{'':>10} {'':>10} {'':>7} {c['violations']:>5d} "
            f"{c['attainment']:>6.1%}")
        return "\n".join(lines)
