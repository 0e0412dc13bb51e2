"""Metrics registry: counters, gauges, log-binned histograms.

Counterpart of ``repro/obs/metrics.py`` (numpy only, a copy of its own).

One ``Metrics`` instance is the serving stack's single accounting
surface: the extract server's stats dict, the semantic gate's
hit/miss/revalidation counters, runtime wall clocks, the optimizer's
per-phase walls and per-feed latency/staleness distributions all land
here (``ingest`` for existing dict-shaped counters, ``observe`` for
samples), so benchmarks and the SLO tracker read one registry instead of
scraping per-component dicts.

``Histogram`` is log-binned (geometric bins, ``bins_per_decade`` per
decade): recording is O(1) — one log, one increment into a fixed int64
array — and quantile extraction (p50/p95/p99) is exact to one bin's
relative width (``10**(1/bins_per_decade)``, ~3.7% at the default 64),
verified against a numpy percentile reference in
``tests/test_torch_obs.py``.

``snapshot()``/``restore()`` round-trip the whole registry (the same
aligned-checkpoint idiom as ``Op.snapshot``): restore drops metrics
created after the snapshot and returns every surviving one to its
recorded state.
"""
from __future__ import annotations

import math
from collections import OrderedDict
from typing import Any, Dict, List, Optional

import numpy as np


class Counter:
    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n

    def set(self, v: int) -> None:
        self.value = v


class Gauge:
    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = v


class Histogram:
    """Log-binned histogram over positive values (unit-agnostic).

    Bins are geometric: bin k covers ``lo * g**k .. lo * g**(k+1)`` with
    ``g = 10**(1/bins_per_decade)``; values below ``lo`` clamp into bin
    0, values above the last edge into the last bin.  Exact count, sum,
    min and max ride alongside, so ``mean()`` is exact and percentiles
    clamp into the observed range."""

    __slots__ = ("lo", "growth", "nbins", "counts", "count", "total",
                 "vmin", "vmax", "_log_g", "_log_lo")

    def __init__(self, bins_per_decade: int = 64, lo: float = 1e-3,
                 decades: int = 15):
        self.lo = lo
        self.growth = 10.0 ** (1.0 / bins_per_decade)
        self.nbins = bins_per_decade * decades
        self.counts = np.zeros(self.nbins, np.int64)
        self.count = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf
        self._log_g = math.log(self.growth)
        self._log_lo = math.log(lo)

    def _bin(self, v: float) -> int:
        if v <= self.lo:
            return 0
        b = int((math.log(v) - self._log_lo) / self._log_g)
        return b if b < self.nbins else self.nbins - 1

    def record(self, v: float, n: int = 1) -> None:
        """Record ``n`` observations of value ``v`` (``n>1``: a batch of
        frames sharing one measured latency)."""
        self.counts[self._bin(v)] += n
        self.count += n
        self.total += v * n
        if v < self.vmin:
            self.vmin = v
        if v > self.vmax:
            self.vmax = v

    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def percentile(self, p: float) -> float:
        """Value at the p-th percentile (geometric bin midpoint, clamped
        to the observed [min, max]); 0.0 when empty."""
        if not self.count:
            return 0.0
        target = (p / 100.0) * self.count
        cum = 0
        for b in range(self.nbins):
            c = int(self.counts[b])
            if not c:
                continue
            cum += c
            if cum >= target:
                mid = self.lo * self.growth ** (b + 0.5)
                return min(max(mid, self.vmin), self.vmax)
        return self.vmax

    def merge(self, other: "Histogram") -> "Histogram":
        """Fold ``other`` into this histogram, bin-exactly: both must share
        the binning (same ``lo``/``growth``/``nbins``), so summed counts
        are identical to having recorded the interleaved value stream into
        one histogram (the property ``tests/test_torch_obs.py`` asserts).
        Returns self for chaining."""
        assert (self.lo, self.growth, self.nbins) == \
            (other.lo, other.growth, other.nbins), \
            "merging histograms with different binning"
        self.counts += other.counts
        self.count += other.count
        self.total += other.total
        self.vmin = min(self.vmin, other.vmin)
        self.vmax = max(self.vmax, other.vmax)
        return self

    # -- checkpoint state ------------------------------------------------
    def state(self) -> Dict[str, Any]:
        return {"counts": self.counts.copy(), "count": self.count,
                "total": self.total, "vmin": self.vmin, "vmax": self.vmax}

    def load(self, st: Dict[str, Any]) -> None:
        self.counts[:] = st["counts"]
        self.count = st["count"]
        self.total = st["total"]
        self.vmin = st["vmin"]
        self.vmax = st["vmax"]


class Metrics:
    """Create-on-first-use registry of counters, gauges and histograms."""

    def __init__(self) -> None:
        self._counters: "OrderedDict[str, Counter]" = OrderedDict()
        self._gauges: "OrderedDict[str, Gauge]" = OrderedDict()
        self._hists: "OrderedDict[str, Histogram]" = OrderedDict()

    # -- access ----------------------------------------------------------
    def counter(self, name: str) -> Counter:
        c = self._counters.get(name)
        if c is None:
            c = self._counters[name] = Counter()
        return c

    def gauge(self, name: str) -> Gauge:
        g = self._gauges.get(name)
        if g is None:
            g = self._gauges[name] = Gauge()
        return g

    def histogram(self, name: str, **kw) -> Histogram:
        h = self._hists.get(name)
        if h is None:
            h = self._hists[name] = Histogram(**kw)
        return h

    def inc(self, name: str, n: int = 1) -> None:
        self.counter(name).inc(n)

    def set_gauge(self, name: str, v: float) -> None:
        self.gauge(name).set(v)

    def observe(self, name: str, v: float, n: int = 1) -> None:
        self.histogram(name).record(v, n)

    def drop(self, prefix: str) -> None:
        """Remove every metric whose name is ``prefix`` or starts with
        ``prefix/`` — how warmup-polluted histograms (compile time would
        swamp a measured p99) are cleared before the measured run."""
        for d in (self._counters, self._gauges, self._hists):
            for k in [k for k in d
                      if k == prefix or k.startswith(prefix + "/")]:
                del d[k]

    def ingest(self, prefix: str, stats: Dict[str, Any]) -> None:
        """Adopt an existing dict-shaped counter surface (the extract
        server's ``stats``, the gate's counters) into the registry as
        ``prefix/key`` counters — set, not incremented, so repeated
        ingestion of a cumulative dict stays idempotent."""
        for k, v in stats.items():
            if isinstance(v, (int, np.integer)):
                self.counter(f"{prefix}/{k}").set(int(v))
            elif isinstance(v, float):
                self.gauge(f"{prefix}/{k}").set(v)

    # -- reporting -------------------------------------------------------
    def to_rows(self) -> List[Dict[str, Any]]:
        """Structured rows, one per metric."""
        rows: List[Dict[str, Any]] = []
        for name, c in self._counters.items():
            rows.append({"kind": "counter", "name": name, "value": c.value})
        for name, g in self._gauges.items():
            rows.append({"kind": "gauge", "name": name, "value": g.value})
        for name, h in self._hists.items():
            rows.append({"kind": "histogram", "name": name,
                         "count": h.count, "mean": h.mean(),
                         "p50": h.percentile(50), "p95": h.percentile(95),
                         "p99": h.percentile(99),
                         "min": h.vmin if h.count else 0.0,
                         "max": h.vmax if h.count else 0.0})
        return rows

    def describe(self) -> str:
        lines = []
        for r in self.to_rows():
            if r["kind"] == "histogram":
                lines.append(
                    f"{r['name']:<44s} n={r['count']:<7d} "
                    f"mean={r['mean']:.3f} p50={r['p50']:.3f} "
                    f"p95={r['p95']:.3f} p99={r['p99']:.3f}")
            else:
                lines.append(f"{r['name']:<44s} {r['value']}")
        return "\n".join(lines)

    # -- checkpoint ------------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        return {
            "counters": {k: c.value for k, c in self._counters.items()},
            "gauges": {k: g.value for k, g in self._gauges.items()},
            "hists": {k: h.state() for k, h in self._hists.items()},
        }

    def restore(self, st: Dict[str, Any]) -> None:
        """Return the registry to exactly the snapshot's state: metrics
        created after the snapshot are dropped, surviving ones reloaded."""
        self._counters = OrderedDict(
            (k, Counter()) for k in st["counters"])
        for k, v in st["counters"].items():
            self._counters[k].value = v
        self._gauges = OrderedDict((k, Gauge()) for k in st["gauges"])
        for k, v in st["gauges"].items():
            self._gauges[k].value = v
        hists: "OrderedDict[str, Histogram]" = OrderedDict()
        for k, hst in st["hists"].items():
            old = self._hists.get(k)
            h = old if old is not None else Histogram()
            h.load(hst)
            hists[k] = h
        self._hists = hists

    def reset(self) -> None:
        self._counters.clear()
        self._gauges.clear()
        self._hists.clear()
