"""Frame-lifecycle tracer: monotonic ring-buffer span recording.

Counterpart of ``repro/obs/tracer.py``.  Timestamps are the host clock,
as in the reference: a span around work on the card measures it only
where that work ends in a device-to-host copy (every operator of the
port does).  The tracer never synchronizes the card.

The serving stack is instrumented with *spans* (named intervals on a
track: ``prefix:skip`` on ``feed:tb0``, ``forward[big]`` on ``device``),
*instants* (point events: a gate revalidation) and *counter* samples (the
server's in-flight forward occupancy over time).  Recording is designed
for the hot path:

  * fixed capacity — events land in pre-allocated parallel arrays
    addressed by a monotonically increasing index modulo the capacity, so
    the buffer never grows and old events are overwritten, never moved;
  * no per-event containers — an event is five scalar stores (kind, name,
    category, track are interned strings; timestamps are int64 slots in a
    numpy array), not a dict or tuple allocation;
  * timestamps are ``time.perf_counter_ns()`` — monotonic, ns resolution.

``NullTracer`` is the default everywhere: every recording method is a
no-op ``pass`` and ``enabled`` is False, so instrumented code paths can
skip even the clock reads (``if tracer.enabled:``).  The contract,
enforced by ``tests/test_torch_obs.py``, is that serving with a
``NullTracer`` is bitwise identical to serving before the instrumentation
existed, and within noise of its wall clock.

Export is Chrome trace-event JSON (``export_chrome``), loadable in
Perfetto (https://ui.perfetto.dev) or ``chrome://tracing``: tracks map to
named threads, spans to complete ("X") events, counters to "C" events —
the per-phase timeline evidence the latency work needs.
"""
from __future__ import annotations

import json
import sys
import time
from typing import Any, Dict, List, Optional

import numpy as np


class NullTracer:
    """No-op tracer: the inert default.  Subclassed by ``Tracer`` so both
    present one API; every recording method here must stay a ``pass`` —
    the disabled serving path's overhead is exactly these empty calls."""

    enabled = False

    def now(self) -> int:
        return 0

    def span(self, name: str, cat: str, t0_ns: int,
             t1_ns: Optional[int] = None, track: str = "main",
             n: int = 0) -> None:
        pass

    def instant(self, name: str, cat: str, track: str = "main",
                n: int = 0) -> None:
        pass

    def counter(self, name: str, value: int,
                track: str = "counters") -> None:
        pass

    def events(self) -> List[Dict[str, Any]]:
        return []

    def reset(self) -> None:
        pass


#: process-wide inert default (stateless, safe to share)
NULL_TRACER = NullTracer()


class Tracer(NullTracer):
    """Ring-buffer recording tracer.  See module docstring."""

    enabled = True

    def __init__(self, capacity: int = 65536):
        assert capacity >= 1
        self.capacity = capacity
        # parallel pre-allocated columns — one store per field per event
        self._kind: List[Optional[str]] = [None] * capacity
        self._name: List[Optional[str]] = [None] * capacity
        self._cat: List[Optional[str]] = [None] * capacity
        self._track: List[Optional[str]] = [None] * capacity
        self._t0 = np.zeros(capacity, np.int64)
        self._t1 = np.zeros(capacity, np.int64)
        self._n = np.zeros(capacity, np.int64)
        self._idx = 0                  # total events ever recorded

    # -- recording (hot path) -------------------------------------------
    def now(self) -> int:
        return time.perf_counter_ns()

    def _store(self, kind: str, name: str, cat: str, track: str,
               t0_ns: int, t1_ns: int, n: int) -> None:
        i = self._idx % self.capacity
        self._kind[i] = kind
        self._name[i] = name
        self._cat[i] = cat
        self._track[i] = track
        self._t0[i] = t0_ns
        self._t1[i] = t1_ns
        self._n[i] = n
        self._idx += 1

    def span(self, name: str, cat: str, t0_ns: int,
             t1_ns: Optional[int] = None, track: str = "main",
             n: int = 0) -> None:
        """Record a completed interval [t0_ns, t1_ns] (t1 defaults to
        now); ``n`` annotates the batch size the span covered."""
        if t1_ns is None:
            t1_ns = time.perf_counter_ns()
        self._store("X", name, cat, track, t0_ns, t1_ns, n)

    def instant(self, name: str, cat: str, track: str = "main",
                n: int = 0) -> None:
        t = time.perf_counter_ns()
        self._store("i", name, cat, track, t, t, n)

    def counter(self, name: str, value: int,
                track: str = "counters") -> None:
        t = time.perf_counter_ns()
        self._store("C", name, "counter", track, t, t, value)

    # -- inspection / export (cold path) --------------------------------
    @property
    def recorded(self) -> int:
        """Total events ever recorded (including overwritten ones)."""
        return self._idx

    @property
    def dropped(self) -> int:
        """Events overwritten by ring wraparound."""
        return max(0, self._idx - self.capacity)

    def reset(self) -> None:
        self._idx = 0

    def events(self) -> List[Dict[str, Any]]:
        """Retained events in recording order (oldest surviving first)."""
        n = min(self._idx, self.capacity)
        start = self._idx % self.capacity if self._idx > self.capacity \
            else 0
        out = []
        for k in range(n):
            i = (start + k) % self.capacity
            out.append({"kind": self._kind[i], "name": self._name[i],
                        "cat": self._cat[i], "track": self._track[i],
                        "t0_ns": int(self._t0[i]), "t1_ns": int(self._t1[i]),
                        "n": int(self._n[i])})
        return out

    def export_chrome(self, path: str) -> int:
        """Write Chrome trace-event JSON loadable in Perfetto; returns the
        number of events exported.

        Tracks become named threads of one process (metadata "M" events);
        spans become complete "X" events (ts/dur in µs, relative to the
        oldest retained event), instants "i", counters "C"."""
        evs = self.events()
        t_base = min((e["t0_ns"] for e in evs), default=0)
        tids: Dict[str, int] = {}
        out: List[Dict[str, Any]] = []
        for e in evs:
            tid = tids.setdefault(e["track"], len(tids) + 1)
            ts = (e["t0_ns"] - t_base) / 1e3
            rec: Dict[str, Any] = {
                "name": e["name"], "cat": e["cat"], "ph": e["kind"],
                "ts": ts, "pid": 1, "tid": tid,
            }
            if e["kind"] == "X":
                rec["dur"] = (e["t1_ns"] - e["t0_ns"]) / 1e3
                rec["args"] = {"n": e["n"]}
            elif e["kind"] == "i":
                rec["s"] = "t"
                rec["args"] = {"n": e["n"]}
            else:                      # "C": sampled counter value
                rec["args"] = {"value": e["n"]}
            out.append(rec)
        meta = [{"name": "thread_name", "ph": "M", "pid": 1, "tid": tid,
                 "args": {"name": track}} for track, tid in tids.items()]
        meta.append({"name": "process_name", "ph": "M", "pid": 1,
                     "args": {"name": "repro-serving"}})
        with open(path, "w") as f:
            json.dump({"traceEvents": meta + out,
                       "displayTimeUnit": "ms",
                       "otherData": {"dropped_events": self.dropped}}, f)
        if self.dropped:
            # a truncated trace looks complete in Perfetto — say so loudly
            # instead of burying the count in the otherData blob
            print(f"WARNING: trace {path} dropped {self.dropped} events "
                  f"(ring capacity {self.capacity}; oldest overwritten) — "
                  "raise Tracer(capacity=...) for a complete timeline",
                  file=sys.stderr)
        return len(out)
