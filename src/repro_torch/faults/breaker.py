"""Per-feed circuit breaker: closed → open → half-open → closed.

Counterpart of ``repro/faults/breaker.py``.

The breaker quarantines one failing feed so the rest of the fleet keeps
serving: on a trip (ingest retries exhausted, or an extract request that
failed past its retry budget) the feed stops submitting work for
``cooldown`` scheduling rounds — frames it ingests meanwhile are
degraded or dropped with exact accounting, never served.  After the
cooldown the breaker goes *half-open*: the runtime sends one probe
(transport peek + an isolated canary extract); success closes the
breaker (the feed re-admits by replaying from its last snapshot),
failure re-opens it with the cooldown doubled up to ``max_cooldown``.

Cooldowns are counted in the feed's own scheduling *rounds*, not wall
time, so breaker behavior is as deterministic as the fault schedule
driving it.
"""
from __future__ import annotations

from typing import Dict

CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"


class CircuitBreaker:
    """State machine for one feed (see module docs)."""

    def __init__(self, cooldown: int = 4, max_cooldown: int = 64):
        assert cooldown >= 1
        self.base_cooldown = cooldown
        self.max_cooldown = max(max_cooldown, cooldown)
        self.cooldown = cooldown
        self.state = CLOSED
        self.rounds_left = 0
        self.counters: Dict[str, int] = {
            "trips": 0, "probes": 0, "probe_failures": 0, "recoveries": 0}

    @property
    def closed(self) -> bool:
        return self.state == CLOSED

    def trip(self, reason: str = "") -> None:
        """Open the circuit (idempotent while already open)."""
        if self.state != OPEN:
            self.counters["trips"] += 1
        self.state = OPEN
        self.rounds_left = self.cooldown
        self.last_reason = reason

    def tick(self) -> None:
        """One quarantined scheduling round; transitions open →
        half-open when the cooldown expires."""
        if self.state == OPEN:
            self.rounds_left -= 1
            if self.rounds_left <= 0:
                self.state = HALF_OPEN

    @property
    def should_probe(self) -> bool:
        return self.state == HALF_OPEN

    def probe_failed(self) -> None:
        """Back to open, cooldown doubled (capped)."""
        self.counters["probes"] += 1
        self.counters["probe_failures"] += 1
        self.cooldown = min(self.cooldown * 2, self.max_cooldown)
        self.state = OPEN
        self.rounds_left = self.cooldown

    def close(self) -> None:
        """Probe succeeded: resume serving, cooldown reset to base."""
        self.counters["probes"] += 1
        self.counters["recoveries"] += 1
        self.cooldown = self.base_cooldown
        self.state = CLOSED
        self.rounds_left = 0
