"""Deterministic, schedule-driven fault injection.

Counterpart of ``repro/faults/injector.py``: for the same seed and rules
its schedule is the reference's, event for event.

A ``FaultInjector`` is a *pure schedule*, not a chaos monkey: every fault
it fires is a function of (site, feed, event index, attempt index) plus
the injector's seed — never the wall clock — so a faulted run is exactly
reproducible, and the contract tests can assert bitwise properties of
what survives the faults.

Sites and kinds
---------------
``source`` — the feed's ingest path, one *event* per attempted pull:

  * ``stall``   — the feed produces nothing this scheduling round (pure
    delay; no frames are lost).  A stall consumes its event: the round
    is skipped and the feed's next turn draws the next event.
  * ``corrupt`` — the pulled frames arrive damaged on the transport
    (NaN-poisoned copy; the stream itself stays pristine).  ``param`` is
    the number of consecutive delivery *attempts* that fail — a value
    larger than the runtime's ingest retry budget models a dead link.

``forward`` — the shared extract server's device forwards, one event per
extract request (assigned at enqueue, so retries of one request replay
the same event):

  * ``error``   — the forward raises.  ``param`` = consecutive failing
    attempts (``param=1``: the first launch fails, the retry succeeds;
    a large ``param`` models a poisoned input that never succeeds).
  * ``latency`` — the forward completes but its completion is observed
    ``param`` polls late (clock-free artificial device latency).

Event indices are per ``(site, feed)`` and assigned by the serving
runtime via ``next_event`` exactly once per pull / per request, so the
schedule is stable under retries, coalescing and scheduling jitter.
``fault_at`` is side-effect free — probes may *peek* at a future event
without consuming it.  Probabilistic rules (``p < 1``) draw from a hash
of (seed, rule index, event index), not from a shared RNG stream, so
they too are independent of feed interleaving.

``NULL_FAULTS`` is the inert default: ``enabled`` is False and every
call site guards with ``if faults.enabled:`` (the ``NULL_OBS`` idiom),
so the un-faulted stack stays bitwise identical to a build without this
package.
"""
from __future__ import annotations

import dataclasses
import random
from typing import Dict, List, Optional, Tuple

import numpy as np

SITES = ("source", "forward")
KINDS = ("stall", "corrupt", "error", "latency")

_SITE_KINDS = {
    "source": ("stall", "corrupt"),
    "forward": ("error", "latency"),
}


@dataclasses.dataclass
class FaultRule:
    """One line of a fault schedule.

    The rule fires on events ``start, start+every, start+2*every, ...``
    of its site, at most ``count`` times (``count=-1``: forever),
    filtered to one ``feed`` / ``variant`` ("" matches all), each firing
    gated by probability ``p`` (deterministic per event, see module
    docs).  ``param`` is kind-specific: consecutive failing attempts for
    ``corrupt``/``error``, delay polls for ``latency``; ignored for
    ``stall``."""

    site: str
    kind: str
    feed: str = ""
    variant: str = ""
    start: int = 0
    every: int = 1
    count: int = -1
    p: float = 1.0
    param: int = 1

    def __post_init__(self):
        assert self.site in SITES, self.site
        assert self.kind in _SITE_KINDS[self.site], \
            f"kind {self.kind!r} invalid for site {self.site!r}"
        assert self.every >= 1 and self.start >= 0
        assert 0.0 <= self.p <= 1.0
        assert self.param >= 1

    def matches(self, site: str, feed: str, variant: str,
                event: int) -> bool:
        if site != self.site:
            return False
        if self.feed and feed != self.feed:
            return False
        if self.variant and variant and variant != self.variant:
            return False
        if event < self.start or (event - self.start) % self.every:
            return False
        if self.count >= 0 and \
                (event - self.start) // self.every >= self.count:
            return False
        return True


class FaultInjector:
    """A seeded fault schedule (see module docs).  Thread the instance
    through ``OpContext.faults`` / ``SharedExtractServer(faults=...)`` /
    ``MultiStreamRuntime(faults=...)``; the inert ``NULL_FAULTS`` is the
    default everywhere."""

    enabled = True

    def __init__(self, rules: Optional[List[FaultRule]] = None,
                 seed: int = 0):
        self.rules = list(rules or [])
        self.seed = seed
        #: monotonic event counters per (site, feed) — the runtime draws
        #: one per pull attempt (source) / per extract request (forward)
        self._events: Dict[Tuple[str, str], int] = {}
        #: every fault actually fired, for determinism tests and the
        #: fault-timeline trace: dicts with site/kind/feed/event/attempt
        self.log: List[Dict] = []

    # ------------------------------------------------------------------
    def next_event(self, site: str, feed: str) -> int:
        """Consume and return the next event index for (site, feed)."""
        key = (site, feed)
        e = self._events.get(key, 0)
        self._events[key] = e + 1
        return e

    def peek_event(self, site: str, feed: str) -> int:
        """The event index ``next_event`` would return — side-effect
        free (circuit-breaker probes peek at the schedule the feed's
        next real pull will face)."""
        return self._events.get((site, feed), 0)

    def _roll(self, rule_idx: int, event: int, p: float) -> bool:
        if p >= 1.0:
            return True
        # hash-seeded draw: independent of feed interleaving / retries
        return random.Random(
            f"{self.seed}:{rule_idx}:{event}").random() < p

    def fault_at(self, site: str, feed: str, variant: str, event: int,
                 attempt: int = 0) -> Optional[Tuple[str, int]]:
        """The fault (kind, param) active for this event/attempt, or
        None.  Pure function of the schedule — calling it never advances
        state; pass ``record=True`` work to ``fire`` instead."""
        for i, rule in enumerate(self.rules):
            if not rule.matches(site, feed, variant, event):
                continue
            if not self._roll(i, event, rule.p):
                continue
            if rule.kind in ("corrupt", "error") and \
                    attempt >= rule.param:
                continue          # this attempt survives: fault cleared
            return rule.kind, rule.param
        return None

    def fire(self, site: str, feed: str, variant: str, event: int,
             attempt: int = 0) -> Optional[Tuple[str, int]]:
        """``fault_at`` + append to the fault log when a fault fires."""
        f = self.fault_at(site, feed, variant, event, attempt)
        if f is not None:
            self.log.append({"site": site, "kind": f[0], "feed": feed,
                             "variant": variant, "event": event,
                             "attempt": attempt})
        return f

    # ------------------------------------------------------------------
    def transport(self, feed: str, frames: np.ndarray, event: int,
                  attempt: int = 0) -> np.ndarray:
        """One delivery attempt of a pulled batch over the (simulated)
        transport: returns the frames, NaN-poisoned in a *copy* when the
        schedule corrupts this attempt — the stream's own data is never
        touched, so a later attempt (or a replay) sees pristine frames."""
        f = self.fire("source", feed, "", event, attempt)
        if f is None or f[0] != "corrupt":
            return frames
        # integer frame buffers can't hold NaN — the corrupted delivery
        # is promoted to float32 (harmless: validation rejects it and a
        # cleared attempt returns the original array, bitwise)
        bad = np.array(frames, copy=True, dtype=np.float32) \
            if not np.issubdtype(frames.dtype, np.floating) \
            else np.array(frames, copy=True)
        bad.reshape(-1)[:: max(1, bad.size // 16)] = np.nan
        return bad

    @staticmethod
    def delivered_ok(frames: np.ndarray) -> bool:
        """Ingest validation: a corrupt delivery is always detectable
        (NaN-poisoned, float dtype), so validation is a finite-ness
        check — trivially true for integer payloads."""
        if not np.issubdtype(frames.dtype, np.floating):
            return True
        return bool(np.isfinite(frames).all())


class _NullFaultInjector(FaultInjector):
    """Inert default: no schedule, no state, no log — ``enabled`` False
    lets every call site skip fault logic entirely."""

    enabled = False

    def __init__(self) -> None:
        super().__init__([], 0)

    def next_event(self, site: str, feed: str) -> int:
        return 0

    def fault_at(self, site: str, feed: str, variant: str, event: int,
                 attempt: int = 0) -> Optional[Tuple[str, int]]:
        return None


NULL_FAULTS = _NullFaultInjector()


def resolve_faults(*candidates) -> FaultInjector:
    """First non-None injector among ``candidates``, else NULL_FAULTS —
    the lookup rule every component uses (explicit arg outranks context,
    context outranks the inert default)."""
    for c in candidates:
        if c is not None:
            return c
    return NULL_FAULTS
