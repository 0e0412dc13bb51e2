"""Fault injection and the resilience machinery it exercises.

Counterpart of ``repro/faults/``, a copy of its own (the port imports
nothing of the JAX package):

* ``FaultInjector`` / ``FaultRule`` (``injector``): a seeded,
  schedule-driven, clock-free fault source: source stalls, corrupt
  deliveries, extract-forward errors and artificial forward latency at
  named sites, reproducible event for event.  ``NULL_FAULTS`` is the
  inert default threaded through ``OpContext.faults``.
* ``CircuitBreaker`` (``breaker``): the per-feed open → half-open →
  closed quarantine state machine, with round-counted, doubling
  cooldowns.
* ``RetryPolicy`` and the error types of the serving tier.
* ``guard_stream``: transport validation and bounded redelivery for the
  solo ``StreamRuntime`` ingest path.

The contract: faults the stack absorbs leave every answer bitwise equal
to a fault-free run, and with ``NULL_FAULTS`` the stack is bitwise
identical to a build without this package.  ``repro_torch.scheduler``'s
extract server drives the forward-site rules and its multi-stream
runtime the breaker.
"""
from __future__ import annotations

import dataclasses

from repro_torch.faults.breaker import CLOSED, HALF_OPEN, OPEN, CircuitBreaker
from repro_torch.faults.injector import (
    FaultInjector,
    FaultRule,
    NULL_FAULTS,
    resolve_faults,
)


class FaultError(RuntimeError):
    """Base of every error the fault-tolerance tier raises."""


class SourceFaultError(FaultError):
    """Ingest retries exhausted: a feed's transport kept delivering
    corrupt frames past the retry budget."""


class ExtractFaultError(FaultError):
    """An extract request failed past its retry budget (its ``failed``
    flag is set; accessing its result raises this)."""


class ExtractStallError(FaultError):
    """The ``wait()``/``drain()`` watchdog: no progress (no launch, no
    retirement) for ``drain_timeout_s`` — names the stuck chunk/bucket
    instead of spinning forever."""


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded retry with exponential backoff for extract forwards.

    A failed in-flight chunk's requests stay queued and relaunch
    *isolated* (one request per chunk, so a poisoned feed's frames never
    exhaust chunk-mates' budgets).  Backoff is counted in dispatch
    rounds — ``backoff_base * 2**(attempt-1)`` rounds before a request
    is eligible again — keeping retry timing as deterministic as the
    fault schedule.  After ``max_attempts`` total attempts the request
    is terminally ``failed`` (the runtime's circuit breaker takes over).
    """

    max_attempts: int = 3
    backoff_base: int = 1

    def __post_init__(self):
        assert self.max_attempts >= 1 and self.backoff_base >= 0

    def backoff_rounds(self, attempt: int) -> int:
        return self.backoff_base * (2 ** max(attempt - 1, 0))


class _GuardedStream:
    """A stream wrapped in transport validation + bounded redelivery
    (the solo ``StreamRuntime`` ingest path).  Stalls are meaningless
    without a scheduler to skip rounds, so only ``corrupt`` rules apply
    here."""

    def __init__(self, stream, faults: FaultInjector, feed: str,
                 retries: int = 2):
        self._stream = stream
        self._faults = faults
        self._feed = feed
        self._retries = retries

    def batch(self, n: int):
        frames, labels = self._stream.batch(n)
        fi = self._faults
        event = fi.next_event("source", self._feed)
        for attempt in range(self._retries + 1):
            got = fi.transport(self._feed, frames, event, attempt)
            if fi.delivered_ok(got):
                return got, labels
        raise SourceFaultError(
            f"feed {self._feed!r}: corrupt delivery survived "
            f"{self._retries + 1} attempts (source event {event})")

    def __getattr__(self, name):
        return getattr(self._stream, name)


def guard_stream(stream, faults, feed: str = "stream", retries: int = 2):
    """Wrap ``stream`` with transport-fault validation and bounded
    redelivery when ``faults`` is enabled; returns the stream unchanged
    otherwise (zero overhead on the fault-free path)."""
    faults = resolve_faults(faults)
    if not faults.enabled:
        return stream
    return _GuardedStream(stream, faults, feed, retries)


__all__ = [
    "CLOSED", "CircuitBreaker", "ExtractFaultError", "ExtractStallError",
    "FaultError", "FaultInjector", "FaultRule", "HALF_OPEN", "NULL_FAULTS",
    "OPEN", "RetryPolicy", "SourceFaultError", "guard_stream",
    "resolve_faults",
]
