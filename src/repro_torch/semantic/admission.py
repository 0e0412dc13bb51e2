"""Accuracy-budgeted admission control for the semantic cache.

Counterpart of ``repro/semantic/admission.py``.

The cache's only knob with accuracy consequences is the similarity
threshold below which a frame is served from a keyframe's cached extract.
The right value differs per feed (an empty toll lane tolerates a loose
threshold; a volleyball rally does not) and drifts over time, so the
controller tunes it **online from measured evidence**: every revalidation
(a cache hit deliberately sent through the model anyway) yields one
boolean observation — did the cached answer still match the model?

The mismatch rate is tracked as an EMA per feed and steered toward the
configured accuracy budget with asymmetric multiplicative updates:

* mismatch EMA above the budget → *tighten sharply* (halve the
  threshold): the cache is lying at a rate the query set cannot absorb,
  so stop admitting aggressively and let novel frames refresh keyframes;
* mismatch EMA comfortably below the budget → *recover slowly*
  (+5% per clean revalidation), but never past the configured base
  threshold — the budget bounds risk, it is not a license to drift looser
  than the operator asked for.

Mismatches are rare events, so the EMA weight is high (each observation
is expensive — it cost a real forward) and the floor keeps the threshold
strictly positive: a fully-closed gate would stop producing revalidation
evidence and could never re-open.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class FeedAdmission:
    """Per-feed controller state (snapshot/restore round-trips it)."""

    threshold: float
    mismatch_ema: float = 0.0
    observations: int = 0


class AdmissionController:
    """Steers per-feed thresholds toward a target revalidation-mismatch
    rate (the accuracy budget)."""

    #: EMA weight per revalidation observation
    EMA = 0.25
    #: multiplicative tighten on budget violation / recover when clean
    TIGHTEN = 0.5
    RECOVER = 1.05
    #: the threshold never collapses to 0 (no evidence) nor exceeds base
    MIN_FRAC = 0.05

    def __init__(self, base_threshold: float, budget: float):
        assert base_threshold >= 0.0 and budget >= 0.0
        self.base_threshold = base_threshold
        self.budget = budget
        self._feeds: dict = {}

    # ------------------------------------------------------------------
    def feed(self, feed: str) -> FeedAdmission:
        st = self._feeds.get(feed)
        if st is None:
            st = self._feeds[feed] = FeedAdmission(
                threshold=self.base_threshold)
        return st

    def threshold(self, feed: str) -> float:
        return self.feed(feed).threshold

    def observe(self, feed: str, mismatch: bool) -> None:
        """Fold one revalidation outcome into the feed's threshold."""
        st = self.feed(feed)
        st.observations += 1
        st.mismatch_ema = (1 - self.EMA) * st.mismatch_ema \
            + self.EMA * float(mismatch)
        if st.mismatch_ema > self.budget:
            st.threshold = max(st.threshold * self.TIGHTEN,
                               self.base_threshold * self.MIN_FRAC)
        elif st.mismatch_ema < 0.5 * self.budget:
            st.threshold = min(st.threshold * self.RECOVER,
                               self.base_threshold)

    # ------------------------------------------------------------------
    def reset(self, feed=None) -> None:
        if feed is None:
            self._feeds.clear()
        else:
            self._feeds.pop(feed, None)

    def snapshot(self, feed: str) -> dict:
        return dataclasses.asdict(self.feed(feed))

    def restore(self, feed: str, st: dict) -> None:
        self._feeds[feed] = FeedAdmission(**st)
