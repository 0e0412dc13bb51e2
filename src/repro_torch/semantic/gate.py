"""The semantic gate: signature + cache + admission control, one facade.

Counterpart of ``repro/semantic/gate.py``.  ``SemanticGate.admit(feed,
variant, frames)`` is the cache-consult stage an MLLM extract calls for
every batch that reached it: it computes the batch's temporal signatures
(one batched call on the gate's device), classifies each row against the
feed's keyframe cache under the feed's *current* (controller-tuned)
threshold, and returns an ``Admission`` describing which rows pay a
forward and which are answered from keyframes, with every Nth hit per
keyframe escalated to a revalidation (model + compare).

The gate is a runtime service shared by every consumer (the solo
``MLLMExtractOp`` path keys state by op, the ``SharedExtractServer`` by
feed name), and it is *inert* unless
enabled with a positive threshold: callers check ``gate.active`` and take
their original, bitwise-identical path when it is False.  ``device=None``
means CUDA for the gate's ``TemporalSignature``; a fused prefix upstream
hands the extract its signature, and the gate's own is then not computed.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Dict, Optional

import numpy as np

from repro_torch.common.device import DeviceLike
from repro_torch.obs import NULL_OBS
from repro_torch.semantic.admission import AdmissionController
from repro_torch.semantic.cache import (Admission, CacheEntry,
                                        SemanticExtractCache)
from repro_torch.semantic.signature import TemporalSignature


@dataclasses.dataclass
class GateConfig:
    """Knobs of the semantic tier.

    ``threshold`` is the *base* signature-distance below which a frame is
    a near-duplicate (0 disables the gate entirely — every caller takes
    its pre-gate path).  ``revalidate_every`` bounds trust in any one
    keyframe: of every ``revalidate_every`` consecutive hits, one is sent
    through the model and compared.  ``accuracy_budget`` is the target
    revalidation-mismatch rate the admission controller steers each
    feed's threshold toward.

    ``mismatch_min_tasks`` separates drift from model churn: a
    revalidation counts as a mismatch only when at least this many task
    heads disagree with the cached answer (a single head's argmax flips
    on identical scenes; a real scene change flips several at once).
    Single-task disagreements still refresh the keyframe with the fresh
    answer; they do not count against the accuracy budget.  Set to 1 for
    the strictest reading."""

    threshold: float = 0.08
    revalidate_every: int = 8
    accuracy_budget: float = 0.05
    max_entries: int = 64
    bucket_width: float = 0.5
    mismatch_min_tasks: int = 2

    def __post_init__(self):
        assert self.threshold >= 0.0
        assert self.revalidate_every >= 2, \
            "revalidate_every < 2 means every hit revalidates — disable " \
            "the gate instead"


class SemanticGate:
    """Temporal-redundancy gate in front of the MLLM."""

    COUNTER_KEYS = ("cache_hits", "cache_misses", "revalidations",
                    "cache_mismatches")

    def __init__(self, config: Optional[GateConfig] = None,
                 device: DeviceLike = None):
        self.config = config if config is not None else GateConfig()
        self.signature = TemporalSignature(device=device)
        self.cache = SemanticExtractCache(self.config.max_entries)
        self.controller = AdmissionController(self.config.threshold,
                                              self.config.accuracy_budget)
        self.counters: Dict[str, int] = {k: 0 for k in self.COUNTER_KEYS}
        #: observability handle; owners overwrite it with the context's —
        #: the gate then emits per-consult ``gate`` spans and
        #: hit/miss/revalidate instants on the feed's track
        self.obs = NULL_OBS
        #: per-feed view of the same counters — the measured hit rates the
        #: cost model prices gated plans by
        self.feed_counters: Dict[str, Dict[str, int]] = {}
        #: serializes classification and finalize against each other: a
        #: gated extract inside a multi-query fan-out *tail* runs on the
        #: tail pool, and lost counter increments there would skew every
        #: measured rate
        self._lock = threading.Lock()

    def _count(self, feed: str, key: str) -> None:
        self.counters[key] += 1
        fc = self.feed_counters.setdefault(
            feed, {k: 0 for k in self.COUNTER_KEYS})
        fc[key] += 1

    # ------------------------------------------------------------------
    @property
    def active(self) -> bool:
        return self.config.threshold > 0.0

    def hit_rate(self, feed: Optional[str] = None) -> float:
        """Fraction of admitted frames answered without a forward —
        workload-wide, or for one feed."""
        c = self.counters if feed is None \
            else self.feed_counters.get(feed, {})
        served = sum(c.get(k, 0) for k in
                     ("cache_hits", "cache_misses", "revalidations"))
        return c.get("cache_hits", 0) / max(served, 1)

    def served(self, feed: Optional[str] = None) -> int:
        """Frames classified by the gate (hit + miss + revalidation)."""
        c = self.counters if feed is None \
            else self.feed_counters.get(feed, {})
        return sum(c.get(k, 0) for k in
                   ("cache_hits", "cache_misses", "revalidations"))

    # ------------------------------------------------------------------
    def admit(self, feed: str, variant: str,
              frames: np.ndarray, sig=None) -> Admission:
        """Classify one batch; the caller runs the model only over
        ``admission.model_frames(frames)`` and binds the output.

        ``sig``, when given, is a precomputed ``(feats, emb)`` pair for
        exactly these frames: the fused prefix (``FusedPrefixOp``)
        computes it in the same device pass as the rest of the chain, so
        the gate skips its own call.  On one device the fused signature
        equals ``self.signature.features(frames)`` bit for bit (both
        derive from ``signature_layout`` and share the arithmetic), so
        cache buckets and distances agree whichever path computed it."""
        assert self.active
        obs = self.obs
        t0 = obs.now() if obs.enabled else 0
        n = int(frames.shape[0])
        adm = Admission(feed=feed, variant=variant, n=n, gate=self,
                        mismatch_min_tasks=self.config.mismatch_min_tasks)
        feats, emb = sig if sig is not None \
            else self.signature.features(frames)
        shape = tuple(frames.shape[1:])
        every = self.config.revalidate_every
        with self._lock:
            thr = self.controller.threshold(feed)
            for i in range(n):
                key = (variant, shape,
                       TemporalSignature.bucket(emb[i],
                                                self.config.bucket_width))
                entry = self.cache.lookup(feed, key)
                if entry is not None and TemporalSignature.distance(
                        feats[i], emb[i], entry.feats, entry.emb) >= thr:
                    entry = None
                if entry is None:
                    # temporal-locality fallback: a drifting scene walks
                    # its embedding across bucket edges — probe the feed's
                    # newest keyframe before declaring the frame novel
                    last = self.cache.last_entry(feed, key[:2])
                    if last is not None and TemporalSignature.distance(
                            feats[i], emb[i], last.feats, last.emb) < thr:
                        entry = last
                if entry is not None:
                    entry.hits += 1
                    if entry.since_reval + 1 >= every:
                        # the Nth hit pays a forward anyway: drift check
                        entry.since_reval = 0
                        entry.validations += 1
                        adm.add_reval_row(i, entry)
                        self._count(feed, "revalidations")
                    else:
                        entry.since_reval += 1
                        adm.add_cache_row(i, entry.ref())
                        self._count(feed, "cache_hits")
                else:
                    # novel: pays a forward, becomes the bucket's keyframe
                    j = adm.add_model_row(i)
                    new = CacheEntry(feats[i], emb[i])
                    self.cache.insert(feed, key, new)
                    adm.attach_fill(new, j)
                    self._count(feed, "cache_misses")
        if obs.enabled:
            track = f"feed:{feed}"
            tr = obs.tracer
            tr.span("gate", "gate", t0, obs.now(), track=track, n=n)
            revals = len(adm.reval)
            hits = n - adm.n_model
            misses = adm.n_model - revals
            if hits:
                tr.instant("gate:hit", "gate", track=track, n=hits)
            if misses:
                tr.instant("gate:miss", "gate", track=track, n=misses)
            if revals:
                tr.instant("gate:revalidate", "gate", track=track,
                           n=revals)
        return adm

    # ------------------------------------------------------------------
    def reset(self, feed: Optional[str] = None) -> None:
        """Drop gating state (keyframes + tuned thresholds) for one feed,
        or for every feed — the warmup/reset analogue of ``Op.reset``.
        Counters are accounting and reset separately
        (``reset_counters``)."""
        self.cache.reset(feed)
        self.controller.reset(feed)

    def reset_counters(self) -> None:
        for k in self.COUNTER_KEYS:
            self.counters[k] = 0
        self.feed_counters.clear()

    # ------------------------------------------------------------------
    def stale_answer(self, feed: str) -> Optional[dict]:
        """The newest concrete keyframe extract output for ``feed``,
        summarized to plain Python values — what degraded-mode serving
        reports (marked ``stale``) while the feed's circuit is open.
        None when the feed has no usable keyframe yet."""
        preds = self.cache.newest_preds(feed)
        if preds is None:
            return None
        return {k: np.asarray(v).tolist() for k, v in preds.items()}

    # ------------------------------------------------------------------
    def snapshot_feed(self, feed: str) -> dict:
        return {"admission": self.controller.snapshot(feed),
                "cache": self.cache.snapshot(feed)}

    def restore_feed(self, feed: str, st: dict) -> None:
        self.controller.restore(feed, st["admission"])
        self.cache.restore(feed, st["cache"])

    def snapshot(self) -> dict:
        feeds = set(self.cache._feeds) | set(self.controller._feeds)
        return {"feeds": {f: self.snapshot_feed(f) for f in sorted(feeds)},
                "counters": dict(self.counters),
                "feed_counters": {f: dict(c)
                                  for f, c in self.feed_counters.items()}}

    def restore(self, st: dict) -> None:
        self.reset()
        for feed, fs in st["feeds"].items():
            self.restore_feed(feed, fs)
        self.counters.update(st["counters"])
        self.feed_counters = {f: dict(c)
                              for f, c in st.get("feed_counters",
                                                 {}).items()}
