"""Semantic extract cache: keyframe outputs answering near-duplicates.

Counterpart of ``repro/semantic/cache.py`` (numpy only).

Entries are keyed by ``(variant, frame shape, signature bucket)`` inside a
per-feed LRU (a feed is one camera — temporal redundancy is a per-feed
phenomenon; the variant and shape keep physically different extracts from
ever answering each other).  A *novel* frame becomes a keyframe entry; a
*near-duplicate* is served the keyframe's cached per-task predictions.

The cache composes with pipelined serving: a keyframe's own forward may
still be in flight when a later micro-batch hits it, so an entry's
predictions are either concrete numpy rows or a ``_ModelRowRef`` — row
*j* of an earlier admission's model output, resolvable once that forward
retires.  ``Admission.ready`` folds those donors into the request's
``done`` contract, and per-feed FIFO resume order means a donor (submitted
strictly earlier) never blocks its dependents' progress.

``Admission`` is the unit the serving tier handles: the cache-consult
decision for one submitted batch (which rows go to the model, which are
answered from keyframes, which hits revalidate), plus ``assemble()`` —
the one-shot finalize that stitches model and cached rows back into the
batch's per-task prediction arrays, fills this admission's new keyframe
entries, performs the revalidation comparisons (counting mismatches,
feeding the admission controller, and refreshing drifted keyframes with
the fresh model answer).
"""
from __future__ import annotations

import copy
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple

import numpy as np


class _ModelRowRef:
    """Row ``j`` of ``adm``'s model output — resolvable once the backing
    forward (bound by the serving tier) completes."""

    __slots__ = ("adm", "j")

    def __init__(self, adm: "Admission", j: int):
        self.adm = adm
        self.j = j

    @property
    def done(self) -> bool:
        src = self.adm._src
        return src is not None and src.done

    def resolve(self) -> Dict[str, np.ndarray]:
        res = self.adm._src.result
        return {k: np.asarray(v)[self.j] for k, v in res.items()}


class _Ready:
    """Concrete model output masquerading as a completed request — the
    synchronous (solo ``MLLMExtractOp``) path binds one of these."""

    __slots__ = ("result",)
    done = True

    def __init__(self, preds: Dict[str, np.ndarray]):
        self.result = preds


class CacheEntry:
    """One keyframe: its signature, its extract output (possibly still in
    flight), and the hit/revalidation accounting the budget rides on."""

    __slots__ = ("feats", "emb", "preds", "pending", "hits", "since_reval",
                 "validations")

    def __init__(self, feats: np.ndarray, emb: np.ndarray,
                 preds: Optional[Dict[str, np.ndarray]] = None):
        self.feats = feats
        self.emb = emb
        self.preds = preds
        self.pending: Optional[_ModelRowRef] = None
        self.hits = 0
        self.since_reval = 0
        self.validations = 0

    def ref(self):
        """What a hit serves: concrete rows, or the in-flight donor."""
        return self.preds if self.preds is not None else self.pending


class SemanticExtractCache:
    """Per-feed LRU of keyframe entries."""

    def __init__(self, max_entries: int = 64):
        assert max_entries >= 1
        self.max_entries = max_entries
        self._feeds: Dict[str, OrderedDict] = {}
        #: feed -> (variant, shape) -> bucket key of the newest keyframe.
        #: Temporal-locality fallback: a slowly drifting scene (a car
        #: creeping through the lane) walks its embedding across bucket
        #: edges, so the bucket probe misses although the frame is within
        #: threshold of the *most recent* keyframe — probing that one
        #: keyframe recovers the straddle without a neighborhood search.
        self._last: Dict[str, Dict[Tuple, Tuple]] = {}

    # ------------------------------------------------------------------
    def lookup(self, feed: str, key: Tuple) -> Optional[CacheEntry]:
        entries = self._feeds.get(feed)
        if entries is None:
            return None
        e = entries.get(key)
        if e is not None:
            entries.move_to_end(key)
        return e

    def last_entry(self, feed: str, subkey: Tuple) -> Optional[CacheEntry]:
        """The newest keyframe of this (variant, shape), if still cached."""
        key = self._last.get(feed, {}).get(subkey)
        if key is None:
            return None
        return self._feeds.get(feed, {}).get(key)

    def insert(self, feed: str, key: Tuple, entry: CacheEntry) -> None:
        entries = self._feeds.setdefault(feed, OrderedDict())
        entries[key] = entry
        entries.move_to_end(key)
        self._last.setdefault(feed, {})[key[:2]] = key
        while len(entries) > self.max_entries:
            entries.popitem(last=False)

    def newest_preds(self, feed: str) -> Optional[Dict[str, np.ndarray]]:
        """The most recently touched keyframe's *concrete* extract
        output for ``feed`` (entries still awaiting their donor forward
        are skipped) — the degraded-mode fallback a quarantined feed
        serves, marked stale, while its circuit is open."""
        entries = self._feeds.get(feed)
        if not entries:
            return None
        for key in reversed(entries):       # LRU order: newest last
            preds = entries[key].preds
            if preds is not None:
                return preds
        return None

    def __len__(self) -> int:
        return sum(len(e) for e in self._feeds.values())

    # ------------------------------------------------------------------
    def reset(self, feed: Optional[str] = None) -> None:
        if feed is None:
            self._feeds.clear()
            self._last.clear()
        else:
            self._feeds.pop(feed, None)
            self._last.pop(feed, None)

    def snapshot(self, feed: str) -> Dict[str, Any]:
        """LRU-ordered entry list + newest-keyframe pointers; every entry
        must be concrete — the serving tier drains in-flight forwards
        before snapshotting."""
        out = []
        for key, e in self._feeds.get(feed, {}).items():
            if e.preds is None and e.pending is not None:
                assert e.pending.done, \
                    "snapshot with in-flight keyframe — drain() first"
                e.preds = e.pending.resolve()
                e.pending = None
            out.append((key, {
                "feats": np.copy(e.feats), "emb": np.copy(e.emb),
                "preds": copy.deepcopy(e.preds),
                "hits": e.hits, "since_reval": e.since_reval,
                "validations": e.validations}))
        return {"entries": out,
                "last": dict(self._last.get(feed, {}))}

    def restore(self, feed: str, st: Dict[str, Any]) -> None:
        entries: OrderedDict = OrderedDict()
        for key, d in st["entries"]:
            e = CacheEntry(np.copy(d["feats"]), np.copy(d["emb"]),
                           copy.deepcopy(d["preds"]))
            e.hits = d["hits"]
            e.since_reval = d["since_reval"]
            e.validations = d["validations"]
            entries[tuple(key)] = e
        self._feeds[feed] = entries
        self._last[feed] = dict(st.get("last", {}))


class Admission:
    """Cache-consult decision for one submitted batch of ``n`` frames.

    ``plan[i]`` says how batch row *i* is answered: ``("model", j)`` — row
    *j* of this admission's model forward (novel frames and revalidated
    hits), or ``("cache", ref)`` — a keyframe's output (concrete rows or a
    ``_ModelRowRef`` into an earlier, possibly in-flight forward).  The
    serving tier runs the model over ``model_frames(frames)`` only, binds
    the output (a request or a concrete prediction dict) with ``bind``,
    and calls ``assemble()`` once ``ready``."""

    def __init__(self, feed: str, variant: str, n: int, gate,
                 mismatch_min_tasks: int = 2):
        self.feed = feed
        self.variant = variant
        self.n = n
        self.gate = gate
        self.mismatch_min_tasks = mismatch_min_tasks
        self.model_rows: List[int] = []
        self.plan: List[Optional[Tuple[str, Any]]] = [None] * n
        #: (entry, model row j, cached ref) revalidation comparisons
        self.reval: List[Tuple[CacheEntry, int, Any]] = []
        #: keyframe entries this admission's forward will fill
        self.fills: List[Tuple[CacheEntry, int]] = []
        #: earlier admissions' refs this one depends on
        self.donors: List[_ModelRowRef] = []
        self._src = None
        self._assembled: Optional[Dict[str, np.ndarray]] = None

    # ------------------------------------------------------------------
    @property
    def n_model(self) -> int:
        return len(self.model_rows)

    def add_model_row(self, i: int) -> int:
        j = len(self.model_rows)
        self.model_rows.append(i)
        self.plan[i] = ("model", j)
        return j

    def add_cache_row(self, i: int, ref) -> None:
        self.plan[i] = ("cache", ref)
        if isinstance(ref, _ModelRowRef) and ref.adm is not self:
            self.donors.append(ref)

    def add_reval_row(self, i: int, entry: CacheEntry) -> int:
        """Escalate a hit: row ``i`` pays a forward whose output both
        answers the row and is compared against the keyframe's cached
        answer at assemble time."""
        j = self.add_model_row(i)
        cached = entry.ref()
        self.reval.append((entry, j, cached))
        if isinstance(cached, _ModelRowRef) and cached.adm is not self:
            self.donors.append(cached)
        return j

    def attach_fill(self, entry: CacheEntry, j: int) -> None:
        """Register a fresh keyframe whose predictions are model row j."""
        entry.pending = _ModelRowRef(self, j)
        self.fills.append((entry, j))

    def model_frames(self, frames: np.ndarray) -> np.ndarray:
        """The subset of ``frames`` that must pay a forward."""
        if self.n_model == self.n:
            return frames
        return frames[np.asarray(self.model_rows)]

    # ------------------------------------------------------------------
    def bind(self, src) -> None:
        """Attach the model output for ``model_rows``: an extract request
        (pipelined path), a concrete per-task dict (solo path), or None
        when every row was answered from cache."""
        if isinstance(src, dict):
            src = _Ready(src)
        assert src is not None or self.n_model == 0
        self._src = src

    @property
    def ready(self) -> bool:
        """The forward (if any) and every donor completed — ``assemble``
        will not block."""
        if self.n_model and (self._src is None or not self._src.done):
            return False
        return all(d.done for d in self.donors)

    def assemble(self) -> Dict[str, np.ndarray]:
        """Finalize (idempotent): stitch model + cached rows into per-task
        arrays, fill this admission's keyframes, run the revalidation
        comparisons, and feed the admission controller."""
        if self._assembled is not None:
            return self._assembled
        assert self.ready, "assemble() before the backing forward completed"
        model: Dict[str, np.ndarray] = {}
        if self.n_model:
            model = {k: np.asarray(v) for k, v in self._src.result.items()}
        rows: List[Dict[str, np.ndarray]] = [None] * self.n
        for i, (kind, x) in enumerate(self.plan):
            if kind == "model":
                rows[i] = {k: v[x] for k, v in model.items()}
            else:
                rows[i] = x.resolve() if isinstance(x, _ModelRowRef) else x
        with self.gate._lock:
            for entry, j in self.fills:
                # the entry may have been superseded by a later keyframe
                # of the same bucket — fill only if it still waits on us
                if entry.pending is not None and entry.pending.adm is self:
                    entry.preds = {k: v[j] for k, v in model.items()}
                    entry.pending = None
            for entry, j, cached in self.reval:
                fresh = {k: v[j] for k, v in model.items()}
                old = cached.resolve() if isinstance(cached, _ModelRowRef) \
                    else cached
                # drift vs churn: a real scene change flips several heads
                # at once; an isolated head flip is indistinguishable from
                # the model's own argmax tie-churn on unchanged frames
                n_diff = sum(not np.array_equal(fresh[k], old[k])
                             for k in fresh)
                mismatch = n_diff >= self.mismatch_min_tasks
                if mismatch:
                    self.gate._count(self.feed, "cache_mismatches")
                self.gate.controller.observe(self.feed, mismatch)
                # refresh the keyframe with the fresh answer regardless —
                # even sub-threshold drift self-corrects every Nth hit
                entry.preds = fresh
                entry.pending = None
        self._assembled = {k: np.stack([r[k] for r in rows])
                           for k in rows[0]}
        return self._assembled
