"""Multi-feed serving runtime: K streams, one shared MLLM serving tier.

Counterpart of ``repro/scheduler/multistream.py``.  ``MultiStreamRuntime``
generalizes ``MultiQueryRuntime`` (N queries, one stream) to N queries
over K heterogeneous feeds.  Per feed, the ``SharingTreePlanner`` factors
that feed's plans into sharing groups (shared signature prefix + merged
union-task extract + per-query tails); across feeds, every group's
extract requests route through one ``SharedExtractServer`` that
coalesces them into shape-bucketed batched forwards, so K feeds cost one
forward per coalesced batch instead of K.

Scheduling is round-robin over feeds at micro-batch granularity (the
starting feed rotates every round), with per-stream backpressure: a feed
whose un-fulfilled extract continuations reach ``max_pending ×
n_groups`` is skipped until the server drains.

Execution is suspension-based: a group advances each micro-batch through
its prefix until an ``MLLMExtractOp``, parks the batch as a continuation
keyed by the server request, and resumes, in submission order per group,
once the server fulfils it.  The server runs the same extract function as
the op's solo path (per-frame normalization, union heads), so every
query's outputs equal independent execution.

Serving is *pipelined* by default: the run loop dispatches coalesced
forwards (on the server's own CUDA stream), ``poll``s for completions,
and resumes exactly the continuations whose forwards finished, so round
*k*'s source batching, prefix operators and tail fan-out overlap round
*k-1*'s forwards under the server's ``max_inflight`` cap.
``pipelined=False`` restores the lock-step barrier drain.

With a live fault injector every feed gets a circuit breaker: a feed whose
source or extract path stays sick is quarantined (its frames answered
stale from the gate's keyframe, or dropped with exact accounting) while
the rest of the fleet serves, then probed, replayed from its snapshot
with sink collection suppressed, and recovered.  ``served + degraded +
dropped`` always partitions each feed's ingested frames.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Union

import numpy as np

from repro_torch.core.costs import op_cost_key
from repro_torch.faults import OPEN, CircuitBreaker, resolve_faults
from repro_torch.scheduler.extract_server import (
    PendingResume,
    SharedExtractServer,
    settle_fifo,
)
from repro_torch.scheduler.sharing_tree import SharingForest, SharingTreePlanner
from repro_torch.streaming.fused import FusedPrefixOp
from repro_torch.streaming.multiquery import (broadcast_windows, fan_out_tails,
                                        flush_shared)
from repro_torch.streaming.operators import (
    Batch,
    MLLMExtractOp,
    Op,
    OpContext,
    SinkOp,
    SourceOp,
)
from repro_torch.streaming.plan import Plan
from repro_torch.streaming.runtime import (
    RunResult,
    mllm_frames_of,
    warmup_ops,
)


@dataclasses.dataclass
class Feed:
    """One physical stream plus the queries standing on it."""

    name: str
    stream: Any                       # TollBoothStream / VolleyballStream
    plans: List[Plan]


@dataclasses.dataclass
class FeedResult:
    name: str
    n_frames: int
    mllm_frames: int
    per_query: Dict[str, RunResult]
    plan: str
    #: fault-tolerance accounting — ``served + degraded + dropped`` exactly
    #: partitions the feed's ingested frames.  ``served`` frames are
    #: bitwise identical to a fault-free run; ``degraded`` frames were
    #: answered from the semantic gate's last keyframe (marked ``stale``
    #: in ``degraded_records``); ``dropped`` frames had no stale answer
    #: available and are counted, never silently invented.
    served: int = 0
    degraded: int = 0
    dropped: int = 0
    degraded_records: List[Dict[str, Any]] = \
        dataclasses.field(default_factory=list)
    #: per-feed circuit-breaker counters (trips/probes/recoveries)
    breaker: Dict[str, int] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class MultiStreamResult:
    #: aggregate throughput in query-frames/s across every feed
    fps: float
    wall_s: float
    n_feeds: int
    n_queries: int
    #: frames *reaching* MLLM extracts (each shared prefix counted once);
    #: under semantic gating the cache answers part of them — frames that
    #: actually paid a forward are ``server_stats["frames"]``
    mllm_frames: int
    #: server accounting for the sharing claim: ``forwards`` is the number
    #: of extract forwards serving *all* feeds
    server_stats: Dict[str, int]
    feeds: Dict[str, FeedResult]


#: suspended micro-batch continuation (shared with MultiQueryRuntime's
#: pipelined path — one definition of the resume contract)
_Pending = PendingResume


class _GroupExec:
    """Executor for one sharing group: shared prefix with extract
    suspension points + per-query fan-out tails.  Used per feed by
    ``MultiStreamRuntime`` and (single-instance) by ``MultiQueryRuntime``'s
    server-backed pipelined path."""

    def __init__(self, execution, ctx: OpContext,
                 server: SharedExtractServer, feed: str,
                 parallel_tails: bool, open_ops: bool = True,
                 arrival: Optional[list] = None):
        self.exe = execution
        self.server = server
        self.feed = feed
        self.parallel_tails = parallel_tails
        #: observability rides the server — one handle for every group
        #: coalescing into it, so spans from all feeds land in one trace
        self.obs = server.obs
        self._track = f"feed:{feed}"
        #: shared one-slot newest-arrival stamp (ns): the pull loop writes
        #: it at ingest, ``_fan_out`` reads it at emit — their difference
        #: is the feed's staleness (how far the freshest served answer
        #: lags the stream head)
        self.arrival = arrival if arrival is not None else [0]
        if open_ops:
            for op in self.all_ops():
                op.open(ctx)
        for tail in self.exe.tails:
            assert isinstance(tail[-1], SinkOp), "tails must end in a Sink"
        self.reset_accumulators()

    def all_ops(self) -> List[Op]:
        ops = list(self.exe.prefix)
        for tail in self.exe.tails:
            ops.extend(tail)
        return ops

    def reset_accumulators(self) -> None:
        self.pcounts: Dict[str, int] = {op.name: 0
                                        for op in self.exe.prefix}
        self.counts: List[Dict[str, int]] = [
            {op.name: 0 for op in tail} for tail in self.exe.tails]
        self.windows: List[List[Dict[str, Any]]] = [
            [] for _ in self.exe.tails]

    def begin_run(self) -> None:
        """Per-run reset: drop collected sink records and accumulators
        (operator *state* — windows, skip carries — persists, so a
        warmup=0 run continues the stream exactly like StreamRuntime)."""
        for tail in self.exe.tails:
            tail[-1].collected = []
        self.reset_accumulators()

    # ------------------------------------------------------------------
    def start(self, batch: Batch) -> Optional[_Pending]:
        """Advance a fresh micro-batch; returns a continuation if the
        prefix suspended at an extract, else None (fan-out done)."""
        return self._advance(dict(batch), 0)

    def resume(self, p: _Pending) -> Optional[_Pending]:
        op = self.exe.prefix[p.op_index]
        obs = self.obs
        if obs.enabled:
            t0 = obs.now()
            batch = op.apply_preds(p.batch, p.req.result, p.n)
            obs.tracer.span("resume", "resume", t0, obs.now(),
                            track=self._track, n=p.n)
        else:
            batch = op.apply_preds(p.batch, p.req.result, p.n)
        return self._advance(batch, p.op_index + 1)

    def _advance(self, batch: Batch, i: int) -> Optional[_Pending]:
        obs = self.obs
        while i < len(self.exe.prefix):
            op = self.exe.prefix[i]
            self.pcounts[op.name] += len(batch["idx"])
            n = int(batch["frames"].shape[0])
            if isinstance(op, MLLMExtractOp) and n > 0:
                variant = op.begin_extract(n)
                # a fused prefix immediately upstream computed the gate
                # signature in its single pass — hand it to the server
                # (and strip it: it must not ride into apply_preds)
                sig = batch.pop("_sig", None)
                req = self.server.submit(variant, batch["frames"],
                                         feed=self.feed, sig=sig)
                return _Pending(op_index=i, batch=batch, req=req, n=n)
            if obs.enabled:
                t0 = obs.now()
                batch = broadcast_windows(op.process(batch), self.windows)
                t1 = obs.now()
                fused = isinstance(op, FusedPrefixOp)
                obs.tracer.span("prefix:fused" if fused
                                else f"prefix:{op.name}", "prefix", t0,
                                t1, track=self._track, n=n)
                if n > 0:
                    # measured per-op accounting keyed the way the cost
                    # catalog keys predictions — what PlanAudit joins
                    # against (wall µs per invocation; frames in; rows
                    # surviving) to reconcile marginal cost + pass rate
                    key = op_cost_key(op)
                    obs.metrics.observe(f"op_wall_us/{key}",
                                        (t1 - t0) / 1e3)
                    obs.metrics.inc(f"op_frames/{key}", n)
                    obs.metrics.inc(f"op_rows_out/{key}",
                                    int(batch["frames"].shape[0]))
                if fused:
                    # per-stage attribution: the chain collapsed to one
                    # dispatch, so surviving-row counts per fused stage
                    # are the remaining stage-level signal
                    for sname, rows_in, rows_out in op.last_stage_counts:
                        obs.metrics.set_gauge(
                            f"prefix_fused/{self.feed}/{sname}/in",
                            rows_in)
                        obs.metrics.set_gauge(
                            f"prefix_fused/{self.feed}/{sname}/out",
                            rows_out)
            else:
                batch = broadcast_windows(op.process(batch), self.windows)
            i += 1
        self._fan_out(batch)
        return None

    def _fan_out(self, batch: Batch) -> None:
        obs = self.obs
        if not obs.enabled:
            fan_out_tails(self.exe.tails, batch, self.counts, self.windows,
                          parallel=self.parallel_tails)
            return
        t0 = obs.now()
        fan_out_tails(self.exe.tails, batch, self.counts, self.windows,
                      parallel=self.parallel_tails)
        t1 = obs.now()
        obs.tracer.span("tail", "tail", t0, t1, track=self._track,
                        n=len(batch["idx"]))
        tb = batch.get("_obs_t0")
        if tb:
            # frame latency: ingest stamp → emit; staleness: emit − the
            # feed's newest arrival (exceeds latency whenever fresher
            # frames arrived while this batch was in flight)
            stale = (t1 - self.arrival[0]) / 1e6 if self.arrival[0] \
                else None
            obs.slo.record(self.feed, (t1 - tb) / 1e6, stale,
                           n=int(batch.get("_obs_n", len(batch["idx"]))))

    def flush(self) -> None:
        """End of stream.  Flush batches carry no frames (only buffered
        window results), so pushing them through a downstream extract op is
        a no-op and never needs the server."""
        flush_shared(self.exe.prefix, self.exe.tails, self.windows,
                     self._fan_out)


class _FeedState:
    def __init__(self, feed: Feed, groups: List[_GroupExec],
                 arrival: Optional[list] = None):
        self.feed = feed
        self.groups = groups
        self.source_index = 0
        self.labels: List[Dict[str, Any]] = []
        self.pendings: List[tuple] = []      # (group, _Pending) FIFO
        self.arrival = arrival if arrival is not None else [0]
        # ---- fault-tolerance state (inert without a live injector) ----
        #: circuit breaker quarantining this feed after retry exhaustion
        self.breaker: Optional[CircuitBreaker] = None
        #: outstanding frame-range tickets: start idx -> groups still
        #: working on that micro-batch.  FIFO serving makes the
        #: outstanding set a contiguous suffix, so ``served_upto`` (the
        #: exactly-once frontier) is just the minimum outstanding start.
        self.tickets: Dict[int, int] = {}
        #: last per-feed recovery snapshot (ops + gate + sink/window
        #: lengths + the stream offset of the next pull)
        self.snap: Optional[Dict[str, Any]] = None
        #: captured at trip: the gate's newest concrete keyframe answer,
        #: served as the ``stale`` degraded-mode result (None -> drop)
        self.stale_answer: Optional[Dict[str, Any]] = None
        #: trip set this: on recovery, replay frames [snap.next_pull,
        #: replay_to) with sinks suppressed to rebuild operator state
        self.replay_to: Optional[int] = None
        self.degraded_records: List[Dict[str, Any]] = []
        self.n_degraded = 0
        self.n_dropped = 0

    @property
    def served_upto(self) -> int:
        """Every frame below this index has fully fanned out through
        every sharing group (the exactly-once frontier)."""
        return min(self.tickets) if self.tickets else self.source_index

    @property
    def name(self) -> str:
        return self.feed.name

    def all_ops(self) -> List[Op]:
        return [op for g in self.groups for op in g.all_ops()]


class MultiStreamRuntime:
    """Serves ``feeds`` through one ``SharedExtractServer``.  ``ctx=None``
    builds a model-less ``OpContext`` on CUDA (raising where CUDA is
    absent)."""

    def __init__(self, feeds: List[Feed], ctx: Optional[OpContext] = None,
                 micro_batch: int = 16,
                 server: Optional[SharedExtractServer] = None,
                 planner: Optional[SharingTreePlanner] = None,
                 max_pending: int = 2,
                 coalesce_frames: Optional[int] = None,
                 parallel_tails: bool = True,
                 pipelined: bool = True,
                 max_inflight: int = 2,
                 gate=None,
                 faults=None,
                 breaker_cooldown: int = 4,
                 snapshot_every: int = 8,
                 ingest_retries: int = 2):
        assert feeds, "need at least one feed"
        names = [f.name for f in feeds]
        assert len(set(names)) == len(names), f"duplicate feed names {names}"
        assert server is None or gate is None, \
            "pass the gate to the SharedExtractServer, not both"
        if ctx is None:
            ctx = OpContext()
        self.ctx = dataclasses.replace(ctx, micro_batch=micro_batch)
        self.micro_batch = micro_batch
        self.pipelined = pipelined
        #: fault injection (explicit arg > ctx.faults > the server's own >
        #: inert NULL_FAULTS); the resolved injector is pushed into the
        #: server so ingest and forward faults draw from one schedule
        self.faults = resolve_faults(
            faults, getattr(ctx, "faults", None),
            server.faults if server is not None
            and server.faults.enabled else None)
        self.server = server if server is not None \
            else SharedExtractServer(self.ctx, max_inflight=max_inflight,
                                     gate=gate, faults=self.faults)
        if self.faults.enabled and not self.server.faults.enabled:
            self.server.faults = self.faults
        self._chaos = self.faults.enabled
        self.breaker_cooldown = breaker_cooldown
        #: take a per-feed recovery snapshot every this many scheduling
        #: rounds (when the feed has no outstanding work) — bounds both
        #: snapshot overhead and the replay a recovery pays
        self.snapshot_every = max(snapshot_every, 1)
        #: bounded redelivery attempts for a corrupt ingest transport
        self.ingest_retries = ingest_retries
        #: observability rides the server (one trace across every feed);
        #: attach via ``ctx.obs`` or the server's ``obs=``
        self.obs = self.server.obs
        self._restored = False
        self.planner = planner if planner is not None else SharingTreePlanner()
        self.max_pending = max_pending
        #: drain the server once this many frames are queued (default: one
        #: full coalesced forward) — or when no feed can progress
        self.coalesce_frames = coalesce_frames if coalesce_frames is not None \
            else self.server.max_batch
        self.forests: Dict[str, SharingForest] = {}
        self._feeds: List[_FeedState] = []
        for feed in feeds:
            streams = {p.ops[0].stream_name for p in feed.plans
                       if isinstance(p.ops[0], SourceOp)}
            assert len(streams) == 1, \
                f"feed {feed.name!r} mixes source streams {streams}"
            forest = self.planner.plan(feed.plans)
            self.forests[feed.name] = forest
            arrival = [0]                 # shared newest-arrival slot
            groups = [_GroupExec(g.execution, self.ctx, self.server,
                                 feed.name, parallel_tails,
                                 arrival=arrival)
                      for g in forest.groups()]
            self._feeds.append(_FeedState(feed, groups, arrival=arrival))

    @classmethod
    def from_fleet(cls, fleet, streams: Dict[str, Any], ctx: OpContext,
                   **kw) -> "MultiStreamRuntime":
        """Serve a whole ``repro_torch.core.fleet.FleetResult``: one feed per
        fleet feed (``streams`` maps feed name -> stream object), with the
        fleet's calibrated cost catalog backing the sharing-tree planner
        unless the caller supplies one explicitly."""
        assert set(streams) == set(fleet.plans_by_feed), \
            f"streams {sorted(streams)} != fleet feeds " \
            f"{sorted(fleet.plans_by_feed)}"
        feeds = [Feed(name, streams[name],
                      [p.clone() for p in plans])
                 for name, plans in fleet.plans_by_feed.items()]
        kw.setdefault("planner", SharingTreePlanner(
            catalog=fleet.catalog, micro_batch=kw.get("micro_batch", 16)))
        return cls(feeds, ctx, **kw)

    # ------------------------------------------------------------------
    def describe(self) -> str:
        return "\n".join(f"[{fs.name}]\n{self.forests[fs.name].describe()}"
                         for fs in self._feeds)

    # ------------------------------------------------------------------
    def audit(self, tolerance: float = 0.5):
        """A ``PlanAudit`` over this runtime's sharing forests, priced
        with the planner's own catalog / micro-batch / gate-hit-rate —
        call after ``run`` and join with ``self.obs.metrics`` for the
        predicted-vs-measured decision table."""
        from repro_torch.obs.audit import PlanAudit
        return PlanAudit.from_runtime(self, tolerance=tolerance)

    #: drift tolerance for end-of-run cost reconciliation (relative)
    reconcile_tolerance = 0.5
    #: drift-flagged catalog keys from the most recent reconcile
    drift_flags: List[str] = []

    def _reconcile_costs(self) -> None:
        """Close the audit loop: EMA-feed the run's measured op costs
        (device-probed forwards, prefix-op walls) back into the
        planner's catalog — the cost-model twin of the gate-hit-rate
        feedback in ``_collect`` — and keep the drift flags for the
        flight report.  No catalog, no measurements: no-op."""
        catalog = getattr(self.planner, "catalog", None)
        if catalog is None or not hasattr(catalog, "reconcile"):
            return
        audit = self.audit(tolerance=self.reconcile_tolerance)
        self.drift_flags = audit.reconcile(self.obs.metrics, catalog)

    # ------------------------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        """Aligned multi-feed checkpoint: per-feed source offsets + every
        group operator's state + the semantic gate's per-feed keyframes
        and tuned thresholds.  ``SharedExtractServer.drain()`` is the
        alignment barrier — in-flight extract continuations are run to
        completion and resumed first, so no channel holds data."""
        self._drain_all()
        assert not (self.server._queue or self.server._inflight)
        if self.obs.enabled:
            # the checkpoint is a natural audit boundary: everything
            # launched has retired, so the measured surfaces are complete
            # up to this instant — fold them into the catalog before the
            # state is frozen
            self._reconcile_costs()
        st: Dict[str, Any] = {"feeds": {}}
        for fs in self._feeds:
            st["feeds"][fs.name] = {
                "source_index": fs.source_index,
                "groups": [[op.snapshot() for op in g.all_ops()]
                           for g in fs.groups],
            }
        if self.server.gate is not None:
            st["gate"] = self.server.gate.snapshot()
        return st

    def restore(self, st: Dict[str, Any]) -> None:
        """Resume from a snapshot: replay each feed's stream to its
        recorded offset (the caller positions the streams, exactly like
        ``StreamRuntime``), restore operator + gating state, and suppress
        the next ``run``'s warmup reset."""
        assert set(st["feeds"]) == {fs.name for fs in self._feeds}
        for fs in self._feeds:
            fst = st["feeds"][fs.name]
            fs.source_index = fst["source_index"]
            assert len(fst["groups"]) == len(fs.groups)
            for g, states in zip(fs.groups, fst["groups"]):
                ops = g.all_ops()
                assert len(ops) == len(states)
                for op, s in zip(ops, states):
                    op.restore(s)
        if st.get("gate") is not None and self.server.gate is not None:
            self.server.gate.restore(st["gate"])
        self._restored = True

    # ------------------------------------------------------------------
    def _settle(self, fs: _FeedState) -> int:
        """Resume fulfilled continuations of one feed in FIFO order per
        group lane (so stateful post-extract ops observe stream order);
        re-suspensions keep their position in the queue.  Returns the
        number of continuations resumed."""
        if not self._chaos:
            fs.pendings, resumed = settle_fifo(
                fs.pendings, lambda group, p: group.resume(p))
            return resumed

        def resume(group, p):
            nxt = group.resume(p)
            if nxt is None:
                # this group finished the micro-batch: retire its share
                # of the frame-range ticket (advances ``served_upto``)
                self._ticket_done(fs, p.batch)
            return nxt

        fs.pendings, resumed = settle_fifo(fs.pendings, resume)
        return resumed

    def _ticket_done(self, fs: _FeedState, batch: Batch) -> None:
        i0 = batch.get("_ticket")
        if i0 is None:
            return                 # replay / flush batches carry no ticket
        left = fs.tickets.get(i0)
        if left is not None:
            if left <= 1:
                del fs.tickets[i0]
            else:
                fs.tickets[i0] = left - 1

    def _drain_all(self) -> None:
        """Blocking barrier: run every queued and in-flight forward and
        resume until no continuation is left (warmup, end of run, flush —
        the steady-state path is dispatch/poll in ``run``).

        A feed whose parked work holds a terminally failed request can
        never settle past it (its lane stays blocked), so the barrier
        leaves it to the breaker (``_chaos_turn`` trips it in the next
        scheduling round).  The reference's barrier waits for it forever:
        its lock-step run hangs once a request exhausts its retries."""
        while any(fs.pendings and not self._failed(fs)
                  for fs in self._feeds):
            self.server.drain()
            for fs in self._feeds:
                self._settle(fs)

    def _failed(self, fs: _FeedState) -> bool:
        """The feed holds a request that exhausted its retry budget."""
        return self._chaos and any(p.req.failed for _, p in fs.pendings)

    def _warmup(self) -> None:
        """One untimed batch per feed through its full group set (and the
        server: building the kernels and extract functions is the point), then
        rewind streams, reset ops, drop accumulators and server stats.
        The fault injector sleeps through warmup: warmup traffic must not
        consume schedule events (or fail unobserved)."""
        was_enabled = self.faults.enabled
        self.faults.enabled = False
        try:
            self._warmup_inner()
        finally:
            self.faults.enabled = was_enabled

    def _warmup_inner(self) -> None:
        for fs in self._feeds:
            def advance(batch):
                for g in fs.groups:
                    p = g.start(batch)
                    if p is not None:
                        fs.pendings.append((g, p))
                self._drain_all()

            warmup_ops(fs.feed.stream, self.micro_batch, advance,
                       fs.all_ops())
            assert not fs.pendings
            fs.source_index = 0
            for g in fs.groups:
                g.reset_accumulators()
        if self.server.gate is not None:
            # keyframes learned from warmup frames must not leak into the
            # measured stream — the gate resets exactly like the ops do
            self.server.gate.reset()
        self.server.reset_stats()

    # ------------------------------------------------------------------
    # fault-tolerant serving (active only with a live injector; every
    # entry point below is behind ``self._chaos``)
    # ------------------------------------------------------------------
    def _snap_feed(self, fs: _FeedState) -> None:
        """Per-feed recovery snapshot — taken only when the feed has no
        outstanding work, so every captured structure is quiescent and
        the semantic cache holds no pending entries."""
        assert not fs.pendings and not fs.tickets
        gate = self.server.gate
        fs.snap = {
            "next_pull": fs.source_index,
            "groups": [[op.snapshot() for op in g.all_ops()]
                       for g in fs.groups],
            "window_lens": [[len(w) for w in g.windows]
                            for g in fs.groups],
            "pcounts": [dict(g.pcounts) for g in fs.groups],
            "counts": [[dict(c) for c in g.counts] for g in fs.groups],
            "gate": gate.snapshot_feed(fs.name)
            if gate is not None and gate.active else None,
        }

    def _rollback(self, fs: _FeedState, keep_upto: int) -> None:
        """Restore ops/gate/accumulators to the feed's last snapshot.
        Sink records below ``keep_upto`` (the exactly-once frontier) are
        final — *served* — and are kept; the recovery replay re-drives
        those frames with sink collection suppressed, so operator state
        catches back up without serving any frame twice."""
        snap = fs.snap
        gate = self.server.gate
        for g, states, lens, pc, cc in zip(
                fs.groups, snap["groups"], snap["window_lens"],
                snap["pcounts"], snap["counts"]):
            for op, s in zip(g.all_ops(), states):
                if isinstance(op, SinkOp):
                    continue     # sinks truncate content-based below
                op.restore(s)
            for tail in g.exe.tails:
                sink = tail[-1]
                sink.collected = [r for r in sink.collected
                                  if r.get("idx", -1) < keep_upto]
            for wl, L in zip(g.windows, lens):
                del wl[L:]       # replay re-emits deterministically
            g.pcounts = dict(pc)
            g.counts = [dict(c) for c in cc]
        if gate is not None and snap.get("gate") is not None:
            gate.restore_feed(fs.name, snap["gate"])

    def _degrade_range(self, fs: _FeedState, a: int, b: int) -> None:
        """Account frames [a, b) as degraded (stale keyframe answer) or
        dropped (no answer available) — exact loss accounting, never a
        silently wrong result."""
        n = b - a
        if n <= 0:
            return
        obs = self.obs
        if fs.stale_answer is not None:
            for i in range(a, b):
                fs.degraded_records.append(
                    {"idx": i, "stale": True, "answer": fs.stale_answer})
            fs.n_degraded += n
            if obs.enabled:
                obs.tracer.instant("degraded", "degraded",
                                   track=f"feed:{fs.name}", n=n)
                obs.metrics.inc(f"faults/degraded/{fs.name}", n)
                obs.slo.record_degraded(fs.name, n)
        else:
            fs.n_dropped += n
            if obs.enabled:
                obs.tracer.instant("dropped", "degraded",
                                   track=f"feed:{fs.name}", n=n)
                obs.metrics.inc(f"faults/dropped/{fs.name}", n)
                obs.slo.record_dropped(fs.name, n)

    def _trip(self, fs: _FeedState, reason: str) -> None:
        """Open the feed's circuit: capture the stale-answer fallback,
        cancel parked submissions, account the un-served suffix and roll
        the feed back to its last snapshot so a later recovery can replay
        forward.  The rest of the fleet is untouched — its requests keep
        flowing through the shared server."""
        obs = self.obs
        gate = self.server.gate
        # let healthy in-flight work finish first: an *ingest* trip
        # leaves the extract path intact, so frames already accepted can
        # still be served exactly once — only an extract trip (a failed
        # request among the pendings) skips straight to cancellation
        while fs.pendings and \
                not any(p.req.failed for _, p in fs.pendings):
            self.server.drain()
            self._settle(fs)
        keep_upto = fs.served_upto
        pulled_upto = fs.source_index
        if gate is not None and gate.active:
            fs.stale_answer = gate.stale_answer(fs.name)
        for _, p in fs.pendings:
            inner = getattr(p.req, "inner", p.req)
            if inner is not None:
                self.server.cancel(inner)
        fs.pendings = []
        fs.tickets.clear()
        self._degrade_range(fs, keep_upto, pulled_upto)
        self._rollback(fs, keep_upto)
        fs.replay_to = keep_upto
        fs.breaker.trip(reason)
        if obs.enabled:
            obs.tracer.instant(f"quarantine[{fs.name}]", "quarantine",
                               track=f"feed:{fs.name}")
            obs.metrics.inc(f"faults/trips/{fs.name}", 1)

    def _outage_turn(self, fs: _FeedState,
                     remaining: Dict[str, int]) -> None:
        """One quarantined scheduling round: the frames the feed would
        have pulled are accounted (stale-served or dropped) without
        touching the stream — recovery repositions it.  The skipped pull
        still consumes its source schedule event: quarantine does not
        freeze the fault timeline, so a count-limited outage ages out
        and the probe's peek can eventually see daylight."""
        if remaining[fs.name] <= 0:
            return
        take = min(self.micro_batch, remaining[fs.name])
        self.faults.next_event("source", fs.name)
        self._degrade_range(fs, fs.source_index, fs.source_index + take)
        fs.source_index += take
        remaining[fs.name] -= take

    def _canary_ok(self, fs: _FeedState) -> bool:
        """Drive one isolated canary extract for the feed through the
        real server.  It consumes a forward schedule event — an honest
        probe pays the same schedule the feed's next request would."""
        variant = None
        for g in fs.groups:
            for op in g.exe.prefix:
                if isinstance(op, MLLMExtractOp):
                    v = getattr(op, "model", "small")
                    variant = v if v in SharedExtractServer.VARIANTS \
                        else "small"
                    break
            if variant is not None:
                break
        if variant is None:
            return True      # no extract path: the transport peek decides
        frames = np.zeros((1,) + tuple(self.ctx.frame_shape),
                          dtype=np.float32)
        req = self.server.probe(variant, frames, feed=fs.name)
        while not req.done and not req.failed:
            self.server.dispatch()
            if self.server._inflight:
                self.server._inflight[0].block()
            self.server.poll()
        return not req.failed

    def _replay(self, fs: _FeedState) -> bool:
        """Recovery: reposition the stream and re-drive frames
        [snap.next_pull, replay_to) with sink collection suppressed —
        operator/gate/window state catches back up to the exactly-once
        frontier without serving any frame twice — then skip the stream
        past the degraded gap.  A terminal extract failure mid-replay
        rolls back again and reports False (the breaker re-opens with a
        doubled cooldown)."""
        snap = fs.snap
        start = snap["next_pull"]
        target = fs.replay_to
        stream = fs.feed.stream
        stream.reset()
        if start:
            stream.batch(start)
        pos = start
        ok = True
        while pos < target and ok:
            take = min(self.micro_batch, target - pos)
            frames, _ = stream.batch(take)
            batch = {"frames": frames,
                     "idx": np.arange(pos, pos + take),
                     "_suppress_sink": True}
            for g in fs.groups:
                p = g.start(batch)
                if p is not None:
                    fs.pendings.append((g, p))
            pos += take
            while fs.pendings:
                if any(p.req.failed for _, p in fs.pendings):
                    ok = False
                    break
                self.server.drain()
                self._settle(fs)
        if not ok:
            for _, p in fs.pendings:
                inner = getattr(p.req, "inner", p.req)
                if inner is not None:
                    self.server.cancel(inner)
            fs.pendings = []
            self._rollback(fs, fs.replay_to)
            return False
        if fs.source_index > target:
            stream.batch(fs.source_index - target)  # skip the degraded gap
        return True

    def _probe(self, fs: _FeedState) -> None:
        """Half-open: one probe decides.  The transport is *peeked*
        (would the next delivery fail past the retry budget?) without
        consuming a schedule event; the device path pays a real isolated
        canary forward.  Success replays from the last snapshot and
        closes the breaker; failure re-opens it with a doubled cooldown."""
        obs = self.obs
        br = fs.breaker
        if obs.enabled:
            obs.tracer.instant(f"probe[{fs.name}]", "quarantine",
                               track=f"feed:{fs.name}")
            obs.metrics.inc(f"faults/probes/{fs.name}", 1)
        fi = self.faults
        f = fi.fault_at("source", fs.name, "",
                        fi.peek_event("source", fs.name))
        src_dead = f is not None and f[0] == "corrupt" \
            and f[1] > self.ingest_retries
        if src_dead or not self._canary_ok(fs) or not self._replay(fs):
            br.probe_failed()
            return
        br.close()
        fs.stale_answer = None
        fs.replay_to = None
        self._snap_feed(fs)
        if obs.enabled:
            obs.tracer.instant(f"recovered[{fs.name}]", "quarantine",
                               track=f"feed:{fs.name}")
            obs.metrics.inc(f"faults/recoveries/{fs.name}", 1)

    def _ingest(self, fs: _FeedState, take: int) -> tuple:
        """One guarded pull: returns ``("ok", frames, labels)``,
        ``("stall",)`` — the feed produced nothing this round — or
        ``("lost",)`` when corrupt-delivery retries are exhausted (the
        caller accounts the frames and trips the breaker)."""
        fi = self.faults
        ev = fi.next_event("source", fs.name)
        f = fi.fault_at("source", fs.name, "", ev)
        if f is not None and f[0] == "stall":
            fi.fire("source", fs.name, "", ev)           # log the stall
            if self.obs.enabled:
                self.obs.tracer.instant("fault:stall", "fault",
                                        track=f"feed:{fs.name}", n=take)
            return ("stall",)
        frames, labels = fs.feed.stream.batch(take)
        if f is None:
            return ("ok", frames, labels)
        # corrupt transport: bounded redelivery against the same event —
        # a cleared attempt returns the pristine frames (bitwise)
        for attempt in range(self.ingest_retries + 1):
            got = fi.transport(fs.name, frames, ev, attempt)
            if fi.delivered_ok(got):
                return ("ok", got, labels)
        return ("lost",)

    def _chaos_turn(self, fs: _FeedState,
                    remaining: Dict[str, int]) -> Optional[bool]:
        """Breaker gate in front of a feed's scheduling turn: None lets
        the normal serve path run; otherwise the turn was consumed here
        and the value is whether it made progress (a quarantined feed
        with nothing left to account is *idle* — claiming progress would
        starve the other feeds' force-dispatch/wait path forever)."""
        br = fs.breaker
        if br.closed:
            if any(p.req.failed for _, p in fs.pendings):
                self._trip(fs, "extract retry budget exhausted")
                return True
            return None
        if br.state == OPEN:
            if remaining[fs.name] <= 0:
                br.tick()
                return False
            self._outage_turn(fs, remaining)
            br.tick()
            return True
        self._probe(fs)
        return True

    # ------------------------------------------------------------------
    def run(self, n_frames: Union[int, Dict[str, int]],
            warmup: int = 1) -> MultiStreamResult:
        """Drive every feed ``n_frames`` frames (int, or per-feed dict).

        ``warmup=1`` (default) makes this a *fresh* measurement — streams
        rewound, every op reset — exactly like ``StreamRuntime.run``; pass
        ``warmup=0`` to continue previous segments (the first run after
        ``restore()`` continues automatically).  Either way, sinks and
        per-run accumulators start empty."""
        if isinstance(n_frames, int):
            frames_by_feed = {fs.name: n_frames for fs in self._feeds}
        else:
            frames_by_feed = dict(n_frames)
            assert set(frames_by_feed) == {fs.name for fs in self._feeds}

        for fs in self._feeds:
            assert not fs.pendings
            fs.labels = []
            for g in fs.groups:
                g.begin_run()
            if self._chaos:
                fs.breaker = CircuitBreaker(self.breaker_cooldown)
                fs.tickets = {}
                fs.snap = None
                fs.stale_answer = None
                fs.replay_to = None
                fs.degraded_records = []
                fs.n_degraded = fs.n_dropped = 0
        if warmup and not self._restored:
            self._warmup()
        self._restored = False
        if self._chaos:
            # run-start snapshot: rollback always has a floor to land on
            for fs in self._feeds:
                self._snap_feed(fs)
        # per-run (not lifetime) model load, per prefix/tail component —
        # the same convention as the single-stream executors
        mllm_start = {
            fs.name: [(mllm_frames_of(g.exe.prefix),
                       [mllm_frames_of(t) for t in g.exe.tails])
                      for g in fs.groups]
            for fs in self._feeds}

        remaining = dict(frames_by_feed)
        t0 = time.perf_counter()
        rnd = 0
        while any(remaining.values()) or \
                any(fs.pendings for fs in self._feeds):
            order = self._feeds[rnd % len(self._feeds):] + \
                self._feeds[:rnd % len(self._feeds)]
            progressed = False
            for fs in order:
                if self._chaos:
                    ct = self._chaos_turn(fs, remaining)
                    if ct is not None:      # trip / quarantine / probe
                        progressed = progressed or ct
                        continue
                if remaining[fs.name] <= 0:
                    continue
                if len(fs.pendings) >= self.max_pending * len(fs.groups):
                    continue                      # per-stream backpressure
                if self._chaos and not fs.tickets and not fs.pendings \
                        and rnd % self.snapshot_every == 0:
                    self._snap_feed(fs)           # opportunistic, quiescent
                take = min(self.micro_batch, remaining[fs.name])
                obs = self.obs
                t_pull = obs.now() if obs.enabled else 0
                if self._chaos:
                    got = self._ingest(fs, take)
                    if got[0] == "stall":
                        continue   # the feed produced nothing this round
                    if got[0] == "lost":
                        # delivery retries exhausted: quarantine first
                        # (healthy in-flight frames settle and serve),
                        # then account the lost batch itself
                        self._trip(fs,
                                   "ingest delivery retries exhausted")
                        self._degrade_range(fs, fs.source_index,
                                            fs.source_index + take)
                        fs.source_index += take
                        remaining[fs.name] -= take
                        progressed = True
                        continue
                    frames, labels = got[1], got[2]
                else:
                    frames, labels = fs.feed.stream.batch(take)
                fs.labels.extend(labels)
                batch = {"frames": frames,
                         "idx": np.arange(fs.source_index,
                                          fs.source_index + take)}
                if self._chaos:
                    # frame-range ticket: retired once every group's
                    # fan-out for this micro-batch completes — the
                    # outstanding set defines ``served_upto``
                    fs.tickets[fs.source_index] = len(fs.groups)
                    batch["_ticket"] = fs.source_index
                if obs.enabled:
                    # lifecycle stamps ride the batch dict (every op
                    # copies it, so they survive to fan-out); the shared
                    # arrival slot feeds the staleness measure
                    t_arr = obs.now()
                    obs.tracer.span("ingest", "ingest", t_pull, t_arr,
                                    track=f"feed:{fs.name}", n=take)
                    batch["_obs_t0"] = t_arr
                    batch["_obs_n"] = take
                    fs.arrival[0] = t_arr
                fs.source_index += take
                remaining[fs.name] -= take
                for g in fs.groups:
                    p = g.start(batch)
                    if p is not None:
                        fs.pendings.append((g, p))
                    elif self._chaos:
                        self._ticket_done(fs, batch)
                progressed = True
            if self.pipelined:
                # overlap: ship the queue when the coalescing window fills
                # (or every feed is parked), harvest whatever the device
                # finished while this round did host-side work, resume
                # those continuations, and block only when truly stalled
                self.server.pump(
                    progressed, self.coalesce_frames,
                    lambda: sum(self._settle(fs) for fs in self._feeds))
            elif self.server.pending_frames() >= self.coalesce_frames \
                    or not progressed:
                self._drain_all()                 # lock-step baseline
            rnd += 1
        self._drain_all()
        for fs in self._feeds:
            if self._chaos and fs.breaker is not None \
                    and not fs.breaker.closed:
                # still quarantined at end of run: window aggregates over
                # the outage would cover frames the feed never served —
                # withhold them (never wrong) instead of emitting
                # partial answers
                continue
            for g in fs.groups:
                g.flush()
        wall = time.perf_counter() - t0

        return self._collect(frames_by_feed, mllm_start, wall)

    # ------------------------------------------------------------------
    def _collect(self, frames_by_feed: Dict[str, int],
                 mllm_start: Dict[str, List[tuple]],
                 wall: float) -> MultiStreamResult:
        total_q = sum(len(g.exe.queries) for fs in self._feeds
                      for g in fs.groups)
        #: query-frames served this run — feeds may have different budgets
        total_qframes = sum(
            frames_by_feed[fs.name] * sum(len(g.exe.queries)
                                          for g in fs.groups)
            for fs in self._feeds)
        feeds: Dict[str, FeedResult] = {}
        total_mllm = 0
        for fs in self._feeds:
            n = frames_by_feed[fs.name]
            per_query: Dict[str, RunResult] = {}
            used: set = set()
            feed_mllm = 0
            for gi, g in enumerate(fs.groups):
                prefix_start, tail_starts = mllm_start[fs.name][gi]
                prefix_mllm = mllm_frames_of(g.exe.prefix) - prefix_start
                tail_mllms = [mllm_frames_of(t) - s
                              for t, s in zip(g.exe.tails, tail_starts)]
                feed_mllm += prefix_mllm + sum(tail_mllms)
                for qi, qid in enumerate(g.exe.queries):
                    tail = g.exe.tails[qi]
                    key = qid
                    k = 1
                    while key in used:           # same qid in two groups
                        key = f"{qid}#{k}"
                        k += 1
                    used.add(key)
                    q_counts = dict(g.pcounts)
                    q_counts.update(g.counts[qi])
                    # amortized sharing convention (as MultiQueryRuntime):
                    # per-query fps is the aggregate query-frames/s every
                    # query experiences, and per-query walls — weighted by
                    # each query's frame budget — sum to the shared wall
                    per_query[key] = RunResult(
                        fps=total_qframes / wall,
                        wall_s=wall * n / max(total_qframes, 1),
                        n_frames=n,
                        outputs=tail[-1].collected,
                        window_results=g.windows[qi],
                        op_input_counts=q_counts,
                        mllm_frames=prefix_mllm + tail_mllms[qi],
                        labels=fs.labels,
                    )
            total_mllm += feed_mllm
            feeds[fs.name] = FeedResult(
                name=fs.name, n_frames=n, mllm_frames=feed_mllm,
                per_query=per_query,
                plan=self.forests[fs.name].describe(),
                # served + degraded + dropped == n: the exact partition
                # of the feed's ingested frames the chaos tests assert
                served=n - fs.n_degraded - fs.n_dropped,
                degraded=fs.n_degraded,
                dropped=fs.n_dropped,
                degraded_records=list(fs.degraded_records),
                breaker=dict(fs.breaker.counters)
                if fs.breaker is not None else {},
            )
        gate = self.server.gate
        if gate is not None and gate.active and \
                getattr(self.planner, "catalog", None) is not None:
            # close the cost-model loop: the measured per-feed hit rates
            # land in the planner's catalog, so the next planning pass
            # (SharingTreePlanner / FleetOptimizer) prices gated extracts
            # at their observed, not assumed, model load
            for fs in self._feeds:
                if gate.served(fs.name):
                    self.planner.catalog.record_gate_hit_rate(
                        fs.name, gate.hit_rate(fs.name))
        if self.obs.enabled:
            # unify the ad-hoc surfaces: server stats + gate counters land
            # in the registry next to the latency/staleness histograms
            m = self.obs.metrics
            m.ingest("server", self.server.stats)
            m.set_gauge("run/wall_s", wall)
            m.set_gauge("run/fps", total_qframes / wall)
            # a truncated trace looks complete in Perfetto — surface the
            # tracer's overwrite count where dashboards actually look
            m.counter("tracer/dropped_events").set(
                getattr(self.obs.tracer, "dropped", 0))
            for name, fr in feeds.items():
                m.counter(f"mllm_frames/{name}").set(fr.mllm_frames)
            if self._chaos:
                for fs in self._feeds:
                    if fs.breaker is not None:
                        m.ingest(f"breaker/{fs.name}",
                                 fs.breaker.counters)
            self._reconcile_costs()
        return MultiStreamResult(
            fps=total_qframes / wall,
            wall_s=wall,
            n_feeds=len(self._feeds),
            n_queries=total_q,
            mllm_frames=total_mllm,
            server_stats=dict(self.server.stats),
            feeds=feeds,
        )
