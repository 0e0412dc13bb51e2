"""Multi-query shared-execution runtime (synchronous).

Counterpart of ``repro/streaming/multiquery.py``.  ``MultiQueryRuntime``
serves N concurrent queries over one stream with one pass over the frames:
the planner (``repro_torch.core.multiquery.factor_plans``) factors the
plans' longest common operator prefix, including a single union-task MLLM
extract, and the runtime pushes each micro-batch through that prefix once,
then fans the annotated batch out to the per-query relational tails
(Filter / WindowAgg / Sink).

Results are reported *per query* as ordinary ``RunResult``s (so the
catalog evaluators score each query exactly as if it ran alone), plus
aggregate throughput and the total MLLM frame count: the sharing claim is
``mllm_frames(shared) < sum_q mllm_frames(independent_q)`` with per-query
outputs bitwise identical.  The merged extract sees the same micro-batches
as each solo extract and computes every head in one forward, so each
query's records equal its solo run's bit for bit.

Per-query tails are independent (each owns its operator instances and its
accumulators), so the fan-out dispatches them on a process-wide pool of
eight threads.  A tail may hold a device operator where factoring stopped
before the extract; every device entry point sets its own grad mode
(thread-local in PyTorch) and the kernels count launches under a lock.

An aligned snapshot captures the source offset and every prefix and tail
operator's state, and the first ``run()`` after ``restore()`` suppresses
the warmup reset.

With ``ctx.obs`` set, every micro-batch is an SLO record of feed ``mq`` (as
in the reference), and, beyond the reference's synchronous path, every
prefix operator call is an ``op:<name>`` span (category ``prefix``) and
every fan-out a ``tail`` span, both on the ``feed:mq`` track.

Passing a ``SharedExtractServer`` (``server=``) switches ``run`` to the
*pipelined* serving path: the shared prefix suspends at its extract op,
the forward is dispatched through the server (on its own CUDA stream), and
the next micro-batch's source pull, prefix ops and tail fan-out overlap
it: the dispatch/poll/resume protocol of ``MultiStreamRuntime``, under the
feed label ``mq``.  Outputs equal the synchronous path's (``server=None``,
the default).  ``from_fleet`` serves one feed of a ``FleetResult``.
"""
from __future__ import annotations

import dataclasses
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.obs import NULL_OBS
from repro_torch.streaming.operators import Batch, Op, OpContext, SinkOp
from repro_torch.streaming.plan import Plan
from repro_torch.streaming.runtime import (
    RunResult,
    RunScaffold,
    drive_stream,
    flush_ops,
    mllm_frames_of,
)

#: one process-wide pool shared by every fan-out (runtimes come and go per
#: run; a per-runtime pool would leak idle threads)
_FANOUT_POOL: Optional[ThreadPoolExecutor] = None
_FANOUT_WORKERS = 8


def _fanout_pool() -> ThreadPoolExecutor:
    global _FANOUT_POOL
    if _FANOUT_POOL is None:
        _FANOUT_POOL = ThreadPoolExecutor(
            max_workers=_FANOUT_WORKERS, thread_name_prefix="fanout")
    return _FANOUT_POOL


def fan_out_tails(tails: List[List[Op]], batch: Batch,
                  counts: List[Dict[str, int]],
                  windows: List[List[Dict[str, Any]]],
                  parallel: bool = True) -> None:
    """Push one fully advanced prefix batch through every per-query tail.

    Each tail owns its op instances and writes only its own ``counts[qi]``
    / ``windows[qi]`` slot, and operators copy-on-write the shared batch
    dict, so the tails are embarrassingly parallel.  ``parallel=False``
    keeps the sequential loop (single tail, or debugging)."""
    def one(qi: int) -> None:
        b = batch
        for op in tails[qi]:
            counts[qi][op.name] += len(b["idx"])
            b = op.process(b)
            if "window_results" in b:
                windows[qi].extend(b.pop("window_results"))

    if not parallel or len(tails) <= 1:
        for qi in range(len(tails)):
            one(qi)
    else:
        # list() propagates the first tail exception to the caller
        list(_fanout_pool().map(one, range(len(tails))))


def broadcast_windows(batch: Batch,
                      windows: List[List[Dict[str, Any]]]) -> Batch:
    """Pop window results emitted by a *shared prefix* op and append them
    to every query's accumulator: a window op shared by every query
    produces results that belong to all of them."""
    if "window_results" in batch:
        wr = batch.pop("window_results")
        for w in windows:
            w.extend(wr)
    return batch


def flush_shared(prefix: List[Op], tails: List[List[Op]],
                 windows: List[List[Dict[str, Any]]], fan_out) -> None:
    """End-of-stream flush for a shared prefix + per-query tails: prefix
    partials broadcast to every query and fan out through the tails, then
    each tail flushes into its own accumulator."""
    def emit_all(wr):
        for w in windows:
            w.extend(wr)

    flush_ops(prefix, emit_all, terminal=fan_out)
    for qi, tail in enumerate(tails):
        flush_ops(tail, windows[qi].extend)


@dataclasses.dataclass
class MultiQueryResult:
    #: aggregate throughput in query-frames/s (n_queries * n_frames / wall)
    fps: float
    wall_s: float
    n_frames: int
    n_queries: int
    #: frames through MLLM extracts this run (shared prefix counted once)
    mllm_frames: int
    shared_plan: str
    #: per-query RunResults score exactly as standalone runs; their wall_s
    #: is the shared wall *amortized* over the queries (per-query walls sum
    #: to the shared wall)
    per_query: Dict[str, RunResult]


class MultiQueryRuntime(RunScaffold):
    """Runs N plans over one stream with a shared prefix.  ``ctx=None``
    builds a model-less ``OpContext`` on CUDA (raising where CUDA is
    absent).  ``server=`` (a ``SharedExtractServer``) takes the pipelined
    path; ``max_pending`` bounds its outstanding continuations and
    ``coalesce_frames`` (default: one micro-batch) is its dispatch
    window."""

    def __init__(self, plans: List[Plan], ctx: Optional[OpContext] = None,
                 micro_batch: int = 16, parallel_tails: bool = True,
                 server=None, max_pending: int = 2,
                 coalesce_frames: Optional[int] = None):
        # local import: repro_torch.core pulls in the optimizer stack
        from repro_torch.core.multiquery import factor_plans

        self.shared = factor_plans(plans)
        self.parallel_tails = parallel_tails
        self._init_scaffold(ctx if ctx is not None else OpContext(),
                            micro_batch, self._all_ops())
        for tail in self.shared.tails:
            assert isinstance(tail[-1], SinkOp), "tails must end in a Sink"
        #: pipelined serving (a SharedExtractServer); None keeps the
        #: synchronous in-line extract path
        self.server = server
        self.max_pending = max_pending
        #: dispatch once this many frames are queued; a single feed fills
        #: one micro-batch per pull, so default to shipping every batch
        self.coalesce_frames = coalesce_frames if coalesce_frames is not None \
            else micro_batch
        self._gexec = None
        if server is not None:
            # deferred: repro_torch.scheduler imports this module
            from repro_torch.scheduler.multistream import _GroupExec

            self._gexec = _GroupExec(self.shared, self.ctx, server,
                                     feed="mq",
                                     parallel_tails=parallel_tails,
                                     open_ops=False)

    @classmethod
    def from_fleet(cls, fleet, feed: str, ctx: OpContext,
                   **kw) -> "MultiQueryRuntime":
        """Serve one feed of a ``repro_torch.core.fleet.FleetResult``: the
        fleet optimizer canonicalized the plans' prefixes, so factoring
        here recovers the sharing the joint optimizer planned for."""
        return cls([p.clone() for p in fleet.plans_by_feed[feed]], ctx, **kw)

    def _all_ops(self) -> List[Op]:
        ops = list(self.shared.prefix)
        for tail in self.shared.tails:
            ops.extend(tail)
        return ops

    # ------------------------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        st = {
            "source_index": self._source_index,
            "prefix": [op.snapshot() for op in self.shared.prefix],
            "tails": [[op.snapshot() for op in tail]
                      for tail in self.shared.tails],
        }
        if self.server is not None and self.server.gate is not None:
            # the server path gates under this runtime's feed label; the
            # solo path's gate state rides the extract op's own snapshot
            st["gate"] = self.server.gate.snapshot_feed("mq")
        return st

    def restore(self, st: Dict[str, Any]) -> None:
        self._source_index = st["source_index"]
        for op, s in zip(self.shared.prefix, st["prefix"]):
            op.restore(s)
        for tail, states in zip(self.shared.tails, st["tails"]):
            for op, s in zip(tail, states):
                op.restore(s)
        if st.get("gate") is not None and self.server is not None \
                and self.server.gate is not None:
            self.server.gate.restore_feed("mq", st["gate"])
        self._mark_restored()

    # ------------------------------------------------------------------
    def _fan_out(self, batch: Batch, counts: List[Dict[str, int]],
                 windows: List[List[Dict[str, Any]]]) -> None:
        fan_out_tails(self.shared.tails, batch, counts, windows,
                      parallel=self.parallel_tails)

    def _advance(self, batch: Batch, pcounts: Dict[str, int],
                 counts: List[Dict[str, int]],
                 windows: List[List[Dict[str, Any]]],
                 obs=NULL_OBS) -> None:
        for op in self.shared.prefix:
            pcounts[op.name] += len(batch["idx"])
            if obs.enabled:
                t_op = obs.now()
                batch = op.process(batch)
                obs.tracer.span(f"op:{op.name}", "prefix", t_op, obs.now(),
                                track="feed:mq", n=len(batch["idx"]))
            else:
                batch = op.process(batch)
            batch = broadcast_windows(batch, windows)
        if obs.enabled:
            t_tail = obs.now()
            self._fan_out(batch, counts, windows)
            obs.tracer.span("tail", "tail", t_tail, obs.now(),
                            track="feed:mq", n=len(batch["idx"]))
        else:
            self._fan_out(batch, counts, windows)

    def _flush(self, counts: List[Dict[str, int]],
               windows: List[List[Dict[str, Any]]]) -> None:
        flush_shared(self.shared.prefix, self.shared.tails, windows,
                     lambda b: self._fan_out(b, counts, windows))

    # ------------------------------------------------------------------
    def run(self, stream, n_frames: int, warmup: int = 1,
            flush: bool = True) -> MultiQueryResult:
        if self.server is not None:
            return self._run_pipelined(stream, n_frames, warmup, flush)
        sinks = [tail[-1] for tail in self.shared.tails]
        for sink in sinks:
            sink.collected = []
        pcounts: Dict[str, int] = {op.name: 0 for op in self.shared.prefix}
        counts: List[Dict[str, int]] = [
            {op.name: 0 for op in tail} for tail in self.shared.tails]
        windows: List[List[Dict[str, Any]]] = [[] for _ in self.shared.tails]
        labels_all: List[Dict[str, Any]] = []

        def warm_advance(batch):
            # throwaway accumulators; SinkOp.reset() drops warmup records
            self._advance(batch, dict(pcounts), [dict(c) for c in counts],
                          [[] for _ in windows])

        self._begin_run(stream, warmup, warm_advance, self._all_ops())
        # per-run (not lifetime) model load, per prefix/tail component
        prefix_mllm_start = mllm_frames_of(self.shared.prefix)
        tail_mllm_start = [mllm_frames_of(tail)
                           for tail in self.shared.tails]

        obs = self.obs

        def advance(batch):
            self._stamp(batch)
            if obs.enabled:
                t_arr = obs.now()
                n0 = len(batch["idx"])
                self._advance(batch, pcounts, counts, windows, obs)
                obs.slo.record("mq", (obs.now() - t_arr) / 1e6, n=n0)
            else:
                self._advance(batch, pcounts, counts, windows)

        t0 = time.perf_counter()
        drive_stream(stream, n_frames, self.micro_batch,
                     self._source_index, advance, labels_all)
        if flush:
            self._flush(counts, windows)
        if self.ctx.device.type == "cuda":
            torch.cuda.synchronize(self.ctx.device)
        wall = time.perf_counter() - t0
        return self._collect(wall, n_frames, labels_all, pcounts, counts,
                             windows, prefix_mllm_start, tail_mllm_start)

    # ------------------------------------------------------------------
    def _run_pipelined(self, stream, n_frames: int, warmup: int,
                       flush: bool) -> MultiQueryResult:
        """Dispatch-ahead serving through the SharedExtractServer: the
        prefix suspends at its extract, the forward runs on the server's
        stream, and the next micro-batch's host work overlaps it.
        ``max_pending`` bounds outstanding continuations; resume order is
        FIFO, so outputs equal the synchronous path's."""
        from repro_torch.scheduler.extract_server import settle_fifo

        g = self._gexec
        g.begin_run()
        labels_all: List[Dict[str, Any]] = []
        pendings: List[tuple] = []

        def resume(lane, p):
            return lane.resume(p)

        def drain_pendings():
            nonlocal pendings
            while pendings:
                self.server.drain()
                pendings, _ = settle_fifo(pendings, resume)

        def warm_advance(batch):
            p = g.start(batch)
            if p is not None:
                pendings.append((g, p))
            drain_pendings()

        fresh = warmup and not self._restored
        self._begin_run(stream, warmup, warm_advance, self._all_ops())
        if fresh:
            g.reset_accumulators()
            if self.server.gate is not None:
                self.server.gate.reset("mq")   # no warmup keyframe leaks
            self.server.reset_stats()
        prefix_mllm_start = mllm_frames_of(self.shared.prefix)
        tail_mllm_start = [mllm_frames_of(tail)
                           for tail in self.shared.tails]

        def settle() -> int:
            nonlocal pendings
            pendings, resumed = settle_fifo(pendings, resume)
            return resumed

        base = self._source_index
        done = 0
        obs = self.obs
        t0 = time.perf_counter()
        while done < n_frames or pendings:
            progressed = False
            if done < n_frames and len(pendings) < self.max_pending:
                take = min(self.micro_batch, n_frames - done)
                t_pull = obs.now() if obs.enabled else 0
                frames, labels = stream.batch(take)
                labels_all.extend(labels)
                batch = {"frames": frames,
                         "idx": np.arange(base + done, base + done + take)}
                done += take
                self._stamp(batch)
                if obs.enabled:
                    t_arr = obs.now()
                    obs.tracer.span("ingest", "ingest", t_pull, t_arr,
                                    track="feed:mq", n=take)
                    batch["_obs_t0"] = t_arr
                    batch["_obs_n"] = take
                    g.arrival[0] = t_arr
                p = g.start(batch)
                if p is not None:
                    pendings.append((g, p))
                progressed = True
            self.server.pump(progressed, self.coalesce_frames, settle)
        drain_pendings()
        if flush:
            g.flush()
        if self.ctx.device.type == "cuda":
            torch.cuda.synchronize(self.ctx.device)
        wall = time.perf_counter() - t0
        return self._collect(wall, n_frames, labels_all, g.pcounts,
                             g.counts, g.windows, prefix_mllm_start,
                             tail_mllm_start)

    # ------------------------------------------------------------------
    def _collect(self, wall: float, n_frames: int, labels_all,
                 pcounts, counts, windows, prefix_mllm_start,
                 tail_mllm_start) -> MultiQueryResult:
        sinks = [tail[-1] for tail in self.shared.tails]
        n_q = len(self.shared.tails)
        if self.obs.enabled:
            self.obs.metrics.set_gauge("run/wall_s", wall)
            if self.server is not None:
                self.obs.metrics.ingest("server", self.server.stats)
        prefix_mllm = mllm_frames_of(self.shared.prefix) - prefix_mllm_start
        per_query: Dict[str, RunResult] = {}
        total_mllm = prefix_mllm
        for qi, (qid, tail) in enumerate(zip(self.shared.queries,
                                             self.shared.tails)):
            tail_mllm = mllm_frames_of(tail) - tail_mllm_start[qi]
            total_mllm += tail_mllm
            q_counts = dict(pcounts)
            q_counts.update(counts[qi])
            per_query[qid] = RunResult(
                fps=n_frames * n_q / wall,
                wall_s=wall / n_q,
                n_frames=n_frames,
                outputs=sinks[qi].collected,
                window_results=windows[qi],
                op_input_counts=q_counts,
                mllm_frames=prefix_mllm + tail_mllm,
                labels=labels_all,
            )
        return MultiQueryResult(
            fps=n_q * n_frames / wall,
            wall_s=wall,
            n_frames=n_frames,
            n_queries=n_q,
            mllm_frames=total_mllm,
            shared_plan=self.shared.describe(),
            per_query=per_query,
        )
