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

The reference's pipelined path (``server=``, a ``SharedExtractServer``)
and ``from_fleet`` come with the serving tier (ROADMAP queue 1 item 6).
"""
from __future__ import annotations

import dataclasses
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional

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
    absent).  ``server=`` (the pipelined path) is not ported yet."""

    def __init__(self, plans: List[Plan], ctx: Optional[OpContext] = None,
                 micro_batch: int = 16, parallel_tails: bool = True,
                 server=None):
        if server is not None:
            raise NotImplementedError(
                "MultiQueryRuntime(server=...): the pipelined path through "
                "a SharedExtractServer comes with the serving tier "
                "(ROADMAP queue 1 item 6); pass server=None")
        # local import: repro_torch.core pulls in the optimizer stack
        from repro_torch.core.multiquery import factor_plans

        self.shared = factor_plans(plans)
        self.parallel_tails = parallel_tails
        self._init_scaffold(ctx if ctx is not None else OpContext(),
                            micro_batch, self._all_ops())
        for tail in self.shared.tails:
            assert isinstance(tail[-1], SinkOp), "tails must end in a Sink"

    def _all_ops(self) -> List[Op]:
        ops = list(self.shared.prefix)
        for tail in self.shared.tails:
            ops.extend(tail)
        return ops

    # ------------------------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        # the solo path's gate state rides the extract op's own snapshot
        return {
            "source_index": self._source_index,
            "prefix": [op.snapshot() for op in self.shared.prefix],
            "tails": [[op.snapshot() for op in tail]
                      for tail in self.shared.tails],
        }

    def restore(self, st: Dict[str, Any]) -> None:
        self._source_index = st["source_index"]
        for op, s in zip(self.shared.prefix, st["prefix"]):
            op.restore(s)
        for tail, states in zip(self.shared.tails, st["tails"]):
            for op, s in zip(tail, states):
                op.restore(s)
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
    def _collect(self, wall: float, n_frames: int, labels_all,
                 pcounts, counts, windows, prefix_mllm_start,
                 tail_mllm_start) -> MultiQueryResult:
        sinks = [tail[-1] for tail in self.shared.tails]
        n_q = len(self.shared.tails)
        if self.obs.enabled:
            self.obs.metrics.set_gauge("run/wall_s", wall)
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
