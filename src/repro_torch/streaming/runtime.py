"""Micro-batch streaming runtime.

Counterpart of ``repro/streaming/runtime.py``.  Drives a Plan over a frame
stream: pulls micro-batches from the source, pushes them through the
operator chain (each op may drop rows; the runtime forwards the compacted
batch), collects sink outputs, and tracks per-operator input counts + wall
time (the paper's FPS / model-load metrics).

``snapshot()`` captures every operator's state + the source frame index;
``restore()`` resumes by replaying the source from the recorded offset, and
the first ``run()`` after it suppresses the warmup reset.

With ``ctx.obs`` set, every operator call is an ``op:<name>`` span on the
``stream`` track and every micro-batch an SLO record of feed ``stream``
(host clock; nothing synchronizes the card on that account); with
``ctx.faults`` set, the measured stream goes through ``guard_stream``'s
transport validation and bounded redelivery.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.faults import guard_stream
from repro_torch.obs import resolve_obs
from repro_torch.streaming.operators import (
    MLLMExtractOp,
    Op,
    OpContext,
    SinkOp,
)
from repro_torch.streaming.plan import Plan


@dataclasses.dataclass
class RunResult:
    fps: float
    wall_s: float
    n_frames: int
    outputs: List[Dict[str, Any]]
    window_results: List[Dict[str, Any]]
    op_input_counts: Dict[str, int]
    mllm_frames: int
    labels: List[Dict[str, Any]]


# ---------------------------------------------------------------------------
# Shared warmup / end-of-stream protocol
# ---------------------------------------------------------------------------

def warmup_ops(stream, micro_batch: int, advance, ops: List[Op]) -> None:
    """Push one untimed batch (negative indices, separate from the measured
    stream) through ``advance`` to trigger one-time set-up (kernel builds,
    library handles), then rewind the stream and Op.reset() every operator
    so no warmup state leaks."""
    frames, labels = stream.batch(micro_batch)
    advance({"frames": frames,
             "idx": np.arange(len(labels)) - len(labels)})
    stream.reset()
    for op in ops:
        op.reset()


def mllm_frames_of(ops: List[Op]) -> int:
    """Lifetime MLLM model load of an op chain (frames through extracts)."""
    return sum(op.frames_processed for op in ops
               if isinstance(op, MLLMExtractOp))


class RunScaffold:
    """Run-lifecycle bookkeeping shared by executors: warmup suppression
    after restore(), per-run ``mllm_frames`` reporting, and the
    per-micro-batch source-index advance."""

    def _init_scaffold(self, ctx: OpContext, micro_batch: int,
                       ops: List[Op]) -> None:
        self.ctx = dataclasses.replace(ctx, micro_batch=micro_batch)
        self.micro_batch = micro_batch
        #: observability handle (``ctx.obs`` or the inert NULL_OBS)
        self.obs = resolve_obs(ctx.obs)
        for op in ops:
            op.open(self.ctx)
        self._source_index = 0
        self._restored = False

    def _mark_restored(self) -> None:
        """The next run() must not warmup-reset the restored state."""
        self._restored = True

    def _begin_run(self, stream, warmup: int, advance, ops: List[Op],
                   ) -> int:
        """Warmup (unless suppressed by a preceding restore) and return the
        run's MLLM model-load baseline over ``ops``."""
        if warmup and not self._restored:
            warmup_ops(stream, self.micro_batch, advance, ops)
            self._source_index = 0
        self._restored = False
        return mllm_frames_of(ops)

    def _stamp(self, batch: Dict[str, Any]) -> None:
        """Advance the checkpoint offset past this micro-batch."""
        self._source_index = int(batch["idx"][-1]) + 1


def drive_stream(stream, n_frames: int, micro_batch: int, base: int,
                 advance, labels_all: List[Dict[str, Any]]) -> int:
    """The measured loop: pull micro-batches, stamp absolute frame
    indices continuing from ``base``, hand each batch to ``advance``.
    Returns the new source index."""
    done = 0
    while done < n_frames:
        take = min(micro_batch, n_frames - done)
        frames, labels = stream.batch(take)
        labels_all.extend(labels)
        advance({"frames": frames,
                 "idx": np.arange(base + done, base + done + take)})
        done += take
    return base + done


def flush_ops(ops: List[Op], emit, terminal=None) -> None:
    """End of stream: let every op in the chain emit buffered partials and
    push them through the downstream ops.  ``emit`` receives window
    results; ``terminal``, if given, receives each fully propagated batch
    (the multi-query runtime fans it out to the per-query tails)."""
    for i, op in enumerate(ops):
        fb = op.flush()
        if fb is None:
            continue
        if "window_results" in fb:
            emit(fb.pop("window_results"))
        for nxt in ops[i + 1:]:
            fb = nxt.process(fb)
            if "window_results" in fb:
                emit(fb.pop("window_results"))
        if terminal is not None:
            terminal(fb)


class StreamRuntime(RunScaffold):
    """Runs one plan.  ``ctx=None`` builds a model-less ``OpContext`` on
    CUDA (raising where CUDA is absent)."""

    def __init__(self, plan: Plan, ctx: Optional[OpContext] = None,
                 micro_batch: int = 16):
        self.plan = plan
        self._init_scaffold(ctx if ctx is not None else OpContext(),
                            micro_batch, plan.ops)

    # ------------------------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        return {
            "source_index": self._source_index,
            "ops": [op.snapshot() for op in self.plan.ops],
        }

    def restore(self, st: Dict[str, Any]) -> None:
        self._source_index = st["source_index"]
        for op, s in zip(self.plan.ops, st["ops"]):
            op.restore(s)
        self._mark_restored()

    # ------------------------------------------------------------------
    def run(self, stream, n_frames: int, warmup: int = 1,
            flush: bool = True) -> RunResult:
        """``warmup=1`` (default) makes this a *fresh* measurement: the
        stream is rewound and every op reset.  Pass ``warmup=0`` to
        continue a previous segment; the first run after ``restore()``
        continues automatically."""
        sink = self.plan.ops[-1]
        assert isinstance(sink, SinkOp)
        sink.collected = []
        counts: Dict[str, int] = {op.name: 0 for op in self.plan.ops}
        window_results: List[Dict[str, Any]] = []
        labels_all: List[Dict[str, Any]] = []

        def warm_advance(batch):
            for op in self.plan.ops:
                batch = op.process(batch)

        mllm_start = self._begin_run(stream, warmup, warm_advance,
                                     self.plan.ops)

        obs = self.obs

        def advance(batch):
            self._stamp(batch)
            t_b = obs.now() if obs.enabled else 0
            n0 = len(batch["idx"])
            for op in self.plan.ops:
                counts[op.name] += len(batch["idx"])
                if obs.enabled:
                    t_op = obs.now()
                    batch = op.process(batch)
                    obs.tracer.span(f"op:{op.name}", "prefix", t_op,
                                    obs.now(), track="stream",
                                    n=len(batch["idx"]))
                else:
                    batch = op.process(batch)
                if "window_results" in batch:
                    window_results.extend(batch.pop("window_results"))
            if obs.enabled:
                obs.slo.record("stream", (obs.now() - t_b) / 1e6, n=n0)

        # the measured stream goes through transport validation and
        # bounded redelivery when a fault injector is live (the bare
        # stream otherwise).  Warmup above ran unguarded: it must not
        # consume schedule events the measured stream would never see.
        guarded = guard_stream(stream, self.ctx.faults)

        t0 = time.perf_counter()
        drive_stream(guarded, n_frames, self.micro_batch,
                     self._source_index, advance, labels_all)
        if flush:
            flush_ops(self.plan.ops, window_results.extend)
        if self.ctx.device.type == "cuda":
            torch.cuda.synchronize(self.ctx.device)
        wall = time.perf_counter() - t0
        if obs.enabled:
            obs.metrics.set_gauge("run/wall_s", wall)

        mllm_frames = mllm_frames_of(self.plan.ops) - mllm_start
        return RunResult(
            fps=n_frames / wall,
            wall_s=wall,
            n_frames=n_frames,
            outputs=sink.collected,
            window_results=window_results,
            op_input_counts=counts,
            mllm_frames=mllm_frames,
            labels=labels_all,
        )
