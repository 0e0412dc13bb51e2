"""Shared MLLM extract server: one model, many feeds, pipelined.

Counterpart of ``repro/scheduler/extract_server.py``.  The server holds one
union-task extract function per *physical backbone variant* (big / small /
pruned; "adaptive" is resolved by the op's density tracker before
submission) and coalesces extract requests from different streams into
batched forwards.

Coalescing is shape-bucketed and padded: requests whose frames agree on
(C, H, W) and dtype concatenate into one batch, padded to a power-of-two
bucket (``_bucket_pad``) so the forwards take few distinct shapes.
``make_extract_fn`` normalizes per frame and computes every head in one
forward, so each row of a coalesced batch is what the op's solo path
would have produced: the server changes *how many* forwards run, never
*what* any query observes.

Pipelined serving protocol (dispatch / poll / resume)
-----------------------------------------------------
``submit()`` queues a request.  ``dispatch(budget)`` packs shape-bucketed
chunks into *reused staging buffers* and launches the forwards;
``poll()`` (non-blocking) or ``wait()``/``drain()`` (blocking) observe
their completion; a request then reports ``done`` and materializes its
per-task numpy slices on first ``result`` access, one device-to-host copy
per chunk shared by every request coalesced into it.  ``max_inflight``
bounds launched-but-unretired forwards (default 2, double buffering), and
with it the staging memory: a buffer returns to the pool only when its
forward retires.

The device interface.  Where the reference relies on JAX's asynchronous
dispatch, the port launches each forward on a CUDA stream of the server's
own (``torch.cuda.Stream``), so the feeds' prefix operators, which run on
the current stream and end in a copy back to the host, never queue
behind an in-flight forward.  Per chunk, on that stream and in order: the
stream waits for the current stream (anything the host enqueued before
the launch is visible to the forward), the staging buffer (pinned host
memory) is copied to the card without blocking, the forward runs, its
per-task predictions are packed into one tensor and copied without
blocking into pinned host memory, and a ``torch.cuda.Event`` is recorded.
``event.query()`` is the readiness probe and ``event.synchronize()`` the
blocking one; every tensor the chunk allocates on the card is allocated
on the server's stream, so the caching allocator never hands its memory
to another stream early.  On the CPU a forward is complete when it
returns: a chunk of CPU tensors is ready at once (dispatch by the
tensor's device, as ``repro_torch.kernels`` does), and the protocol runs
unchanged.

Semantic gating (the cache-consult stage)
-----------------------------------------
With a ``repro_torch.semantic.SemanticGate`` attached (``gate=`` or
``ctx.gate``), ``submit()`` consults the per-feed keyframe cache before
anything is queued: near-duplicate rows are answered from cached extract
outputs and only the admission's *novel* rows (plus its revalidation hits)
enter the dispatch queue; a batch whose every row hits short-circuits
dispatch entirely.  The returned ``GatedExtractRequest`` keeps the
``n``/``done``/``result`` surface; a gate with ``threshold=0`` is inert.

Stats: ``forwards``, ``dispatches``, ``max_inflight_seen``,
``staging_allocated`` / ``staging_reused`` / ``staging_skipped``, the
fault tier's ``forward_faults`` / ``retries`` / ``retry_exhausted`` /
``latency_faults``, the cache tier's ``cache_hits`` / ``cache_misses`` /
``revalidations`` / ``cache_mismatches``, and ``frames`` /
``padded_frames`` / ``requests`` / ``coalesced_batches``.  ``stats`` is one
dict for the server's lifetime, updated in place; ``queue_depth`` and
``inflight`` are gauges recomputed on every read.

Observability (``repro_torch.obs``): with an enabled ``Observability``
the server records per-request ``queue_wait`` spans and
``queue_wait_ms/<feed>`` histograms, ``staging`` / ``dispatch`` spans on
the ``server`` track, a ``forward[variant]`` span per chunk on the
``device`` track (launch to observed completion) feeding ``forward_ms``,
and ``inflight`` / ``queue_depth`` counter samples.  Every
``device_probe_every``-th forward is *probed*: the host blocks on that
chunk's event (never on the whole device) and records launch to device
completion as ``forward_device[variant]`` and the ``forward_device_ms``
histograms, with the frames in ``forward_device_frames/<variant>``.
Host clock throughout; a forward's launch is stamped where the host starts
enqueueing it (the reference stamps it after its jitted call returns).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.faults import (
    ExtractFaultError,
    ExtractStallError,
    RetryPolicy,
    resolve_faults,
)
from repro_torch.obs import resolve_obs
from repro_torch.streaming.mllm import make_extract_fn, variant_models
from repro_torch.streaming.operators import OpContext, _bucket_pad


class _InFlightChunk:
    """One launched forward: its predictions (CPU tensors, or a pinned
    host copy still being filled on the card) plus the bookkeeping to
    fulfil its requests and recycle its staging buffer once it retires."""

    __slots__ = ("preds", "reqs", "buf_key", "buf", "completed", "_np",
                 "t_launch", "variant", "total", "delay_polls", "event",
                 "layout")

    def __init__(self, preds, reqs: List["ExtractRequest"],
                 buf_key=None, buf=None, event=None, layout=None):
        #: CPU path: task -> CPU tensor.  CUDA path: one pinned host
        #: tensor (bucket, width) the card copies the packed predictions
        #: into, unpacked by ``layout``
        self.preds = preds
        self.reqs = reqs
        self.buf_key = buf_key
        self.buf = buf                    # staging buffer, held until retire
        self.completed = False
        self._np: Optional[Dict[str, np.ndarray]] = None
        self.t_launch = 0                 # obs stamp: forward launch (ns)
        self.variant = ""
        self.total = 0
        #: injected artificial device latency: the chunk's completion is
        #: observed this many ``poll()``s late (clock-free by design)
        self.delay_polls = 0
        #: recorded on the server's stream after the copy back (None: the
        #: chunk ran on the CPU and was complete when launched)
        self.event = event
        self.layout = layout              # [(task, row shape)] of preds

    def ready(self) -> bool:
        return self.event is None or self.event.query()

    def block(self) -> None:
        if self.event is not None:
            self.event.synchronize()

    def materialize(self) -> Dict[str, np.ndarray]:
        """The chunk's predictions as numpy, computed once (blocks only if
        the forward is still running); requests slice views out of it."""
        if self._np is None:
            if self.event is None:
                self._np = {k: v.numpy() for k, v in self.preds.items()}
            else:
                self.block()
                flat = self.preds.numpy()
                out, off = {}, 0
                for k, shape in self.layout:
                    w = int(np.prod(shape, dtype=np.int64))
                    out[k] = flat[:, off:off + w].reshape(
                        (flat.shape[0],) + shape)
                    off += w
                self._np = out
            self.preds = {}               # release the tensors
        return self._np


class GatedExtractRequest:
    """A submitted extract answered (partly or fully) by the semantic
    cache: only the admission's *model rows* entered the server queue
    (``inner``), the rest resolve from cached keyframe outputs.  Presents
    the same ``n``/``done``/``result`` surface as ``ExtractRequest``."""

    __slots__ = ("variant", "frames", "feed", "adm", "inner")

    def __init__(self, variant: str, frames: np.ndarray, feed: str,
                 adm, inner: Optional["ExtractRequest"]):
        self.variant = variant
        self.frames = frames
        self.feed = feed
        self.adm = adm
        self.inner = inner

    @property
    def n(self) -> int:
        return int(self.frames.shape[0])

    @property
    def dispatched(self) -> bool:
        return self.inner is None or self.inner.dispatched

    @property
    def failed(self) -> bool:
        """The model rows' request exhausted its retry budget."""
        return self.inner is not None and self.inner.failed

    @property
    def done(self) -> bool:
        """The model rows' forward and every cached-row donor completed:
        ``result`` will not block."""
        return self.adm.ready

    @property
    def result(self) -> Optional[Dict[str, np.ndarray]]:
        if not self.done:
            return None
        return self.adm.assemble()


class ExtractRequest:
    """One pending union extract: ``frames`` in, per-task predictions out.

    Lifecycle: queued -> dispatched (forward in flight) -> ``done``
    (forward observed complete by ``poll``/``wait``/``drain``) ->
    ``result`` (numpy, shared per coalesced chunk, on first access)."""

    __slots__ = ("variant", "frames", "feed", "_chunk", "_offset",
                 "t_submit", "attempts", "isolate", "failed", "not_before",
                 "fault_event")

    def __init__(self, variant: str, frames: np.ndarray, feed: str = ""):
        self.variant = variant            # big | small | pruned
        self.frames = frames              # (n, C, H, W)
        self.feed = feed
        self._chunk: Optional[_InFlightChunk] = None
        self._offset = 0
        self.t_submit = 0                 # obs stamp: enqueue time (ns)
        #: retry accounting: launches attempted / earliest dispatch round
        #: the next attempt is eligible (exponential backoff) / whether a
        #: failed chunk's members must relaunch one-per-chunk
        self.attempts = 0
        self.not_before = 0
        self.isolate = False
        #: terminally failed (retry budget exhausted): ``result`` raises
        self.failed = False
        #: fault-schedule event index, assigned once at enqueue so every
        #: retry of this request replays the same scheduled fault
        self.fault_event = 0

    @property
    def n(self) -> int:
        return int(self.frames.shape[0])

    @property
    def dispatched(self) -> bool:
        return self._chunk is not None

    @property
    def done(self) -> bool:
        """The forward completed: ``result`` will not block."""
        return self._chunk is not None and self._chunk.completed

    @property
    def result(self) -> Optional[Dict[str, np.ndarray]]:
        if self.failed:
            raise ExtractFaultError(
                f"extract request feed={self.feed!r} "
                f"variant={self.variant} n={self.n} failed after "
                f"{self.attempts} attempts")
        if not self.done:
            return None
        preds = self._chunk.materialize()
        return {k: v[self._offset:self._offset + self.n]
                for k, v in preds.items()}


# ---------------------------------------------------------------------------
# suspension-queue settling (shared by MultiStreamRuntime's feed queues and
# MultiQueryRuntime's server path: one implementation of the resume-order
# invariant)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PendingResume:
    """A suspended micro-batch: resumes past ``op_index`` once ``req``'s
    forward completes."""

    op_index: int
    batch: Any
    req: Union["ExtractRequest", "GatedExtractRequest"]
    n: int


def settle_fifo(pendings: List[Tuple[Any, PendingResume]],
                resume: Callable[[Any, PendingResume], Optional[PendingResume]],
                ) -> Tuple[List[Tuple[Any, PendingResume]], int]:
    """Resume, in FIFO order, every fulfilled continuation whose *lane* has
    no earlier outstanding one.

    Stateful post-extract ops must observe batches in stream order per
    lane (a lane = one sharing-group executor), so a completed
    continuation stays parked while an older one of the same lane is
    still in flight.  ``resume(lane, pending)`` returns a re-suspension or
    None; re-suspensions keep their queue position.  Returns ``(new
    queue, number resumed)``."""
    out: List[Tuple[Any, PendingResume]] = []
    blocked: set = set()
    resumed = 0
    for lane, p in pendings:
        if id(lane) not in blocked and p.req.done:
            nxt = resume(lane, p)
            resumed += 1
            if nxt is not None:
                out.append((lane, nxt))
                blocked.add(id(lane))
        else:
            out.append((lane, p))
            blocked.add(id(lane))
    return out, resumed


def _torch_dtype(dtype: np.dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, dtype)).dtype


class SharedExtractServer:
    """Coalesces union-task extract requests across feeds into batched
    forwards per (variant, frame-shape) bucket, pipelined.

    ``max_batch`` bounds a single coalesced forward; ``max_inflight``
    bounds dispatched-but-unretired forwards (double buffering by
    default).  The forwards run on ``ctx.device``."""

    VARIANTS = ("big", "small", "pruned")

    #: consecutive dispatch calls a padded partial chunk may be deferred
    #: before it launches anyway (continuous-traffic starvation guard)
    MAX_PARTIAL_DEFERS = 2

    def __init__(self, ctx: OpContext, max_batch: int = 64,
                 max_inflight: int = 2, gate=None, obs=None,
                 faults=None, retry: Optional[RetryPolicy] = None,
                 drain_timeout_s: float = 120.0,
                 device_probe_every: int = 8):
        assert max_batch >= 1 and max_inflight >= 1
        self.ctx = ctx
        self.max_batch = max_batch
        self.max_inflight = max_inflight
        #: optional ``repro_torch.semantic.SemanticGate``: the cache-consult
        #: stage in front of dispatch (defaults to the context's gate)
        self.gate = gate if gate is not None else ctx.gate
        #: observability handle (explicit arg > ctx.obs > inert NULL_OBS)
        self.obs = resolve_obs(obs, getattr(ctx, "obs", None))
        if self.gate is not None:
            self.gate.obs = self.obs
        #: fault injection (explicit arg > ctx.faults > inert NULL_FAULTS)
        self.faults = resolve_faults(faults, getattr(ctx, "faults", None))
        #: bounded-retry policy for failed forwards (see repro_torch.faults)
        self.retry = retry if retry is not None else RetryPolicy()
        #: watchdog deadline: ``wait()``/``drain()`` raise an
        #: ``ExtractStallError`` naming the stuck chunk/bucket after this
        #: many seconds without progress
        self.drain_timeout_s = drain_timeout_s
        #: every Nth launched forward (with an enabled Observability) is
        #: probed: the host blocks on its event and times launch to device
        #: completion; 0 disables probing
        self.device_probe_every = device_probe_every
        self._probe_seq = 0                   # forwards since last probe
        self._dispatch_seq = 0                # retry backoff clock (rounds)
        self._defers: Dict[Tuple, int] = {}   # bucket key -> deferred calls
        self._fns: Dict[str, Any] = {}
        self._queue: List[ExtractRequest] = []
        self._inflight: List[_InFlightChunk] = []
        #: staging-buffer pool: (bucket, shape, dtype) -> free buffers
        #: (pinned host tensors for a CUDA context, numpy arrays on the CPU)
        self._staging: Dict[Tuple, List[Any]] = {}
        #: the forwards' own CUDA stream, made at the first CUDA launch
        self._stream: Optional[torch.cuda.Stream] = None
        # running pending counters: submit/dispatch keep them exact, so
        # the per-feed backpressure checks each scheduling round are O(1)
        self._pending_reqs: Dict[str, int] = {}
        self._pending_frames: Dict[str, int] = {}
        self._pending_reqs_total = 0
        self._pending_frames_total = 0
        self._stats = self._fresh_stats()

    @staticmethod
    def _fresh_stats() -> Dict[str, int]:
        return {"forwards": 0, "frames": 0, "padded_frames": 0,
                "requests": 0, "coalesced_batches": 0,
                "dispatches": 0, "max_inflight_seen": 0,
                "staging_allocated": 0, "staging_reused": 0,
                "staging_skipped": 0,
                # fault-tolerance tier
                "forward_faults": 0, "retries": 0, "retry_exhausted": 0,
                "latency_faults": 0,
                # live gauges (recomputed on read, see ``stats``)
                "queue_depth": 0, "inflight": 0,
                # cache tier (mirrors the gate's counters; stays 0 ungated)
                "cache_hits": 0, "cache_misses": 0,
                "revalidations": 0, "cache_mismatches": 0}

    @property
    def stats(self) -> Dict[str, int]:
        """The server's counters as one dict for its lifetime, updated in
        place.  Reading syncs the semantic cache's counters into it and
        recomputes the ``queue_depth`` / ``inflight`` gauges."""
        if self.gate is not None:
            self._stats.update(self.gate.counters)
        self._stats["queue_depth"] = self._pending_reqs_total
        self._stats["inflight"] = len(self._inflight)
        return self._stats

    def reset_stats(self) -> None:
        """Drop accounting (e.g. after warmup) without dropping the
        extract functions, the staging pool or the semantic cache's
        keyframes; warmup-polluted latency histograms drop with it."""
        self._stats.update(self._fresh_stats())
        if self.gate is not None:
            self.gate.reset_counters()
        if self.obs.enabled:
            self.obs.metrics.drop("queue_wait_ms")
            self.obs.metrics.drop("forward_ms")
            self.obs.metrics.drop("forward_device_ms")
            self.obs.metrics.drop("forward_device_frames")
            # the first *measured* forward is probed
            self._probe_seq = 0

    # ------------------------------------------------------------------
    def _fn(self, variant: str):
        if variant not in self._fns:
            mllm = variant_models(self.ctx)[variant]
            assert mllm is not None, f"ctx has no model for {variant!r}"
            self._fns[variant] = make_extract_fn(mllm)
        return self._fns[variant]

    @property
    def _on_cuda(self) -> bool:
        return self.ctx.device.type == "cuda"

    # ------------------------------------------------------------------
    def submit(self, variant: str, frames: np.ndarray,
               feed: str = "", sig=None) -> Union[ExtractRequest,
                                                  GatedExtractRequest]:
        """Queue an extract; the returned request reports ``done`` once a
        ``dispatch``ed forward completes (observed by ``poll``/``wait``)
        or a blocking ``drain()`` runs it.  "adaptive" must be resolved by
        the caller (``MLLMExtractOp.begin_extract``).

        With an active semantic gate, submission first consults the
        per-feed keyframe cache; only the admission's model rows are
        queued.  ``sig`` forwards a fused-prefix-computed ``(feats, emb)``
        pair for these frames to the gate."""
        assert variant in self.VARIANTS, variant
        assert frames.ndim == 4 and frames.shape[0] > 0, frames.shape
        self.stats["requests"] += 1
        if self.gate is not None and self.gate.active:
            adm = self.gate.admit(feed, variant, frames, sig=sig)
            inner = None
            if adm.n_model:
                inner = self._enqueue(variant, adm.model_frames(frames),
                                      feed)
            adm.bind(inner)
            return GatedExtractRequest(variant, frames, feed, adm, inner)
        return self._enqueue(variant, frames, feed)

    def _enqueue(self, variant: str, frames: np.ndarray,
                 feed: str) -> ExtractRequest:
        req = ExtractRequest(variant=variant, frames=frames, feed=feed)
        if self.obs.enabled:
            req.t_submit = self.obs.now()
        if self.faults.enabled:
            req.fault_event = self.faults.next_event("forward", feed)
        self._queue.append(req)
        self._pending_reqs[feed] = self._pending_reqs.get(feed, 0) + 1
        self._pending_frames[feed] = \
            self._pending_frames.get(feed, 0) + req.n
        self._pending_reqs_total += 1
        self._pending_frames_total += req.n
        return req

    def probe(self, variant: str, frames: np.ndarray,
              feed: str = "") -> ExtractRequest:
        """Enqueue an *isolated* canary extract (circuit-breaker half-open
        probe): it never coalesces with other feeds' requests."""
        req = self._enqueue(variant, frames, feed)
        req.isolate = True
        return req

    def cancel(self, req: ExtractRequest) -> bool:
        """Remove a still-queued request (quarantine path).  Returns False
        when the request already dispatched or left the queue."""
        if req.dispatched or req.failed:
            return False
        try:
            self._queue.remove(req)
        except ValueError:
            return False
        self._pending_reqs[req.feed] -= 1
        self._pending_frames[req.feed] -= req.n
        self._pending_reqs_total -= 1
        self._pending_frames_total -= req.n
        return True

    def pending_frames(self, feed: Optional[str] = None) -> int:
        """Frames queued and not yet dispatched (running counter)."""
        if feed is None:
            return self._pending_frames_total
        return self._pending_frames.get(feed, 0)

    def pending_requests(self, feed: Optional[str] = None) -> int:
        """Requests queued and not yet dispatched (running counter)."""
        if feed is None:
            return self._pending_reqs_total
        return self._pending_reqs.get(feed, 0)

    @property
    def inflight(self) -> int:
        """Forwards dispatched and not yet retired."""
        return len(self._inflight)

    # ------------------------------------------------------------------
    def _acquire_staging(self, key: Tuple, bucket: int, shape: Tuple,
                         dtype: np.dtype):
        pool = self._staging.get(key)
        if pool:
            self.stats["staging_reused"] += 1
            return pool.pop()
        self.stats["staging_allocated"] += 1
        if self._on_cuda:
            return torch.empty((bucket,) + tuple(shape),
                               dtype=_torch_dtype(dtype), pin_memory=True)
        return np.empty((bucket,) + tuple(shape), dtype)

    def _forward(self, variant: str, host: torch.Tensor
                 ) -> Tuple[Any, Any, Any]:
        """Launch one forward on ``host`` frames.  On the CPU it runs to
        completion: returns (task -> tensor, None, None).  On CUDA it is
        enqueued on the server's stream: returns (pinned host tensor the
        packed predictions land in, the event recorded after that copy,
        the packing layout)."""
        fn = self._fn(variant)
        if not self._on_cuda:
            return fn(host), None, None
        dev = self.ctx.device
        if self._stream is None:
            self._stream = torch.cuda.Stream(dev)
        stream = self._stream
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            x = host.to(dev, non_blocking=True)
            preds = fn(x)
            rows = x.shape[0]
            packed = torch.cat([v.reshape(rows, -1)
                                for v in preds.values()], dim=1)
            out = torch.empty(packed.shape, dtype=packed.dtype,
                              pin_memory=True)
            out.copy_(packed, non_blocking=True)
            event = torch.cuda.Event()
            event.record(stream)
        layout = [(k, tuple(v.shape[1:])) for k, v in preds.items()]
        return out, event, layout

    def _chunk_failed(self, variant: str,
                      chunk: List[ExtractRequest]) -> None:
        """A chunk's forward faulted (injected or real): every member
        request stays queued for an *isolated* relaunch after its
        exponential backoff, or, past ``retry.max_attempts``, turns
        terminally ``failed`` and leaves the queue."""
        obs = self.obs
        self.stats["forward_faults"] += 1
        seq = self._dispatch_seq
        for r in chunk:
            r.attempts += 1
            r.isolate = True
            if r.attempts >= self.retry.max_attempts:
                r.failed = True
                self.stats["retry_exhausted"] += 1
                # terminal: dispatch removes it from the queue below
                self._pending_reqs[r.feed] -= 1
                self._pending_frames[r.feed] -= r.n
                self._pending_reqs_total -= 1
                self._pending_frames_total -= r.n
            else:
                r.not_before = seq + self.retry.backoff_rounds(r.attempts)
                self.stats["retries"] += 1
            if obs.enabled:
                track = f"feed:{r.feed}"
                obs.tracer.instant(
                    f"fault:forward[{variant}]", "fault", track=track,
                    n=r.n)
                if r.failed:
                    obs.metrics.inc(f"faults/exhausted/{r.feed}", 1)
                else:
                    obs.tracer.instant("retry", "retry", track=track,
                                       n=r.n)
                    obs.metrics.inc(f"faults/retries/{r.feed}", 1)

    def _launch(self, variant: str, chunk: List[ExtractRequest]) -> bool:
        """Pack one chunk and launch its forward; returns False when the
        forward faulted (members re-staged or failed)."""
        obs = self.obs
        faults = self.faults
        delay = 0
        if faults.enabled:
            for r in chunk:
                f = faults.fire("forward", r.feed, variant,
                                r.fault_event, r.attempts)
                if f is None:
                    continue
                if f[0] == "error":
                    self._chunk_failed(variant, chunk)
                    return False
                delay = max(delay, f[1])        # latency
        t_stage = obs.now() if obs.enabled else 0
        total = sum(r.n for r in chunk)
        bucket = _bucket_pad(total)
        shape = chunk[0].frames.shape[1:]
        dtype = chunk[0].frames.dtype
        if len(chunk) == 1 and chunk[0].n == bucket:
            # an exactly-full single request needs no staging copy
            host = torch.from_numpy(np.ascontiguousarray(chunk[0].frames))
            buf_key = buf = None
            self.stats["staging_skipped"] += 1
        else:
            buf_key = (bucket,) + tuple(shape) + (dtype.str,)
            buf = self._acquire_staging(buf_key, bucket, shape, dtype)
            view = buf.numpy() if isinstance(buf, torch.Tensor) else buf
            off = 0
            for r in chunk:
                view[off:off + r.n] = r.frames
                off += r.n
            if bucket > total:
                # padding rows must classify as "normalized" in the
                # extract: a reused buffer otherwise carries stale frames
                view[total:bucket] = 0
            host = buf if isinstance(buf, torch.Tensor) \
                else torch.from_numpy(buf)
        t_disp = obs.now() if obs.enabled else 0
        if faults.enabled:
            # with the injector live, a real forward exception follows
            # the same retry path as an injected one; without it, errors
            # propagate as before
            try:
                preds, event, layout = self._forward(variant, host)
            except AssertionError:
                raise
            except Exception:
                if buf is not None:
                    self._staging.setdefault(buf_key, []).append(buf)
                self._chunk_failed(variant, chunk)
                return False
        else:
            preds, event, layout = self._forward(variant, host)
        fl = _InFlightChunk(preds, list(chunk), buf_key, buf, event, layout)
        fl.variant = variant
        fl.total = total
        if delay:
            fl.delay_polls = delay
            self.stats["latency_faults"] += 1
            if obs.enabled:
                obs.tracer.instant(f"fault:latency[{variant}]", "fault",
                                   track="device", n=total)
        if obs.enabled:
            # the launch is stamped where the host starts enqueueing the
            # forward: the port enqueues it kernel by kernel (milliseconds
            # of host time at full width), where the reference's jitted
            # call returns at once and is stamped after it; the dispatch
            # span is that enqueue
            fl.t_launch = t_disp
            tr = obs.tracer
            tr.span("staging", "staging", t_stage, t_disp,
                    track="server", n=total)
            tr.span(f"dispatch[{variant}]", "dispatch", t_disp,
                    obs.now(), track="server", n=bucket)
            for r in chunk:
                if r.t_submit:
                    tr.span("queue_wait", "queue", r.t_submit, fl.t_launch,
                            track=f"feed:{r.feed}", n=r.n)
                    obs.metrics.observe(
                        f"queue_wait_ms/{r.feed}",
                        (fl.t_launch - r.t_submit) / 1e6, r.n)
            if self.device_probe_every and not delay:
                # device-accurate forward timing: every Nth forward blocks
                # on its own event (never on the whole device), so the
                # launch->completion interval excludes the poll
                # quantization the observed ``forward`` span carries
                if self._probe_seq % self.device_probe_every == 0:
                    fl.block()
                    t_done = obs.now()
                    tr.span(f"forward_device[{variant}]", "forward",
                            fl.t_launch, t_done, track="device", n=total)
                    dev_ms = (t_done - fl.t_launch) / 1e6
                    obs.metrics.observe("forward_device_ms", dev_ms)
                    obs.metrics.observe(
                        f"forward_device_ms/{variant}", dev_ms)
                    obs.metrics.inc(
                        f"forward_device_frames/{variant}", total)
                self._probe_seq += 1
        off = 0
        for r in chunk:
            r._chunk = fl
            r._offset = off
            off += r.n
            self._pending_reqs[r.feed] -= 1
            self._pending_frames[r.feed] -= r.n
        self._pending_reqs_total -= len(chunk)
        self._pending_frames_total -= total
        self._inflight.append(fl)
        if obs.enabled:
            # occupancy timeline: sampled at every launch and retire
            obs.tracer.counter("inflight", len(self._inflight))
            obs.tracer.counter("queue_depth", self._pending_reqs_total)
        self.stats["forwards"] += 1
        self.stats["frames"] += total
        self.stats["padded_frames"] += bucket - total
        if len(chunk) > 1:
            self.stats["coalesced_batches"] += 1
        self.stats["max_inflight_seen"] = max(
            self.stats["max_inflight_seen"], len(self._inflight))
        return True

    def dispatch(self, budget: Optional[int] = None) -> int:
        """Launch queued requests as forwards and return at once; returns
        the number of forwards launched.

        Requests group by (variant, frame shape, dtype) and chunk greedily
        under ``max_batch`` frames per forward; at most ``budget`` chunks
        launch (None: as many as ``max_inflight`` allows).  Unlaunched
        requests stay queued in order.  A chunk that exactly fills its
        power-of-two bucket launches eagerly, while a padded partial chunk
        is deferred unless nothing is in flight or its bucket has already
        been deferred ``MAX_PARTIAL_DEFERS`` times.  With a live fault
        injector, terminally failed requests leave the queue here,
        requests inside their backoff window stay queued, and isolated
        retries launch one-per-chunk ahead of everything else."""
        seq = self._dispatch_seq = self._dispatch_seq + 1
        room = self.max_inflight - len(self._inflight)
        if budget is not None:
            room = min(room, budget)
        if room <= 0 or not self._queue:
            return 0
        launched = 0
        taken: set = set()
        iso: List[ExtractRequest] = []
        groups: Dict[Tuple, List[ExtractRequest]] = {}
        for r in self._queue:
            if r.failed:
                taken.add(id(r))      # terminal: drop from the queue
                continue
            if r.not_before > seq:
                continue              # backing off: not eligible yet
            if r.isolate:
                iso.append(r)
                continue
            key = (r.variant, r.frames.shape[1:], r.frames.dtype.str)
            groups.setdefault(key, []).append(r)
        full: List[Tuple[Tuple, List[ExtractRequest]]] = []
        partial: List[Tuple[Tuple, List[ExtractRequest]]] = []
        for key, reqs in groups.items():
            chunk: List[ExtractRequest] = []
            size = 0
            for r in reqs:
                if chunk and size + r.n > self.max_batch:
                    (full if size == _bucket_pad(size) else partial).append(
                        (key, chunk))
                    chunk, size = [], 0
                chunk.append(r)
                size += r.n
            if chunk:
                (full if size == _bucket_pad(size) else partial).append(
                    (key, chunk))

        def launch(key: Tuple, chunk: List[ExtractRequest],
                   served: bool) -> None:
            nonlocal launched
            ok = self._launch(key[0], chunk)
            if served:
                # only a *partial* launch services the waiting bucket
                self._defers.pop(key, None)
            if ok:
                taken.update(id(r) for r in chunk)
                launched += 1
            else:
                # the forward faulted: members stay queued for isolated
                # retry, except those that just exhausted their budget
                taken.update(id(r) for r in chunk if r.failed)

        # isolated retries outrank everything
        for r in iso:
            if launched >= room:
                break
            launch((r.variant,), [r], served=False)
        overdue = [c for c in partial
                   if self._defers.get(c[0], 0) >= self.MAX_PARTIAL_DEFERS]
        fresh = [c for c in partial
                 if self._defers.get(c[0], 0) < self.MAX_PARTIAL_DEFERS]
        # overdue partials outrank full chunks
        for key, chunk in overdue:
            if launched >= room:
                break
            launch(key, chunk, served=True)
        for key, chunk in full:
            if launched >= room:
                break
            launch(key, chunk, served=False)
        for key, chunk in fresh:
            if launched >= room or self._inflight:
                break              # defer padding while the device is fed
            launch(key, chunk, served=True)
        # age every partial bucket that stayed queued; buckets with
        # nothing left waiting drop their count
        waiting = {key for key, chunk in partial
                   if id(chunk[0]) not in taken}
        for key in waiting:
            self._defers[key] = self._defers.get(key, 0) + 1
        for key in list(self._defers):
            if key not in waiting:
                del self._defers[key]
        if not taken:
            return 0
        self._queue = [r for r in self._queue if id(r) not in taken]
        self.stats["dispatches"] += 1
        return launched

    # ------------------------------------------------------------------
    def _retire(self, fl: _InFlightChunk) -> None:
        fl.completed = True
        if fl.buf is not None:
            # the forward's copy of the staging input is complete (its
            # event passed): recycle the buffer
            self._staging.setdefault(fl.buf_key, []).append(fl.buf)
            fl.buf = None
        if fl.t_launch:
            # launch -> observed completion: an upper bound on device time
            # (includes the poll interval)
            obs = self.obs
            t1 = obs.now()
            obs.tracer.span(f"forward[{fl.variant}]", "forward",
                            fl.t_launch, t1, track="device", n=fl.total)
            obs.metrics.observe(
                "forward_ms", (t1 - fl.t_launch) / 1e6)
            fl.t_launch = 0

    def poll(self) -> int:
        """Non-blocking: retire every in-flight forward whose device work
        completed (its requests report ``done``) and recycle its staging
        buffer.  Returns the number of forwards retired."""
        still: List[_InFlightChunk] = []
        retired = 0
        for fl in self._inflight:
            if fl.delay_polls > 0:
                # injected device latency: completion observed late, one
                # poll at a time (clock-free)
                fl.delay_polls -= 1
                still.append(fl)
            elif fl.ready():
                self._retire(fl)
                retired += 1
            else:
                still.append(fl)
        self._inflight = still
        return retired

    def pump(self, progressed: bool, coalesce_frames: int,
             settle: Callable[[], int]) -> None:
        """One pipelined scheduling step, the one implementation of the
        dispatch/poll/resume protocol (``MultiStreamRuntime.run`` and
        ``MultiQueryRuntime``'s server path): poll completions, dispatch
        once the coalescing window holds ``coalesce_frames`` queued frames
        (or nothing progressed this round), ``settle()`` fulfilled
        continuations (returns how many resumed), and block for the
        oldest forward only when nothing was pulled and nothing
        resumed."""
        self.poll()
        if self.pending_frames() >= coalesce_frames or not progressed:
            self.dispatch()
        resumed = settle()
        if not progressed and not resumed:
            self.wait()

    def _stuck_desc(self) -> str:
        """Name the work the watchdog is stuck on."""
        if self._inflight:
            fl = self._inflight[0]
            total = sum(r.n for r in fl.reqs)
            feeds = sorted({r.feed for r in fl.reqs})
            return (f"in-flight chunk variant={fl.variant!r} "
                    f"bucket={_bucket_pad(total)} ({len(fl.reqs)} reqs, "
                    f"{total} frames, feeds={feeds})")
        if self._queue:
            r = self._queue[0]
            return (f"queued request feed={r.feed!r} "
                    f"variant={r.variant!r} n={r.n} "
                    f"attempts={r.attempts} "
                    f"not_before={r.not_before} (round {self._dispatch_seq})")
        return "no queued or in-flight work"

    def wait(self) -> int:
        """Block until at least one in-flight forward completes
        (dispatching queued work first when nothing is in flight); returns
        the number of forwards retired.  Raises ``ExtractStallError``
        naming the stuck chunk after ``drain_timeout_s`` without a
        retirement or a launch."""
        if not self._inflight:
            self.dispatch()
        deadline = time.monotonic() + self.drain_timeout_s
        while self._inflight:
            self._inflight[0].block()
            retired = self.poll()
            if retired:
                return retired
            if not self.dispatch() and time.monotonic() > deadline:
                raise ExtractStallError(
                    f"wait(): no extract progress for "
                    f"{self.drain_timeout_s:g}s; stuck on "
                    f"{self._stuck_desc()}")
        return 0

    def drain(self) -> int:
        """Synchronous barrier: run every queued and in-flight request to
        completion; returns the number of forwards.  Rounds that launch or
        retire reset the watchdog's deadline; past it an
        ``ExtractStallError`` names the stuck bucket/variant."""
        forwards0 = self.stats["forwards"]
        deadline = time.monotonic() + self.drain_timeout_s
        while self._queue or self._inflight:
            launched = self.dispatch()
            retired = 0
            if self._inflight:
                self._inflight[0].block()
                retired = self.poll()
            if launched or retired:
                deadline = time.monotonic() + self.drain_timeout_s
            elif time.monotonic() > deadline:
                raise ExtractStallError(
                    f"drain(): no extract progress for "
                    f"{self.drain_timeout_s:g}s with "
                    f"{len(self._queue)} queued / "
                    f"{len(self._inflight)} in-flight forwards; stuck on "
                    f"{self._stuck_desc()}")
        return self.stats["forwards"] - forwards0
