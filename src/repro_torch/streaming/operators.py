"""Streaming operators: declarative descriptors + PyTorch implementations.

Counterpart of ``repro/streaming/operators.py``.  An operator is a
*descriptor* dataclass (the unit the optimizer rewrites) plus an
``open(ctx)``/``process(batch)`` runtime implementation.  Batches flow
host-side as dicts of numpy arrays (frames, indices, attrs), as in the
reference; each operator's compute copies its frames to ``ctx.device``,
runs there (the hand-written kernels on CUDA, their plain versions on the
CPU) and brings its small result back.  Operators may drop rows (Skip /
filters); the runtime forwards the compacted batch.

Not ported yet: the semantic gate and the observability / fault-injection
hooks; ``OpContext`` has no fields for them until the port has its own
copies of those modules.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.common.device import resolve_device
from repro_torch.data.tollbooth import BRANDS, COLORS, COLOR_RGB, PLATE_CHARS
from repro_torch.data.volleyball import ACTIONS
from repro_torch.kernels.frame_diff.ops import frame_diff
from repro_torch.kernels.fused_prefix.ref import color_frac
from repro_torch.kernels.fused_preprocess.ops import fused_preprocess
from repro_torch.streaming.mllm import (StreamMLLM, make_extract_fn,
                                        variant_models)

Batch = Dict[str, Any]


def _bucket_pad(n: int, lo: int = 4) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


# ===========================================================================
# Descriptor base
# ===========================================================================

@dataclasses.dataclass
class Op:
    """Base descriptor. Subclasses add parameters; runtime calls open()."""

    #: measured *marginal* cost per input frame (µs), stamped by the cost
    #: catalog (``repro_torch.core.costs``).  Negative means uncalibrated:
    #: 0.0 is a legitimate measurement for a free op.
    cost_us: float = dataclasses.field(default=-1.0, init=False)

    #: measured fixed cost per invocation (µs), paid once per processed
    #: batch however few frames it holds
    overhead_us: float = dataclasses.field(default=0.0, init=False)

    #: measured survivor fraction (output rows / input rows) on the
    #: calibration sample: 1.0 for pure transforms, < 1.0 for filters
    pass_rate: float = dataclasses.field(default=1.0, init=False)

    name: str = dataclasses.field(default="", init=False)

    def open(self, ctx: "OpContext") -> None:  # pragma: no cover - interface
        pass

    def process(self, batch: Batch) -> Batch:  # pragma: no cover - interface
        raise NotImplementedError

    def reset(self) -> None:
        """Return all mutable runtime state to its just-opened value (the
        runtime calls this after the untimed warmup batch)."""

    def flush(self) -> Optional[Batch]:
        """End-of-stream: emit buffered partial results as a batch to push
        through downstream operators, or None."""
        return None

    def signature(self) -> Tuple:
        """Structural identity (class + init parameters, no runtime state)."""
        params = tuple(
            (f.name, getattr(self, f.name))
            for f in dataclasses.fields(self) if f.init)
        return (type(self).__name__,) + params

    # -- state snapshot (aligned checkpoint) --------------------------------
    def snapshot(self) -> Dict[str, Any]:
        return {}

    def restore(self, st: Dict[str, Any]) -> None:
        pass


@dataclasses.dataclass
class OpContext:
    """Models every plan may reference, and the device the operators run on.

    ``device=None`` means CUDA and raises where CUDA is absent; tests pass
    ``device="cpu"``.  Each model must live on this device.  A context is
    shared by the ops opened with it: copying an op (``copy.deepcopy``, as
    ``Plan.clone`` and the cost calibration do) never copies the models."""

    mllm: Optional[StreamMLLM] = None
    mllm_small: Optional[StreamMLLM] = None
    mllm_pruned: Optional[StreamMLLM] = None
    #: the cascade detector (``repro_torch.streaming.detector.TinyDet``)
    detector: Optional[torch.nn.Module] = None
    device: Any = None
    frame_shape: Tuple[int, int, int] = (3, 128, 256)
    #: micro-batch size the driving runtime uses
    micro_batch: int = 16

    def __post_init__(self):
        self.device = resolve_device(self.device)

    def __deepcopy__(self, memo):
        return self

    def to_device(self, frames: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(frames)).to(self.device)


# ===========================================================================
# Source / Sink
# ===========================================================================

@dataclasses.dataclass
class SourceOp(Op):
    stream_name: str = "tollbooth"

    def __post_init__(self):
        self.name = f"source[{self.stream_name}]"

    def process(self, batch: Batch) -> Batch:
        return batch


@dataclasses.dataclass
class SinkOp(Op):
    def __post_init__(self):
        self.name = "sink"
        self.collected: List[Dict[str, Any]] = []

    def process(self, batch: Batch) -> Batch:
        n = len(batch["idx"])
        for i in range(n):
            rec = {"idx": int(batch["idx"][i])}
            for k, v in batch.get("attrs", {}).items():
                rec[k] = np.asarray(v[i]).tolist()
            self.collected.append(rec)
        if "window_results" in batch:
            self.collected.extend(batch["window_results"])
        return batch

    def reset(self):
        self.collected = []

    def snapshot(self):
        return {"n": len(self.collected)}


# ===========================================================================
# Semantic data-reduction operators (the paper's catalog)
# ===========================================================================

@dataclasses.dataclass
class SkipOp(Op):
    """Skip(Amount, Condition): after an "empty" frame, drop the next
    ``amount`` frames without any further compute.  Emptiness = mean region
    frame-diff against the previous frame below ``threshold`` inside the
    region of interest."""

    amount: int = 3
    condition: str = "no_car"
    threshold: float = 0.02
    roi: Optional[Tuple[int, int, int, int]] = None   # y0,x0,h,w region
    regions: Tuple[int, int] = (4, 8)

    def __post_init__(self):
        self.name = f"skip[{self.amount},{self.condition}]"
        self._prev: Optional[np.ndarray] = None
        self._skip_left = 0

    def open(self, ctx: OpContext) -> None:
        self._ctx = ctx
        self._diff = functools.partial(frame_diff, regions=self.regions)

    def prev_frames(self, frames: np.ndarray) -> np.ndarray:
        """The per-row predecessors one batched diff call compares
        against: frame i vs frame i-1, the first vs the carried state."""
        prev0 = self._prev if self._prev is not None else frames[0]
        return np.concatenate([prev0[None], frames[:-1]], axis=0)

    def keep_from_diff(self, frames: np.ndarray,
                       d: np.ndarray) -> np.ndarray:
        """Advance the skip state over one batch given its (n, ry, rx)
        diff grid and return the keep mask (the one host-side
        implementation of the stateful skip rule)."""
        n = frames.shape[0]
        keep = np.ones(n, bool)
        if self.roi is not None:
            y0, x0, hh, ww = self.roi
            ry, rx = self.regions
            rh, rw = frames.shape[2] // ry, frames.shape[3] // rx
            d = d[:, y0 // rh:(y0 + hh + rh - 1) // rh,
                  x0 // rw:(x0 + ww + rw - 1) // rw]
        act = d.reshape(n, -1).max(axis=1)             # per-frame activity
        for i in range(n):                             # cheap host loop
            if self._skip_left > 0:
                self._skip_left -= 1
                keep[i] = False
                continue
            if self._prev is None:
                self._prev = frames[i]
                continue
            if act[i] < self.threshold:
                keep[i] = False
                self._skip_left = self.amount
        self._prev = frames[-1]
        return keep

    def process(self, batch: Batch) -> Batch:
        frames = batch["frames"]
        n = frames.shape[0]
        if n == 0:
            return batch
        # one batched kernel call: frame i vs frame i-1 (first vs carry)
        ctx = self._ctx
        d = self._diff(ctx.to_device(frames),
                       ctx.to_device(self.prev_frames(frames)))
        return _mask_batch(batch, self.keep_from_diff(frames,
                                                      d.cpu().numpy()))

    def reset(self):
        self._prev = None
        self._skip_left = 0

    def snapshot(self):
        return {"prev": self._prev, "skip_left": self._skip_left}

    def restore(self, st):
        self._prev = st["prev"]
        self._skip_left = st["skip_left"]


@dataclasses.dataclass
class CropOp(Op):
    """Crop(region): spatial projection (logical: projection pushdown)."""

    region: Tuple[int, int, int, int] = (64, 0, 64, 256)  # y0,x0,h,w

    def __post_init__(self):
        self.name = f"crop{self.region}"

    def process(self, batch: Batch) -> Batch:
        y0, x0, h, w = self.region
        batch = dict(batch)
        batch["frames"] = batch["frames"][:, :, y0:y0 + h, x0:x0 + w]
        return batch


@dataclasses.dataclass
class DownscaleOp(Op):
    """Downscale(resolution): area-mean pooling (logical: aggregation)."""

    factor: int = 2

    def __post_init__(self):
        self.name = f"downscale[{self.factor}]"

    def process(self, batch: Batch) -> Batch:
        f = self.factor
        x = batch["frames"]
        b, c, h, w = x.shape
        x = x.reshape(b, c, h // f, f, w // f, f).astype(np.float32)
        x = x.mean(axis=(3, 5))
        batch = dict(batch)
        batch["frames"] = x.astype(batch["frames"].dtype) \
            if batch["frames"].dtype == np.uint8 else x
        return batch


@dataclasses.dataclass
class GreyscaleOp(Op):
    def __post_init__(self):
        self.name = "greyscale"

    def process(self, batch: Batch) -> Batch:
        x = batch["frames"].astype(np.float32)
        g = 0.299 * x[:, 0] + 0.587 * x[:, 1] + 0.114 * x[:, 2]
        batch = dict(batch)
        batch["frames"] = np.repeat(g[:, None], 3, axis=1).astype(
            batch["frames"].dtype)
        return batch


@dataclasses.dataclass
class FusedPreprocessOp(Op):
    """Crop+Downscale+Normalize(+Greyscale) in one pass: the logical
    optimizer's fusion rule, run by the ``fused_preprocess`` kernel."""

    crop: Tuple[int, int, int, int] = (0, 0, 128, 256)
    factor: int = 1
    grey: bool = False

    def __post_init__(self):
        self.name = f"fused_preprocess[{self.crop},/{self.factor}" + \
            (",grey]" if self.grey else "]")

    def open(self, ctx: OpContext) -> None:
        self._ctx = ctx
        self._fn = functools.partial(
            fused_preprocess, crop=self.crop, factor=self.factor,
            grey=self.grey)

    def process(self, batch: Batch) -> Batch:
        batch = dict(batch)
        out = self._fn(self._ctx.to_device(batch["frames"])).cpu().numpy()
        if self.grey:
            out = np.repeat(out, 3, axis=1)
        batch["frames"] = out
        batch["normalized"] = True
        return batch


# ===========================================================================
# Logical-phase cheap filters / physical-phase cascade
# ===========================================================================

@dataclasses.dataclass
class CheapColorFilterOp(Op):
    """Pixel-statistics filter: keep frames whose ROI contains at least
    ``min_frac`` pixels near the target color (the paper's 'red-ish pixels'
    pushdown filter, realized without any model)."""

    color: str = "red"
    min_frac: float = 0.01
    roi: Optional[Tuple[int, int, int, int]] = None

    def __post_init__(self):
        self.name = f"cheap_color[{self.color}]"

    def open(self, ctx: OpContext) -> None:
        self._ctx = ctx

    def near_fraction(self, frames: torch.Tensor) -> torch.Tensor:
        """Per-frame fraction of pixels within RGB distance 70 of the
        target.  Raw vs normalized is a *per-frame* property (the
        make_extract_fn convention), never a batch-global one.  The fused
        prefix computes its colour stages with this same function."""
        return color_frac(frames, COLOR_RGB[self.color])

    def process(self, batch: Batch) -> Batch:
        if batch["frames"].shape[0] == 0:
            return batch
        roi_frames = batch["frames"]
        if self.roi is not None:
            y0, x0, h, w = self.roi
            roi_frames = roi_frames[:, :, y0:y0 + h, x0:x0 + w]
        frac = self.near_fraction(self._ctx.to_device(roi_frames))
        return _mask_batch(batch, frac.cpu().numpy() >= self.min_frac)


def detect_prob(detector: torch.nn.Module,
                frames: torch.Tensor) -> torch.Tensor:
    """TinyDet's car-present probability per frame.  Raw frames are
    normalized as ``x/255 - 0.5`` (the detector's training input), decided
    per frame; ``DetectOp`` and ``FusedPrefixOp`` share this one body."""
    with torch.inference_mode():
        x = frames.to(torch.float32)
        raw = x.reshape(x.shape[0], -1).amax(dim=1) > 8.0
        x = torch.where(raw[:, None, None, None], x / 255.0 - 0.5, x)
        return torch.softmax(detector(x)["present"], dim=-1)[:, 1]


@dataclasses.dataclass
class DetectOp(Op):
    """TinyDet cascade: drop frames without the object (physical phase)."""

    threshold: float = 0.5

    def __post_init__(self):
        self.name = "tinydet"

    def open(self, ctx: OpContext) -> None:
        if ctx.detector is None:
            raise ValueError("tinydet: the context has no detector")
        self._ctx = ctx

    def process(self, batch: Batch) -> Batch:
        if batch["frames"].shape[0] == 0:
            return batch
        p = detect_prob(self._ctx.detector,
                        self._ctx.to_device(batch["frames"]))
        return _mask_batch(batch, p.cpu().numpy() >= self.threshold)


# ===========================================================================
# The MLLM operator
# ===========================================================================

@dataclasses.dataclass
class MLLMExtractOp(Op):
    """Extract(tasks) with a selectable physical implementation.

    model="adaptive" realizes the paper's *adaptive pruning*: the runtime
    switches between the full and the pruned variant per micro-batch from
    the observed stream density."""

    tasks: Tuple[str, ...] = ("present", "color", "plate")
    model: str = "big"          # big | small | pruned | adaptive
    density_threshold: float = 0.35

    def __post_init__(self):
        self.name = f"mllm[{self.model}:{','.join(self.tasks)}]"
        self.frames_processed = 0
        self.forwards = 0            # extract invocations this run
        self._density_ema = 0.5

    def open(self, ctx: OpContext) -> None:
        self._ctx = ctx
        self._micro_batch_hint = ctx.micro_batch
        variants = variant_models(ctx)
        wanted = ("big", "pruned") if self.model == "adaptive" \
            else (self.model,)
        for v in wanted:
            m = variants[v]
            if m is None or m.device.type != ctx.device.type:
                raise ValueError(f"{self.name}: variant {v!r} needs a model "
                                 f"on {ctx.device}")
        self._runs = {v: make_extract_fn(variants[v]) for v in wanted}

    def resolve_variant(self, n: int) -> str:
        """Pick the physical variant for a batch of ``n`` surviving frames
        (advances the adaptive density EMA: call once per batch)."""
        if self.model != "adaptive":
            return self.model
        density = n / max(self._micro_batch_hint, 1)
        self._density_ema = 0.8 * self._density_ema + 0.2 * density
        return "big" if self._density_ema >= self.density_threshold \
            else "pruned"

    def begin_extract(self, n: int) -> str:
        """Account ``n`` frames of model load and resolve the variant."""
        self.frames_processed += n
        return self.resolve_variant(n)

    def apply_preds(self, batch: Batch, preds: Dict[str, Any],
                    n: int) -> Batch:
        """Merge per-task predictions (first ``n`` rows are real) into the
        batch's attrs."""
        batch = dict(batch)
        attrs = dict(batch.get("attrs", {}))
        for k, v in preds.items():
            attrs[k] = np.asarray(v)[:n]
        batch["attrs"] = attrs
        return batch

    def _forward(self, variant: str, frames: np.ndarray, n: int
                 ) -> Dict[str, np.ndarray]:
        """One bucket-padded forward over ``frames[:n]``."""
        bucket = _bucket_pad(n)
        if bucket != n:
            pad = np.zeros((bucket - n,) + frames.shape[1:], frames.dtype)
            frames = np.concatenate([frames, pad], 0)
        self.forwards += 1
        preds = self._runs[variant](self._ctx.to_device(frames))
        return {k: v.cpu().numpy() for k, v in preds.items()}

    def process(self, batch: Batch) -> Batch:
        # a FusedPrefixOp immediately upstream computed the gate signature
        # in its device pass; the port has no gate yet, so the extract
        # drops it here and it never reaches a tail or a sink record
        if "_sig" in batch:
            batch = dict(batch)
            batch.pop("_sig")
        n = batch["frames"].shape[0]
        if n == 0:
            return batch
        variant = self.begin_extract(n)
        preds = self._forward(variant, batch["frames"], n)
        return self.apply_preds(batch, preds, n)

    def reset(self):
        self.frames_processed = 0
        self.forwards = 0
        self._density_ema = 0.5

    def snapshot(self):
        return {"frames_processed": self.frames_processed,
                "forwards": self.forwards,
                "density_ema": self._density_ema}

    def restore(self, st):
        self.frames_processed = st["frames_processed"]
        self.forwards = st.get("forwards", 0)
        self._density_ema = st.get("density_ema", 0.5)


# ===========================================================================
# Relational tail: Filter / Window-Aggregate
# ===========================================================================

@dataclasses.dataclass
class FilterOp(Op):
    """Predicate on extracted attrs. Predicates are small s-expr tuples:
      ("eq", "color", "red") | ("prefix", "plate", "MTT")
      | ("and", p1, p2) | ("or", p1, p2) | ("eq", "action", "spike")
    """

    pred: Tuple = ("eq", "present", 1)

    def __post_init__(self):
        self.name = f"filter{self.pred}"

    def _eval(self, pred, attrs, n) -> np.ndarray:
        kind = pred[0]
        if kind in ("and", "or"):
            a = self._eval(pred[1], attrs, n)
            b = self._eval(pred[2], attrs, n)
            return (a & b) if kind == "and" else (a | b)
        if kind == "eq":
            _, field, val = pred
            vocab = {"color": COLORS, "brand": BRANDS, "action": ACTIONS}
            iv = vocab[field].index(val) if isinstance(val, str) else val
            return np.asarray(attrs[field]) == iv
        if kind == "ge":
            _, field, val = pred
            return np.asarray(attrs[field]) >= val
        if kind == "prefix":
            _, field, val = pred
            chars = np.asarray(attrs[field])   # (B, PLATE_LEN)
            want = [PLATE_CHARS.index(c) for c in val]
            ok = np.ones(n, bool)
            for i, w in enumerate(want):
                ok &= chars[:, i] == w
            return ok
        raise ValueError(pred)

    def process(self, batch: Batch) -> Batch:
        n = len(batch["idx"])
        if n == 0:
            return batch
        keep = self._eval(self.pred, batch["attrs"], n)
        return _mask_batch(batch, keep)


@dataclasses.dataclass
class WindowAggOp(Op):
    """Tumbling-window aggregation over extracted attrs.

    kinds: top_color | top_brand | top_brand_color | count_distinct_plates |
           repeated_plates | count_jumping | top_team | top3_actions
    """

    kind: str = "top_color"
    window: int = 128            # frames per tumbling window (by index)

    def __post_init__(self):
        self.name = f"window[{self.kind},{self.window}]"
        self._buf: List[Dict[str, Any]] = []
        self._window_start = 0

    def process(self, batch: Batch) -> Batch:
        n = len(batch["idx"])
        attrs = batch.get("attrs", {})
        for i in range(n):
            rec = {"idx": int(batch["idx"][i])}
            for k, v in attrs.items():
                rec[k] = np.asarray(v[i])
            self._buf.append(rec)
        out_results = []
        # tumble on frame index (event time)
        max_idx = int(batch["idx"][-1]) if n else None
        while max_idx is not None and \
                max_idx >= self._window_start + self.window:
            w_end = self._window_start + self.window
            in_win = [r for r in self._buf if r["idx"] < w_end]
            self._buf = [r for r in self._buf if r["idx"] >= w_end]
            out_results.append(self._aggregate(in_win,
                                               self._window_start, w_end))
            self._window_start = w_end
        batch = dict(batch)
        if out_results:
            batch["window_results"] = batch.get("window_results", []) \
                + out_results
        return batch

    def _aggregate(self, recs, w0, w1) -> Dict[str, Any]:
        from collections import Counter

        res: Dict[str, Any] = {"window": (w0, w1), "kind": self.kind,
                               "n": len(recs)}
        if self.kind in ("top_color", "top_brand", "top_brand_color"):
            if self.kind != "top_brand":
                c = Counter(int(r["color"]) for r in recs if "color" in r)
                res["top_color"] = COLORS[c.most_common(1)[0][0]] if c else None
            if self.kind != "top_color":
                c = Counter(int(r["brand"]) for r in recs if "brand" in r)
                res["top_brand"] = BRANDS[c.most_common(1)[0][0]] if c else None
        elif self.kind == "count_distinct_plates":
            plates = set(tuple(int(x) for x in r["plate"]) for r in recs
                         if "plate" in r)
            res["distinct_plates"] = len(plates)
        elif self.kind == "repeated_plates":
            c = Counter(tuple(int(x) for x in r["plate"]) for r in recs
                        if "plate" in r)
            res["repeated"] = ["".join(PLATE_CHARS[i] for i in p)
                               for p, k in c.items() if k >= 2]
        elif self.kind == "count_jumping":
            res["total_jumping"] = sum(int(r.get("n_jumping", 0))
                                       for r in recs)
        elif self.kind == "top_team":
            # offense proxy: most spike actions => attacking team majority
            c = Counter(int(r["action"]) for r in recs if "action" in r)
            res["spikes"] = c.get(ACTIONS.index("spike"), 0)
        elif self.kind == "top3_actions":
            c = Counter(int(r["action"]) for r in recs if "action" in r)
            res["top3"] = [ACTIONS[a] for a, _ in c.most_common(3)]
        return res

    def reset(self):
        self._buf = []
        self._window_start = 0

    def flush(self) -> Optional[Batch]:
        """Emit the open (partial) tumbling window, marked ``partial``;
        non-destructive, so a resumed run keeps tumbling identically."""
        if not self._buf:
            return None
        w0 = self._window_start
        res = self._aggregate(self._buf, w0, w0 + self.window)
        res["partial"] = True
        return {"frames": np.zeros((0, 1, 1, 1), np.float32),
                "idx": np.zeros((0,), np.int64),
                "window_results": [res]}

    def snapshot(self):
        return {"buf": list(self._buf), "window_start": self._window_start}

    def restore(self, st):
        self._buf = list(st["buf"])
        self._window_start = st["window_start"]


# ===========================================================================
def _mask_batch(batch: Batch, keep: np.ndarray) -> Batch:
    out = dict(batch)
    out["frames"] = batch["frames"][keep]
    out["idx"] = batch["idx"][keep]
    if "attrs" in batch:
        out["attrs"] = {k: np.asarray(v)[keep]
                        for k, v in batch["attrs"].items()}
    return out
