"""FusedPrefixOp: a plan's surviving-frame prefix as one device pass.

Counterpart of ``repro/streaming/fused.py``.  The prefix of an optimized
plan (Skip's frame diff, cheap colour filters, crop / downscale /
normalize, the TinyDet cascade, and the signature) otherwise runs as one
operator call per stage per micro-batch, each with its own host-to-device
copy and launch.  ``FusedPrefixOp.process`` copies the micro-batch (and
Skip's predecessor frames) to the device once, launches the
``fused_prefix`` kernel once, runs the TinyDet forward and the signature
projection on its outputs on the same device, and brings the results back.
The host then replays each stage's *decision* (Skip's stateful loop, the
colour and detect thresholds) in chain order, exactly as the unfused ops
would.

Contract: on one device the fused op keeps the same rows and writes the
same frames and signatures as the unfused chain, bit for bit: filters never
transform frames, so their per-row statistics computed on the full batch
equal those computed on the survivors, and the kernel (or, on the CPU, the
plain version) shares each stage's arithmetic with the unfused operator.
The physical phase (``core/physical.py``) decides fused vs unfused from
calibrated costs; this op never chooses for itself.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.data.tollbooth import COLOR_RGB
from repro_torch.kernels.fused_prefix.kernel import out_frame_shape
from repro_torch.kernels.fused_prefix.ops import fused_prefix
from repro_torch.semantic.signature import signature_layout
from repro_torch.streaming.operators import (
    Batch,
    CheapColorFilterOp,
    CropOp,
    DetectOp,
    FusedPreprocessOp,
    Op,
    OpContext,
    SkipOp,
    _mask_batch,
    detect_prob,
)

#: operator classes the fused pass can absorb.  Downscale/Greyscale are
#: absent: their host-numpy math is not the device's, and the logical
#: optimizer folds them into ``FusedPreprocessOp`` (rule R3) anyway.
FUSABLE = (SkipOp, CheapColorFilterOp, CropOp, FusedPreprocessOp,
           DetectOp)


def fusable_segment(ops: List[Op]) -> bool:
    """True when ``ops`` is a chain the fused pass can execute: only
    FUSABLE classes, any Skip first (its diff reads the raw input), any
    Detect last (it scores the fully transformed frames)."""
    if not ops or not all(isinstance(o, FUSABLE) for o in ops):
        return False
    if any(isinstance(o, SkipOp) for o in ops[1:]):
        return False
    if any(isinstance(o, DetectOp) for o in ops[:-1]):
        return False
    return sum(isinstance(o, SkipOp) for o in ops) <= 1 \
        and sum(isinstance(o, DetectOp) for o in ops) <= 1


@dataclasses.dataclass
class FusedPrefixOp(Op):
    """One-device-pass execution of a fusable prefix segment.

    ``stage_ops`` are the original descriptors in plan order: they hold
    every threshold and region, and Skip's runtime state (``keep_from_diff``
    advances the member SkipOp itself, so a fused plan snapshots and
    restores like the unfused one).  The op also emits the signature of
    the surviving rows as ``batch["_sig"]`` for the extract downstream."""

    stage_ops: Tuple[Op, ...] = ()

    def __post_init__(self):
        if not fusable_segment(list(self.stage_ops)):
            raise ValueError("not a fusable segment: "
                             f"{[o.name for o in self.stage_ops]}")
        self.name = "fused_prefix[" + \
            "+".join(o.name for o in self.stage_ops) + "]"
        self._layouts: Dict[Tuple, Any] = {}
        #: per-stage (name, rows_in, rows_out) of the last processed batch
        self.last_stage_counts: List[Tuple[str, int, int]] = []

    # ------------------------------------------------------------------
    def signature(self) -> Tuple:
        # nested primitive tuples instead of Op instances: hashable
        return ("FusedPrefixOp",
                tuple(o.signature() for o in self.stage_ops))

    def unfuse(self) -> List[Op]:
        """Fresh, stateless copies of the member descriptors: the unfused
        chain this op replaces."""
        return [type(o)(**{f.name: getattr(o, f.name)
                           for f in dataclasses.fields(o) if f.init})
                for o in self.stage_ops]

    # ------------------------------------------------------------------
    def open(self, ctx: OpContext) -> None:
        self._ctx = ctx
        self._skip: Optional[SkipOp] = None
        self._detect: Optional[DetectOp] = None
        pix: List[Tuple] = []
        for o in self.stage_ops:
            if isinstance(o, SkipOp):
                self._skip = o
                pix.append(("diff", o.regions))
            elif isinstance(o, CheapColorFilterOp):
                pix.append(("color", tuple(COLOR_RGB[o.color]), o.roi))
            elif isinstance(o, CropOp):
                pix.append(("crop", o.region))
            elif isinstance(o, FusedPreprocessOp):
                pix.append(("preprocess", o.crop, o.factor, o.grey))
            else:
                self._detect = o
                if ctx.detector is None:
                    raise ValueError(f"{self.name}: the context has no "
                                     "detector")
        self._pix_spec = tuple(pix)
        self._normalizes = any(isinstance(o, FusedPreprocessOp)
                               for o in self.stage_ops)
        self._layouts = {}

    def _layout(self, shape: Tuple[int, ...]):
        """The stage spec (with the signature stage) and the projection on
        the device, for one input frame shape."""
        if shape not in self._layouts:
            # the signature layout of the *final* frame shape, from the one
            # source of truth the unfused signature also reads
            gy, gx, _, proj = signature_layout(
                out_frame_shape(self._pix_spec, shape))
            self._layouts[shape] = (
                self._pix_spec + (("signature", (gy, gx)),),
                torch.from_numpy(proj).to(self._ctx.device))
        return self._layouts[shape]

    # ------------------------------------------------------------------
    def process(self, batch: Batch) -> Batch:
        frames = batch["frames"]
        n = frames.shape[0]
        if n == 0:
            return batch
        ctx = self._ctx
        spec, proj = self._layout(tuple(frames.shape[1:]))
        prevs = None
        if self._skip is not None:
            prevs = ctx.to_device(self._skip.prev_frames(frames))
        with torch.inference_mode():
            d, fracs, x, feats, emb = fused_prefix(
                ctx.to_device(frames), prevs, proj, spec=spec)
            p = detect_prob(ctx.detector, x) \
                if self._detect is not None else None

        # host side: replay each stage's decision in chain order; Skip's
        # stateful loop advances the member op itself
        keep = np.ones(n, bool)
        self.last_stage_counts = []
        ci = 0
        for o in self.stage_ops:
            rows_in = int(keep.sum())
            if isinstance(o, SkipOp):
                keep &= o.keep_from_diff(frames, d.cpu().numpy())
            elif isinstance(o, CheapColorFilterOp):
                keep &= fracs[ci].cpu().numpy() >= o.min_frac
                ci += 1
            elif isinstance(o, DetectOp):
                keep &= p.cpu().numpy() >= o.threshold
            self.last_stage_counts.append(
                (o.name, rows_in, int(keep.sum())))

        batch = dict(batch)
        batch["frames"] = x.cpu().numpy()
        if self._normalizes:
            batch["normalized"] = True
        batch = _mask_batch(batch, keep)
        batch["_sig"] = (feats.cpu().numpy()[keep], emb.cpu().numpy()[keep])
        return batch

    # ------------------------------------------------------------------
    def reset(self) -> None:
        for o in self.stage_ops:
            o.reset()
        self.last_stage_counts = []

    def snapshot(self) -> Dict[str, Any]:
        return {"stages": [o.snapshot() for o in self.stage_ops]}

    def restore(self, st: Dict[str, Any]) -> None:
        for o, s in zip(self.stage_ops, st["stages"]):
            o.restore(s)
