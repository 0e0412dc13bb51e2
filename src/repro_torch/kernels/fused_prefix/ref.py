"""Plain PyTorch version of the fused surviving-frame prefix chain.

One function evaluates every *pixel* stage of a plan's prefix (frame-diff
activity, cheap colour fractions, crop, fused preprocess with its grey
re-expansion, and the signature pooling) in plan order on the full
micro-batch.  Filters never transform frames, so their per-row statistics
computed here on all rows equal the values the unfused operators compute
on their compacted survivor batches; transforms apply to every row as the
unfused chain applies them to survivors.

The stages *are* the unfused operators' arithmetic: ``frame_diff_ref``,
``fused_preprocess_ref``, ``color_frac`` (``CheapColorFilterOp``'s body)
and ``signature_feats`` (``TemporalSignature``'s body), so on one device
the fused and the unfused chain agree bit for bit.

``spec`` is a tuple of stage tuples, in plan order:

  ("diff", (ry, rx))                      at most one, first if present
  ("color", (r, g, b), roi_or_None)       per CheapColorFilterOp
  ("crop", (y0, x0, h, w))                per CropOp
  ("preprocess", (y0, x0, h, w), f, grey) per FusedPreprocessOp
  ("signature", (gy, gx))                 at most one, last if present

Returns ``(d, fracs, x, feats, emb)``: the (B, ry, rx) diff grid (or
None), a tuple of per-colour (B,) fractions, the transformed frames, and
the signature feats/emb (or None, None).
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.kernels.frame_diff.ref import frame_diff_ref
from repro_torch.kernels.fused_preprocess.ref import fused_preprocess_ref


def project_rowwise(feats: torch.Tensor, proj: torch.Tensor) -> torch.Tensor:
    """``feats @ proj`` as broadcast-multiply + sum over the feature axis.

    A gemm's accumulation order may change with the number of rows, so the
    same row could round differently in a padded gate batch and in a full
    micro-batch; the explicit reduce keeps each row's order fixed."""
    return (feats[:, :, None] * proj[None]).sum(dim=1)


def color_frac(x: torch.Tensor, rgb: Sequence[float]) -> torch.Tensor:
    """Per-frame fraction of pixels within RGB distance 70 of ``rgb``.

    Raw vs normalized is decided per frame (max <= 8 means normalized).
    The target colour enters as Python scalars, one channel at a time, so
    nothing is copied to the device and each distance is summed in channel
    order, as the CUDA kernel sums it."""
    x = x.to(torch.float32)
    norm = x.reshape(x.shape[0], -1).amax(dim=1) <= 8.0
    x = torch.where(norm[:, None, None, None], (x * 0.25 + 0.5) * 255.0, x)
    d2 = (x[:, 0] - float(rgb[0])) ** 2
    for k in range(1, x.shape[1]):
        d2 = d2 + (x[:, k] - float(rgb[k])) ** 2
    return (torch.sqrt(d2) < 70.0).to(torch.float32).mean(dim=(1, 2))


def signature_feats(x: torch.Tensor, gy: int, gx: int) -> torch.Tensor:
    """(B, C, H, W) -> (B, C·gy·gx) per-channel patch means; raw frames
    (max > 8) are normalized first, decided per frame."""
    b, c, h, w = x.shape
    x = x.to(torch.float32)
    raw = x.reshape(b, -1).amax(dim=1) > 8.0
    x = torch.where(raw[:, None, None, None], (x / 255.0 - 0.5) / 0.25, x)
    p = x.reshape(b, c, gy, h // gy, gx, w // gx)
    return p.mean(dim=(3, 5)).reshape(b, c * gy * gx)


def fused_prefix_ref(frames: torch.Tensor, prevs=None, proj=None, *, spec):
    cur = frames
    d = None
    fracs = []
    feats = emb = None
    for stage in spec:
        kind = stage[0]
        if kind == "diff":
            d = frame_diff_ref(frames, prevs, regions=stage[1])
        elif kind == "color":
            roi = stage[2]
            x = cur
            if roi is not None:
                y0, x0, h, w = roi
                x = x[:, :, y0:y0 + h, x0:x0 + w]
            fracs.append(color_frac(x, stage[1]))
        elif kind == "crop":
            y0, x0, h, w = stage[1]
            cur = cur[:, :, y0:y0 + h, x0:x0 + w]
        elif kind == "preprocess":
            _, crop, factor, grey = stage
            cur = fused_preprocess_ref(cur, crop=crop, factor=factor,
                                       grey=grey)
            if grey:
                # FusedPreprocessOp re-expands grey to 3 channels on the
                # host; downstream stages must see the same frames
                cur = cur.repeat(1, 3, 1, 1)
        elif kind == "signature":
            gy, gx = stage[1]
            feats = signature_feats(cur, gy, gx)
            emb = project_rowwise(feats, proj)
        else:
            raise ValueError(f"unknown fused-prefix stage {kind!r}")
    return d, tuple(fracs), cur, feats, emb
