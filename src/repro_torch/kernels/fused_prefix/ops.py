"""Public fused-prefix op: one device pass for a plan's whole pixel
prefix; the input's device picks kernel or plain version.

``FusedPrefixOp`` (``repro_torch.streaming.fused``) composes this with the
detector forward and owns the host-side mask and state logic.
"""
from __future__ import annotations

import torch

from repro_torch.kernels._build import plain_device
from repro_torch.kernels.fused_prefix.kernel import fused_prefix_cuda
from repro_torch.kernels.fused_prefix.ref import fused_prefix_ref


def fused_prefix(frames: torch.Tensor, prevs=None, proj=None, *, spec):
    """frames (B, C, H, W), prevs the same shape (diff stage only), proj
    (D, EMB_DIM) f32 (signature stage only); ``spec`` is the stage tuple
    documented in ``ref.py``.  Returns ``(d, fracs, x, feats, emb)``."""
    fn = fused_prefix_ref if plain_device(frames) \
        else fused_prefix_cuda
    return fn(frames, prevs, proj, spec=spec)
