"""Plain PyTorch version of fused preprocessing."""
from __future__ import annotations

from typing import Tuple

import torch

LUMA = (0.299, 0.587, 0.114)


def fused_preprocess_ref(
    frames: torch.Tensor, *, crop: Tuple[int, int, int, int],
    factor: int = 1, mean: Tuple[float, ...] = (0.5, 0.5, 0.5),
    std: Tuple[float, ...] = (0.25, 0.25, 0.25), grey: bool = False,
) -> torch.Tensor:
    """frames (B, C, H, W); crop (y0, x0, h, w) -> (B, C', h/f, w/f) f32."""
    b, c, h, w = frames.shape
    y0, x0, ch, cw = crop
    x = frames[:, :, y0:y0 + ch, x0:x0 + cw].to(torch.float32) / 255.0
    x = x.reshape(b, c, ch // factor, factor, cw // factor, factor)
    x = x.mean(dim=(3, 5))
    # per-channel Python scalars: no host-to-device copy of the constants
    chans = [(x[:, ci] - mean[ci]) / std[ci] for ci in range(c)]
    if grey:
        out = chans[0] * LUMA[0]
        for ci in range(1, c):
            out = out + chans[ci] * LUMA[ci]
        return out[:, None]
    return torch.stack(chans, dim=1)
