"""Plain PyTorch version of frame differencing."""
from __future__ import annotations

import torch


def frame_diff_ref(cur: torch.Tensor, prev: torch.Tensor, *,
                   regions=(4, 4)) -> torch.Tensor:
    """cur/prev (B, C, H, W) -> (B, RY, RX) f32 mean |cur − prev| / 255."""
    b, c, h, w = cur.shape
    ry, rx = regions
    rh, rw = h // ry, w // rx
    d = (cur.to(torch.float32) - prev.to(torch.float32)).abs() / 255.0
    d = d.reshape(b, c, ry, rh, rx, rw)
    return d.mean(dim=(1, 3, 5))
