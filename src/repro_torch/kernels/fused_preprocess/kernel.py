"""Binding of ``csrc/fused_preprocess.cu`` (see the source for the design
note)."""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels._build import CudaKernel, require_cuda

_I, _F = ctypes.c_int, ctypes.c_float
KERNEL = CudaKernel("fused_preprocess", "fused_preprocess_u8",
                    [ctypes.c_void_p, ctypes.c_void_p]
                    + [_I] * 10 + [_F] * 8)


def fused_preprocess_cuda(
    frames: torch.Tensor, *, crop: Tuple[int, int, int, int],
    factor: int = 1, mean: Tuple[float, ...] = (0.5, 0.5, 0.5),
    std: Tuple[float, ...] = (0.25, 0.25, 0.25), grey: bool = False,
) -> torch.Tensor:
    """frames (B, C, H, W) uint8 on CUDA -> (B, C', h/f, w/f) f32.

    Takes every crop inside the frame whose height and width divide by
    ``factor`` (what the plain version takes)."""
    dev = require_cuda("fused_preprocess", frames)
    if frames.dtype != torch.uint8 or frames.dim() != 4:
        raise ValueError("fused_preprocess: the CUDA kernel takes uint8 "
                         "(B, C, H, W) frames")
    b, c, h, w = frames.shape
    y0, x0, ch, cw = crop
    f = factor
    if not (0 <= y0 and 0 <= x0 and y0 + ch <= h and x0 + cw <= w
            and ch > 0 and cw > 0):
        raise ValueError(f"fused_preprocess: crop {crop} outside {h}x{w}")
    if f <= 0 or ch % f or cw % f:
        raise ValueError(f"fused_preprocess: crop {ch}x{cw} not divisible "
                         f"by factor {f}")
    if c > 4 or len(mean) != c or len(std) != c:
        raise ValueError("fused_preprocess: one mean/std per channel, "
                         "at most 4 channels")
    if grey and c != 3:
        raise ValueError("fused_preprocess: greyscale needs 3 channels")
    out = torch.empty((b, 1 if grey else c, ch // f, cw // f),
                      dtype=torch.float32, device=dev)
    if b:
        m = list(mean) + [0.0] * (4 - c)
        s = list(std) + [1.0] * (4 - c)
        KERNEL.launch(dev, frames.data_ptr(), out.data_ptr(), b, c, h, w,
                      y0, x0, ch, cw, f, int(grey), *m, *s)
    return out
