"""Binding of ``csrc/frame_diff.cu`` (see the source for the design note)."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._build import CudaKernel, require_cuda

_I = ctypes.c_int
KERNEL = CudaKernel("frame_diff", "frame_diff_u8",
                    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                     _I, _I, _I, _I, _I, _I])


def frame_diff_cuda(cur: torch.Tensor, prev: torch.Tensor, *,
                    regions=(4, 4)) -> torch.Tensor:
    """cur/prev (B, C, H, W) uint8 on CUDA -> (B, RY, RX) f32."""
    dev = require_cuda("frame_diff", cur, prev)
    if cur.dtype != torch.uint8 or prev.dtype != torch.uint8:
        raise ValueError("frame_diff: the CUDA kernel takes uint8 frames")
    if cur.shape != prev.shape or cur.dim() != 4:
        raise ValueError(f"frame_diff: shapes {tuple(cur.shape)} vs "
                         f"{tuple(prev.shape)}")
    b, c, h, w = cur.shape
    ry, rx = regions
    if h % ry or w % rx:
        raise ValueError(f"frame_diff: {h}x{w} frame not divisible into "
                         f"{ry}x{rx} regions")
    out = torch.empty((b, ry, rx), dtype=torch.float32, device=dev)
    if b:
        KERNEL.launch(dev, cur.data_ptr(), prev.data_ptr(), out.data_ptr(),
                      b, c, h, w, ry, rx)
    return out
