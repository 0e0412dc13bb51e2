"""Plain PyTorch version of the int8 matmul and its quantization helpers.

Counterpart of ``repro/kernels/int8_matmul/ref.py``, with its arithmetic
step for step: ``amax`` clamped at 1e-8 and divided by 127, round half to
even, clamp to [-127, 127]; the product accumulated exactly, converted to
fp32 (round to nearest), then multiplied by ``sx`` and then by ``sw``.
"""
from __future__ import annotations

from typing import Tuple

import torch


def _quantize(x: torch.Tensor, dim) -> Tuple[torch.Tensor, torch.Tensor]:
    amax = x.abs().amax(dim=dim, keepdim=True)
    # 127 as a tensor: PyTorch multiplies a CUDA tensor by the reciprocal
    # of a Python number, one ulp off the CPU's (and the reference's) true
    # division; a tensor divisor divides on both devices
    scale = torch.clamp(amax, min=1e-8) / torch.full((), 127.0,
                                                     device=x.device)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale.to(torch.float32)


def quantize_rowwise(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row int8 quantization: x (M, K) -> q (M, K) int8,
    scale (M, 1) f32."""
    return _quantize(x, -1)


def quantize_colwise(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-column int8 quantization: w (K, N) -> q (K, N) int8,
    scale (1, N) f32."""
    return _quantize(w, 0)


def int8_matmul_plain(x_q: torch.Tensor, w_q: torch.Tensor,
                      sx: torch.Tensor, sw: torch.Tensor) -> torch.Tensor:
    """x_q (M, K) int8 @ w_q (K, N) int8, scaled -> (M, N) f32:
    ``(float(acc) * sx) * sw``.

    The integer product is taken in float64, where every partial sum is an
    integer below K·127² < 2⁵³ and so exact (PyTorch has no int32 matmul
    on CUDA, and an fp32 product is exact only up to K ≈ 1040); it equals
    the reference's int32 accumulation wherever that does not overflow."""
    acc = (x_q.to(torch.float64) @ w_q.to(torch.float64)).to(torch.int32)
    return (acc.to(torch.float32) * sx) * sw
