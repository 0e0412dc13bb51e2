"""Public int8 matmul ops: the input's device picks kernel or plain
version.

Counterpart of ``repro/kernels/int8_matmul/ops.py``: ``int8_matmul`` on
quantized operands and ``matmul_int8_dynamic``, which quantizes the
activations row by row (in PyTorch, outside the kernel, as the reference
does in jnp) against weights quantized ahead of time
(``serving/quantize.py``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels._build import plain_device
from repro_torch.kernels.int8_matmul.kernel import int8_matmul_cuda
from repro_torch.kernels.int8_matmul.ref import (int8_matmul_plain,
                                                 quantize_rowwise)


def int8_matmul(x_q: torch.Tensor, w_q: torch.Tensor, sx: torch.Tensor,
                sw: torch.Tensor) -> torch.Tensor:
    """x_q (M, K) int8, w_q (K, N) int8, sx (M, 1), sw (1, N) -> (M, N)
    f32."""
    if not plain_device(x_q):
        return int8_matmul_cuda(x_q, w_q, sx, sw)
    return int8_matmul_plain(x_q, w_q, sx, sw)


def matmul_int8_dynamic(x: torch.Tensor, w_q: torch.Tensor,
                        sw: torch.Tensor) -> torch.Tensor:
    """x (M, K) f32 against pre-quantized w_q (K, N) int8 with column
    scales sw (1, N) -> (M, N) f32."""
    x_q, sx = quantize_rowwise(x)
    return int8_matmul(x_q, w_q, sx, sw)
