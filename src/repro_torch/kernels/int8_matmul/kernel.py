"""Binding of ``csrc/int8_matmul.cu`` (see the source for the design
note)."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._build import CudaKernel, require_cuda

_I, _P = ctypes.c_int, ctypes.c_void_p
#: w's K-major transpose into scratch, then the tensor-core product
TRANSPOSE = CudaKernel("int8_matmul", "int8_transpose_kn",
                       [_P, _P, _I, _I, _I])
KERNEL = CudaKernel("int8_matmul", "int8_mma_f32",
                    [_P, _P, _P, _P, _P, _I, _I, _I, _I])
#: the int32 accumulator holds K products of at most 127² without overflow
MAX_K = (2 ** 31 - 1) // (127 * 127)


def int8_matmul_cuda(x_q: torch.Tensor, w_q: torch.Tensor, sx: torch.Tensor,
                     sw: torch.Tensor, out_dtype=torch.float32
                     ) -> torch.Tensor:
    """x_q (M, K) int8, w_q (K, N) int8, sx (M, 1) f32, sw (1, N) f32, on
    CUDA -> (M, N) f32, ``(float(acc) * sx) * sw``.  Any M, N and K up to
    ``MAX_K``: w's transpose (N, Kp), Kp = K rounded up to 16, into
    scratch, then the product on the int8 tensor cores (exact)."""
    if x_q.dtype != torch.int8 or w_q.dtype != torch.int8:
        raise ValueError("int8_matmul: the CUDA kernel takes int8 operands "
                         f"(got {x_q.dtype}, {w_q.dtype})")
    if sx.dtype != torch.float32 or sw.dtype != torch.float32:
        raise ValueError("int8_matmul: the scales must be float32")
    if out_dtype != torch.float32:
        raise ValueError(f"int8_matmul: the CUDA kernel writes float32, not "
                         f"{out_dtype}")
    if x_q.dim() != 2 or w_q.dim() != 2:
        raise ValueError(f"int8_matmul: x {tuple(x_q.shape)}, w "
                         f"{tuple(w_q.shape)} must be matrices")
    m, k = x_q.shape
    n = w_q.shape[1]
    if w_q.shape[0] != k or sx.shape != (m, 1) or sw.shape != (1, n):
        raise ValueError(f"int8_matmul: x {tuple(x_q.shape)}, w "
                         f"{tuple(w_q.shape)}, sx {tuple(sx.shape)}, sw "
                         f"{tuple(sw.shape)}")
    if k > MAX_K:
        raise ValueError(f"int8_matmul: K {k} overflows the int32 "
                         f"accumulator (at most {MAX_K})")
    dev = require_cuda("int8_matmul", x_q, w_q, sx, sw)
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    if m and n and k:
        kp = -(-k // 16) * 16
        wt = torch.empty((n, kp), dtype=torch.int8, device=dev)
        TRANSPOSE.launch(dev, w_q.data_ptr(), wt.data_ptr(), k, n, kp)
        KERNEL.launch(dev, x_q.data_ptr(), wt.data_ptr(), sx.data_ptr(),
                      sw.data_ptr(), out.data_ptr(), m, n, k, kp)
    elif m and n:
        out.zero_()
    return out
