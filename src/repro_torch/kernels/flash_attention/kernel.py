"""Binding of ``csrc/flash_attention.cu`` (see the source for the design
note)."""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels._build import CudaKernel, require_cuda

_I, _F, _P = ctypes.c_int, ctypes.c_float, ctypes.c_void_p
KERNEL = CudaKernel("flash_attention", "flash_attention_f32",
                    [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I])
HEAD_DIMS = (16, 32, 64, 96, 128, 256)
MAX_GROUP = 64


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, cap: Optional[float] = None,
                         window: Optional[int] = None) -> torch.Tensor:
    """Model layout on CUDA, fp32: q (B, S, H, D); k, v (B, S, Hk, D) ->
    (B, S, H, D).  Any S; D in ``HEAD_DIMS``; H/Hk at most ``MAX_GROUP``."""
    dev = require_cuda("flash_attention", q, k, v)
    if not (q.dtype == k.dtype == v.dtype == torch.float32):
        raise ValueError("flash_attention: the CUDA kernel takes float32")
    b, s, h, d = q.shape
    hk = k.shape[2]
    if k.shape != (b, s, hk, d) or v.shape != k.shape:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if d not in HEAD_DIMS or h % hk or h // hk > MAX_GROUP:
        raise ValueError(f"flash_attention: head_dim {d} (takes {HEAD_DIMS})"
                         f", {h} q heads over {hk} kv heads")
    if cap is not None and cap <= 0:
        raise ValueError("flash_attention: cap must be positive")
    if window is not None and window <= 0:
        raise ValueError("flash_attention: window must be positive")
    out = torch.empty_like(q)
    if b and s:
        KERNEL.launch(dev, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      out.data_ptr(), b, s, h, hk, d, int(causal),
                      0.0 if cap is None else float(cap),
                      0 if window is None else int(window))
    return out
