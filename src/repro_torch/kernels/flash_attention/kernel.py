"""Bindings of ``csrc/flash_attention.cu`` (the forward, with or without
each row's log-sum-exp) and ``csrc/flash_attention_bwd.cu`` (its gradient);
see the sources for the design notes."""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels._build import CudaKernel, require_cuda

_I, _F, _P = ctypes.c_int, ctypes.c_float, ctypes.c_void_p
KERNEL = CudaKernel("flash_attention", "flash_attention_f32",
                    [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I])
#: the training forward: the output and each row's log-sum-exp
KERNEL_LSE = CudaKernel("flash_attention", "flash_attention_lse_f32",
                        [_P] * 5 + [_I] * 6 + [_F, _I])
#: the backward: dQ, dK, dV (three launches: delta, dK/dV, dQ)
KERNEL_BWD = CudaKernel("flash_attention_bwd", "flash_attention_bwd_f32",
                        [_P] * 10 + [_I] * 6 + [_F, _I])
HEAD_DIMS = (16, 32, 64, 96, 128, 256)
MAX_GROUP = 64


def _check(name: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           cap: Optional[float], window: Optional[int]) -> torch.device:
    dev = require_cuda(name, q, k, v)
    if not (q.dtype == k.dtype == v.dtype == torch.float32):
        raise ValueError(f"{name}: the CUDA kernel takes float32")
    b, s, h, d = q.shape
    hk = k.shape[2]
    if k.shape != (b, s, hk, d) or v.shape != k.shape:
        raise ValueError(f"{name}: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if d not in HEAD_DIMS or h % hk or h // hk > MAX_GROUP:
        raise ValueError(f"{name}: head_dim {d} (takes {HEAD_DIMS})"
                         f", {h} q heads over {hk} kv heads")
    if cap is not None and cap <= 0:
        raise ValueError(f"{name}: cap must be positive")
    if window is not None and window <= 0:
        raise ValueError(f"{name}: window must be positive")
    return dev


def _options(causal: bool, cap: Optional[float], window: Optional[int]):
    return (int(causal), 0.0 if cap is None else float(cap),
            0 if window is None else int(window))


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, cap: Optional[float] = None,
                         window: Optional[int] = None, lse: bool = False):
    """Model layout on CUDA, fp32: q (B, S, H, D); k, v (B, S, Hk, D) ->
    (B, S, H, D).  Any S; D in ``HEAD_DIMS``; H/Hk at most ``MAX_GROUP``.
    With ``lse`` returns (out, lse) where lse (B, H, S) is each row's
    log-sum-exp of its scaled (and capped) logits, which
    ``flash_attention_bwd_cuda`` takes (``flash_attention_lse_f32``; the
    output is the same kernel's)."""
    dev = _check("flash_attention", q, k, v, cap, window)
    b, s, h, d = q.shape
    out = torch.empty_like(q)
    rows = torch.empty((b, h, s), device=dev) if lse else None
    if b and s:
        dims = (b, s, h, k.shape[2], d, *_options(causal, cap, window))
        if lse:
            KERNEL_LSE.launch(dev, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                              out.data_ptr(), rows.data_ptr(), *dims)
        else:
            KERNEL.launch(dev, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                          out.data_ptr(), *dims)
    return (out, rows) if lse else out


def flash_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, out: torch.Tensor,
                             lse: torch.Tensor, dout: torch.Tensor, *,
                             causal: bool = True,
                             cap: Optional[float] = None,
                             window: Optional[int] = None):
    """The gradient of ``flash_attention_cuda(q, k, v, ...)`` at ``dout``
    (B, S, H, D), given its output ``out`` and ``lse`` (from ``lse=True``
    with the same options): (dq, dk, dv) in the layouts of q, k, v."""
    dev = _check("flash_attention_bwd", q, k, v, cap, window)
    require_cuda("flash_attention_bwd", out, lse, dout)
    b, s, h, d = q.shape
    if out.shape != q.shape or dout.shape != q.shape or \
            lse.shape != (b, h, s):
        raise ValueError(f"flash_attention_bwd: out {tuple(out.shape)}, "
                         f"dout {tuple(dout.shape)}, lse {tuple(lse.shape)}"
                         f" for q {tuple(q.shape)}")
    if not (out.dtype == dout.dtype == lse.dtype == torch.float32):
        raise ValueError("flash_attention_bwd: the CUDA kernel takes "
                         "float32")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), \
        torch.empty_like(v)
    delta = torch.empty((b, h, s), device=dev)          # scratch
    if b and s:
        KERNEL_BWD.launch(dev, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                          out.data_ptr(), dout.data_ptr(), lse.data_ptr(),
                          delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                          dv.data_ptr(), b, s, h, k.shape[2], d,
                          *_options(causal, cap, window))
    return dq, dk, dv
