"""Public flash-attention op: model layout in, the input's device picks
kernel or plain version, and autograd picks forward or forward + backward
kernels."""
from __future__ import annotations

from typing import Optional

import torch
from torch.autograd.function import once_differentiable

from repro_torch.kernels.flash_attention.kernel import (
    flash_attention_bwd_cuda, flash_attention_cuda)
from repro_torch.kernels.flash_attention.ref import flash_attention_plain


class FlashAttentionFn(torch.autograd.Function):
    """The CUDA forward (with each row's log-sum-exp) and its hand-written
    backward (``csrc/flash_attention_bwd.cu``) as one autograd node."""

    @staticmethod
    def forward(ctx, q, k, v, causal, cap, window):
        out, lse = flash_attention_cuda(q, k, v, causal=causal, cap=cap,
                                        window=window, lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.options = dict(causal=causal, cap=cap, window=window)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd_cuda(q, k, v, out, lse,
                                              dout.contiguous(),
                                              **ctx.options)
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, cap: Optional[float] = None,
                    window: Optional[int] = None) -> torch.Tensor:
    """Model layout: q (B, Sq, H, D); k, v (B, Sk, Hk, D) -> (B, Sq, H, D).

    GQA: query heads ``hk*G .. hk*G+G-1`` share kv head ``hk``.  Sk may
    differ from Sq (cross attention to an encoder's output) with
    ``causal=False`` and no window; otherwise ``ValueError``.  A CPU
    tensor takes the plain version, which autograd differentiates; a CUDA
    one takes the forward kernel, and, when grad mode is on and an input
    requires grad, ``FlashAttentionFn`` (the forward kernel with its
    log-sum-exp, then the backward kernel).  The backward kernel takes
    fp32: bf16 CUDA inputs that require grad raise ``ValueError``."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, cap=cap,
                                     window=window)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        if torch.float32 != q.dtype or q.dtype != k.dtype \
                or q.dtype != v.dtype:
            raise ValueError(
                f"flash_attention: no bf16 backward kernel yet "
                f"(csrc/flash_attention_bwd.cu takes float32): {q.dtype} "
                "inputs that require grad on the card are refused, not "
                "cast; train in float32 or run under torch.no_grad()")
        return FlashAttentionFn.apply(q, k, v, causal, cap, window)
    return flash_attention_cuda(q, k, v, causal=causal, cap=cap,
                                window=window)
