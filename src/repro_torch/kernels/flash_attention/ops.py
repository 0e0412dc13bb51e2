"""Public flash-attention op: model layout in, the input's device picks
kernel or plain version, and autograd picks forward or forward + backward
kernels."""
from __future__ import annotations

from typing import Optional

import torch
from torch.autograd.function import once_differentiable

from repro_torch.kernels._build import plain_device
from repro_torch.kernels.flash_attention.kernel import (
    flash_attention_bwd_cuda, flash_attention_cuda)
from repro_torch.kernels.flash_attention.ref import flash_attention_plain


class FlashAttentionFn(torch.autograd.Function):
    """The CUDA forward (with each row's log-sum-exp) and its hand-written
    backward (``csrc/flash_attention_bwd.cu``) as one autograd node: the
    fp32 pair or, on bf16 inputs, the bf16 pair (``flash_attention_lse_bf16``,
    ``flash_attention_bwd_bf16``)."""

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
    log-sum-exp, then the backward kernel), in fp32 or bf16 (q, k and v of
    one dtype: the bf16 pair keeps fp32 sums and the fp32 lse)."""
    if plain_device(q):
        return flash_attention_plain(q, k, v, causal=causal, cap=cap,
                                     window=window)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttentionFn.apply(q, k, v, causal, cap, window)
    return flash_attention_cuda(q, k, v, causal=causal, cap=cap,
                                window=window)
