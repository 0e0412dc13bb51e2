"""Public flash-attention op: model layout in, the input's device picks
kernel or plain version."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
from repro_torch.kernels.flash_attention.ref import flash_attention_plain


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, cap: Optional[float] = None,
                    window: Optional[int] = None) -> torch.Tensor:
    """Model layout: q (B, S, H, D); k, v (B, S, Hk, D) -> (B, S, H, D).

    GQA: query heads ``hk*G .. hk*G+G-1`` share kv head ``hk``."""
    if q.device.type != "cpu":
        return flash_attention_cuda(q, k, v, causal=causal, cap=cap,
                                    window=window)
    return flash_attention_plain(q, k, v, causal=causal, cap=cap,
                                 window=window)
