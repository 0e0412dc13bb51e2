"""Public decode-attention op: model layout in, the input's device picks
kernel or plain version."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels._build import plain_device
from repro_torch.kernels.decode_attention.kernel import decode_attention_cuda
from repro_torch.kernels.decode_attention.ref import decode_attention_plain


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     kv_len: torch.Tensor, *, cap: Optional[float] = None,
                     window: Optional[int] = None) -> torch.Tensor:
    """Model layout: q (B, 1, H, D), k/v (B, S, Hk, D), kv_len (B, 1) int32
    -> (B, 1, H, D).  Query head ``hk*G + g`` reads kv head ``hk``."""
    if not plain_device(q):
        return decode_attention_cuda(q, k, v, kv_len, cap=cap, window=window)
    return decode_attention_plain(q, k, v, kv_len, cap=cap, window=window)
