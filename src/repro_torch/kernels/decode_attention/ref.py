"""Plain PyTorch version of decode attention, in the kernel layout and in
the model layout."""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         kv_len: torch.Tensor, *,
                         cap: Optional[float] = None,
                         window: Optional[int] = None) -> torch.Tensor:
    """q (B, Hk, G, D), k/v (B, S, Hk, D), kv_len (B, 1) -> (B, Hk, G, D).

    Key ``kpos`` is visible when ``kpos < kv_len`` and, with a window,
    ``kpos > kv_len - 1 - window``."""
    b, hk, g, d = q.shape
    s = k.shape[1]
    scale = 1.0 / math.sqrt(d)
    logits = torch.einsum("bhgd,bshd->bhgs", q.to(torch.float32),
                          k.to(torch.float32)) * scale
    if cap is not None:
        logits = cap * torch.tanh(logits / cap)
    kpos = torch.arange(s, device=q.device)[None, :]
    kv_len = kv_len.to(q.device)
    mask = kpos < kv_len                                   # (B, S)
    if window is not None:
        mask &= kpos > kv_len - 1 - window
    logits = torch.where(mask[:, None, None, :], logits,
                         torch.full_like(logits, NEG_INF))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgs,bshd->bhgd", probs, v.to(torch.float32))
    return out.to(q.dtype)


def decode_attention_plain(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, kv_len: torch.Tensor, *,
                           cap: Optional[float] = None,
                           window: Optional[int] = None) -> torch.Tensor:
    """``decode_attention_ref`` in model layout: q (B, 1, H, D) ->
    (B, 1, H, D), query head ``hk*G + g`` on kv head ``hk``."""
    b, _, h, d = q.shape
    hk = k.shape[2]
    out = decode_attention_ref(q[:, 0].reshape(b, hk, h // hk, d), k, v,
                               kv_len, cap=cap, window=window)
    return out.reshape(b, 1, h, d)
