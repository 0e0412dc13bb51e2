"""Plain PyTorch version of flash attention, in the kernel layout and in
the model layout."""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, cap: Optional[float] = None,
                        window: Optional[int] = None) -> torch.Tensor:
    """q (B, Hk, G, S, D); k, v (B, Hk, S, D) -> (B, Hk, G, S, D)."""
    b, hk, g, s, d = q.shape
    scale = 1.0 / math.sqrt(d)
    logits = torch.einsum("bhgsd,bhtd->bhgst", q.to(torch.float32),
                          k.to(torch.float32)) * scale
    if cap is not None:
        logits = cap * torch.tanh(logits / cap)
    qpos = torch.arange(s, device=q.device)[:, None]
    kpos = torch.arange(s, device=q.device)[None, :]
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgst,bhtd->bhgsd", probs, v.to(torch.float32))
    return out.to(q.dtype)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, cap: Optional[float] = None,
                          window: Optional[int] = None) -> torch.Tensor:
    """``flash_attention_ref`` in model layout: q (B, S, H, D), k/v
    (B, S, Hk, D) -> (B, S, H, D), query head ``hk*G + g`` on kv head
    ``hk``."""
    b, s, h, d = q.shape
    hk = k.shape[2]
    qg = q.permute(0, 2, 1, 3).reshape(b, hk, h // hk, s, d)
    out = flash_attention_ref(qg, k.permute(0, 2, 1, 3),
                              v.permute(0, 2, 1, 3), causal=causal, cap=cap,
                              window=window)
    return out.reshape(b, h, s, d).permute(0, 2, 1, 3)
