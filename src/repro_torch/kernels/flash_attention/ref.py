"""Plain PyTorch version of flash attention, in the kernel layout and in
the model layout, and of the training forward (with each row's
log-sum-exp).  The sums run in fp32 (float64 for float64 inputs, which
measure both fp32 versions); autograd differentiates them."""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

NEG_INF = -1e30


def _logits(q: torch.Tensor, k: torch.Tensor, causal: bool,
            cap: Optional[float], window: Optional[int]) -> torch.Tensor:
    """q (B, Hk, G, S, D), k (B, Hk, S, D) -> masked logits (B, Hk, G, S,
    S) in fp32 (or float64)."""
    s, d = q.shape[3], q.shape[4]
    dt = torch.promote_types(q.dtype, torch.float32)
    logits = torch.einsum("bhgsd,bhtd->bhgst", q.to(dt), k.to(dt)) \
        * (1.0 / math.sqrt(d))
    if cap is not None:
        logits = cap * torch.tanh(logits / cap)
    qpos = torch.arange(s, device=q.device)[:, None]
    kpos = torch.arange(s, device=q.device)[None, :]
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    return torch.where(mask, logits, torch.full_like(logits, NEG_INF))


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, cap: Optional[float] = None,
                        window: Optional[int] = None) -> torch.Tensor:
    """q (B, Hk, G, S, D); k, v (B, Hk, S, D) -> (B, Hk, G, S, D)."""
    logits = _logits(q, k, causal, cap, window)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgst,bhtd->bhgsd", probs, v.to(logits.dtype))
    return out.to(q.dtype)


def _grouped(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    b, s, h, d = q.shape
    hk = k.shape[2]
    return (q.permute(0, 2, 1, 3).reshape(b, hk, h // hk, s, d),
            k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3))


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, cap: Optional[float] = None,
                          window: Optional[int] = None) -> torch.Tensor:
    """``flash_attention_ref`` in model layout: q (B, S, H, D), k/v
    (B, S, Hk, D) -> (B, S, H, D), query head ``hk*G + g`` on kv head
    ``hk``."""
    b, s, h, d = q.shape
    out = flash_attention_ref(*_grouped(q, k, v), causal=causal, cap=cap,
                              window=window)
    return out.reshape(b, h, s, d).permute(0, 2, 1, 3)


def flash_attention_lse_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, *, causal: bool = True,
                              cap: Optional[float] = None,
                              window: Optional[int] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The training forward's plain version: ``flash_attention_plain``'s
    output and each row's log-sum-exp of its scaled (and capped) logits,
    (B, H, S)."""
    b, s, h, d = q.shape
    qg, kk, vv = _grouped(q, k, v)
    logits = _logits(qg, kk, causal, cap, window)
    lse = torch.logsumexp(logits, dim=-1).reshape(b, h, s)
    out = torch.einsum("bhgst,bhtd->bhgsd", torch.softmax(logits, dim=-1),
                       vv.to(logits.dtype)).to(q.dtype)
    return out.reshape(b, h, s, d).permute(0, 2, 1, 3), lse
