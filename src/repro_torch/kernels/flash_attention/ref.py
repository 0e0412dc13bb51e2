"""Plain PyTorch version of flash attention, in the kernel layout and in
the model layout, and of the training forward (with each row's
log-sum-exp).  The sums run in fp32 (float64 for float64 inputs, which
measure both fp32 versions); autograd differentiates them.

Keys may outnumber the queries or fall short of them (Sk != Sq: cross
attention to an encoder's output) where every query sees every key:
``causal=False`` and no window, as ``chunked_bidir_attention`` computes
in the reference; a mask over positions of two sequences of different
lengths has no meaning there and raises ``ValueError``."""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

NEG_INF = -1e30


def check_lengths(name: str, sq: int, sk: int, causal: bool,
                  window: Optional[int]) -> None:
    """Sq != Sk only without a positional mask (the kernels' rule too)."""
    if sq != sk and (causal or window is not None):
        raise ValueError(f"{name}: {sq} queries against {sk} keys take "
                         "causal=False and no window")


def _logits(q: torch.Tensor, k: torch.Tensor, causal: bool,
            cap: Optional[float], window: Optional[int]) -> torch.Tensor:
    """q (B, Hk, G, Sq, D), k (B, Hk, Sk, D) -> masked logits (B, Hk, G,
    Sq, Sk) in fp32 (or float64)."""
    sq, d = q.shape[3], q.shape[4]
    sk = k.shape[2]
    check_lengths("flash_attention", sq, sk, causal, window)
    dt = torch.promote_types(q.dtype, torch.float32)
    logits = torch.einsum("bhgsd,bhtd->bhgst", q.to(dt), k.to(dt)) \
        * (1.0 / math.sqrt(d))
    if cap is not None:
        logits = cap * torch.tanh(logits / cap)
    if not causal and window is None:
        return logits
    qpos = torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    return torch.where(mask, logits, torch.full_like(logits, NEG_INF))


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, cap: Optional[float] = None,
                        window: Optional[int] = None) -> torch.Tensor:
    """q (B, Hk, G, Sq, D); k, v (B, Hk, Sk, D) -> (B, Hk, G, Sq, D)."""
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
    """``flash_attention_ref`` in model layout: q (B, Sq, H, D), k/v
    (B, Sk, Hk, D) -> (B, Sq, H, D), query head ``hk*G + g`` on kv head
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
    (B, H, Sq)."""
    b, s, h, d = q.shape
    qg, kk, vv = _grouped(q, k, v)
    logits = _logits(qg, kk, causal, cap, window)
    lse = torch.logsumexp(logits, dim=-1).reshape(b, h, s)
    out = torch.einsum("bhgst,bhtd->bhgsd", torch.softmax(logits, dim=-1),
                       vv.to(logits.dtype)).to(q.dtype)
    return out.reshape(b, h, s, d).permute(0, 2, 1, 3), lse
