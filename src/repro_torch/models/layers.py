"""Core layers: RMSNorm, rotary embeddings, gated MLP.

Counterpart of ``repro/models/layers.py`` (the subset the stream MLLM
calls).  Plain functions on tensors; weights are passed explicitly and keep
the reference's (in, out) storage.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def apply_norm(scale: torch.Tensor, x: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm in fp32, cast back to the input's dtype."""
    x32 = x.to(torch.float32)
    ms = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(ms + eps) * scale.to(torch.float32)
    return y.to(x.dtype)


def rope_freqs(head_dim: int, rotary_pct: float, theta: float,
               device=None) -> torch.Tensor:
    rot_dim = int(head_dim * rotary_pct)
    rot_dim -= rot_dim % 2
    exponent = torch.arange(0, rot_dim, 2, dtype=torch.float32,
                            device=device) / rot_dim
    return 1.0 / (theta ** exponent)  # (rot_dim/2,)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, rotary_pct: float,
               theta: float) -> torch.Tensor:
    """x (..., S, H, D); positions broadcastable to (..., S).  Half-split
    rotation (not interleaved) of the first ``rotary_pct`` of D."""
    head_dim = x.shape[-1]
    rot_dim = int(head_dim * rotary_pct)
    rot_dim -= rot_dim % 2
    if rot_dim == 0:
        return x
    inv = rope_freqs(head_dim, rotary_pct, theta, device=x.device)
    ang = positions[..., None].to(torch.float32) * inv  # (..., S, rot/2)
    cos = torch.cos(ang)[..., None, :]                  # (..., S, 1, rot/2)
    sin = torch.sin(ang)[..., None, :]
    x_rot, x_pass = x[..., :rot_dim], x[..., rot_dim:]
    x1, x2 = x_rot[..., :rot_dim // 2], x_rot[..., rot_dim // 2:]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1, y2, x_pass], dim=-1).to(x.dtype)


def apply_mlp(w_in: torch.Tensor, w_gate: torch.Tensor, w_out: torch.Tensor,
              x: torch.Tensor) -> torch.Tensor:
    """Gated SiLU MLP: ``(silu(x·w_in) * (x·w_gate))·w_out``; the
    activation is on ``w_in``.  Weights are (in, out)."""
    return (F.silu(x @ w_in) * (x @ w_gate)) @ w_out
