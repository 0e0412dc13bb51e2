"""Token sampling: greedy / temperature / top-k."""
from __future__ import annotations

from typing import Optional

import torch


def sample_logits(logits: torch.Tensor,
                  generator: Optional[torch.Generator] = None, *,
                  temperature: float = 0.0, top_k: int = 0) -> torch.Tensor:
    """logits (B, V) -> tokens (B,) int32.  Greedy unless a temperature
    and a generator (on the logits' device) are given; ``top_k`` keeps the
    k largest logits.  The random draws are PyTorch's, not ``jax.random``'s:
    only greedy sampling is comparable across the two packages."""
    if temperature <= 0.0 or generator is None:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    logits = logits.to(torch.float32) / temperature
    if top_k > 0:
        cutoff = torch.topk(logits, top_k, dim=-1).values[:, -1:]
        logits = torch.where(logits < cutoff,
                             torch.full_like(logits, -1e30), logits)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(
        torch.int32)
