"""Architecture configuration: the subset the stream MLLM reads.

Counterpart of ``repro/common/config.py``.  Only ``ArchConfig`` and
``AttentionConfig`` are ported, with the fields the streaming MLLM backbone
uses; the LM zoo's MoE/SSM/shape-cell configuration waits for its slice.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class AttentionConfig:
    n_heads: int
    n_kv_heads: int
    head_dim: int
    rope_theta: float = 10000.0
    rotary_pct: float = 1.0
    softcap: Optional[float] = None  # attention logit soft-capping


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str
    n_layers: int
    d_model: int
    d_ff: int
    vocab_size: int
    attention: Optional[AttentionConfig] = None
    block_pattern: Tuple[str, ...] = ("attn+dense",)
    norm: str = "rmsnorm"
    frontend: Optional[str] = None   # "patch" for the stream MLLM
    mlp_gated: bool = True
    remat: bool = True
    notes: str = ""

    @property
    def n_periods(self) -> int:
        assert self.n_layers % len(self.block_pattern) == 0, (
            f"{self.name}: n_layers={self.n_layers} not divisible by "
            f"pattern length {len(self.block_pattern)}"
        )
        return self.n_layers // len(self.block_pattern)
