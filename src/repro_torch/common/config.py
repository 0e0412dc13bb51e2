"""Architecture configuration: the fields the port's models read.

Counterpart of ``repro/common/config.py``.  ``ArchConfig``,
``AttentionConfig``, ``MoEConfig``, ``SSMConfig`` and ``BlockSpecEntry``
are ported with the fields the stream MLLM and the LMs (dense attention,
Mamba2 and MoE stacks, an encoder with cross attention, stub frontends)
use, and the assigned shape cells (``ShapeCell``, ``SHAPE_CELLS``,
``applicable_cells``) that the dry run (``launch/dryrun.py``) runs.

Block kind strings are ``"<mixer>+<mlp>"``:
  mixer: ``attn`` | ``attn_local`` | ``attn_global`` | ``mamba``
  mlp:   ``dense`` | ``moe`` | ``none``
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

from repro_torch.common.utils import pad_to_multiple

VOCAB_PAD = 256  # the embedding table's rows are padded to a multiple of this


@dataclass(frozen=True)
class AttentionConfig:
    n_heads: int
    n_kv_heads: int
    head_dim: int
    rope_theta: float = 10000.0
    rotary_pct: float = 1.0
    qk_norm: bool = False            # RMSNorm on q and k per head
    softcap: Optional[float] = None  # attention logit soft-capping
    window: Optional[int] = None     # sliding-window size for attn_local


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared_experts: int = 0
    capacity_factor: float = 1.25
    router_z_coef: float = 1e-3
    aux_loss_coef: float = 1e-2


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    d_conv: int = 4
    head_dim: int = 64
    expand: int = 2
    n_groups: int = 1
    chunk: int = 256


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str
    n_layers: int
    d_model: int
    d_ff: int
    vocab_size: int
    attention: Optional[AttentionConfig] = None
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    block_pattern: Tuple[str, ...] = ("attn+dense",)
    n_encoder_layers: int = 0
    encoder_decoder: bool = False
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    post_block_norm: bool = False    # sandwich norms (gemma2)
    embed_scale: bool = False        # embeddings scaled by sqrt(d_model)
    final_softcap: Optional[float] = None
    tie_embeddings: bool = True
    frontend: Optional[str] = None   # "patch" | "audio": stub embeddings
    sub_quadratic: bool = False      # eligible for long_500k
    mlp_gated: bool = True
    grad_accum: int = 1              # micro-batches a dry-run train step
    remat: bool = True
    notes: str = ""

    @property
    def padded_vocab(self) -> int:
        return pad_to_multiple(self.vocab_size, VOCAB_PAD)

    @property
    def n_periods(self) -> int:
        assert self.n_layers % len(self.block_pattern) == 0, (
            f"{self.name}: n_layers={self.n_layers} not divisible by "
            f"pattern length {len(self.block_pattern)}"
        )
        return self.n_layers // len(self.block_pattern)

    @property
    def has_attention(self) -> bool:
        return any(BlockSpecEntry.parse(k).mixer.startswith("attn")
                   for k in self.block_pattern)

    @property
    def has_mamba(self) -> bool:
        return any(BlockSpecEntry.parse(k).mixer == "mamba"
                   for k in self.block_pattern)

    @property
    def has_moe(self) -> bool:
        return any(BlockSpecEntry.parse(k).mlp == "moe"
                   for k in self.block_pattern)

    def n_params_dense_equiv(self) -> int:
        """Parameter count N (all parameters)."""
        from repro_torch.models.model import param_count_estimate

        return param_count_estimate(self)

    def n_params_active(self) -> int:
        """Parameters a token uses (an MoE layer's top-k experts only)."""
        from repro_torch.models.model import param_count_estimate

        return param_count_estimate(self, active_only=True)

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class BlockSpecEntry:
    """One entry of a block pattern, parsed."""

    mixer: str
    mlp: str

    @staticmethod
    def parse(kind: str) -> "BlockSpecEntry":
        mixer, mlp = kind.split("+")
        return BlockSpecEntry(mixer, mlp)


@dataclass(frozen=True)
class ShapeCell:
    """One assigned (input-shape) cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


SHAPE_CELLS: Dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}


def applicable_cells(cfg: ArchConfig) -> Tuple[str, ...]:
    """The shape cells this architecture runs: ``long_500k`` only where
    attention is not quadratic (the SSM and hybrid archs)."""
    cells = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.sub_quadratic:
        cells.append("long_500k")
    return tuple(cells)
