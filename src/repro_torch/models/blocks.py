"""Pre-norm residual decoder blocks and their stacked periods.

Counterpart of ``repro/models/blocks.py`` for ``block_pattern =
("attn+dense",)``.  A *period* is one repetition of the pattern; every
weight of the stack keeps its leading per-period axis, as the reference's
scanned stack does, and ``apply_stack`` loops over that axis.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.common.config import ArchConfig
from repro_torch.models.attention import attend_prefill
from repro_torch.models.layers import apply_mlp, apply_norm
from repro_torch.models.param import ParamSpec, stack

SUPPORTED = ("attn+dense",)


def _check(cfg: ArchConfig) -> None:
    if tuple(cfg.block_pattern) != SUPPORTED or cfg.norm != "rmsnorm" \
            or not cfg.mlp_gated:
        raise NotImplementedError(
            f"{cfg.name}: the port runs gated rmsnorm {SUPPORTED} stacks "
            f"only, got {cfg.block_pattern} / {cfg.norm}")


def block_spec(cfg: ArchConfig) -> Dict[str, Any]:
    _check(cfg)
    d, att = cfg.d_model, cfg.attention
    return {
        "pre_norm": {"scale": ParamSpec((d,), "ones")},
        "mixer": {
            "wq": ParamSpec((d, att.n_heads, att.head_dim)),
            "wk": ParamSpec((d, att.n_kv_heads, att.head_dim)),
            "wv": ParamSpec((d, att.n_kv_heads, att.head_dim)),
            "wo": ParamSpec((att.n_heads, att.head_dim, d)),
        },
        "pre_mlp_norm": {"scale": ParamSpec((d,), "ones")},
        "mlp": {
            "w_in": ParamSpec((d, cfg.d_ff)),
            "w_out": ParamSpec((cfg.d_ff, d)),
            "w_gate": ParamSpec((d, cfg.d_ff)),
        },
    }


def stack_spec(cfg: ArchConfig) -> Dict[str, Any]:
    return stack({"i0": block_spec(cfg)}, cfg.n_periods)


def apply_block(cfg: ArchConfig, params: Dict[str, Any], x: torch.Tensor,
                positions: torch.Tensor) -> torch.Tensor:
    """One pre-norm residual block: x + attn(norm(x)), then + mlp(norm)."""
    h = apply_norm(params["pre_norm"]["scale"], x)
    x = x + attend_prefill(params["mixer"], cfg.attention, h, positions)
    h = apply_norm(params["pre_mlp_norm"]["scale"], x)
    mlp = params["mlp"]
    return x + apply_mlp(mlp["w_in"], mlp["w_gate"], mlp["w_out"], h)


def _period(tree: Any, i: int) -> Any:
    if isinstance(tree, dict):
        return {k: _period(v, i) for k, v in tree.items()}
    return tree[i]


def apply_stack(cfg: ArchConfig, stacked: Dict[str, Any], x: torch.Tensor,
                positions: torch.Tensor) -> torch.Tensor:
    """Run every period of the stacked weights in order."""
    _check(cfg)
    n = stacked["i0"]["pre_norm"]["scale"].shape[0]
    for i in range(n):
        x = apply_block(cfg, _period(stacked, i)["i0"], x, positions)
    return x
