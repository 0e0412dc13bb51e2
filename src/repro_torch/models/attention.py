"""GQA self-attention for prefill (causal), through the flash kernel.

Counterpart of ``repro/models/attention.py`` for the path the stream MLLM
runs: ``_project_qkv``, ``_out_proj`` and ``attend_prefill``.  Head counts
come from the weights (``wq`` (d, H, Dh), ``wk``/``wv`` (d, Hk, Dh), ``wo``
(H, Dh, d)), so a pruned variant with other shapes runs unchanged.  There is
no tensor-parallel head padding: the port runs on one card.  The attention
itself is ``kernels.flash_attention.ops.flash_attention`` in model layout;
the reference computes the same function in plain jnp (``full_attention``).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.common.config import AttentionConfig
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models.layers import apply_rope


def _project_qkv(params: Dict[str, torch.Tensor], xq: torch.Tensor,
                 xkv: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """xq (B, Sq, d), xkv (B, Skv, d) -> q (B,Sq,H,Dh), k/v (B,Skv,Hk,Dh)."""
    def proj(x, w):
        d, h, dh = w.shape
        return (x @ w.reshape(d, h * dh)).reshape(*x.shape[:-1], h, dh)

    return (proj(xq, params["wq"]), proj(xkv, params["wk"]),
            proj(xkv, params["wv"]))


def _out_proj(params: Dict[str, torch.Tensor],
              out: torch.Tensor) -> torch.Tensor:
    """out (B, S, H, Dh) -> (B, S, d)."""
    h, dh, d = params["wo"].shape
    return out.reshape(*out.shape[:-2], h * dh) @ params["wo"].reshape(
        h * dh, d)


def attend_prefill(params: Dict[str, torch.Tensor], att: AttentionConfig,
                   x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """Causal self-attention over a full sequence x (B, S, d)."""
    q, k, v = _project_qkv(params, x, x)
    q = apply_rope(q, positions, att.rotary_pct, att.rope_theta)
    k = apply_rope(k, positions, att.rotary_pct, att.rope_theta)
    out = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                          causal=True, cap=att.softcap)
    return _out_proj(params, out)
