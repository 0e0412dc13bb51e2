"""Mixture-of-Experts FFN on one device.

Counterpart of ``repro/models/moe.py``'s single-device path
(``apply_moe`` with no mesh), in the activations' dtype: an fp32 router with top-k routing,
renormalised weights and the Switch load-balance + z-loss aux; each expert
takes at most ``C = int(ceil(k·T / E)·capacity_factor) + 1`` of the T
tokens of the call, assigned in the order of the flat (token, k) list, and
the overflow is dropped; the expert SwiGLU runs as batched matmuls over a
(E, C, d) dispatch buffer; shared experts add a dense SwiGLU path.

Every row of the call competes for capacity: a serving prefill's bucket
padding and a decode tick's free slots are routed as the reference routes
them.  The combine gathers each token's k expert outputs and adds them in
k order, where the reference scatter-adds them: no atomics, so a token's
output does not depend on the order of other writes.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.common.config import MoEConfig
from repro_torch.common.utils import ceil_div
from repro_torch.models.layers import cast_matmul
from repro_torch.models.param import ParamSpec


def moe_spec(d_model: int, moe: MoEConfig) -> Dict[str, ParamSpec]:
    e, f = moe.n_experts, moe.d_ff_expert
    spec = {
        "router": ParamSpec((d_model, e), "small", axes=(None, None)),
        "w_in": ParamSpec((e, d_model, f),
                          axes=("experts", "expert_fsdp", "expert_ff")),
        "w_gate": ParamSpec((e, d_model, f),
                            axes=("experts", "expert_fsdp", "expert_ff")),
        "w_out": ParamSpec((e, f, d_model),
                           axes=("experts", "expert_ff", "expert_fsdp")),
    }
    if moe.n_shared_experts:
        fs = f * moe.n_shared_experts
        spec["shared_in"] = ParamSpec((d_model, fs), axes=("fsdp", "mlp"))
        spec["shared_gate"] = ParamSpec((d_model, fs), axes=("fsdp", "mlp"))
        spec["shared_out"] = ParamSpec((fs, d_model), axes=("mlp", "fsdp"))
    return spec


def _route(router_w: torch.Tensor, x2d: torch.Tensor, moe: MoEConfig
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-k routing.  x2d (T, d) -> (idx (T, k), weights (T, k), aux
    loss scalar)."""
    logits = x2d.to(torch.float32) @ router_w.to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    weights, idx = torch.topk(probs, moe.top_k, dim=-1)
    weights = weights / torch.clamp_min(weights.sum(-1, keepdim=True), 1e-9)
    # load-balance aux loss (Switch): E * sum(frac_tokens * frac_probs),
    # the top-1 choice as the load
    e = logits.shape[-1]
    frac_tokens = F.one_hot(idx[:, 0], e).to(torch.float32).mean(0)
    frac_probs = probs.mean(0)
    aux = moe.aux_loss_coef * e * torch.sum(frac_tokens * frac_probs)
    z = moe.router_z_coef * torch.mean(
        torch.square(torch.logsumexp(logits, dim=-1)))
    return idx, weights, aux + z


def capacity(moe: MoEConfig, n_tokens: int) -> int:
    """Slots per expert for a call of ``n_tokens`` tokens."""
    cap = max(1, ceil_div(moe.top_k * n_tokens, moe.n_experts))
    return int(cap * moe.capacity_factor) + 1


def dispatch_slots(idx: torch.Tensor, n_experts: int, cap: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(slot (T·k,), keep (T·k,)) of the flat (token, k) assignments: an
    assignment is its expert's n-th in the flat order (token-major); the
    first ``cap`` of each expert keep slots ``expert·cap + n``, the rest
    are dropped (slot ``E·cap``, the overflow row)."""
    flat_e = idx.reshape(-1)
    onehot = F.one_hot(flat_e, n_experts)                   # (T·k, E)
    pos = torch.cumsum(onehot, dim=0).gather(1, flat_e[:, None])[:, 0] - 1
    keep = pos < cap
    slot = torch.where(keep, flat_e * cap + pos,
                       torch.full_like(pos, n_experts * cap))
    return slot, keep


def _expert_ffn(w_in: torch.Tensor, w_gate: torch.Tensor,
                w_out: torch.Tensor, xb: torch.Tensor) -> torch.Tensor:
    """xb (E, C, d) -> (E, C, d): each expert's SwiGLU on its slots, the
    weights cast to xb's dtype."""
    h = cast_matmul(xb, w_in, torch.bmm)
    g = cast_matmul(xb, w_gate, torch.bmm)
    return cast_matmul(F.silu(h) * g, w_out, torch.bmm)


def apply_moe(params: Dict[str, Any], x: torch.Tensor, moe: MoEConfig
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> (y (B, S, d), aux loss scalar)."""
    b, s, d = x.shape
    e, k, t = moe.n_experts, moe.top_k, b * s
    x2d = x.reshape(t, d)
    cap = capacity(moe, t)
    idx, weights, aux = _route(params["router"], x2d, moe)
    slot, keep = dispatch_slots(idx, e, cap)
    flat_tok = torch.arange(t, device=x.device).repeat_interleave(k)
    # each kept assignment writes its own slot, so no two writes meet
    # there; the dropped ones all write the overflow row, which is cut off
    # (no index depends on how many are kept: shapes alone decide, as the
    # dry run's meta tensors need)
    buf = x2d.new_zeros((e * cap + 1, d)).index_put(
        (slot,), x2d[flat_tok])[:e * cap]
    yb = _expert_ffn(params["w_in"], params["w_gate"], params["w_out"],
                     buf.reshape(e, cap, d)).reshape(e * cap, d)
    yb = torch.cat([yb, yb.new_zeros((1, d))], dim=0)
    coef = weights.reshape(-1) * keep.to(weights.dtype)
    contrib = (yb[slot] * coef[:, None].to(yb.dtype)).reshape(t, k, d)
    y = contrib[:, 0]
    for i in range(1, k):
        y = y + contrib[:, i]
    y = y.reshape(b, s, d)
    if moe.n_shared_experts:
        h = cast_matmul(x, params["shared_in"])
        g = cast_matmul(x, params["shared_gate"])
        y = y + cast_matmul(F.silu(h) * g, params["shared_out"])
    return y, aux
