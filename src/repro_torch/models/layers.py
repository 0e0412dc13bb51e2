"""Core layers: norms, rotary embeddings, MLPs, embeddings, soft-capping.

Counterpart of ``repro/models/layers.py``.  Plain functions on tensors;
weights are passed explicitly and keep the reference's (in, out) storage.
The activations' dtype is the compute dtype: a matmul weight is cast to it
where it is used (``w.to(x.dtype)``, a no-op when they agree), as the
reference's ``w.astype(dtype)``; norms, rotary angles and the
cross-entropy compute in fp32 and return the input's dtype.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.param import ParamSpec


# --------------------------------------------------------------------------
# Normalization
# --------------------------------------------------------------------------

def norm_spec(d: int, kind: str) -> Dict[str, ParamSpec]:
    if kind == "layernorm":
        return {"scale": ParamSpec((d,), "ones"),
                "bias": ParamSpec((d,), "zeros")}
    return {"scale": ParamSpec((d,), "ones")}


def apply_norm(scale: torch.Tensor, x: torch.Tensor, eps: float = 1e-6,
               *, kind: str = "rmsnorm",
               bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """RMSNorm (or LayerNorm with ``bias``) in fp32 (float64 for float64
    inputs), cast back to the input's dtype."""
    dt = torch.promote_types(x.dtype, torch.float32)
    xf = x.to(dt)
    if kind == "layernorm":
        mu = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
        y = y * scale.to(dt) + bias.to(dt)
    else:
        ms = torch.mean(torch.square(xf), dim=-1, keepdim=True)
        y = xf * torch.rsqrt(ms + eps) * scale.to(dt)
    return y.to(x.dtype)


def norm(params: Dict[str, torch.Tensor], x: torch.Tensor,
         kind: str) -> torch.Tensor:
    """``apply_norm`` from a ``norm_spec`` parameter dict."""
    return apply_norm(params["scale"], x, kind=kind, bias=params.get("bias"))


def rms_norm_simple(x: torch.Tensor, scale: torch.Tensor,
                    eps: float = 1e-6) -> torch.Tensor:
    """Scale-only RMSNorm over the last dim (qk-norm, the Mamba2 gate)."""
    return apply_norm(scale, x, eps)


# --------------------------------------------------------------------------
# Rotary position embeddings
# --------------------------------------------------------------------------

def rope_freqs(head_dim: int, rotary_pct: float, theta: float,
               device=None, dtype=torch.float32) -> torch.Tensor:
    rot_dim = int(head_dim * rotary_pct)
    rot_dim -= rot_dim % 2
    exponent = torch.arange(0, rot_dim, 2, dtype=dtype,
                            device=device) / rot_dim
    return 1.0 / (theta ** exponent)  # (rot_dim/2,)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, rotary_pct: float,
               theta: float) -> torch.Tensor:
    """x (..., S, H, D); positions broadcastable to (..., S).  Half-split
    rotation (not interleaved) of the first ``rotary_pct`` of D; the angles
    in fp32 (float64 for float64 inputs)."""
    head_dim = x.shape[-1]
    rot_dim = int(head_dim * rotary_pct)
    rot_dim -= rot_dim % 2
    if rot_dim == 0:
        return x
    dt = torch.promote_types(x.dtype, torch.float32)
    inv = rope_freqs(head_dim, rotary_pct, theta, device=x.device, dtype=dt)
    ang = positions[..., None].to(dt) * inv             # (..., S, rot/2)
    cos = torch.cos(ang)[..., None, :]                  # (..., S, 1, rot/2)
    sin = torch.sin(ang)[..., None, :]
    x_rot, x_pass = x[..., :rot_dim], x[..., rot_dim:]
    x1, x2 = x_rot[..., :rot_dim // 2], x_rot[..., rot_dim // 2:]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1, y2, x_pass], dim=-1).to(x.dtype)


# --------------------------------------------------------------------------
# Soft-capping (gemma2)
# --------------------------------------------------------------------------

def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


# --------------------------------------------------------------------------
# MLP (SwiGLU / GeGLU, or ungated)
# --------------------------------------------------------------------------

def mlp_spec(d_model: int, d_ff: int,
             gated: bool = True) -> Dict[str, ParamSpec]:
    spec = {"w_in": ParamSpec((d_model, d_ff)),
            "w_out": ParamSpec((d_ff, d_model))}
    if gated:
        spec["w_gate"] = ParamSpec((d_model, d_ff))
    return spec


def frame_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` for x (B, S, K) and w (K, N), as one batched GEMM of B
    products of S rows each.  A plain ``x @ w`` is one GEMM of B·S rows,
    whose algorithm cuBLAS picks by the row count (split-K among them), so
    a row's sums would depend on how many frames share the call; here each
    frame's product has the same shape whatever B is (on the H100, rows
    of 4-32 frames equal their rows in a 64-frame call, where the plain
    GEMM moved them by up to 1.7e-4).  The stream MLLM uses it, so a frame
    coalesced by the extract server gets its solo logits bit for bit.

    bf16 products: cuBLAS may reduce a split-K GEMM's partial sums in bf16
    when ``torch.backends.cuda.matmul.allow_bf16_reduced_precision_
    reduction`` is True (PyTorch's default); the reference accumulates in
    fp32, so the port turns it off wherever it computes in bf16
    (``models/model.py::bf16_matmul_fp32_sums``)."""
    return torch.bmm(x, w.expand(x.shape[0], *w.shape))


def apply_mlp(w_in: torch.Tensor, w_gate: Optional[torch.Tensor],
              w_out: torch.Tensor, x: torch.Tensor,
              act: str = "silu", mm=torch.matmul) -> torch.Tensor:
    """``(act(x·w_in) * (x·w_gate))·w_out``, the activation on ``w_in``;
    ungated when ``w_gate`` is None.  ``act="gelu"`` is the tanh
    approximation, as ``jax.nn.gelu``'s default.  Weights are (in, out),
    cast to x's dtype; ``mm`` computes each product (``frame_matmul`` for
    the stream MLLM)."""
    dt = x.dtype
    h = mm(x, w_in.to(dt))
    h = F.gelu(h, approximate="tanh") if act == "gelu" else F.silu(h)
    if w_gate is not None:
        h = h * mm(x, w_gate.to(dt))
    return mm(h, w_out.to(dt))


# --------------------------------------------------------------------------
# Embedding / unembedding
# --------------------------------------------------------------------------

def embed_spec(vocab: int, d_model: int,
               tie: bool = True) -> Dict[str, ParamSpec]:
    """The token table, tied to the unembedding, or with an unembedding
    (d_model, vocab) of its own."""
    spec = {"table": ParamSpec((vocab, d_model), "small")}
    if not tie:
        spec["unembed"] = ParamSpec((d_model, vocab))
    return spec


def embed_tokens(params: Dict[str, Any], tokens: torch.Tensor,
                 scale: Optional[float] = None,
                 dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """tokens (B, S) int -> (B, S, d) in ``dtype`` (default the table's),
    times ``scale`` rounded to that dtype when given, as the reference's
    ``take(table.astype(dtype))`` and ``x * asarray(scale, dtype)``.  The
    table is cast before the gather (a no-op where it is already in
    ``dtype``), so a cast step's gradient reaches it as the reference's."""
    table = params["table"]
    x = (table if dtype is None else table.to(dtype))[tokens]
    if scale is not None:
        x = x * torch.tensor(scale, dtype=x.dtype).item()
    return x


def unembed(params: Dict[str, Any], x: torch.Tensor,
            final_cap: Optional[float] = None) -> torch.Tensor:
    """x (B, S, d) -> logits (B, S, V) in x's dtype over the padded vocab,
    through the unembedding where there is one, else the tied table."""
    if "unembed" in params:
        return softcap(x @ params["unembed"].to(x.dtype), final_cap)
    return softcap(x @ params["table"].to(x.dtype).t(), final_cap)


# --------------------------------------------------------------------------
# Cross-entropy with z-loss
# --------------------------------------------------------------------------

def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  z_coef: float = 1e-4) -> Tuple[torch.Tensor, torch.Tensor]:
    """logits (B, S, V), labels (B, S) int -> (mean nll, mean z-loss), in
    fp32 (float64 for float64 logits); the label's logit is picked by
    index (the reference's take-along-axis path)."""
    logits = logits.to(torch.promote_types(logits.dtype, torch.float32))
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = lse - ll
    zl = z_coef * torch.square(lse)
    return nll.mean(), zl.mean()
