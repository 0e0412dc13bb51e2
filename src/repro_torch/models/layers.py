"""Core layers: norms, rotary embeddings, MLPs, embeddings, soft-capping.

Counterpart of ``repro/models/layers.py``.  Plain functions on tensors;
weights are passed explicitly and keep the reference's (in, out) storage.
The activations' dtype is the compute dtype: a matmul weight is cast to it
where it is used (``cast_matmul``: ``x @ w.to(x.dtype)``, the cast a no-op
when they agree), as the reference's ``w.astype(dtype)``; norms, rotary
angles and the cross-entropy compute in fp32 and return the input's dtype.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from repro_torch.models.param import ParamSpec


# --------------------------------------------------------------------------
# Normalization
# --------------------------------------------------------------------------

def norm_spec(d: int, kind: str) -> Dict[str, ParamSpec]:
    if kind == "layernorm":
        return {"scale": ParamSpec((d,), "ones", axes=("embed",)),
                "bias": ParamSpec((d,), "zeros", axes=("embed",))}
    return {"scale": ParamSpec((d,), "ones", axes=("embed",))}


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
    spec = {"w_in": ParamSpec((d_model, d_ff), axes=("fsdp", "mlp")),
            "w_out": ParamSpec((d_ff, d_model), axes=("mlp", "fsdp"))}
    if gated:
        spec["w_gate"] = ParamSpec((d_model, d_ff), axes=("fsdp", "mlp"))
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


class _CastMatmul(torch.autograd.Function):
    """``x @ w.to(x.dtype)`` whose graph saves the weight ``w`` (a
    parameter or a view of one, held anyway) and casts it again in the
    backward.  Under plain autograd the product would save the cast copy
    for the backward: at bf16 a second copy of every weight, 2 bytes a
    value, from its use to the end of the backward (chatglm3-6b's bf16
    training peak fell from 76.43 to 65.10 GB without it, on an H100).
    x (..., K) with w (K, N) is folded to (rows, K) as ``torch.matmul``
    folds it; x (E, C, K) with w (E, K, N) is a ``bmm``.  The backward
    takes the products autograd's ``mm`` and ``bmm`` take (for a
    column-major operand too), so the gradients keep their bits."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        wc = w.to(x.dtype)
        if w.dim() == 3:
            return torch.bmm(x, wc)
        return x.reshape(-1, wc.shape[0]).mm(wc).view(
            *x.shape[:-1], wc.shape[1])

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        wc = w.to(x.dtype)
        gx = gw = None
        if w.dim() == 3:
            if ctx.needs_input_grad[0]:
                gx = g.bmm(wc.transpose(1, 2))
            if ctx.needs_input_grad[1]:
                gw = x.transpose(1, 2).bmm(g).to(w.dtype)
            return gx, gw
        x2 = x.reshape(-1, wc.shape[0])
        g2 = g.reshape(-1, wc.shape[1])
        if ctx.needs_input_grad[0]:
            gx = (wc.mm(g2.t()).t() if _column_major(x2)
                  else g2.mm(wc.t())).view(x.shape)
        if ctx.needs_input_grad[1]:
            gw = (g2.t().mm(x2).t() if _column_major(wc)
                  else x2.t().mm(g2)).to(w.dtype)
        return gx, gw


def _column_major(m: torch.Tensor) -> bool:
    return m.stride(0) == 1 and m.stride(1) == m.shape[0]


def cast_matmul(x: torch.Tensor, w: torch.Tensor,
                mm=torch.matmul) -> torch.Tensor:
    """``mm(x, w.to(x.dtype))`` for x (..., K) and w (K, N) (or x (E, C, K)
    and w (E, K, N) with ``mm=torch.bmm``).  Where that casts a weight
    that autograd differentiates, the product is ``_CastMatmul``'s, whose
    graph holds no cast copy of w."""
    if w.dtype == x.dtype or mm not in (torch.matmul, torch.bmm) or \
            not (torch.is_grad_enabled() and w.requires_grad):
        return mm(x, w.to(x.dtype))
    return _CastMatmul.apply(x, w)


def apply_mlp(w_in: torch.Tensor, w_gate: Optional[torch.Tensor],
              w_out: torch.Tensor, x: torch.Tensor,
              act: str = "silu", mm=torch.matmul) -> torch.Tensor:
    """``(act(x·w_in) * (x·w_gate))·w_out``, the activation on ``w_in``;
    ungated when ``w_gate`` is None.  ``act="gelu"`` is the tanh
    approximation, as ``jax.nn.gelu``'s default.  Weights are (in, out),
    cast to x's dtype; ``mm`` computes each product (``frame_matmul`` for
    the stream MLLM)."""
    h = cast_matmul(x, w_in, mm)
    h = F.gelu(h, approximate="tanh") if act == "gelu" else F.silu(h)
    if w_gate is not None:
        h = h * cast_matmul(x, w_gate, mm)
    return cast_matmul(h, w_out, mm)


# --------------------------------------------------------------------------
# Embedding / unembedding
# --------------------------------------------------------------------------

def embed_spec(vocab: int, d_model: int,
               tie: bool = True) -> Dict[str, ParamSpec]:
    """The token table, tied to the unembedding, or with an unembedding
    (d_model, vocab) of its own."""
    spec = {"table": ParamSpec((vocab, d_model), "small",
                               axes=("vocab", "fsdp"))}
    if not tie:
        spec["unembed"] = ParamSpec((d_model, vocab), axes=("fsdp", "vocab"))
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
        return softcap(cast_matmul(x, params["unembed"]), final_cap)
    return softcap(cast_matmul(x, params["table"].t()), final_cap)


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
