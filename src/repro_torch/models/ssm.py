"""Mamba2 (SSD, state-space duality) mixer.

Counterpart of ``repro/models/ssm.py`` at ``tp=1`` (no head padding: the
port runs on one card).  The prefills compute the chunked SSD through
``kernels.ssd_scan.ops.ssd``, whose within-chunk terms are the ``ssd_scan``
kernel on CUDA tensors and its plain version on CPU tensors, where the
reference calls its plain jnp ``_ssd_chunked``.  Decode is one recurrent
step on the O(1) state and has no kernel, as in the reference.  The
projections and the conv run in x's dtype (their weights cast to it); dt,
A, the SSD and the state update in fp32, the outputs and the cached state
in x's dtype, as the reference's.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.common.config import SSMConfig
from repro_torch.kernels.ssd_scan.ops import ssd
from repro_torch.models.layers import cast_matmul, rms_norm_simple
from repro_torch.models.param import ParamSpec


def ssm_dims(d_model: int, ssm: SSMConfig) -> Tuple[int, int]:
    """(head count, head count): the reference's (true, tp-padded) pair at
    ``tp=1``."""
    h = d_model * ssm.expand // ssm.head_dim
    return h, h


def mamba_spec(d_model: int, ssm: SSMConfig) -> Dict[str, ParamSpec]:
    h, _ = ssm_dims(d_model, ssm)
    p, n, g, k = ssm.head_dim, ssm.d_state, ssm.n_groups, ssm.d_conv
    return {
        "z_proj": ParamSpec((d_model, h, p), axes=("fsdp", "ssm_heads", None)),
        "x_proj": ParamSpec((d_model, h, p), axes=("fsdp", "ssm_heads", None)),
        "B_proj": ParamSpec((d_model, g, n), axes=("fsdp", None, "ssm_state")),
        "C_proj": ParamSpec((d_model, g, n), axes=("fsdp", None, "ssm_state")),
        "dt_proj": ParamSpec((d_model, h), "small", axes=("fsdp", "ssm_heads")),
        "dt_bias": ParamSpec((h,), "zeros", axes=("ssm_heads",)),
        "A_log": ParamSpec((h,), "zeros", axes=("ssm_heads",)),
        "D": ParamSpec((h,), "ones", axes=("ssm_heads",)),
        "conv_w_x": ParamSpec((h, p, k), "small",
                              axes=("ssm_heads", None, "conv")),
        "conv_b_x": ParamSpec((h, p), "zeros", axes=("ssm_heads", None)),
        "conv_w_B": ParamSpec((g, n, k), "small",
                              axes=(None, "ssm_state", "conv")),
        "conv_b_B": ParamSpec((g, n), "zeros", axes=(None, "ssm_state")),
        "conv_w_C": ParamSpec((g, n, k), "small",
                              axes=(None, "ssm_state", "conv")),
        "conv_b_C": ParamSpec((g, n), "zeros", axes=(None, "ssm_state")),
        "norm_scale": ParamSpec((h, p), "ones", axes=("ssm_heads", None)),
        "out_proj": ParamSpec((h, p, d_model),
                              axes=("ssm_heads", None, "fsdp")),
    }


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (..., d) times w (d, *out) cast to x's dtype -> (..., *out)."""
    return cast_matmul(x, w.reshape(w.shape[0], -1)).reshape(
        *x.shape[:-1], *w.shape[1:])


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv as K shifted adds.
    x (B, L, C1, C2), w (C1, C2, K), b (C1, C2)."""
    k, length = w.shape[-1], x.shape[1]
    out = torch.zeros_like(x)
    for i in range(k):
        shift = k - 1 - i
        xi = x if shift == 0 else F.pad(x, (0, 0, 0, 0, shift, 0))[:, :length]
        out = out + xi * w[..., i]
    return out + b


def _project_and_conv(params: Dict[str, torch.Tensor], x: torch.Tensor):
    """Shared projection + conv of the prefills.  x (B, L, d); the conv
    weights and biases cast to x's dtype, as the reference's."""
    dtp = x.dtype
    z = _proj(x, params["z_proj"])
    xs0 = _proj(x, params["x_proj"])
    Bm0 = _proj(x, params["B_proj"])
    Cm0 = _proj(x, params["C_proj"])
    dt = _proj(x, params["dt_proj"])
    xs = F.silu(_causal_conv(xs0, params["conv_w_x"].to(dtp),
                             params["conv_b_x"].to(dtp)))
    Bm = F.silu(_causal_conv(Bm0, params["conv_w_B"].to(dtp),
                             params["conv_b_B"].to(dtp)))
    Cm = F.silu(_causal_conv(Cm0, params["conv_w_C"].to(dtp),
                             params["conv_b_C"].to(dtp)))
    dt = F.softplus(dt.to(torch.float32) + params["dt_bias"].to(torch.float32))
    return z, xs, Bm, Cm, dt, (xs0, Bm0, Cm0)


def _chunk(ssm: SSMConfig, length: int) -> int:
    """The reference's ``min(chunk, L)``, for the lengths it can compute:
    up to one chunk, or a whole number of chunks."""
    q = min(ssm.chunk, length)
    if length % q:
        raise ValueError(
            f"mamba prefill of {length} tokens: the reference computes "
            f"lengths up to {ssm.chunk} or multiples of it (it reshapes by "
            f"L // chunk), so the port refuses {length}")
    return q


def _ssd_mix(params, ssm: SSMConfig, x: torch.Tensor):
    """The mixer's SSD, gate and output projection; returns (out, final
    state, pre-activation conv inputs)."""
    z, xs, Bm, Cm, dt, pre = _project_and_conv(params, x)
    A = -torch.exp(params["A_log"].to(torch.float32))
    y, state = ssd(xs, dt, A, Bm, Cm, params["D"],
                   chunk=_chunk(ssm, x.shape[1]))
    y = rms_norm_simple(y * F.silu(z), params["norm_scale"])
    return _proj_out(y, params["out_proj"]), state, pre


def _proj_out(y: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """y (..., H, P) times out_proj (H, P, d) cast to y's dtype -> (...,
    d)."""
    h, p, d = w.shape
    return y.reshape(*y.shape[:-2], h * p) @ w.to(y.dtype).reshape(h * p, d)


def mamba_prefill(params: Dict[str, torch.Tensor], ssm: SSMConfig,
                  x: torch.Tensor) -> torch.Tensor:
    """x (B, L, d) -> y (B, L, d), without a cache."""
    return _ssd_mix(params, ssm, x)[0]


def mamba_prefill_with_cache(params: Dict[str, torch.Tensor], ssm: SSMConfig,
                             x: torch.Tensor, cache: Dict[str, torch.Tensor]
                             ) -> torch.Tensor:
    """Prefill that also fills the decode cache ``cache`` in place: the
    final SSM state and the last K-1 pre-activation conv inputs."""
    out, state, (xs0, Bm0, Cm0) = _ssd_mix(params, ssm, x)
    k = ssm.d_conv
    cache["ssm"].copy_(state)
    cache["conv_x"].copy_(xs0[:, -(k - 1):])
    cache["conv_B"].copy_(Bm0[:, -(k - 1):])
    cache["conv_C"].copy_(Cm0[:, -(k - 1):])
    return out


#: the decode cache's logical axes by leaf (the reference's
#: ``mamba_decode_cache_spec`` gives them beside the shapes)
CACHE_AXES = {"ssm": ("batch", "ssm_heads", None, "ssm_state"),
              "conv_x": ("batch", "conv", "ssm_heads", None),
              "conv_B": ("batch", "conv", None, "ssm_state"),
              "conv_C": ("batch", "conv", None, "ssm_state")}


def mamba_decode_cache_spec(d_model: int, ssm: SSMConfig,
                            batch: int) -> Dict[str, Tuple[int, ...]]:
    """Shape of each decode-cache leaf of one block."""
    h, _ = ssm_dims(d_model, ssm)
    p, n, g, k = ssm.head_dim, ssm.d_state, ssm.n_groups, ssm.d_conv
    return {"ssm": (batch, h, p, n), "conv_x": (batch, k - 1, h, p),
            "conv_B": (batch, k - 1, g, n), "conv_C": (batch, k - 1, g, n)}


def mamba_decode(params: Dict[str, torch.Tensor], ssm: SSMConfig,
                 x: torch.Tensor, cache: Dict[str, torch.Tensor]
                 ) -> torch.Tensor:
    """One recurrent step.  x (B, 1, d) -> y (B, 1, d); ``cache`` is
    advanced in place."""
    f32 = torch.float32
    xt = x[:, 0]
    z = _proj(xt, params["z_proj"])
    xs0 = _proj(xt, params["x_proj"])
    Bm0 = _proj(xt, params["B_proj"])
    Cm0 = _proj(xt, params["C_proj"])
    dt = _proj(xt, params["dt_proj"])

    def conv_step(tail, cur, w, bias):
        full = torch.cat([tail, cur[:, None]], dim=1)       # (B, K, ...)
        acc = bias
        for i in range(full.shape[1]):
            acc = acc + full[:, i] * w[..., i]
        return acc

    dtp = x.dtype
    xs = F.silu(conv_step(cache["conv_x"], xs0, params["conv_w_x"].to(dtp),
                          params["conv_b_x"].to(dtp)))
    Bm = F.silu(conv_step(cache["conv_B"], Bm0, params["conv_w_B"].to(dtp),
                          params["conv_b_B"].to(dtp)))
    Cm = F.silu(conv_step(cache["conv_C"], Cm0, params["conv_w_C"].to(dtp),
                          params["conv_b_C"].to(dtp)))
    dt = F.softplus(dt.to(f32) + params["dt_bias"].to(f32))       # (B, H)
    A = -torch.exp(params["A_log"].to(f32))
    dA = torch.exp(dt * A)
    rep = xs.shape[1] // ssm.n_groups
    Bh = torch.repeat_interleave(Bm, rep, dim=1).to(f32)          # (B, H, N)
    Ch = torch.repeat_interleave(Cm, rep, dim=1).to(f32)
    state = dA[:, :, None, None] * cache["ssm"].to(f32) + (
        dt[:, :, None, None] * xs.to(f32)[..., None] * Bh[:, :, None, :])
    y = torch.einsum("bhpn,bhn->bhp", state, Ch)
    y = y + params["D"].to(f32)[None, :, None] * xs.to(f32)
    y = rms_norm_simple(y.to(x.dtype) * F.silu(z), params["norm_scale"])
    out = _proj_out(y, params["out_proj"])

    cache["ssm"].copy_(state)
    for key, cur in (("conv_x", xs0), ("conv_B", Bm0), ("conv_C", Cm0)):
        cache[key].copy_(torch.cat([cache[key][:, 1:], cur[:, None]], dim=1))
    return out[:, None, :]
