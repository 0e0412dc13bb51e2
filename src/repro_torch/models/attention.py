"""GQA attention: self-attention over a prefill, an encoder's bidirectional
self-attention and cross attention through the flash kernel, cached decode
through the decode-attention kernel.

Counterpart of ``repro/models/attention.py`` for the paths the port runs:
``attention_spec`` (``cross=True``: no qk-norm), ``_project_qkv`` (with
qk-norm), ``_out_proj``, ``attend_prefill`` (causal, sliding-window for
``attn_local``), ``attend_encoder`` (bidirectional, rotated),
``cross_kv`` and ``attend_cross`` (decoder tokens against an encoder's
keys, neither rotated; the flash kernel at Sq != Sk, or the decode kernel
for one token) and ``attend_decode``.  Head
counts come from the weights (``wq`` (d, H, Dh), ``wk``/``wv`` (d, Hk, Dh),
``wo`` (H, Dh, d)), so a pruned variant with other shapes runs unchanged.
There is no tensor-parallel head padding: the port runs on one card, which
is the reference's layout at ``tp=1``.  The attention itself is the
kernels' (``kernels.flash_attention.ops.flash_attention`` and
``kernels.decode_attention.ops.decode_attention``); the reference computes
the same functions in plain jnp (``full_attention``, ``_decode_attend``).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.common.config import AttentionConfig
from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models.layers import apply_rope, cast_matmul, \
    rms_norm_simple
from repro_torch.models.param import ParamSpec


def attention_spec(d_model: int, att: AttentionConfig,
                   cross: bool = False) -> Dict[str, ParamSpec]:
    d = att.head_dim
    spec = {
        "wq": ParamSpec((d_model, att.n_heads, d),
                        axes=("fsdp", "heads", "head_dim")),
        "wk": ParamSpec((d_model, att.n_kv_heads, d),
                        axes=("fsdp", None, "head_dim")),
        "wv": ParamSpec((d_model, att.n_kv_heads, d),
                        axes=("fsdp", None, "head_dim")),
        "wo": ParamSpec((att.n_heads, d, d_model),
                        axes=("heads", "head_dim", "fsdp")),
    }
    if att.qk_norm and not cross:
        spec["q_norm"] = ParamSpec((d,), "ones", axes=("head_dim",))
        spec["k_norm"] = ParamSpec((d,), "ones", axes=("head_dim",))
    return spec


def _proj(x: torch.Tensor, w: torch.Tensor, mm=torch.matmul) -> torch.Tensor:
    """x (B, S, d), w (d, H, Dh) cast to x's dtype -> (B, S, H, Dh)."""
    d, h, dh = w.shape
    return cast_matmul(x, w.reshape(d, h * dh), mm).reshape(
        *x.shape[:-1], h, dh)


def _project_qkv(params: Dict[str, torch.Tensor], xq: torch.Tensor,
                 xkv: torch.Tensor, mm=torch.matmul
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """xq (B, Sq, d), xkv (B, Skv, d) -> q (B,Sq,H,Dh), k/v (B,Skv,Hk,Dh);
    q and k RMS-normed per head (qk-norm) when the weights hold their
    scales, before the rotary embedding, as in the reference."""
    q, k = _proj(xq, params["wq"], mm), _proj(xkv, params["wk"], mm)
    if "q_norm" in params:
        q = rms_norm_simple(q, params["q_norm"])
        k = rms_norm_simple(k, params["k_norm"])
    return q, k, _proj(xkv, params["wv"], mm)


def _out_proj(params: Dict[str, torch.Tensor],
              out: torch.Tensor, mm=torch.matmul) -> torch.Tensor:
    """out (B, S, H, Dh) -> (B, S, d); ``wo`` cast to out's dtype."""
    h, dh, d = params["wo"].shape
    return cast_matmul(out.reshape(*out.shape[:-2], h * dh),
                       params["wo"].reshape(h * dh, d), mm)


def attend_prefill(params: Dict[str, torch.Tensor], att: AttentionConfig,
                   x: torch.Tensor, positions: torch.Tensor, *,
                   local: bool = False, return_kv: bool = False,
                   mm=torch.matmul):
    """Causal self-attention over a full sequence x (B, S, d).  A local
    layer masks its sliding window when S exceeds it (below that the window
    hides nothing), as the reference chooses.  With ``return_kv`` also the
    rotated (k, v), (B, S, Hk, Dh) each, for the cache.  ``mm`` computes
    the projections (``layers.frame_matmul`` for the stream MLLM)."""
    q, k, v = _project_qkv(params, x, x, mm)
    q = apply_rope(q, positions, att.rotary_pct, att.rope_theta)
    k = apply_rope(k, positions, att.rotary_pct, att.rope_theta)
    window = att.window if (local and att.window is not None
                            and x.shape[1] > att.window) else None
    out = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                          causal=True, cap=att.softcap, window=window)
    y = _out_proj(params, out, mm)
    return (y, (k, v)) if return_kv else y


def attend_encoder(params: Dict[str, torch.Tensor], att: AttentionConfig,
                   x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """Bidirectional self-attention over an encoder's input x (B, T, d):
    q and k rotated at ``positions``, every frame sees every frame."""
    q, k, v = _project_qkv(params, x, x)
    q = apply_rope(q, positions, att.rotary_pct, att.rope_theta)
    k = apply_rope(k, positions, att.rotary_pct, att.rope_theta)
    out = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                          causal=False, cap=att.softcap)
    return _out_proj(params, out)


def cross_kv(params: Dict[str, torch.Tensor],
             enc_out: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The encoder's output (B, T, d) -> the cross attention's (K, V),
    (B, T, Hk, Dh) each, not rotated (computed once a sequence)."""
    return _proj(enc_out, params["wk"]), _proj(enc_out, params["wv"])


def attend_cross(params: Dict[str, torch.Tensor], att: AttentionConfig,
                 x: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                 decode: bool = False) -> torch.Tensor:
    """Decoder tokens x (B, Sq, d) against an encoder's (K, V) (B, T, Hk,
    Dh): q not rotated, no mask.  A sequence (``causal`` and
    ``prefill_cache`` modes) goes through the flash kernel at Sq != T; one
    token (``decode``) through the decode kernel with ``kv_len`` T for
    every row and no window."""
    q = _proj(x, params["wq"])
    if decode:
        kv_len = torch.full((x.shape[0], 1), k.shape[1], dtype=torch.int32,
                            device=x.device)
        out = decode_attention(q.contiguous(), k.contiguous(),
                               v.contiguous(), kv_len, cap=att.softcap)
        out = out.to(x.dtype)
    else:
        out = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                              causal=False, cap=att.softcap)
    return _out_proj(params, out)


def attend_decode(params: Dict[str, torch.Tensor], att: AttentionConfig,
                  x: torch.Tensor, cache_k: torch.Tensor,
                  cache_v: torch.Tensor, lens: torch.Tensor, *,
                  local: bool = False) -> torch.Tensor:
    """One new token per sequence against its KV cache.

    x (B, 1, d); cache_k/v (B, S_max, Hk, Dh); lens (B,) int, each
    sequence's length before this token.  The new token's k/v are written
    into the caches at ``lens`` in place (the reference returns new
    caches), then it attends to the ``lens + 1`` cached keys (its sliding
    window on a local layer).  Returns y (B, 1, d)."""
    b = x.shape[0]
    q, k_new, v_new = _project_qkv(params, x, x)
    pos = lens[:, None]
    q = apply_rope(q, pos, att.rotary_pct, att.rope_theta)
    k_new = apply_rope(k_new, pos, att.rotary_pct, att.rope_theta)
    bidx = torch.arange(b, device=x.device)
    cache_k[bidx, lens] = k_new[:, 0].to(cache_k.dtype)
    cache_v[bidx, lens] = v_new[:, 0].to(cache_v.dtype)
    kv_len = (lens + 1).to(torch.int32)[:, None]
    window: Optional[int] = att.window if local else None
    out = decode_attention(q.contiguous(), cache_k, cache_v, kv_len,
                           cap=att.softcap, window=window)
    return _out_proj(params, out.to(x.dtype))
