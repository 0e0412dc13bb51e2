"""Pre-norm residual blocks and their stacked periods.

Counterpart of ``repro/models/blocks.py`` for the mixers ``attn``,
``attn_local``, ``attn_global`` and ``mamba`` with a ``dense``, ``moe`` or
no MLP, and a decoder's cross attention to an encoder's output
(``cross_norm`` and ``cross`` after the mixer).
A *period* is one repetition of ``cfg.block_pattern`` (gemma2's (local,
global) pair); every weight and cache leaf of the stack keeps its leading
per-period axis, as the reference's scanned stack does, and
``apply_stack`` splits each stacked leaf into its periods once and loops
over them (under autograd each period's gradient goes straight into the
leaf's ``.grad``: ``_PeriodSlice``).  So a stacked leaf's gradient exists
only in its ``.grad`` after ``loss.backward()``: ``torch.autograd.grad``,
``backward(inputs=...)``, hooks on the leaf and double backward see none
for it.  Modes: ``causal`` (no cache),
``prefill_cache`` (fills the cache), ``decode`` (one token against it) and
``encode`` (an encoder's bidirectional self-attention, no cache); a stack
with cross attention takes each period's cross (K, V) (``cross_kv_stack``
makes them from the encoder's output; the cache holds them for decode).
The port writes caches in place; the reference returns new ones.  The MoE
blocks' aux losses are summed period by period, as the reference's scan
carries them (``apply_stack(..., return_aux=True)``).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
from torch.autograd.function import once_differentiable
from torch.utils.checkpoint import checkpoint

from repro_torch.common.config import ArchConfig, BlockSpecEntry
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import apply_mlp, mlp_spec, norm, norm_spec
from repro_torch.models.param import stack, step_cast

MIXERS = ("attn", "attn_local", "attn_global", "mamba")
MODES = ("causal", "prefill_cache", "decode", "encode")
#: one period's cross attention (K, V) by block key, (B, T, Hk, Dh) each
CrossKV = Dict[str, Tuple[torch.Tensor, torch.Tensor]]


def _entry(kind: str) -> BlockSpecEntry:
    ent = BlockSpecEntry.parse(kind)
    if ent.mixer not in MIXERS or ent.mlp not in ("dense", "moe", "none"):
        raise NotImplementedError(f"block {kind!r}: the port runs mixers "
                                  f"{MIXERS} with a dense, MoE or no MLP")
    return ent


def _check(cfg: ArchConfig) -> None:
    for kind in cfg.block_pattern:
        _entry(kind)


def block_spec(cfg: ArchConfig, kind: str,
               cross_attention: bool = False) -> Dict[str, Any]:
    ent = _entry(kind)
    d = cfg.d_model
    spec: Dict[str, Any] = {"pre_norm": norm_spec(d, cfg.norm)}
    if ent.mixer == "mamba":
        spec["mixer"] = ssm_mod.mamba_spec(d, cfg.ssm)
    else:
        spec["mixer"] = attn.attention_spec(d, cfg.attention)
    if cfg.post_block_norm:
        spec["post_mixer_norm"] = norm_spec(d, cfg.norm)
    if cross_attention:
        spec["cross_norm"] = norm_spec(d, cfg.norm)
        spec["cross"] = attn.attention_spec(d, cfg.attention, cross=True)
    if ent.mlp != "none":
        spec["pre_mlp_norm"] = norm_spec(d, cfg.norm)
        if ent.mlp == "moe":
            spec["mlp"] = moe_mod.moe_spec(d, cfg.moe)
        else:
            spec["mlp"] = mlp_spec(d, cfg.d_ff, cfg.mlp_gated)
        if cfg.post_block_norm:
            spec["post_mlp_norm"] = norm_spec(d, cfg.norm)
    return spec


def stack_spec(cfg: ArchConfig, n_periods: Optional[int] = None,
               cross_attention: bool = False) -> Dict[str, Any]:
    """The stacked periods: ``cfg.n_periods`` (the decoder) unless
    ``n_periods`` is given (an encoder's)."""
    _check(cfg)
    return stack({f"i{j}": block_spec(cfg, kind, cross_attention)
                  for j, kind in enumerate(cfg.block_pattern)},
                 cfg.n_periods if n_periods is None else n_periods)


#: an attention block's cache leaves' logical axes
KV_AXES = ("batch", "kv_seq", "kv_heads", "head_dim")


def block_cache_shapes(cfg: ArchConfig, kind: str, batch: int,
                       s_max: int) -> Dict[str, Tuple[Tuple[int, ...],
                                                      Tuple]]:
    """(shape, logical axes) of each cache leaf of one block, as the
    reference's."""
    if _entry(kind).mixer == "mamba":
        return {leaf: (shape, ssm_mod.CACHE_AXES[leaf]) for leaf, shape in
                ssm_mod.mamba_decode_cache_spec(cfg.d_model, cfg.ssm,
                                                batch).items()}
    att = cfg.attention
    kv = (batch, s_max, att.n_kv_heads, att.head_dim)
    return {"k": (kv, KV_AXES), "v": (kv, KV_AXES)}


def apply_block(cfg: ArchConfig, kind: str, params: Dict[str, Any],
                x: torch.Tensor, *, mode: str, positions: torch.Tensor,
                cache: Optional[Dict[str, torch.Tensor]] = None,
                lens: Optional[torch.Tensor] = None,
                cross_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                mm=torch.matmul,
                aux: Optional[List[torch.Tensor]] = None) -> torch.Tensor:
    """One block: x + mixer(norm(x)) (sandwiched by a post norm when the
    config says so), then x + cross(cross_norm(x)) against ``cross_kv``
    where the block has cross attention, then the MLP as the mixer.
    ``cache`` (this block's leaves for this period) is filled or advanced
    in place.  ``mm`` computes the dense MLP's products and, in ``causal``
    mode, the attention's projections (``layers.frame_matmul`` for the
    stream MLLM).  An MoE block appends its aux loss to ``aux`` when
    given."""
    ent = _entry(kind)
    h = norm(params["pre_norm"], x, cfg.norm)
    mix = params["mixer"]
    if ent.mixer == "mamba":
        if mode == "decode":
            y = ssm_mod.mamba_decode(mix, cfg.ssm, h, cache)
        elif mode == "prefill_cache":
            y = ssm_mod.mamba_prefill_with_cache(mix, cfg.ssm, h, cache)
        else:
            y = ssm_mod.mamba_prefill(mix, cfg.ssm, h)
    else:
        local = ent.mixer == "attn_local"
        if mode == "encode":
            y = attn.attend_encoder(mix, cfg.attention, h, positions)
        elif mode == "decode":
            y = attn.attend_decode(mix, cfg.attention, h, cache["k"],
                                   cache["v"], lens, local=local)
        elif mode == "prefill_cache":
            y, (k, v) = attn.attend_prefill(mix, cfg.attention, h, positions,
                                            local=local, return_kv=True)
            cache["k"][:, :k.shape[1]] = k.to(cache["k"].dtype)
            cache["v"][:, :v.shape[1]] = v.to(cache["v"].dtype)
        else:
            y = attn.attend_prefill(mix, cfg.attention, h, positions,
                                    local=local, mm=mm)
    if cfg.post_block_norm:
        y = norm(params["post_mixer_norm"], y, cfg.norm)
    x = x + y
    if "cross" in params:
        if cross_kv is None:
            raise ValueError(f"{cfg.name}: a cross-attention block without "
                             "the encoder's (K, V)")
        h = norm(params["cross_norm"], x, cfg.norm)
        x = x + attn.attend_cross(params["cross"], cfg.attention, h,
                                  *cross_kv, decode=mode == "decode")
    if ent.mlp != "none":
        h = norm(params["pre_mlp_norm"], x, cfg.norm)
        mlp = params["mlp"]
        if ent.mlp == "moe":
            y, a = moe_mod.apply_moe(mlp, h, cfg.moe)
            if aux is not None:
                aux.append(a)
        else:
            # the reference picks GeLU by the config's name
            act = "gelu" if cfg.name.startswith("gemma") else "silu"
            y = apply_mlp(mlp["w_in"], mlp.get("w_gate"), mlp["w_out"], h,
                          act, mm=mm)
        if cfg.post_block_norm:
            y = norm(params["post_mlp_norm"], y, cfg.norm)
        x = x + y
    return x


class _PeriodSlice(torch.autograd.Function):
    """Period ``i`` of a stacked parameter (the view ``leaf[i]``) whose
    gradient is added into the parameter's ``.grad`` slice as soon as it
    arrives; the parameter itself receives nothing through autograd.  With
    ``unbind`` (or ``select``) autograd would hold every period's gradient
    until the last one arrived and then stack them (or build a full-size
    zero gradient for each period): a second full-size gradient of every
    stacked leaf, 23 GB at chatglm3-6b, beside the accumulated ``.grad``."""

    @staticmethod
    def forward(ctx, leaf, i):
        ctx.leaf, ctx.i = leaf, i
        return leaf[i]

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        leaf = ctx.leaf
        if leaf.grad is None:
            leaf.grad = torch.zeros_like(leaf)
        leaf.grad[ctx.i] += g
        return None, None


def _periods(tree: Any, n: int, cast: bool = True):
    """``i -> period i's tree`` of a stacked tree.  A leaf without a graph
    is split once (``leaf.unbind(0)``, the views ``leaf[i]``).  A leaf
    that requires grad gets its period's ``_PeriodSlice`` only when that
    period runs: autograd's ready queue runs later-made nodes first, so a
    slice made before the whole stack would wait until the end of the
    backward, holding every period's gradient.  Under the cast step
    (``param.cast_step``) a weight's slice is cast after its
    ``_PeriodSlice`` (``cast``; a cache's leaves are not), so the rounded
    gradient still reaches the stacked leaf's ``.grad``."""
    if isinstance(tree, dict):
        subs = {k: _periods(v, n, cast) for k, v in tree.items()}
        return lambda i: {k: f(i) for k, f in subs.items()}
    nd = tree.dim()
    if torch.is_grad_enabled() and tree.requires_grad:
        if cast:
            return lambda i: step_cast(_PeriodSlice.apply(tree, i), nd)
        return lambda i: _PeriodSlice.apply(tree, i)
    views = tree.unbind(0)
    if cast:
        return lambda i: step_cast(views[i], nd)
    return lambda i: views[i]


def cross_kv_stack(cfg: ArchConfig, stacked: Dict[str, Any],
                   enc_out: torch.Tensor) -> List[CrossKV]:
    """Each period's cross (K, V) by block key from the encoder's output
    (B, T, d): the per-period list ``apply_stack`` takes.  Only the cross
    attention's ``wk`` and ``wv`` are sliced (a period's ``_PeriodSlice``
    under autograd)."""
    n = stacked["i0"]["pre_norm"]["scale"].shape[0]
    period = _periods({key: {w: blk["cross"][w] for w in ("wk", "wv")}
                       for key, blk in stacked.items()}, n)
    out = []
    for i in range(n):
        p = period(i)
        out.append({key: attn.cross_kv(p[key], enc_out) for key in p})
    return out


def apply_stack(cfg: ArchConfig, stacked: Dict[str, Any], x: torch.Tensor,
                positions: torch.Tensor, *, mode: str = "causal",
                cache: Optional[Dict[str, Any]] = None,
                lens: Optional[torch.Tensor] = None,
                cross_kv: Optional[Sequence[CrossKV]] = None,
                mm=torch.matmul, return_aux: bool = False,
                remat: bool = False):
    """Run every period of the stacked weights in order.  ``cache`` is a
    dict per block key ``i{j}`` of (n_periods, B, ...) tensors, filled
    (``prefill_cache``) or advanced (``decode``) in place.  ``cross_kv``
    gives each period's cross (K, V) by block key (a stack with cross
    attention).  ``mm`` is ``apply_block``'s.  ``remat`` (without a
    cache, under autograd): each period's blocks run under
    ``torch.utils.checkpoint``, the reference's ``jax.checkpoint`` of a
    period, so the graph holds a period's input and not its activations,
    which its backward computes again.  Returns x, or with ``return_aux``
    (x, the MoE aux loss): each period's blocks summed in order, then the
    periods, from a float32 zero, as the reference's scan carries it."""
    _check(cfg)
    if mode not in MODES:
        raise ValueError(f"mode {mode!r}; have {MODES}")
    if (cache is None) != (mode in ("causal", "encode")):
        raise ValueError(f"mode {mode!r} with cache={cache is not None}")
    n = stacked["i0"]["pre_norm"]["scale"].shape[0]
    if cross_kv is not None and len(cross_kv) != n:
        raise ValueError(f"{len(cross_kv)} periods of cross (K, V) for a "
                         f"stack of {n}")
    period = _periods(stacked, n)
    cache_at = None if cache is None else _periods(cache, n, cast=False)
    remat = remat and cache is None and torch.is_grad_enabled()
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(n):
        p_params = period(i)
        p_cache = None if cache_at is None else cache_at(i)

        def run(x, i=i, p_params=p_params, p_cache=p_cache):
            p_aux: List[torch.Tensor] = []
            for j, kind in enumerate(cfg.block_pattern):
                key = f"i{j}"
                x = apply_block(
                    cfg, kind, p_params[key], x, mode=mode,
                    positions=positions,
                    cache=None if p_cache is None else p_cache[key],
                    lens=lens,
                    cross_kv=None if cross_kv is None else cross_kv[i][key],
                    mm=mm, aux=p_aux)
            if not p_aux:
                return x, None
            a = torch.zeros((), dtype=torch.float32, device=x.device)
            for one in p_aux:
                a = a + one
            return x, a

        x, a = checkpoint(run, x, use_reentrant=False) if remat else run(x)
        if a is not None:
            total = total + a
    return (x, total) if return_aux else x
