"""LM: the language model the serving engine and the trainer run.

Counterpart of ``repro/models/model.py``: decoder-only stacks, the
encoder-decoder (seamless-m4t: an encoder over stub audio frames, cross
attention in every decoder block) and the patch frontend (pixtral: stub
patch embeddings added at their positions), with a tied or untied
unembedding: ``spec``, ``_embed``, ``_encode``, ``_cross_kv_stack``,
``forward`` / ``logits_and_aux`` (the differentiable causal logits and the
MoE aux loss) and ``loss`` for training; ``logits_causal``,
``cache_shapes`` / ``init_cache``, ``prefill(..., last_pos)`` and
``decode`` without a graph, for serving.  The frontends' inputs are
keywords beside the tokens: ``frames`` (B, T, d) for the encoder,
``patch_embeds`` (B, P, d) and ``patch_pos`` (B, P) for the patches (the
reference's batch keys).  The parameters' dotted names are the reference's
parameter tree paths (``stack.i0.mixer.wq``, ``encoder.stack.i0.mixer.wq``,
``stack.i0.cross.wk``), so ``repro_torch.bridge`` loads the reference's
tree key for key.  The cache is a dict ``{"layers": {"i{j}":
{leaf: (n_periods, B, ...)}}}``, as the reference's, with ``"cross":
{"i{j}": {"k", "v": (n_periods, B, T_src, Hk, Dh)}}`` for an
encoder-decoder; prefill and decode write it in place and return it.

The compute dtype: ``logits_causal``, ``loss``, ``init_cache``,
``prefill`` and ``decode`` take ``dtype=`` as the reference's methods do,
but default to ``torch.float32`` where the reference defaults to
``jnp.bfloat16`` (its engine, launcher and tests pass fp32, and so does
every caller of the port); a model made float64 by ``.double()`` defaults
to float64.  At ``dtype`` the embeddings, activations,
projections and the KV cache are in that dtype, each matmul weight cast to
it where it is used (``CAST_LEAVES``, the leaves the reference casts with
``.astype(dtype)``); norms, rotary angles, soft-caps' inputs, the router,
the SSD and the cross-entropy compute in fp32.  ``cast_`` casts those
leaves once (the served model: 2 bytes a weight), and a model built with
``LM(cfg, dtype=...)`` holds them in that dtype from the start (one whose
fp32 weights would not fit the card); either then refuses calls at another
dtype.  On the card a bf16 call turns off cuBLAS' reduced-precision bf16
split-K sums (``bf16_matmul_fp32_sums``).
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.common.config import ArchConfig, BlockSpecEntry
from repro_torch.common.device import DeviceLike, resolve_device
from repro_torch.models import blocks as blk
from repro_torch.models.layers import (cross_entropy, embed_spec,
                                       embed_tokens, norm, norm_spec,
                                       unembed)
from repro_torch.models.param import (ParamTree, count_params, init_params,
                                      step_cast)

#: the batch keys of the stub frontends' inputs, beside tokens and labels
FRONTEND_KEYS = ("frames", "patch_embeds", "patch_pos")
#: the leaves (by their last name) the reference casts to the compute dtype
#: where it uses them: embeddings, attention and MLP projections, experts,
#: the SSM's projections and convolutions.  Norm scales and biases, qk-norm,
#: the router, ``A_log``, ``D`` and ``dt_bias`` stay fp32.
CAST_LEAVES = frozenset({
    "table", "unembed", "wq", "wk", "wv", "wo", "w_in", "w_gate", "w_out",
    "shared_in", "shared_gate", "shared_out", "z_proj", "x_proj", "B_proj",
    "C_proj", "dt_proj", "conv_w_x", "conv_b_x", "conv_w_B", "conv_b_B",
    "conv_w_C", "conv_b_C", "out_proj"})


def cast_leaf(name: str) -> bool:
    """Whether the dotted parameter ``name`` is cast to the compute dtype."""
    return name.rsplit(".", 1)[-1] in CAST_LEAVES


def bf16_matmul_fp32_sums() -> None:
    """cuBLAS sums a split-K bf16 GEMM's partials in bf16 while PyTorch's
    ``allow_bf16_reduced_precision_reduction`` is True (its default); the
    reference accumulates in fp32, so a bf16 call on the card turns it
    off (process-wide, as PyTorch keeps it)."""
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
        False


class LM(ParamTree):
    """An LM (decoder-only or encoder-decoder) as one module of
    parameters."""

    def __init__(self, cfg: ArchConfig, device: DeviceLike = None,
                 dtype: Optional[torch.dtype] = None):
        """``dtype`` (other than fp32): ``CAST_LEAVES`` are held in it from
        the start, each drawn in fp32 by ``init`` and rounded, and the
        model computes at that dtype only."""
        dev = resolve_device(device)
        low = dtype is not None and dtype != torch.float32
        super().__init__(self.spec(cfg), dev,
                         (lambda n: dtype if cast_leaf(n) else None)
                         if low else None)
        self.cfg = cfg
        self.device = dev
        #: the dtype the cast leaves are held in (None: fp32, any dtype)
        self.compute_dtype: Optional[torch.dtype] = dtype if low else None

    @staticmethod
    def spec(cfg: ArchConfig) -> Dict[str, Any]:
        spec: Dict[str, Any] = {
            "embed": embed_spec(cfg.padded_vocab, cfg.d_model,
                                cfg.tie_embeddings),
            "stack": blk.stack_spec(cfg,
                                    cross_attention=cfg.encoder_decoder),
            "final_norm": norm_spec(cfg.d_model, cfg.norm),
        }
        if cfg.encoder_decoder:
            spec["encoder"] = {
                "stack": blk.stack_spec(
                    cfg, n_periods=cfg.n_encoder_layers
                    // len(cfg.block_pattern)),
                "final_norm": norm_spec(cfg.d_model, cfg.norm),
            }
        return spec

    def init(self, generator: torch.Generator) -> "LM":
        """Seeded init (the reference's scheme) from ``generator``."""
        init_params(self, generator)
        return self

    @torch.no_grad()
    def cast_(self, dtype: torch.dtype) -> "LM":
        """Cast ``CAST_LEAVES`` to ``dtype`` once, in place (leaf by leaf:
        each fp32 leaf is freed as its copy is made), with the values of
        the reference's ``w.astype(dtype)`` at use; the other leaves stay
        fp32.  The model then computes at ``dtype`` only."""
        if self.compute_dtype not in (None, dtype):
            raise ValueError(f"{self.cfg.name}: cast to "
                             f"{self.compute_dtype} already")
        for name, p in self.named_parameters():
            if cast_leaf(name):
                p.data = p.data.to(dtype)
        self.compute_dtype = None if dtype == torch.float32 else dtype
        return self

    def _dtype(self, dtype: Optional[torch.dtype]) -> torch.dtype:
        """The compute dtype of a call: ``dtype``, or by default fp32 (the
        reference's default is bf16), float64 for a model made float64 by
        ``.double()`` (a float64 witness); checked against the cast
        leaves'.  A bf16 call on the card gets fp32 sums in cuBLAS' bf16
        GEMMs."""
        if dtype is None:
            dtype = torch.float64 if self.embed.table.dtype == torch.float64 \
                else torch.float32
        if self.compute_dtype is not None and dtype != self.compute_dtype:
            raise ValueError(f"{self.cfg.name}: the weights are cast to "
                             f"{self.compute_dtype}; a call at {dtype} "
                             "would compute on rounded weights")
        if dtype == torch.bfloat16 and self.device.type == "cuda":
            bf16_matmul_fp32_sums()
        return dtype

    def _params(self) -> Dict[str, Any]:
        """The parameter tree; under the cast step (``param.cast_step``)
        the leaves outside the stacks (the embeddings) are cast here, the
        stacks' period by period in ``blocks.apply_stack``."""
        def walk(tree):
            return {k: v if k == "stack" else
                    (walk(v) if isinstance(v, dict) else step_cast(v))
                    for k, v in tree.items()}
        return walk(self.tree())

    # ------------------------------------------------------------------
    def _embed(self, params: Dict[str, Any], tokens: torch.Tensor,
               patch_embeds: Optional[torch.Tensor] = None,
               patch_pos: Optional[torch.Tensor] = None,
               dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """Token embeddings (B, S, d) in ``dtype`` (default the table's),
        plus ``patch_embeds`` (B, P, d), cast to it, added at
        ``patch_pos`` (B, P) for the patch frontend: a position given twice
        takes both (``index_put(..., accumulate=True)``, out of place, as
        the reference's ``.at[].add``)."""
        cfg = self.cfg
        scale = math.sqrt(float(cfg.d_model)) if cfg.embed_scale else None
        x = embed_tokens(params["embed"], tokens.to(self.device), scale,
                         dtype)
        if patch_embeds is None:
            return x
        if cfg.frontend != "patch" or patch_pos is None:
            raise ValueError(f"{cfg.name}: patch embeddings take the patch "
                             "frontend and their positions")
        pp = patch_pos.to(self.device).long()
        bidx = torch.arange(x.shape[0], device=self.device)[:, None]
        return x.index_put((bidx.expand_as(pp), pp),
                           patch_embeds.to(self.device, x.dtype),
                           accumulate=True)

    def _encode(self, params: Dict[str, Any],
                frames: torch.Tensor) -> torch.Tensor:
        """The encoder over stub frame embeddings (B, T, d): its stack in
        ``encode`` mode (bidirectional), then its final norm."""
        cfg = self.cfg
        x = frames.to(self.device)
        positions = torch.arange(x.shape[1], device=self.device)[None]
        x = blk.apply_stack(cfg, params["encoder"]["stack"], x, positions,
                            mode="encode")
        return norm(params["encoder"]["final_norm"], x, cfg.norm)

    def _cross_kv_stack(self, params: Dict[str, Any],
                        enc_out: torch.Tensor) -> List[blk.CrossKV]:
        """The encoder's output -> each decoder period's cross (K, V)."""
        return blk.cross_kv_stack(self.cfg, params["stack"], enc_out)

    def _cross_from_frames(self, params: Dict[str, Any],
                           frames: Optional[torch.Tensor],
                           dtype: torch.dtype
                           ) -> Optional[List[blk.CrossKV]]:
        if not self.cfg.encoder_decoder:
            if frames is not None:
                raise ValueError(f"{self.cfg.name}: frames take an encoder")
            return None
        if frames is None:
            raise ValueError(f"{self.cfg.name}: the encoder-decoder takes "
                             "frames (B, T, d)")
        return self._cross_kv_stack(
            params, self._encode(params, frames.to(dtype=dtype)))

    def _head(self, params: Dict[str, Any], x: torch.Tensor) -> torch.Tensor:
        x = norm(params["final_norm"], x, self.cfg.norm)
        return unembed(params["embed"], x, self.cfg.final_softcap)

    def logits_and_aux(self, tokens: torch.Tensor, *,
                       dtype: Optional[torch.dtype] = None,
                       frames: Optional[torch.Tensor] = None,
                       patch_embeds: Optional[torch.Tensor] = None,
                       patch_pos: Optional[torch.Tensor] = None,
                       remat: bool = False
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """tokens (B, S) (with ``frames`` for an encoder-decoder, patches
        for the patch frontend) -> (logits (B, S, padded vocab) in
        ``dtype``, the MoE aux loss (fp32; 0 without MoE blocks)), no
        cache; differentiable in the parameters that require grad
        (training).  ``remat``: the decoder's periods are recomputed in
        the backward (``blocks.apply_stack``)."""
        dtype = self._dtype(dtype)
        params = self._params()
        x = self._embed(params, tokens, patch_embeds, patch_pos, dtype)
        positions = torch.arange(tokens.shape[1], device=self.device)[None]
        x, aux = blk.apply_stack(
            self.cfg, params["stack"], x, positions, return_aux=True,
            cross_kv=self._cross_from_frames(params, frames, dtype),
            remat=remat)
        return self._head(params, x), aux

    def forward(self, tokens: torch.Tensor, **inputs) -> torch.Tensor:
        """tokens (B, S) -> logits (B, S, padded vocab), no cache;
        differentiable in the parameters that require grad (training).
        ``inputs``: ``logits_and_aux``'s keywords (``dtype``, the
        frontends')."""
        return self.logits_and_aux(tokens, **inputs)[0]

    @torch.no_grad()
    def logits_causal(self, tokens: torch.Tensor,
                      dtype: Optional[torch.dtype] = None,
                      **inputs) -> torch.Tensor:
        """``forward`` at ``dtype`` without a graph, for serving."""
        return self(tokens, dtype=dtype, **inputs)

    def loss(self, batch: Dict[str, torch.Tensor],
             dtype: Optional[torch.dtype] = None,
             remat: bool = False) -> torch.Tensor:
        """Next-token loss of ``{"tokens", "labels"}`` (B, S), with
        ``"frames"`` or ``"patch_embeds"`` / ``"patch_pos"`` where the
        model takes them, the model run at ``dtype``: mean nll + z-loss (in
        fp32) + the MoE aux loss (router z-loss and load balance, 0 without
        MoE blocks); labels below 0 are read as 0, as the reference
        does.  ``remat``: ``logits_and_aux``'s (the reference's
        ``cfg.remat``; the port's training keeps every period's
        activations unless asked)."""
        logits, aux = self.logits_and_aux(
            batch["tokens"], dtype=dtype, remat=remat,
            **{k: batch[k] for k in FRONTEND_KEYS if k in batch})
        labels = batch["labels"].to(self.device).long().clamp_min(0)
        nll, zl = cross_entropy(logits, labels)
        return nll + zl + aux

    # ------------------------------------------------------------------
    def cache_shapes(self, batch: int, s_max: int,
                     t_src: int = 0) -> Dict[str, Any]:
        """The cache's (shape, logical axes) pairs, as the reference's:
        {"layers": {"i{j}": {leaf: ((n_periods, batch, ...), ("layers",
        "batch", ...))}}}, with {"cross": {"i{j}": {"k", "v": ((n_periods,
        batch, t_src, Hk, Dh), axes)}}} for an encoder-decoder (the
        reference's cross leaves are a (k, v) pair; the port names them)."""
        return cache_shapes(self.cfg, batch, s_max, t_src)

    def init_cache(self, batch: int, s_max: int, t_src: int = 0,
                   dtype: Optional[torch.dtype] = None) -> Dict[str, Any]:
        """A zeroed cache in ``dtype`` (the default as ``prefill``'s: fp32,
        where the reference's is bf16)."""
        dtype = self._dtype(dtype)
        return {part: {key: {leaf: torch.zeros(shape, device=self.device,
                                               dtype=dtype)
                             for leaf, (shape, _) in leaves.items()}
                       for key, leaves in tree.items()}
                for part, tree in self.cache_shapes(batch, s_max,
                                                    t_src).items()}

    @staticmethod
    def _cache_cross(cache: Dict[str, Any]) -> List[blk.CrossKV]:
        """The cache's cross (K, V) as ``apply_stack`` takes them: each
        period's a contiguous view of the stacked leaves."""
        cross = cache["cross"]
        ks = {key: (c["k"].unbind(0), c["v"].unbind(0))
              for key, c in cross.items()}
        n = next(iter(cross.values()))["k"].shape[0]
        return [{key: (k[i], v[i]) for key, (k, v) in ks.items()}
                for i in range(n)]

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, cache: Dict[str, Any],
                last_pos: Optional[torch.Tensor] = None, *,
                dtype: Optional[torch.dtype] = None,
                frames: Optional[torch.Tensor] = None,
                patch_embeds: Optional[torch.Tensor] = None,
                patch_pos: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """Run the prompt tokens (B, S) through the model, filling
        ``cache`` (in place).  ``last_pos`` (B,) picks the position whose
        logits are returned (right-padded prompts); default the last.  An
        encoder-decoder encodes ``frames`` and puts each period's cross
        (K, V) in ``cache["cross"]`` (replacing its leaves, whatever their
        T_src); without frames it reuses the cache's, as the reference
        does.  The model runs at ``dtype`` (the cache's leaves keep theirs:
        K/V are cast as they are written).  Returns (logits (B, 1, V),
        cache)."""
        dtype = self._dtype(dtype)
        params = self._params()
        x = self._embed(params, tokens, patch_embeds, patch_pos, dtype)
        positions = torch.arange(tokens.shape[1], device=self.device)[None]
        cross = None
        if self.cfg.encoder_decoder:
            if frames is not None:
                cross = self._cross_from_frames(params, frames, dtype)
                cache["cross"] = {
                    key: {"k": torch.stack([p[key][0] for p in cross]),
                          "v": torch.stack([p[key][1] for p in cross])}
                    for key in cross[0]}
            cross = self._cache_cross(cache)
        elif frames is not None:
            raise ValueError(f"{self.cfg.name}: frames take an encoder")
        x = blk.apply_stack(self.cfg, params["stack"], x, positions,
                            mode="prefill_cache", cache=cache["layers"],
                            cross_kv=cross)
        if last_pos is not None:
            idx = last_pos.to(self.device).long()[:, None, None]
            x = torch.gather(x, 1, idx.expand(-1, 1, x.shape[-1]))
        else:
            x = x[:, -1:]
        return self._head(params, x), cache

    @torch.no_grad()
    def decode(self, tokens: torch.Tensor, cache: Dict[str, Any],
               lens: torch.Tensor, *, dtype: Optional[torch.dtype] = None
               ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """One decode step at ``dtype``.  tokens (B, 1); lens (B,) int, each
        sequence's length so far (a scalar is broadcast).  An
        encoder-decoder's cross attention reads ``cache["cross"]`` (decode
        writes none).  Returns (logits (B, 1, V), cache advanced in
        place)."""
        dtype = self._dtype(dtype)
        params = self._params()
        b = tokens.shape[0]
        lens = lens.to(self.device).long().reshape(-1).expand(b)
        x = self._embed(params, tokens, dtype=dtype)
        cross = self._cache_cross(cache) if self.cfg.encoder_decoder \
            else None
        x = blk.apply_stack(self.cfg, params["stack"], x, lens[:, None],
                            mode="decode", cache=cache["layers"], lens=lens,
                            cross_kv=cross)
        return self._head(params, x), cache


def cache_shapes(cfg: ArchConfig, batch: int, s_max: int,
                 t_src: int = 0) -> Dict[str, Any]:
    """``LM.cache_shapes`` from the config alone (no parameters)."""
    out: Dict[str, Any] = {"layers": {
        f"i{j}": {leaf: ((cfg.n_periods,) + shape, ("layers",) + axes)
                  for leaf, (shape, axes) in
                  blk.block_cache_shapes(cfg, kind, batch, s_max).items()}
        for j, kind in enumerate(cfg.block_pattern)}}
    if cfg.encoder_decoder:
        att = cfg.attention
        kv = ((cfg.n_periods, batch, t_src, att.n_kv_heads, att.head_dim),
              ("layers", "batch", None, "kv_heads", "head_dim"))
        out["cross"] = {f"i{j}": {"k": kv, "v": kv}
                        for j in range(len(cfg.block_pattern))}
    return out


# --------------------------------------------------------------------------
# Parameter counting (MODEL_FLOPS = 6 N D in launch/roofline.py)
# --------------------------------------------------------------------------

def param_count_estimate(cfg: ArchConfig, active_only: bool = False) -> int:
    """All parameters of ``LM.spec(cfg)``; with ``active_only`` an MoE
    layer's experts count at top_k of n_experts (the reference's
    estimate)."""
    total = count_params(LM.spec(cfg))
    if active_only and cfg.has_moe:
        n_moe_layers = sum(
            1 for k in cfg.block_pattern if BlockSpecEntry.parse(k).mlp == "moe"
        ) * cfg.n_periods
        per_layer_expert = 3 * cfg.moe.n_experts * cfg.d_model * \
            cfg.moe.d_ff_expert
        inactive_frac = (cfg.moe.n_experts - cfg.moe.top_k) / \
            cfg.moe.n_experts
        total -= int(n_moe_layers * per_layer_expert * inactive_frac)
    return total
