"""LM: the decoder-only language model the serving engine runs.

Counterpart of ``repro/models/model.py`` for token inputs (no patch or
audio frontend, no encoder), with a tied or untied unembedding: ``spec``,
``_embed``, ``forward`` / ``logits_and_aux`` (the differentiable causal
logits and the MoE aux loss) and ``loss`` for training;
``logits_causal``, ``cache_shapes`` / ``init_cache``,
``prefill(..., last_pos)`` and ``decode`` without a graph, for serving.
The parameters' dotted names are the reference's parameter tree paths
(``stack.i0.mixer.wq``), so ``repro_torch.bridge`` loads the reference's
tree key for key.  The cache is a dict ``{"layers": {"i{j}":
{leaf: (n_periods, B, ...)}}}``, as the reference's; prefill and decode
write it in place and return it.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.common.config import ArchConfig
from repro_torch.common.device import DeviceLike, resolve_device
from repro_torch.models import blocks as blk
from repro_torch.models.layers import (cross_entropy, embed_spec,
                                       embed_tokens, norm, norm_spec,
                                       unembed)
from repro_torch.models.param import ParamTree, init_params


class LM(ParamTree):
    """A decoder-only LM as one module of parameters."""

    def __init__(self, cfg: ArchConfig, device: DeviceLike = None):
        if cfg.frontend is not None or cfg.encoder_decoder:
            raise NotImplementedError(
                f"{cfg.name}: the port's LM takes tokens only; frontends "
                "and encoders wait for their slices")
        dev = resolve_device(device)
        super().__init__(self.spec(cfg), dev)
        self.cfg = cfg
        self.device = dev

    @staticmethod
    def spec(cfg: ArchConfig) -> Dict[str, Any]:
        return {
            "embed": embed_spec(cfg.padded_vocab, cfg.d_model,
                                cfg.tie_embeddings),
            "stack": blk.stack_spec(cfg),
            "final_norm": norm_spec(cfg.d_model, cfg.norm),
        }

    def init(self, generator: torch.Generator) -> "LM":
        """Seeded init (the reference's scheme) from ``generator``."""
        init_params(self, generator)
        return self

    # ------------------------------------------------------------------
    def _embed(self, params: Dict[str, Any],
               tokens: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        scale = math.sqrt(float(cfg.d_model)) if cfg.embed_scale else None
        return embed_tokens(params["embed"], tokens.to(self.device), scale)

    def _head(self, params: Dict[str, Any], x: torch.Tensor) -> torch.Tensor:
        x = norm(params["final_norm"], x, self.cfg.norm)
        return unembed(params["embed"], x, self.cfg.final_softcap)

    def logits_and_aux(self, tokens: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """tokens (B, S) -> (logits (B, S, padded vocab), the MoE aux loss
        (0 without MoE blocks)), no cache; differentiable in the parameters
        that require grad (training)."""
        params = self.tree()
        x = self._embed(params, tokens)
        positions = torch.arange(tokens.shape[1], device=self.device)[None]
        x, aux = blk.apply_stack(self.cfg, params["stack"], x, positions,
                                 return_aux=True)
        return self._head(params, x), aux

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens (B, S) -> logits (B, S, padded vocab), no cache;
        differentiable in the parameters that require grad (training)."""
        return self.logits_and_aux(tokens)[0]

    @torch.no_grad()
    def logits_causal(self, tokens: torch.Tensor) -> torch.Tensor:
        """``forward`` without a graph, for serving."""
        return self(tokens)

    def loss(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Next-token loss of ``{"tokens", "labels"}`` (B, S): mean nll +
        z-loss + the MoE aux loss (router z-loss and load balance, 0
        without MoE blocks); labels below 0 are read as 0, as the reference
        does."""
        logits, aux = self.logits_and_aux(batch["tokens"])
        labels = batch["labels"].to(self.device).long().clamp_min(0)
        nll, zl = cross_entropy(logits, labels)
        return nll + zl + aux

    # ------------------------------------------------------------------
    def cache_shapes(self, batch: int, s_max: int) -> Dict[str, Any]:
        """{"layers": {"i{j}": {leaf: (n_periods, batch, ...)}}}."""
        cfg = self.cfg
        return {"layers": {
            f"i{j}": {leaf: (cfg.n_periods,) + shape for leaf, shape in
                      blk.block_cache_shapes(cfg, kind, batch, s_max).items()}
            for j, kind in enumerate(cfg.block_pattern)}}

    def init_cache(self, batch: int, s_max: int) -> Dict[str, Any]:
        """A zeroed fp32 cache (the kernels take fp32)."""
        return {"layers": {
            key: {leaf: torch.zeros(shape, device=self.device)
                  for leaf, shape in leaves.items()}
            for key, leaves in self.cache_shapes(batch, s_max)["layers"]
            .items()}}

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, cache: Dict[str, Any],
                last_pos: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """Run the prompt tokens (B, S) through the model, filling
        ``cache`` (in place).  ``last_pos`` (B,) picks the position whose
        logits are returned (right-padded prompts); default the last.
        Returns (logits (B, 1, V), cache)."""
        params = self.tree()
        x = self._embed(params, tokens)
        positions = torch.arange(tokens.shape[1], device=self.device)[None]
        x = blk.apply_stack(self.cfg, params["stack"], x, positions,
                            mode="prefill_cache", cache=cache["layers"])
        if last_pos is not None:
            idx = last_pos.to(self.device).long()[:, None, None]
            x = torch.gather(x, 1, idx.expand(-1, 1, x.shape[-1]))
        else:
            x = x[:, -1:]
        return self._head(params, x), cache

    @torch.no_grad()
    def decode(self, tokens: torch.Tensor, cache: Dict[str, Any],
               lens: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """One decode step.  tokens (B, 1); lens (B,) int, each sequence's
        length so far (a scalar is broadcast).  Returns (logits (B, 1, V),
        cache advanced in place)."""
        params = self.tree()
        b = tokens.shape[0]
        lens = lens.to(self.device).long().reshape(-1).expand(b)
        x = self._embed(params, tokens)
        x = blk.apply_stack(self.cfg, params["stack"], x, lens[:, None],
                            mode="decode", cache=cache["layers"], lens=lens)
        return self._head(params, x), cache
