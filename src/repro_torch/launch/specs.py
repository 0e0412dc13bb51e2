"""Abstract inputs and partition specs for every (arch x shape) cell.

Counterpart of ``repro/launch/specs.py``.  Nothing is allocated: the
abstract inputs are tensors on the ``meta`` device (the reference's
``ShapeDtypeStruct``s: shapes and dtypes, no storage), and each input's
sharding is its partition spec, a tuple (``common/sharding.py``; the
reference's ``NamedSharding``'s spec).  ``cell_spec`` returns:

  step_kind      "train" | "prefill" | "decode"
  args           the step's abstract arguments
  in_shardings   the matching tree of partition specs
  rules          logical-rule overrides active for this cell
  donate         indices of the arguments the reference's step donates
  param_bytes    bytes of the parameters (and, to train, optimizer state)

The port's LM has no tensor-parallel head padding, so its specs are the
reference's at a "model" axis of 1.  The optimizer state's moments are
keyed by dotted parameter name (``training/optimizer.py``), the
reference's by the parameter tree's path; an encoder-decoder's cross K/V
cache leaves are named "k" and "v" where the reference's are a pair.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.common.config import ArchConfig, ShapeCell, SHAPE_CELLS
from repro_torch.common.sharding import Mesh, logical_to_mesh, rules_scope
from repro_torch.models.model import LM, cache_shapes
from repro_torch.models.param import abstract, axes_tree
from repro_torch.training.optimizer import OptimizerConfig, adamw_init

# the stub frontends' sizes
N_PATCHES = 1024        # pixtral patch embeddings a sample
T_SRC_CAP = 4096        # seamless encoder frames cap


@dataclasses.dataclass
class CellSpec:
    arch: str
    cell: str
    step_kind: str
    args: Tuple
    in_shardings: Tuple
    rules: Dict[str, Any]
    donate: Tuple[int, ...]
    param_bytes: int
    notes: str = ""


def _meta(shape, dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_inputs(cfg: ArchConfig, cell: ShapeCell, mesh: Mesh,
                 dtype: torch.dtype = torch.bfloat16
                 ) -> Tuple[Dict[str, torch.Tensor], Dict[str, Tuple]]:
    """Token and frontend inputs of a full-sequence step (train or
    prefill), and their partition specs."""
    b, s = cell.global_batch, cell.seq_len
    batch = {"tokens": _meta((b, s), torch.int32)}
    shard = {"tokens": logical_to_mesh(("batch", "seq"), mesh)}
    if cell.kind == "train":
        batch["labels"] = _meta((b, s), torch.int32)
        shard["labels"] = logical_to_mesh(("batch", "seq"), mesh)
    if cfg.frontend == "patch":
        batch["patch_embeds"] = _meta((b, N_PATCHES, cfg.d_model), dtype)
        batch["patch_pos"] = _meta((b, N_PATCHES), torch.int32)
        shard["patch_embeds"] = logical_to_mesh(("batch", None, "embed"),
                                                mesh)
        shard["patch_pos"] = logical_to_mesh(("batch", None), mesh)
    if cfg.frontend == "audio":
        t_src = min(s, T_SRC_CAP)
        batch["frames"] = _meta((b, t_src, cfg.d_model), dtype)
        shard["frames"] = logical_to_mesh(("batch", None, "embed"), mesh)
    return batch, shard


def _map_shape_leaves(fn, tree: Any) -> Any:
    if isinstance(tree, tuple):  # a (shape, axes) leaf
        return fn(*tree)
    return {k: _map_shape_leaves(fn, v) for k, v in tree.items()}


def cache_abstract(cfg: ArchConfig, batch: int, s_max: int, mesh: Mesh,
                   t_src: int = 0, dtype: torch.dtype = torch.bfloat16
                   ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """The decode cache as meta tensors, and its partition specs."""
    shapes = cache_shapes(cfg, batch, s_max, t_src)
    cache = _map_shape_leaves(lambda shape, axes: _meta(shape, dtype),
                              shapes)
    shard = _map_shape_leaves(lambda shape, axes: logical_to_mesh(axes,
                                                                  mesh),
                              shapes)
    return cache, shard


def quantized_opt(cfg: ArchConfig) -> bool:
    """int8 Adam moments for archs whose fp32 state would not fit one
    pod."""
    return cfg.n_params_dense_equiv() > 3e10


def cell_rules(cfg: ArchConfig, cell: ShapeCell) -> Dict[str, Any]:
    """Logical-rule overrides for a cell (the reference's, with its
    ``REPRO_DECODE_2DTP`` and ``REPRO_FSDP_ONLY`` switches)."""
    rules: Dict[str, Any] = {}
    if cell.is_decode and cell.global_batch == 1:
        # long-context decode: the batch does not shard; the KV sequence
        # does (sequence parallelism over "data")
        rules.update({"batch": None, "kv_seq": ("data",)})
    if cell.is_decode and os.environ.get("REPRO_DECODE_2DTP") == "1" \
            and cfg.d_ff % 256 == 0:
        # weight-stationary decode: dense weights over both mesh axes
        rules.update({"fsdp": None, "mlp": ("model", "data")})
    if cell.kind == "train" and os.environ.get("REPRO_FSDP_ONLY") == "1" \
            and not cfg.has_moe:
        # small dense archs without TP: the batch over every axis, weights
        # ZeRO-3 over both
        rules.update({
            "batch": ("pod", "data", "model"),
            "fsdp": ("data", "model"),
            "mlp": None, "heads": None, "kv_heads": None, "vocab": None,
            "ssm_heads": None,
        })
    return rules


def _specs(axes: Any, mesh: Mesh) -> Any:
    """A tree of logical-axes tuples -> partition specs."""
    if isinstance(axes, tuple):
        return logical_to_mesh(axes, mesh)
    return {k: _specs(v, mesh) for k, v in axes.items()}


def _flat(tree: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def cell_spec(cfg: ArchConfig, cell_name: str, mesh: Mesh,
              opt_cfg: Optional[OptimizerConfig] = None,
              batch_override: Optional[int] = None) -> CellSpec:
    cell = SHAPE_CELLS[cell_name]
    if batch_override is not None:
        cell = ShapeCell(cell.name, cell.seq_len, batch_override, cell.kind)
    spec = LM.spec(cfg)
    rules = cell_rules(cfg, cell)

    with rules_scope(**rules):
        p_shard = _specs(axes_tree(spec), mesh)
        if cell.kind == "train":
            params = abstract(spec, torch.float32)
            opt_cfg = opt_cfg or OptimizerConfig(
                quantized_state=quantized_opt(cfg))
            opt_state = adamw_init(_flat(params), opt_cfg)
            opt_shard = _opt_sharding(opt_state, _flat(p_shard), mesh)
            batch, b_shard = batch_inputs(cfg, cell, mesh)
            args = (params, opt_state, batch)
            shardings = (p_shard, opt_shard, b_shard)
            donate = (0, 1)
            pb = _tree_bytes(params) + _tree_bytes(opt_state)
        elif cell.kind == "prefill":
            params = abstract(spec, torch.bfloat16)
            batch, b_shard = batch_inputs(cfg, cell, mesh)
            t_src = min(cell.seq_len, T_SRC_CAP) if cfg.encoder_decoder \
                else 0
            cache, c_shard = cache_abstract(cfg, cell.global_batch,
                                            cell.seq_len, mesh, t_src)
            args = (params, batch, cache)
            shardings = (p_shard, b_shard, c_shard)
            donate = (2,)
            pb = _tree_bytes(params)
        else:  # decode
            params = abstract(spec, torch.bfloat16)
            tokens = _meta((cell.global_batch, 1), torch.int32)
            tok_shard = logical_to_mesh(("batch", None), mesh)
            t_src = T_SRC_CAP if cfg.encoder_decoder else 0
            cache, c_shard = cache_abstract(cfg, cell.global_batch,
                                            cell.seq_len, mesh, t_src)
            cur = _meta((), torch.int32)
            args = (params, tokens, cache, cur)
            shardings = (p_shard, tok_shard, c_shard,
                         logical_to_mesh((), mesh))
            donate = (2,)
            pb = _tree_bytes(params)

    return CellSpec(arch=cfg.name, cell=cell_name, step_kind=cell.kind,
                    args=args, in_shardings=shardings, rules=rules,
                    donate=donate, param_bytes=pb)


def _opt_sharding(opt_state: Dict[str, Any], p_shard: Dict[str, Tuple],
                  mesh: Mesh) -> Dict[str, Any]:
    """Moments shard as their parameters; the int8 moments' row scales
    drop the last axis."""
    moments = {}
    for name, mom in opt_state["moments"].items():
        spec = p_shard[name]
        moments[name] = {
            k: spec if k in ("m", "v", "m_q", "v_q") or len(spec) < v.dim()
            else tuple(spec[:v.dim() - 1]) + (None,)
            for k, v in mom.items()}
    return {"moments": moments, "step": logical_to_mesh((), mesh)}


def _leaves(tree: Any):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        for v in tree:
            yield from _leaves(v)


def _tree_bytes(tree: Any) -> int:
    return sum(t.numel() * t.element_size() for t in _leaves(tree))
