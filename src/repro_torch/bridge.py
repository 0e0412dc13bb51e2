"""Load the JAX package's stream-model parameters into the port's modules.

The reference's parameter tree arrives as nested dicts of **numpy** arrays
(the caller converts, e.g. ``jax.tree_util.tree_map(np.asarray, params)``;
this module never imports JAX).  Every shape is taken from the arrays, never
from a config, so a pruned variant with a smaller d_ff loads as it is.  The
leading per-period axis of the stacked backbone stays.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping

import numpy as np
import torch
from torch import nn

from repro_torch.streaming.detector import TinyDet
from repro_torch.streaming.mllm import StreamMLLM

#: reference leaves the port's MLLM does not hold: the LM backbone's token
#: embedding table, which the extract forward never reads
UNUSED = ("backbone.embed.",)
#: conv kernels: reference HWIO -> port OIHW
HWIO = ("conv1", "conv2")


def flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, Any]:
    """Nested dicts -> {dotted path: leaf}."""
    out: Dict[str, Any] = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, Mapping):
            out.update(flatten(v, key + "."))
        else:
            out[key] = v
    return out


@torch.no_grad()
def _load(model: nn.Module, flat: Dict[str, Any], hwio, device) -> None:
    """Replace every parameter of ``model`` by the array at the same dotted
    path (shape from the array); KeyError when the trees differ."""
    ours = dict(model.named_parameters())
    missing = sorted(set(ours) - set(flat))
    unknown = sorted(set(flat) - set(ours))
    if missing or unknown:
        raise KeyError(f"parameter trees differ: missing {missing}, "
                       f"unknown {unknown}")
    for key, arr in flat.items():
        a = np.asarray(arr, dtype=np.float32)
        if key in hwio:
            a = a.transpose(3, 2, 0, 1)
        owner, _, leaf = key.rpartition(".")
        module = model.get_submodule(owner) if owner else model
        setattr(module, leaf, nn.Parameter(
            torch.tensor(a, device=device), requires_grad=False))


def load_reference_params(model: StreamMLLM,
                          params: Mapping[str, Any]) -> StreamMLLM:
    """Replace every parameter of ``model`` by the reference's array at the
    same path (shape from the array), on the model's device.  Raises
    KeyError on a reference leaf the port does not hold or a port
    parameter the reference does not give."""
    flat = {k: v for k, v in flatten(params).items()
            if not k.startswith(UNUSED)}
    _load(model, flat, HWIO, model.device)
    p = model.patch // 4
    if model.patch_proj.shape[0] != model.STEM_CH * p * p:
        raise ValueError(f"patch_proj {tuple(model.patch_proj.shape)} does "
                         f"not fit patch {model.patch}")
    return model


def load_reference_pruned(model: StreamMLLM,
                          params: Mapping[str, Any]) -> StreamMLLM:
    """The pruned variant of ``model``'s architecture from the reference's
    pruned parameters (``repro.core.physical.structured_prune``): a new
    ``StreamMLLM`` whose config has the arrays' smaller d_ff, on the
    model's device."""
    d_ff = np.asarray(flatten(params)["backbone.stack.i0.mlp.w_in"]).shape[-1]
    cfg = dataclasses.replace(model.cfg, d_ff=int(d_ff))
    pruned = StreamMLLM(cfg, patch=model.patch, device=model.device,
                        in_ch=model.conv1.shape[1],
                        max_patches=model.patch_pos_emb.shape[0])
    return load_reference_params(pruned, params)


def load_reference_detector_params(det: TinyDet,
                                   params: Mapping[str, Any]) -> TinyDet:
    """TinyDet's reference parameters into ``det`` (HWIO -> OIHW convs)."""
    _load(det, flatten(params), ("conv1", "conv2", "conv3"), det.device)
    return det
