"""Carry the JAX package's parameters and optimizer state into the port's
modules (the stream models and the LMs), and the port's parameters back
out in the reference's layout.

The reference's trees arrive as nested dicts of **numpy** arrays (the
caller converts, e.g. ``jax.tree_util.tree_map(np.asarray, params)``; this
module never imports JAX).  Every shape is taken from the arrays, never
from a config, so a pruned variant with a smaller d_ff loads as it is.  The
leading per-period axis of the stacked backbone stays.  Conv kernels are
HWIO there and OIHW here.  Loaded parameters do not require grad (serving);
the trainer turns grad on for what it trains.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping

import numpy as np
import torch
from torch import nn

from repro_torch.models.model import LM
from repro_torch.streaming.detector import TinyDet
from repro_torch.streaming.mllm import StreamMLLM
from repro_torch.training.checkpoint import nest

#: reference leaves the port's MLLM does not hold: the LM backbone's token
#: embedding table, which the extract forward never reads
UNUSED = ("backbone.embed.",)
#: conv kernels: reference HWIO -> port OIHW (the MLLM's, TinyDet's)
HWIO = ("conv1", "conv2")
DET_HWIO = ("conv1", "conv2", "conv3")


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
    _load(det, flatten(params), DET_HWIO, det.device)
    return det


def load_reference_lm_params(lm: LM, params: Mapping[str, Any]) -> LM:
    """The reference ``LM``'s parameter tree (numpy leaves, built with
    ``tp=1``) into ``lm``, every leaf at the same dotted path, shapes from
    the arrays, on the model's device."""
    _load(lm, flatten(params), (), lm.device)
    return lm


def _hwio_keys(model: nn.Module):
    if isinstance(model, StreamMLLM):
        return HWIO
    if isinstance(model, TinyDet):
        return DET_HWIO
    return ()


def load_reference_opt_state(model: nn.Module,
                             state: Mapping[str, Any]) -> Dict[str, Any]:
    """The reference's AdamW state (``{"moments": tree, "step": n}``, numpy
    leaves; fp32 moments ``m``/``v`` or int8 ``m_q``/``m_s``/``v_q``/
    ``v_s``) in the port's layout (``training/optimizer.py``): moments by
    dotted parameter name, on the model's device, the step an int32
    tensor.  A conv kernel's fp32 moments are transposed HWIO -> OIHW;
    its int8 moments raise, since their row scales run along O there and
    along W here."""
    hwio = _hwio_keys(model)
    ours = dict(model.named_parameters())
    moments: Dict[str, Dict[str, torch.Tensor]] = {}
    for name, p in ours.items():
        node: Any = state["moments"]
        for part in name.split("."):
            node = node[part]
        leaf = {}
        for key, arr in node.items():
            a = np.asarray(arr)
            if name in hwio:
                if key not in ("m", "v"):
                    raise ValueError(
                        f"{name}: int8 moments of a conv kernel have row "
                        "scales along another axis in each package")
                a = a.transpose(3, 2, 0, 1)
            leaf[key] = torch.tensor(a, device=p.device)
        moments[name] = leaf
    return {"moments": moments,
            "step": torch.tensor(int(np.asarray(state["step"])),
                                 dtype=torch.int32, device=model.device)}


def reference_params(model: nn.Module) -> Dict[str, Any]:
    """The port's parameters as the reference's nested tree of numpy
    arrays (conv kernels OIHW -> HWIO), e.g. to hand trained weights to the
    JAX package."""
    hwio = _hwio_keys(model)
    return nest({name: p.detach().cpu().numpy().transpose(2, 3, 1, 0)
                 if name in hwio else p.detach().cpu().numpy()
                 for name, p in model.named_parameters()})
