"""Int8 weight quantization of an LM's parameter tree.

Counterpart of ``repro/serving/quantize.py``: the large matmul weights
(two or more axes, at least ``MIN_QUANT_SIZE`` elements) become symmetric
int8 codes with one scale per last-axis channel, taken over all other axes
(a stacked ``(P, K, ..., N)`` leaf gets a ``(1, ..., 1, N)`` scale); norms
and other small tensors stay as they are.  A quantized leaf is the dict
``{"__quant__": True, "q": int8, "scale": f32}``.

The tree is the nested dict of tensors that ``LM.tree()`` returns (the
reference's parameter tree, key for key).  On the card, a quantized
weight's codes and scale are the operands of
``kernels/int8_matmul/ops.py::matmul_int8_dynamic`` (a layer slice
reshaped to (K, N)); ``dequantize_params`` rebuilds dense weights, which
the engine serves as the reference's does.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import torch

from repro_torch.common.utils import tree_size_bytes

MIN_QUANT_SIZE = 4096  # don't quantize tiny tensors (norms, biases)


def _quantize_leaf(w: torch.Tensor) -> Any:
    if w.dim() < 2 or w.numel() < MIN_QUANT_SIZE:
        return w
    amax = w.abs().amax(dim=tuple(range(w.dim() - 1)), keepdim=True)
    # a tensor divisor, so the card divides as the CPU does (see
    # kernels/int8_matmul/ref.py::_quantize)
    scale = torch.clamp(amax, min=1e-8) / torch.full((), 127.0,
                                                     device=w.device)
    # in place after the division: a full-width stacked leaf is GBs
    q = (w / scale).round_().clamp_(-127, 127).to(torch.int8)
    return {"__quant__": True, "q": q, "scale": scale.to(torch.float32)}


def is_quant(x: Any) -> bool:
    return isinstance(x, Mapping) and x.get("__quant__") is True


def _map(fn, tree: Any) -> Any:
    if isinstance(tree, Mapping) and not is_quant(tree):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def quantize_params_int8(params: Any) -> Tuple[Any, Dict[str, float]]:
    """Returns (quantized tree, {orig_bytes, quant_bytes, ratio})."""
    orig = tree_size_bytes(params)
    qparams = _map(_quantize_leaf, params)
    quant = tree_size_bytes(qparams)
    return qparams, {
        "orig_bytes": float(orig),
        "quant_bytes": float(quant),
        "ratio": float(quant) / max(float(orig), 1.0),
    }


def dequantize_params(qparams: Any, dtype=torch.float32) -> Any:
    """Dense weights ``q * scale`` in ``dtype``; other leaves unchanged."""
    def deq(x):
        if is_quant(x):
            return x["q"].to(torch.float32).mul_(x["scale"]).to(dtype)
        return x

    return _map(deq, qparams)
