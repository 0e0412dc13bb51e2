"""Parameter specs: one tree describes shapes and init, as in the reference.

Counterpart of ``repro/models/param.py``.  A spec tree is a nested dict
whose leaves are ``ParamSpec``.  ``ParamTree`` turns it into an
``nn.Module`` whose parameter names are the tree's paths joined with dots
(``backbone.stack.i0.mixer.wq``), so the reference's parameter tree maps onto
it key for key (``repro_torch.bridge``).  ``init_params`` fills it with the
reference's init scheme from an explicit ``torch.Generator``; the numbers
differ from ``jax.random``'s, the distributions do not.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn


@dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    init: str = "fan_in"  # fan_in | normal | zeros | ones | small
    scale: float = 1.0
    #: fan-in override, for layouts where it is not the second-to-last dim
    #: (conv kernels are stored OIHW here, HWIO in the reference)
    fan_in: Optional[int] = None


def stack(spec: Any, n: int) -> Any:
    """Add a leading per-period dimension of size n to every param."""
    if isinstance(spec, ParamSpec):
        return ParamSpec((n,) + spec.shape, spec.init, spec.scale,
                         spec.fan_in)
    return {k: stack(v, n) for k, v in spec.items()}


class ParamTree(nn.Module):
    """Nested parameters built from a spec tree (uninitialised)."""

    def __init__(self, spec: Dict[str, Any], device: torch.device):
        super().__init__()
        self._specs: Dict[str, ParamSpec] = {}
        for name, s in spec.items():
            if isinstance(s, ParamSpec):
                self._specs[name] = s
                self.register_parameter(name, nn.Parameter(
                    torch.empty(s.shape, device=device),
                    requires_grad=False))
            else:
                self.add_module(name, ParamTree(s, device))

    def tree(self) -> Dict[str, Any]:
        """The parameters as a nested dict of tensors."""
        out: Dict[str, Any] = {n: getattr(self, n) for n in self._specs}
        for n, child in self.named_children():
            if isinstance(child, ParamTree):
                out[n] = child.tree()
        return out

    def specs(self) -> Dict[str, ParamSpec]:
        """Dotted parameter name -> its spec."""
        out = dict(self._specs)
        for n, child in self.named_children():
            if isinstance(child, ParamTree):
                out.update({f"{n}.{k}": s for k, s in child.specs().items()})
        return out


def _init_one(s: ParamSpec, gen: torch.Generator) -> torch.Tensor:
    if s.init == "zeros":
        return torch.zeros(s.shape, device=gen.device)
    if s.init == "ones":
        return torch.ones(s.shape, device=gen.device)
    noise = torch.randn(s.shape, generator=gen, device=gen.device)
    if s.init == "small":
        return (0.02 * s.scale) * noise
    if s.init == "normal":
        return s.scale * noise
    fan_in = s.fan_in or (s.shape[-2] if len(s.shape) >= 2 else s.shape[-1])
    return (s.scale / math.sqrt(max(fan_in, 1))) * noise


@torch.no_grad()
def init_params(tree: ParamTree, generator: torch.Generator) -> None:
    """Fill every parameter in name order.  The numbers are drawn from
    ``generator`` on its device and copied to the parameters' device: a CPU
    generator gives the same weights on every device; a CUDA generator
    draws a full-width model in a fraction of the time, with other
    numbers."""
    params = dict(tree.named_parameters())
    for name, s in sorted(tree.specs().items()):
        params[name].copy_(_init_one(s, generator))
