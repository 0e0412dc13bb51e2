"""Parameter specs: one tree describes shapes, logical axes and init, as
in the reference.

Counterpart of ``repro/models/param.py``.  A spec tree is a nested dict
whose leaves are ``ParamSpec``.  From it: ``axes_tree`` (each leaf's
logical axes, for ``common/sharding.py``), ``abstract`` (tensors on the
``meta`` device, the reference's ``ShapeDtypeStruct``s: shapes and dtypes,
no storage), ``count_params``, and ``ParamTree``, which turns it into an
``nn.Module`` whose parameter names are the tree's paths joined with dots
(``backbone.stack.i0.mixer.wq``), so the reference's parameter tree maps onto
it key for key (``repro_torch.bridge``).  ``init_params`` fills it with the
reference's init scheme from an explicit ``torch.Generator``; the numbers
differ from ``jax.random``'s, the distributions do not.  A leaf may be
held in a lower precision (``ParamTree(..., dtypes=...)``: an LM served in
bf16); it is still drawn in fp32 and then rounded.

``cast_step`` is the reference trainer's ``REPRO_CAST_BF16_STEP``: while it
is active, ``step_cast`` gives every fp32 leaf of two or more dims (by the
stacked leaf's dims for a period's slice) as a bf16 copy inside autograd,
whose gradient is rounded to bf16 on its way back into the fp32 leaf, as
the transpose of JAX's convert.
"""
from __future__ import annotations

import contextlib
import contextvars
import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import torch
from torch import nn

#: the most values of a low-precision leaf drawn in fp32 at once
INIT_CHUNK = 1 << 28
#: the cast step's dtype while ``cast_step`` is active, else None
_STEP_DTYPE: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_step_dtype", default=None)


@contextlib.contextmanager
def cast_step(dtype: torch.dtype = torch.bfloat16) -> Iterator[None]:
    """Within the block, ``step_cast`` casts the leaves the reference's
    cast step casts to ``dtype``."""
    token = _STEP_DTYPE.set(dtype)
    try:
        yield
    finally:
        _STEP_DTYPE.reset(token)


def step_cast(w: torch.Tensor, ndim: Optional[int] = None) -> torch.Tensor:
    """``w`` in the cast step's dtype where the step casts it: an fp32 leaf
    of ``ndim`` (default ``w.dim()``; a period's slice passes its stacked
    leaf's) two or more; else ``w``."""
    dtype = _STEP_DTYPE.get()
    if dtype is None or w.dtype != torch.float32 or \
            (w.dim() if ndim is None else ndim) < 2:
        return w
    return w.to(dtype)


@dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    init: str = "fan_in"  # fan_in | normal | zeros | ones | small
    scale: float = 1.0
    #: fan-in override, for layouts where it is not the second-to-last dim
    #: (conv kernels are stored OIHW here, HWIO in the reference)
    fan_in: Optional[int] = None
    #: logical axis names, one a dim (None: that dim, or all, unnamed); a
    #: leaf stored in another layout than the reference's names its dims
    #: in this one
    axes: Optional[Tuple[Optional[str], ...]] = None

    def __post_init__(self):
        if self.axes is not None:
            assert len(self.axes) == len(self.shape), (self.shape, self.axes)

    @property
    def logical_axes(self) -> Tuple[Optional[str], ...]:
        return self.axes if self.axes is not None else \
            (None,) * len(self.shape)


def stack(spec: Any, n: int) -> Any:
    """Add a leading per-period dimension of size n ("layers") to every
    param."""
    if isinstance(spec, ParamSpec):
        return ParamSpec((n,) + spec.shape, spec.init, spec.scale,
                         spec.fan_in, ("layers",) + spec.logical_axes)
    return {k: stack(v, n) for k, v in spec.items()}


def _map_specs(fn: Callable[[ParamSpec], Any], spec: Any) -> Any:
    if isinstance(spec, ParamSpec):
        return fn(spec)
    return {k: _map_specs(fn, v) for k, v in spec.items()}


def axes_tree(spec: Any) -> Any:
    """Each leaf's logical axes, in the spec's tree."""
    return _map_specs(lambda p: p.logical_axes, spec)


def abstract(spec: Any, dtype: torch.dtype = torch.float32) -> Any:
    """Each leaf as a tensor on the ``meta`` device: its shape and
    ``dtype``, no storage."""
    return _map_specs(lambda p: torch.empty(p.shape, dtype=dtype,
                                            device="meta"), spec)


def count_params(spec: Any) -> int:
    if isinstance(spec, ParamSpec):
        return math.prod(spec.shape)
    return sum(count_params(v) for v in spec.values())


class ParamTree(nn.Module):
    """Nested parameters built from a spec tree (uninitialised), fp32, or
    ``dtypes(dotted name)`` where that gives a dtype (None: fp32)."""

    def __init__(self, spec: Dict[str, Any], device: torch.device,
                 dtypes: Optional[Callable[[str], Optional[torch.dtype]]]
                 = None, prefix: str = ""):
        super().__init__()
        self._specs: Dict[str, ParamSpec] = {}
        for name, s in spec.items():
            if isinstance(s, ParamSpec):
                self._specs[name] = s
                dtype = (dtypes and dtypes(prefix + name)) or torch.float32
                self.register_parameter(name, nn.Parameter(
                    torch.empty(s.shape, device=device, dtype=dtype),
                    requires_grad=False))
            else:
                self.add_module(name, ParamTree(s, device, dtypes,
                                                f"{prefix}{name}."))

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
    numbers.  A leaf held in a lower precision is drawn in fp32 and
    rounded (``copy_``), in slices of its leading axis of at most
    ``INIT_CHUNK`` values (a whole fp32 draw of moonshot's stacked experts
    would be 35 GB), so a leaf of more values than that has other numbers
    than an fp32 leaf at the same seed."""
    params = dict(tree.named_parameters())
    for name, s in sorted(tree.specs().items()):
        p = params[name]
        if p.dtype == torch.float32 or p.dim() < 2:
            p.copy_(_init_one(s, generator))
            continue
        fan_in = s.fan_in or (s.shape[-2] if len(s.shape) >= 2
                              else s.shape[-1])
        rows = max(1, INIT_CHUNK // max(1, math.prod(s.shape[1:])))
        for i in range(0, s.shape[0], rows):
            part = ParamSpec((min(rows, s.shape[0] - i),) + s.shape[1:],
                             s.init, s.scale, fan_in)
            p[i:i + rows].copy_(_init_one(part, generator))
