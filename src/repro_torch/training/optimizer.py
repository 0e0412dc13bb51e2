"""AdamW with optional int8 row-quantized moments.

Counterpart of ``repro/training/optimizer.py``: linear warm-up + cosine
learning rate, global-norm clipping, decoupled weight decay on matrices
only, and the int8 moments with a per-last-axis-row fp32 scale (the second
moment through the fourth-root map), ~2 B a parameter instead of 8.

The parameters are a mapping ``{dotted name: tensor}`` (a module's
``named_parameters()``), updated in place (the reference returns new
ones).  State layout, as the reference's per leaf:
  fp32 moments:  {"m": f32[shape], "v": f32[shape]}
  int8 moments:  {"m_q": i8[shape], "m_s": f32[shape[:-1] + (1,)],
                  "v_q": i8[shape], "v_s": f32[shape[:-1] + (1,)]}
in ``state["moments"][name]``, plus the int32 step counter
``state["step"]``.  Every leaf is updated every step, as in the reference:
a gradient of ``None`` counts as zeros (m and v decay and weight decay
applies), which ``torch.optim`` would skip.

Memory: a leaf is updated in slices along its leading axis of at most
``CHUNK`` elements (a stacked leaf one period or less at a time).  The
scales run along the last axis, so the sliced update equals the whole
one; the dequantized moments and temporaries of one slice stay small
beside a 6.3 GB leaf.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Iterator, Mapping, Optional, Tuple

import torch

#: elements of a leaf updated at once
CHUNK = 1 << 24


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    quantized_state: bool = False
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def lr_schedule(cfg: OptimizerConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warm-up + cosine decay, in fp32."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * cos


# ---------------------------------------------------------------------------
# int8 row quantization of moments
# ---------------------------------------------------------------------------

def _q8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-last-axis-row linear symmetric int8 (the signed first moment)."""
    s = torch.clamp(torch.amax(torch.abs(x), dim=-1, keepdim=True),
                    min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / s), -127, 127).to(torch.int8)
    return q, s.to(torch.float32)


def _dq8(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * s


def _q8_v(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Int8 for the second moment: linear in u = v ** 0.25, so a small v
    beside a large one in its row keeps ~(1/127)^4 relative resolution."""
    return _q8(torch.sqrt(torch.sqrt(torch.clamp(x, min=0.0))))


def _dq8_v(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    u = _dq8(q, s)
    u2 = u * u
    return u2 * u2


# ---------------------------------------------------------------------------
# init / update
# ---------------------------------------------------------------------------

def _quantized(cfg: OptimizerConfig, p: torch.Tensor) -> bool:
    return cfg.quantized_state and p.dim() >= 2


def adamw_init(params: Mapping[str, torch.Tensor],
               cfg: OptimizerConfig) -> Dict[str, Any]:
    """Zero moments for every parameter, on its device, and step 0."""
    moments: Dict[str, Dict[str, torch.Tensor]] = {}
    for name, p in params.items():
        if _quantized(cfg, p):
            srow = p.shape[:-1] + (1,)
            moments[name] = {
                "m_q": torch.zeros(p.shape, dtype=torch.int8,
                                   device=p.device),
                "m_s": torch.zeros(srow, device=p.device),
                "v_q": torch.zeros(p.shape, dtype=torch.int8,
                                   device=p.device),
                "v_s": torch.zeros(srow, device=p.device)}
        else:
            moments[name] = {"m": torch.zeros(p.shape, device=p.device),
                             "v": torch.zeros(p.shape, device=p.device)}
    device = next(iter(params.values())).device if params else None
    return {"moments": moments,
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def _order(params: Mapping[str, torch.Tensor]):
    """Parameter names in the reference's tree order (sorted by path)."""
    return sorted(params, key=lambda n: n.split("."))


def _slices(p: torch.Tensor) -> Iterator[slice]:
    """Slices of the leading axis, each at most ``CHUNK`` elements (at
    least one row), covering ``p``; one slice for a 0-d or 1-d leaf."""
    if p.dim() < 2 or p.numel() <= CHUNK:
        yield slice(None)
        return
    rows = max(1, CHUNK // (p.numel() // p.shape[0]))
    for a in range(0, p.shape[0], rows):
        yield slice(a, a + rows)


def _global_norm(grads: Mapping[str, Optional[torch.Tensor]], names,
                 device) -> torch.Tensor:
    total = torch.zeros((), device=device)
    for name in names:
        g = grads.get(name)
        if g is None:
            continue
        leaf = torch.zeros((), device=device)
        for sl in _slices(g):
            leaf = leaf + torch.sum(torch.square(g[sl].to(torch.float32)))
        total = total + leaf
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(params: Mapping[str, torch.Tensor],
                 grads: Mapping[str, Optional[torch.Tensor]],
                 state: Dict[str, Any], cfg: OptimizerConfig
                 ) -> Tuple[Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step: ``params`` and ``state``'s moments are updated in
    place.  ``grads[name]`` may be ``None`` (zeros).  Returns (state with
    the advanced step, {"grad_norm", "lr"})."""
    names = _order(params)
    device = state["step"].device
    step = state["step"] + 1
    lr = lr_schedule(cfg, step)
    gnorm = _global_norm(grads, names, device)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12),
                        max=1.0)
    stepf = step.to(torch.float32)
    bc1 = 1 - torch.pow(torch.tensor(cfg.b1, device=device), stepf)
    bc2 = 1 - torch.pow(torch.tensor(cfg.b2, device=device), stepf)
    for name in names:
        p, g, mom = params[name], grads.get(name), state["moments"][name]
        quant = _quantized(cfg, p)
        for sl in _slices(p):
            gs = (torch.zeros(p[sl].shape, device=p.device) if g is None
                  else g[sl].to(torch.float32) * scale)
            if quant:
                m = _dq8(mom["m_q"][sl], mom["m_s"][sl])
                v = _dq8_v(mom["v_q"][sl], mom["v_s"][sl])
            else:
                m, v = mom["m"][sl], mom["v"][sl]
            m = cfg.b1 * m + (1 - cfg.b1) * gs
            v = cfg.b2 * v + (1 - cfg.b2) * torch.square(gs)
            delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
            if p.dim() >= 2:     # decoupled weight decay on matrices only
                delta = delta + cfg.weight_decay * p[sl].to(torch.float32)
            p[sl] = (p[sl].to(torch.float32) - lr * delta).to(p.dtype)
            if quant:
                for key, (q, s) in (("m", _q8(m)), ("v", _q8_v(v))):
                    mom[f"{key}_q"][sl] = q
                    mom[f"{key}_s"][sl] = s
            else:
                mom["m"][sl] = m
                mom["v"][sl] = v
    new_state = {"moments": state["moments"], "step": step}
    return new_state, {"grad_norm": gnorm, "lr": lr}
