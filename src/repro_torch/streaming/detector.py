"""TinyDet: the cheap object detector the physical optimizer cascades
before the MLLM.

Counterpart of ``repro/streaming/detector.py``.  Three convs (4×4 stride
4, 4×4 stride 4, 3×3 stride 1) with JAX "SAME" padding per conv and a ReLU
after each, then a car-present head on the pooled features and a coarse
occupancy-grid head.  Parameter names and init are the reference's; conv
kernels are OIHW here (HWIO there), and ``repro_torch.bridge`` converts.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from repro_torch.common.device import DeviceLike, resolve_device
from repro_torch.models.param import ParamSpec, ParamTree, init_params
from repro_torch.streaming.mllm import _same_pad

#: (weight, bias, kernel, stride) of each conv, in order
CONVS = (("conv1", "b1", 4, 4), ("conv2", "b2", 4, 4), ("conv3", "b3", 3, 1))


def tinydet_spec(in_ch: int = 3) -> Dict[str, Any]:
    # fan-in as the reference counts it for HWIO kernels: the input channels
    return {
        "conv1": ParamSpec((16, in_ch, 4, 4), fan_in=in_ch),
        "b1": ParamSpec((16,), "zeros"),
        "conv2": ParamSpec((32, 16, 4, 4), fan_in=16),
        "b2": ParamSpec((32,), "zeros"),
        "conv3": ParamSpec((32, 32, 3, 3), fan_in=32),
        "b3": ParamSpec((32,), "zeros"),
        "head_present": ParamSpec((32, 2)),
        "head_grid": ParamSpec((32, 1)),
    }


class TinyDet(ParamTree):
    def __init__(self, in_ch: int = 3, device: DeviceLike = None):
        dev = resolve_device(device)
        super().__init__(tinydet_spec(in_ch), dev)
        self.in_ch = in_ch
        self.device = dev

    def init(self, generator: torch.Generator) -> "TinyDet":
        """Seeded init (reference scheme) from a CPU ``torch.Generator``."""
        init_params(self, generator)
        return self

    def forward(self, frames: torch.Tensor) -> Dict[str, torch.Tensor]:
        """frames (B, C, h, w) float -> {present (B, 2), grid (B, gh, gw)}."""
        x = frames
        for wk, bk, k, s in CONVS:
            (t, b), (l, r) = _same_pad(x.shape[2], k, s), \
                _same_pad(x.shape[3], k, s)
            x = F.conv2d(F.pad(x, (l, r, t, b)), getattr(self, wk), stride=s)
            x = F.relu(x + getattr(self, bk)[None, :, None, None])
        x = x.permute(0, 2, 3, 1)                     # (B, gh, gw, 32)
        grid = (x @ self.head_grid)[..., 0]
        present = x.mean(dim=(1, 2)) @ self.head_present
        return {"present": present, "grid": grid}

    def loss(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Mean cross-entropy of the car-present head."""
        logits = self(batch["frames"].to(self.device))["present"]
        labels = batch["present"].to(self.device).long()
        lse = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, -1, labels[:, None])[:, 0]
        return torch.mean(lse - ll)
