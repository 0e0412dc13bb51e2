"""Public fused preprocessing op: the input's device picks kernel or plain
version."""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels._build import plain_device
from repro_torch.kernels.fused_preprocess.kernel import fused_preprocess_cuda
from repro_torch.kernels.fused_preprocess.ref import fused_preprocess_ref


def fused_preprocess(frames: torch.Tensor, *,
                     crop: Tuple[int, int, int, int], factor: int = 1,
                     mean: Tuple[float, ...] = (0.5, 0.5, 0.5),
                     std: Tuple[float, ...] = (0.25, 0.25, 0.25),
                     grey: bool = False) -> torch.Tensor:
    fn = fused_preprocess_ref if plain_device(frames) \
        else fused_preprocess_cuda
    return fn(frames, crop=crop, factor=factor, mean=mean, std=std,
              grey=grey)
