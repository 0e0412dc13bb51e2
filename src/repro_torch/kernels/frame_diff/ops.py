"""Public frame-diff op: the input's device picks kernel or plain version."""
from __future__ import annotations

import torch

from repro_torch.kernels._build import plain_device
from repro_torch.kernels.frame_diff.kernel import frame_diff_cuda
from repro_torch.kernels.frame_diff.ref import frame_diff_ref


def frame_diff(cur: torch.Tensor, prev: torch.Tensor, *,
               regions=(4, 4)) -> torch.Tensor:
    if plain_device(cur):
        return frame_diff_ref(cur, prev, regions=regions)
    return frame_diff_cuda(cur, prev, regions=regions)
