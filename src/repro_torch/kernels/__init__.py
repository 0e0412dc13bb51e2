"""Hand-written Hopper kernels for the stream processor's hot spots.

Each kernel directory mirrors ``repro/kernels/<name>/``:
  kernel.py — the ``ctypes`` binding of ``csrc/<name>.cu`` (CUDA C++ for
              ``sm_90a``, built at first use by ``_build.py``), with its
              launch count
  ops.py    — the public wrapper the operators and models call
  ref.py    — the plain PyTorch version of the same function

Ported so far (the rest of ``repro/kernels/`` waits for later slices):
  frame_diff       — per-region mean |cur − prev| / 255 (the Skip operator)
  fused_preprocess — crop + area downscale + normalize (+ greyscale)
  flash_attention  — causal/local GQA attention with online softmax
                     (the MLLM extract's attention)
  fused_prefix     — a plan's whole pixel prefix (diff grid, colour
                     fractions, crop/preprocess, signature) in one pass

Dispatch rule (every ops.py wrapper follows it): the device of the input
tensor decides.  A CPU tensor takes the plain version in ``ref.py``; a CUDA
tensor launches the kernel or raises.  Nothing falls back from one to the
other, and nothing looks at which hardware the host has.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.kernels._build import REGISTRY, build
from repro_torch.kernels.flash_attention import kernel as _flash  # noqa: F401
from repro_torch.kernels.frame_diff import kernel as _diff  # noqa: F401
from repro_torch.kernels.fused_prefix import kernel as _prefix  # noqa: F401
from repro_torch.kernels.fused_preprocess import kernel as _prep  # noqa: F401


def launch_counts() -> Dict[str, int]:
    """Launches of every bound kernel since the last reset."""
    return {name: k.launches for name, k in REGISTRY.items()}


def reset_launch_counts() -> None:
    for k in REGISTRY.values():
        k.launches = 0


__all__ = ["build", "launch_counts", "reset_launch_counts"]
