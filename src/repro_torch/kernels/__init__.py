"""Hand-written Hopper kernels for the stream processor's and the served
LMs' hot spots.

Each kernel directory mirrors ``repro/kernels/<name>/``:
  kernel.py — the ``ctypes`` binding of ``csrc/<name>.cu`` (CUDA C++ for
              ``sm_90a``, built at first use by ``_build.py``), with its
              launch count
  ops.py    — the public wrapper the operators and models call
  ref.py    — the plain PyTorch version of the same function

Every Pallas kernel of the JAX package has its counterpart here:
  frame_diff       — per-region mean |cur − prev| / 255 (the Skip operator)
  fused_preprocess — crop + area downscale + normalize (+ greyscale)
  flash_attention  — causal/local GQA attention with online softmax
                     (the MLLM extract's attention), and its backward
                     (``csrc/flash_attention_bwd.cu``, no Pallas
                     counterpart: the training path's gradient); fp32
                     and bf16 (``flash_attention_bf16``, its lse forward
                     and ``flash_attention_bwd_bf16``)
  fused_prefix     — a plan's whole pixel prefix (diff grid, colour
                     fractions, crop/preprocess, signature) in one pass
  decode_attention — one query token per sequence against its KV cache
                     (splits of the live keys merged by logsumexp in
                     one launch; the served LMs' decode step); fp32 and
                     bf16 (``decode_attention_bf16``)
  ssd_scan         — Mamba2's within-chunk SSD terms (the served SSMs'
                     prefill), and their backward (``csrc/ssd_scan_bwd.cu``,
                     no Pallas counterpart: the Mamba2 layers' training
                     gradient)
  int8_matmul      — int8 x int8 product with int32 accumulation and row /
                     column scales (``serving/quantize.py``'s int8 weights)

Dispatch rule (every ops.py wrapper follows it, through
``_build.plain_device``): the device of the input tensor decides.  A CPU
tensor takes the plain version in ``ref.py``; a ``meta`` tensor (shapes
without storage: the dry run, ``launch/dryrun.py``) takes it too, which
computes nothing there, so no work moves from the card; a CUDA tensor
launches the kernel or raises.  Nothing falls back from one to the other,
and nothing looks at which hardware the host has.  Only
flash_attention and ssd_scan take inputs that require grad on the card
(their ``autograd.Function``s); every other kernel refuses them.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.kernels._build import REGISTRY, build
from repro_torch.kernels.decode_attention import kernel as _decode  # noqa: F401
from repro_torch.kernels.flash_attention import kernel as _flash  # noqa: F401
from repro_torch.kernels.frame_diff import kernel as _diff  # noqa: F401
from repro_torch.kernels.fused_prefix import kernel as _prefix  # noqa: F401
from repro_torch.kernels.fused_preprocess import kernel as _prep  # noqa: F401
from repro_torch.kernels.int8_matmul import kernel as _int8  # noqa: F401
from repro_torch.kernels.ssd_scan import kernel as _ssd  # noqa: F401


def launch_counts() -> Dict[str, int]:
    """Launches of every bound kernel since the last reset."""
    return {name: k.launches for name, k in REGISTRY.items()}


def reset_launch_counts() -> None:
    for k in REGISTRY.values():
        k.launches = 0


__all__ = ["build", "launch_counts", "reset_launch_counts"]
