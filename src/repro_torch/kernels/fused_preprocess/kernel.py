"""Binding of ``csrc/fused_preprocess.cu`` (see the source for the design
note).  ``preprocess_plan`` makes the launch's geometry on the host: the
wrapper launches from it and the CPU tests replay it."""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, Tuple

import torch

from repro_torch.kernels._build import CudaKernel, require_cuda

#: outputs a thread makes, consecutive in one row (kV in the source)
V = 4
#: the block size a band is sized for
THREADS = 256
#: the most threads a block takes (kMaxThreads in the source: its launch
#: bounds leave a thread 128 registers, which grey at f 4 needs)
MAX_THREADS = 512
#: dynamic shared memory a block may take: the H100's opt-in maximum of
#: 227 KB (232448 bytes) less 1 KB
SMEM_BUDGET = 232448 - 1024
#: the H100 SXM's SMs: the plan's default, what the CPU tests replay
H100_SMS = 132
#: the grid's frame dimension; more frames are looped over by its blocks
MAX_GRID_Y = 65535

_I, _F = ctypes.c_int, ctypes.c_float
KERNEL = CudaKernel("fused_preprocess", "fused_preprocess_u8",
                    [ctypes.c_void_p, ctypes.c_void_p]
                    + [_I] * 16 + [_F] * 8)


def preprocess_plan(shape: Tuple[int, int, int, int],
                    crop: Tuple[int, int, int, int], factor: int,
                    grey: bool, *, sms: int = H100_SMS,
                    align: int = 16) -> Dict[str, object]:
    """The launch for (B, C, H, W) uint8 frames whose data pointer is
    aligned to ``align`` bytes, on a card of ``sms`` SMs.

    A block takes ``rows`` output rows (a band) of every output channel of
    one frame: block (``tx``, ``rows``, C') threads, at most
    ``MAX_THREADS``, grid (bands, min(B, 65535)).  Its thread (x, y, z)
    makes the outputs ``V`` at a time from column ``V * x`` of row y of the
    band, channel z, stepping by ``V * tx``.  The block stages the band's
    source rows of every channel in shared memory first: ``words`` words
    of ``unit`` bytes a row from column ``xa`` (``unit`` the widest of 16,
    4, 1 bytes that the frame's width and address allow, ``xa`` the column
    at or below x0 aligned to it), ``pitch`` bytes apart, ``smem`` bytes in
    all.  ``rows`` is as
    many as keep a block at ``THREADS`` threads, then fewer until the grid
    has a block for every SM (or one row a band), within ``SMEM_BUDGET``.
    Raises ``ValueError`` when one output row's source rows of every
    channel exceed the budget."""
    b, c, h, w = shape
    y0, x0, ch, cw = crop
    f = factor
    ho, wo = ch // f, cw // f
    cout = 1 if grey else c
    tx = min(-(-wo // V), MAX_THREADS // cout)
    unit = next(u for u in (16, 4, 1) if w % u == 0 and align % u == 0)
    xa = x0 - x0 % unit
    words = -(-(x0 - xa + cw) // unit)
    pitch = -(-(words * unit) // 16) * 16
    row_bytes = c * f * pitch
    if row_bytes > SMEM_BUDGET:
        raise ValueError(
            f"fused_preprocess: one output row's source rows take "
            f"{row_bytes} bytes of shared memory ({c} channels x {f} rows x "
            f"{pitch} bytes), above the budget of {SMEM_BUDGET} bytes")
    most = max(1, min(ho, THREADS // (tx * cout), SMEM_BUDGET // row_bytes))
    rows = next((r for r in range(most, 0, -1) if b * -(-ho // r) >= sms), 1)
    return dict(rows=rows, grid=(-(-ho // rows), min(b, MAX_GRID_Y)),
                tx=tx, block=(tx, rows, cout), threads=tx * rows * cout,
                xa=xa, words=words, unit=unit, pitch=pitch,
                smem=c * rows * f * pitch, v=V, vec=wo % V == 0)


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def fused_preprocess_cuda(
    frames: torch.Tensor, *, crop: Tuple[int, int, int, int],
    factor: int = 1, mean: Tuple[float, ...] = (0.5, 0.5, 0.5),
    std: Tuple[float, ...] = (0.25, 0.25, 0.25), grey: bool = False,
) -> torch.Tensor:
    """frames (B, C, H, W) uint8 on CUDA -> (B, C', h/f, w/f) f32.

    Takes every crop inside the frame whose height and width divide by
    ``factor`` (what the plain version takes)."""
    dev = require_cuda("fused_preprocess", frames)
    if frames.dtype != torch.uint8 or frames.dim() != 4:
        raise ValueError("fused_preprocess: the CUDA kernel takes uint8 "
                         "(B, C, H, W) frames")
    b, c, h, w = frames.shape
    y0, x0, ch, cw = crop
    f = factor
    if not (0 <= y0 and 0 <= x0 and y0 + ch <= h and x0 + cw <= w
            and ch > 0 and cw > 0):
        raise ValueError(f"fused_preprocess: crop {crop} outside {h}x{w}")
    if f <= 0 or ch % f or cw % f:
        raise ValueError(f"fused_preprocess: crop {ch}x{cw} not divisible "
                         f"by factor {f}")
    if c > 4 or len(mean) != c or len(std) != c:
        raise ValueError("fused_preprocess: one mean/std per channel, "
                         "at most 4 channels")
    if grey and c != 3:
        raise ValueError("fused_preprocess: greyscale needs 3 channels")
    out = torch.empty((b, 1 if grey else c, ch // f, cw // f),
                      dtype=torch.float32, device=dev)
    if b:
        plan = preprocess_plan(tuple(frames.shape), tuple(crop), f,
                               bool(grey), sms=_sms(dev.index),
                               align=math.gcd(frames.data_ptr(), 16))
        m = list(mean) + [0.0] * (4 - c)
        s = list(std) + [1.0] * (4 - c)
        KERNEL.launch(dev, frames.data_ptr(), out.data_ptr(), b, c, h, w,
                      y0, x0, ch, cw, f, int(grey), plan["rows"], plan["tx"],
                      plan["xa"], plan["words"], plan["unit"], plan["pitch"],
                      *m, *s)
    return out
