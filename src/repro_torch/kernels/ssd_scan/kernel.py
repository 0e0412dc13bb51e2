"""Binding of ``csrc/ssd_scan.cu`` (see the source for the design note):
one launch writes both within-chunk terms, C·Bᵀ formed inside it."""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels._build import CudaKernel, require_cuda

_I, _P = ctypes.c_int, ctypes.c_void_p
KERNEL = CudaKernel("ssd_scan", "ssd_scan_f32",
                    [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I])
MAX_Q, MAX_P, MAX_N = 256, 128, 256


def ssd_scan_cuda(x: torch.Tensor, bmat: torch.Tensor, cmat: torch.Tensor,
                  cs: torch.Tensor, dt: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel layout on CUDA, fp32: x (BC, H, Q, P); bmat/cmat
    (BC, G, Q, N); cs/dt (BC, H, 1, Q) -> y_diag (BC, H, Q, P), s_local
    (BC, H, N, P).  Q ≤ 256 (any, not only multiples of a tile), P ≤ 128,
    N ≤ 256, G divides H."""
    dev = require_cuda("ssd_scan", x, bmat, cmat, cs, dt)
    if any(t.dtype != torch.float32 for t in (x, bmat, cmat, cs, dt)):
        raise ValueError("ssd_scan: the CUDA kernel takes float32")
    bc, h, q, p = x.shape
    g, n = bmat.shape[1], bmat.shape[3]
    if bmat.shape != (bc, g, q, n) or cmat.shape != bmat.shape \
            or cs.shape != (bc, h, 1, q) or dt.shape != cs.shape:
        raise ValueError(f"ssd_scan: x {tuple(x.shape)}, B "
                         f"{tuple(bmat.shape)}, C {tuple(cmat.shape)}, cs "
                         f"{tuple(cs.shape)}, dt {tuple(dt.shape)}")
    if not (0 < q <= MAX_Q and 0 < p <= MAX_P and 0 < n <= MAX_N) \
            or h % g:
        raise ValueError(f"ssd_scan: Q {q} (≤ {MAX_Q}), P {p} (≤ {MAX_P}),"
                         f" N {n} (≤ {MAX_N}), {h} heads over {g} groups")
    y = torch.empty((bc, h, q, p), dtype=torch.float32, device=dev)
    s = torch.empty((bc, h, n, p), dtype=torch.float32, device=dev)
    if bc:
        KERNEL.launch(dev, x.data_ptr(), bmat.data_ptr(), cmat.data_ptr(),
                      cs.data_ptr(), dt.data_ptr(), y.data_ptr(),
                      s.data_ptr(), bc, h, g, q, p, n)
    return y, s
