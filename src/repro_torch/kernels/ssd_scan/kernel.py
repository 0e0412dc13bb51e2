"""Bindings of ``csrc/ssd_scan.cu`` (see the source for the design note:
one launch writes both within-chunk terms, C·Bᵀ formed inside it) and of
its gradient, ``csrc/ssd_scan_bwd.cu`` (the training path's backward)."""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels._build import CudaKernel, require_cuda

_I, _P = ctypes.c_int, ctypes.c_void_p
KERNEL = CudaKernel("ssd_scan", "ssd_scan_f32",
                    [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I])
BWD_KERNEL = CudaKernel("ssd_scan_bwd", "ssd_scan_bwd_f32",
                        [_P] * 16 + [_I] * 6)
MAX_Q, MAX_P, MAX_N = 256, 128, 256
#: rows of the backward's tiles (``kT`` in the source): its scratch holds
#: one partial sum per tile of keys
BWD_TILE = 32


def _check(name, x, bmat, cmat, cs, dt):
    """The shapes both kernels take; returns (BC, H, G, Q, P, N)."""
    if any(t.dtype != torch.float32 for t in (x, bmat, cmat, cs, dt)):
        raise ValueError(f"{name}: the CUDA kernel takes float32")
    bc, h, q, p = x.shape
    g, n = bmat.shape[1], bmat.shape[3]
    if bmat.shape != (bc, g, q, n) or cmat.shape != bmat.shape \
            or cs.shape != (bc, h, 1, q) or dt.shape != cs.shape:
        raise ValueError(f"{name}: x {tuple(x.shape)}, B "
                         f"{tuple(bmat.shape)}, C {tuple(cmat.shape)}, cs "
                         f"{tuple(cs.shape)}, dt {tuple(dt.shape)}")
    if not (0 < q <= MAX_Q and 0 < p <= MAX_P and 0 < n <= MAX_N) \
            or h % g:
        raise ValueError(f"{name}: Q {q} (≤ {MAX_Q}), P {p} (≤ {MAX_P}),"
                         f" N {n} (≤ {MAX_N}), {h} heads over {g} groups")
    return bc, h, g, q, p, n


def ssd_scan_cuda(x: torch.Tensor, bmat: torch.Tensor, cmat: torch.Tensor,
                  cs: torch.Tensor, dt: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel layout on CUDA, fp32: x (BC, H, Q, P); bmat/cmat
    (BC, G, Q, N); cs/dt (BC, H, 1, Q) -> y_diag (BC, H, Q, P), s_local
    (BC, H, N, P).  Q ≤ 256 (any, not only multiples of a tile), P ≤ 128,
    N ≤ 256, G divides H."""
    dev = require_cuda("ssd_scan", x, bmat, cmat, cs, dt)
    bc, h, g, q, p, n = _check("ssd_scan", x, bmat, cmat, cs, dt)
    y = torch.empty((bc, h, q, p), dtype=torch.float32, device=dev)
    s = torch.empty((bc, h, n, p), dtype=torch.float32, device=dev)
    if bc:
        KERNEL.launch(dev, x.data_ptr(), bmat.data_ptr(), cmat.data_ptr(),
                      cs.data_ptr(), dt.data_ptr(), y.data_ptr(),
                      s.data_ptr(), bc, h, g, q, p, n)
    return y, s


def ssd_scan_bwd_cuda(x: torch.Tensor, bmat: torch.Tensor,
                      cmat: torch.Tensor, cs: torch.Tensor, dt: torch.Tensor,
                      dy: torch.Tensor, ds: torch.Tensor
                      ) -> Tuple[torch.Tensor, ...]:
    """The gradient of ``ssd_scan_cuda``'s outputs (y_diag, s_local) at
    (dy (BC, H, Q, P), ds (BC, H, N, P)), in the forward's layout and
    limits: (dx, dB, dC, dcs, ddt), dB and dC summed over each group's
    heads.  One call is two launches (the tiles, a block a head, then the
    sums over a group's heads and dcs's) and one launch count; scratch
    holds each head's dB and dC."""
    dev = require_cuda("ssd_scan_bwd", x, bmat, cmat, cs, dt, dy, ds)
    bc, h, g, q, p, n = _check("ssd_scan_bwd", x, bmat, cmat, cs, dt)
    if dy.shape != x.shape or ds.shape != (bc, h, n, p) \
            or dy.dtype != torch.float32 or ds.dtype != torch.float32:
        raise ValueError(f"ssd_scan_bwd: dy {tuple(dy.shape)} {dy.dtype}, "
                         f"ds {tuple(ds.shape)} {ds.dtype}")
    f32 = dict(dtype=torch.float32, device=dev)
    dx = torch.empty_like(x)
    db, dc = torch.empty_like(bmat), torch.empty_like(cmat)
    dcs, ddt = torch.empty_like(cs), torch.empty_like(dt)
    pdb, pdc = (torch.empty((bc, h, q, n), **f32) for _ in range(2))
    dcs_row = torch.empty((bc, h, q), **f32)
    esum = torch.empty((bc, h, -(-q // BWD_TILE)), **f32)
    if bc:
        BWD_KERNEL.launch(dev, *(t.data_ptr() for t in (
            x, bmat, cmat, cs, dt, dy, ds, dx, db, dc, dcs, ddt, pdb, pdc,
            dcs_row, esum)), bc, h, g, q, p, n)
    return dx, db, dc, dcs, ddt
