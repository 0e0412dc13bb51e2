"""Public SSD op: the whole chunked SSD, with the within-chunk terms from
the kernel (CUDA tensors) or its plain version (CPU tensors).

Counterpart of ``repro/kernels/ssd_scan/ops.py::ssd``: the cumsum of
dt·A, the kernel layout, the within-chunk terms, then the inter-chunk
recurrence and the cross-chunk term in PyTorch.  Under autograd on CUDA
tensors the within-chunk terms are ``SSDScanFn`` (the forward kernel, then
the hand-written backward); autograd differentiates the rest.
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch.autograd.function import once_differentiable

from repro_torch.kernels._build import plain_device
from repro_torch.kernels.ssd_scan.kernel import (ssd_scan_bwd_cuda,
                                                 ssd_scan_cuda)
from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref


class SSDScanFn(torch.autograd.Function):
    """The within-chunk terms' forward kernel and its hand-written backward
    (``csrc/ssd_scan_bwd.cu``) as one autograd node."""

    @staticmethod
    def forward(ctx, x, bmat, cmat, cs, dt):
        y, s = ssd_scan_cuda(x, bmat, cmat, cs, dt)
        ctx.save_for_backward(x, bmat, cmat, cs, dt)
        return y, s

    @staticmethod
    @once_differentiable
    def backward(ctx, dy, ds):
        return ssd_scan_bwd_cuda(*ctx.saved_tensors, dy.contiguous(),
                                 ds.contiguous())


def ssd_scan(x, bmat, cmat, cs, dt):
    """The within-chunk terms in kernel layout; the device picks, and on
    CUDA autograd picks the forward kernel or ``SSDScanFn``."""
    if plain_device(x):
        return ssd_scan_ref(x, bmat, cmat, cs, dt)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, bmat, cmat, cs, dt)):
        return SSDScanFn.apply(x, bmat, cmat, cs, dt)
    return ssd_scan_cuda(x, bmat, cmat, cs, dt)


def ssd(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
        bmat: torch.Tensor, cmat: torch.Tensor, d_skip: torch.Tensor, *,
        chunk: int = 256) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, L, H, P); dt (B, L, H) fp32 (softplus'd); a (H,) fp32
    (negative); bmat/cmat (B, L, G, N); d_skip (H,).  L must be a multiple
    of ``chunk`` (the model passes ``min(chunk, L)``).  x, B and C are
    upcast to fp32 around the within-chunk terms (the kernel takes fp32),
    as the reference's ``_ssd_chunked`` computes in fp32.

    Returns (y (B, L, H, P), final_state (B, H, P, N)), both in x's
    dtype."""
    b, l, h, p = x.shape
    g, n = bmat.shape[2], bmat.shape[3]
    if l % chunk:
        raise ValueError(f"ssd: length {l} is not a multiple of the chunk "
                         f"{chunk}")
    nc, q = l // chunk, chunk
    f32 = torch.float32

    da = dt * a                                             # (B, L, H)
    cs = torch.cumsum(da.reshape(b, nc, q, h), dim=2)       # (B, NC, Q, H)
    total = cs[:, :, -1, :]                                 # (B, NC, H)

    def chunks(t, heads):       # (B, L, heads, k) -> (B·NC, heads, Q, k)
        return t.reshape(b, nc, q, heads, -1).permute(0, 1, 3, 2, 4) \
            .reshape(b * nc, heads, q, -1).contiguous()

    xk = chunks(x.to(f32), h)
    bk, ck = chunks(bmat.to(f32), g), chunks(cmat.to(f32), g)
    csk = cs.permute(0, 1, 3, 2).reshape(b * nc, h, 1, q).contiguous()
    dtk = dt.reshape(b, nc, q, h).permute(0, 1, 3, 2) \
        .reshape(b * nc, h, 1, q).contiguous()

    y_diag, s_local = ssd_scan(xk, bk, ck, csk, dtk)
    y_diag = y_diag.reshape(b, nc, h, q, p)
    s_local = s_local.reshape(b, nc, h, n, p)

    # inter-chunk recurrence: the state entering each chunk
    s_prev = torch.zeros((b, h, n, p), dtype=f32, device=x.device)
    s_in = []
    for c in range(nc):
        s_in.append(s_prev)
        s_prev = torch.exp(total[:, c])[:, :, None, None] * s_prev \
            + s_local[:, c]
    s_in = torch.stack(s_in, dim=1)                         # (B, NC, H, N, P)

    # cross-chunk term
    ch = torch.repeat_interleave(cmat.reshape(b, nc, q, g, n), h // g, dim=3)
    c_decay = ch.to(f32) * torch.exp(cs)[..., None]         # (B, NC, Q, H, N)
    y_off = torch.einsum("bcqhn,bchnp->bchqp", c_decay, s_in)

    y = (y_diag + y_off).permute(0, 1, 3, 2, 4).reshape(b, l, h, p)
    y = y + d_skip.to(f32)[None, None, :, None] * x.to(f32)
    final_state = s_prev.transpose(-1, -2)                  # (B, H, P, N)
    return y.to(x.dtype), final_state.to(x.dtype)
