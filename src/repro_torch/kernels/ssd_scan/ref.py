"""Plain PyTorch version of the within-chunk SSD terms (kernel layout)."""
from __future__ import annotations

from typing import Tuple

import torch


def ssd_scan_ref(x: torch.Tensor, bmat: torch.Tensor, cmat: torch.Tensor,
                 cs: torch.Tensor, dt: torch.Tensor, *,
                 dtype: torch.dtype = torch.float32
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (BC, H, Q, P); bmat/cmat (BC, G, Q, N); cs/dt (BC, H, 1, Q).

    Returns y_diag (BC, H, Q, P) = ((C·Bᵀ) ∘ L)·diag(dt)·X with
    L[i, j] = exp(cs_i − cs_j)·1[i ≥ j], and s_local (BC, H, N, P) =
    Bᵀ·diag(exp(cs_Q − cs)·dt)·X, in fp32 (``dtype``: float64 for a
    witness of the arithmetic).  Head h reads group
    h // (H / G).  Only i ≥ j is exponentiated, so autograd's gradients
    stay finite where cs_j − cs_i passes exp's range (about 88)."""
    bc, h, q, p = x.shape
    rep = h // bmat.shape[1]
    f32 = dtype
    bh = torch.repeat_interleave(bmat, rep, dim=1).to(f32)  # (BC, H, Q, N)
    ch = torch.repeat_interleave(cmat, rep, dim=1).to(f32)
    cs2 = cs[:, :, 0, :].to(f32)                             # (BC, H, Q)
    dt2 = dt[:, :, 0, :].to(f32)
    seg = cs2[..., :, None] - cs2[..., None, :]              # (BC, H, i, j)
    causal = torch.tril(torch.ones((q, q), dtype=torch.bool,
                                   device=x.device))
    # masked before exp: above the diagonal seg is a positive sum of -dt·A
    # (~177 over 256 steps at mamba2's init), whose exp overflows to inf,
    # and where's zero gradient times inf would be NaN
    lmat = torch.exp(torch.where(causal, seg, float("-inf")))
    cb = torch.einsum("bhin,bhjn->bhij", ch, bh)
    w = cb * lmat * dt2[..., None, :]
    y = torch.einsum("bhij,bhjp->bhip", w, x.to(f32))
    decay_end = torch.exp(cs2[..., -1:] - cs2) * dt2        # (BC, H, Q)
    s_local = torch.einsum("bhqn,bhq,bhqp->bhnp", bh, decay_end, x.to(f32))
    return y, s_local
