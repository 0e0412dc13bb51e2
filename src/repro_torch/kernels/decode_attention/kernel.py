"""Binding of ``csrc/decode_attention.cu`` (see the source for the design
note): the split-KV partials kernel and the logsumexp combine kernel."""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.common.utils import ceil_div
from repro_torch.kernels._build import CudaKernel, require_cuda

_I, _F, _P = ctypes.c_int, ctypes.c_float, ctypes.c_void_p
PARTIALS = CudaKernel("decode_attention", "decode_attention_partials_f32",
                      [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                       _F, _I])
COMBINE = CudaKernel("decode_attention", "decode_attention_combine_f32",
                     [_P, _P, _P, _P, _I, _I, _I, _I, _I])
HEAD_DIMS = (16, 32, 64, 96, 128, 256)
GROUPS = (1, 2, 4, 8, 16)
#: the widest head a group of 16 query heads is built for (registers)
MAX_D_G16 = 128
#: splits per (sequence, kv head): enough blocks for a long sequence to
#: cover the card's 132 SMs with a handful of kv heads
MAX_SPLITS = 32
KEYS_PER_SPLIT = 128


def num_splits(s_max: int) -> int:
    """Splits of the live range: one per 128 cache rows, at most 32."""
    return max(1, min(MAX_SPLITS, ceil_div(s_max, KEYS_PER_SPLIT)))


def _check(q, k, v, kv_len, cap, window):
    dev = require_cuda("decode_attention", q, k, v, kv_len)
    if not (q.dtype == k.dtype == v.dtype == torch.float32):
        raise ValueError("decode_attention: the CUDA kernel takes float32 "
                         f"(got {q.dtype}, {k.dtype}, {v.dtype})")
    if kv_len.dtype != torch.int32:
        raise ValueError("decode_attention: kv_len must be int32")
    b, one, h, d = q.shape
    s, hk = k.shape[1], k.shape[2]
    if one != 1 or k.shape != (b, s, hk, d) or v.shape != k.shape \
            or kv_len.numel() != b:
        raise ValueError(f"decode_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, kv_len "
                         f"{tuple(kv_len.shape)}")
    if d not in HEAD_DIMS or h % hk or h // hk not in GROUPS \
            or (h // hk == 16 and d > MAX_D_G16):
        raise ValueError(f"decode_attention: head_dim {d} (takes "
                         f"{HEAD_DIMS}), {h} q heads over {hk} kv heads "
                         f"(groups {GROUPS}; 16 up to head_dim "
                         f"{MAX_D_G16})")
    if cap is not None and cap <= 0:
        raise ValueError("decode_attention: cap must be positive")
    if window is not None and window <= 0:
        raise ValueError("decode_attention: window must be positive")
    return dev, b, s, h, hk, d


def decode_partials(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    kv_len: torch.Tensor, *, cap: Optional[float] = None,
                    window: Optional[int] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The first launch alone: per-split partials acc (B, Hk, ns, G, D),
    m and l (B, Hk, ns, G), ``ns = num_splits(S)``."""
    dev, b, s, h, hk, d = _check(q, k, v, kv_len, cap, window)
    ns = num_splits(s)
    g = h // hk
    acc = torch.empty((b, hk, ns, g, d), dtype=torch.float32, device=dev)
    m = torch.empty((b, hk, ns, g), dtype=torch.float32, device=dev)
    l = torch.empty_like(m)
    PARTIALS.launch(dev, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    kv_len.data_ptr(), acc.data_ptr(), m.data_ptr(),
                    l.data_ptr(), b, s, h, hk, d, ns,
                    0.0 if cap is None else float(cap),
                    0 if window is None else int(window))
    return acc, m, l


def decode_combine(acc: torch.Tensor, m: torch.Tensor, l: torch.Tensor,
                   h: int) -> torch.Tensor:
    """The second launch: the partials merged by logsumexp ->
    (B, 1, H, D)."""
    dev = require_cuda("decode_attention", acc, m, l)
    b, hk, ns, g, d = acc.shape
    out = torch.empty((b, 1, h, d), dtype=torch.float32, device=dev)
    COMBINE.launch(dev, acc.data_ptr(), m.data_ptr(), l.data_ptr(),
                   out.data_ptr(), b, h, hk, d, ns)
    return out


def decode_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          kv_len: torch.Tensor, *,
                          cap: Optional[float] = None,
                          window: Optional[int] = None) -> torch.Tensor:
    """Model layout on CUDA, fp32: q (B, 1, H, D), k/v (B, S, Hk, D),
    kv_len (B, 1) int32 -> (B, 1, H, D).  Any S; D in ``HEAD_DIMS``;
    H/Hk in ``GROUPS``.  kv_len is read on the card (no host sync) and must
    be at least 1, as it is in a decode step (a sequence with no visible
    key gets zeros here; the plain version averages V).  A group of 16
    takes D up to ``MAX_D_G16``."""
    acc, m, l = decode_partials(q, k, v, kv_len, cap=cap, window=window)
    return decode_combine(acc, m, l, q.shape[2])
