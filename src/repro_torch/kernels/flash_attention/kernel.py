"""Bindings of ``csrc/flash_attention.cu`` (the forward on fp32 or bf16
inputs, with or without each row's log-sum-exp) and
``csrc/flash_attention_bwd.cu`` (its gradient, fp32 or bf16); see the
sources for the design notes.  Queries and keys may differ in length (Sq != Sk, cross
attention) where no positional mask applies: ``causal=False`` and no
window."""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional

import torch

from repro_torch.kernels._build import CudaKernel, require_cuda
from repro_torch.kernels.flash_attention.ref import check_lengths

_I, _F, _P = ctypes.c_int, ctypes.c_float, ctypes.c_void_p
KERNEL = CudaKernel("flash_attention", "flash_attention_f32",
                    [_P] * 4 + [_I] * 7 + [_F, _I])
#: the serving forward on bf16 q, k, v into a bf16 output (fp32 inside)
KERNEL_BF16 = CudaKernel("flash_attention", "flash_attention_bf16",
                         [_P] * 4 + [_I] * 7 + [_F, _I])
#: the training forward: the output and each row's log-sum-exp
KERNEL_LSE = CudaKernel("flash_attention", "flash_attention_lse_f32",
                        [_P] * 5 + [_I] * 7 + [_F, _I])
#: the bf16 training forward: the bf16 serving kernel writing each row's
#: log-sum-exp (fp32) beside its output
KERNEL_LSE_BF16 = CudaKernel("flash_attention", "flash_attention_lse_bf16",
                             [_P] * 5 + [_I] * 7 + [_F, _I])
#: the backward: dQ, dK, dV (delta, dK/dV and dQ in one launch, the splits'
#: merge where the plan splits the group); its last int is ``bwd_plan``'s
#: split count
KERNEL_BWD = CudaKernel("flash_attention_bwd", "flash_attention_bwd_f32",
                        [_P] * 11 + [_I] * 7 + [_F, _I, _I])
#: the backward on bf16 inputs (dQ, dK, dV in bf16, fp32 sums), the same
#: plan and arguments
KERNEL_BWD_BF16 = CudaKernel("flash_attention_bwd", "flash_attention_bwd_bf16",
                             [_P] * 11 + [_I] * 7 + [_F, _I, _I])
HEAD_DIMS = (16, 32, 64, 96, 128, 256)
MAX_GROUP = 64
H100_SMS = 132
#: shared memory of an SM, and the most a block may take (bytes)
SMEM_SM, SMEM_BLOCK = 233472, 232448
#: the merge pass of a split group, counted in dK/dV query tiles (a launch
#: and a read of the splits' scratch, ~3-4 us, against ~1 us a tile)
MERGE_TILES = 4


def bwd_tiles(d: int) -> Dict[str, int]:
    """What the split count depends on of ``Cfg<D>`` in
    ``csrc/flash_attention_bwd.cu``, which owns the tiles and grids: rows a
    block (16 a row group: keys in dK/dV, queries in dQ), streamed rows a
    tile (8 a column group), shared memory bytes (the resident rows, split
    once where D <= 64; a ring of ``stages`` tiles of two streamed tensors
    in hi and rest planes, with the columns' lse and delta; the score
    parts where warps over D share a row group; rows padded to D + 4
    floats), and the blocks an SM holds (two where shared memory allows).
    The card checks them against the library's
    ``flash_attention_bwd_config``."""
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention_bwd: head_dim {d} (takes "
                         f"{HEAD_DIMS})")
    warps_d = 1 if d <= 32 else d // 32
    groups = 1 if d == 256 else 2
    col_groups = 4 if d <= 32 else 2 if d == 64 else 1
    rows, cols = 16 * groups, 8 * col_groups
    warps = groups * warps_d * col_groups
    ld, planes = d + 4, 2 if d <= 64 else 1
    stages = 3 if d <= 64 else 2
    parts = warps * 2 * 4 * 32 if warps_d > 1 else 0
    smem = 4 * (2 * planes * rows * ld + stages * 4 * cols * ld
                + stages * 2 * cols + parts)
    per_sm = 2 if SMEM_SM // (smem + 1024) >= 2 else 1
    return dict(rows=rows, cols=cols, smem=smem, per_sm=per_sm)


def bwd_bf16_tiles(d: int) -> Dict[str, int]:
    """``bwd_tiles`` of the bf16 backward (``CfgBw<D>`` in
    ``csrc/flash_attention_bwd.cu``): 64 resident rows a block, streamed
    tiles of 64 rows (32 at D 256), warps of 16 rows x 64 columns of D (D
    up to 96: all of D), a two-stage ring of the two streamed tensors, P
    and dS of a tile, and the streamed rows' lse and delta; rows padded by
    8 bf16.  The card checks them against the library's
    ``flash_attention_bwd_bf16_config``."""
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention_bwd: head_dim {d} (takes "
                         f"{HEAD_DIMS})")
    rows, cols = 64, 32 if d == 256 else 64
    threads = 32 * 4 * (d // 64 if d >= 128 else 1)
    smem = 2 * (2 * rows * (d + 8) + 2 * 2 * cols * (d + 8)
                + 2 * rows * (cols + 8)) + 4 * 2 * 2 * cols
    per_sm = max(1, min(SMEM_SM // (smem + 1024), 2048 // threads))
    return dict(rows=rows, cols=cols, smem=smem, threads=threads,
                per_sm=per_sm)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def bwd_plan(b: int, sq: int, sk: int, h: int, hk: int, d: int, *,
             sms: int = H100_SMS, bf16: bool = False) -> Dict[str, int]:
    """The backward's split count and scratch at one shape (``sq``
    queries, ``sk`` keys), from the shape alone.

    The dK/dV blocks are one per (tile of ``rows`` keys, kv head, split of
    the group's heads, batch row); split ``sp`` takes heads ``sp G /
    splits .. (sp + 1) G / splits - 1`` (the C source's ranges).  One
    split where its blocks already fill the card; else the split count
    that makes the longest block's work least, in query tiles (its heads
    x the query tiles of key tile 0, plus ``MERGE_TILES`` for the merge
    pass), among those whose blocks the card holds at once (``sms`` x the
    blocks an SM holds).  With more than one split, each writes its totals
    to an fp32 scratch (2, splits, B, Sk, Hk, D) of ``scratch`` elements,
    which the merge pass adds in split order.  ``bf16``: the bf16
    backward's tiles (``bwd_bf16_tiles``), the same rule."""
    if h % hk or not 0 < h // hk <= MAX_GROUP:
        raise ValueError(f"flash_attention_bwd: {h} q heads over {hk} kv "
                         f"heads (groups up to {MAX_GROUP})")
    t = bwd_bf16_tiles(d) if bf16 else bwd_tiles(d)
    g = h // hk
    blocks = _cdiv(sk, t["rows"]) * hk * b
    nq = _cdiv(sq, t["cols"])
    splits, cost = 1, g * nq
    if blocks < sms:
        for sp in range(2, g + 1):
            if blocks * sp > sms * t["per_sm"]:
                break
            c = _cdiv(g, sp) * nq + MERGE_TILES
            if c < cost:
                splits, cost = sp, c
    return dict(splits=splits,
                scratch=2 * splits * b * sk * hk * d if splits > 1 else 0)


#: the bf16 forward's block (``CfgB`` and the constants beside it in
#: ``csrc/flash_attention.cu``): 128 query rows, two consumer warpgroups of
#: 64 and a producer warpgroup, the producer's and consumers' registers
#: after ``setmaxnreg``
BF16_ROWS, BF16_CONSUMERS, BF16_PRODUCER_REGS, BF16_CONSUMER_REGS = \
    128, 2, 24, 240
#: barriers' room set aside in ``CfgB``: Q's and three a stage, at most 4
BF16_MAX_STAGES = 4


def fwd_bf16_plan(b: int, sq: int, sk: int, h: int, hk: int,
                  d: int) -> Dict[str, object]:
    """The bf16 forward's launch at one shape, mirroring ``CfgB<D>`` and
    ``launch_bf16`` in ``csrc/flash_attention.cu``, which own them (the
    card checks the mirror against the library's
    ``flash_attention_bf16_config``).

    A block takes ``rows`` query rows, ``bq`` = 128 // G positions of the G
    heads on one kv head (``q_rows`` = G x bq of them live), in two
    consumer warpgroups of 64 rows, beside a producer warpgroup whose
    first thread issues the TMA loads: Q once, then K and V in tiles of
    ``keys`` through a ring of ``stages``.  A row of D values is ``boxes``
    TMA boxes of ``box_cols`` columns (``swizzle`` bytes a box row, the
    swizzle's span; D 96 is two boxes of 64, the second half past D); the
    wgmma shapes are m64n``keys``k16 (Q.K^T, ``qk_steps`` k steps) and
    m64n``pv_n``k16 (P.V, ``pv_steps`` k steps a term).  Shared memory:
    1024 bytes to align the tiles, Q's boxes of 128 rows, the ring's K
    and V, 8 bytes a barrier.  Grid (query tiles, Hk, B)."""
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention_bf16: head_dim {d} (takes "
                         f"{HEAD_DIMS})")
    if h % hk or not 0 < h // hk <= MAX_GROUP:
        raise ValueError(f"flash_attention_bf16: {h} q heads over {hk} kv "
                         f"heads (groups up to {MAX_GROUP})")
    g = h // hk
    box_cols = min(d, 64)
    boxes = _cdiv(d, box_cols)
    span = 2 * box_cols
    keys = 64 if d == 256 else 128
    q_bytes = boxes * BF16_ROWS * span
    kv_bytes = boxes * keys * span
    free = SMEM_BLOCK - 1024 - 8 * (1 + 3 * BF16_MAX_STAGES) - q_bytes
    stages = min(BF16_MAX_STAGES, free // (2 * kv_bytes))
    bq = BF16_ROWS // g
    return dict(rows=BF16_ROWS, bq=bq, q_rows=g * bq, keys=keys,
                stages=stages, warpgroups=BF16_CONSUMERS,
                threads=128 * (1 + BF16_CONSUMERS), boxes=boxes,
                box_cols=box_cols, swizzle=span, pv_n=boxes * box_cols,
                qk_steps=d // 16, pv_steps=keys // 16,
                smem=1024 + q_bytes + 2 * stages * kv_bytes
                + 8 * (1 + 3 * stages),
                producer_regs=BF16_PRODUCER_REGS,
                consumer_regs=BF16_CONSUMER_REGS,
                grid=(_cdiv(sq, bq), hk, b))


#: the library's ``flash_attention_bf16_config`` figures, in its order
BF16_CONFIG_KEYS = ("rows", "keys", "stages", "warpgroups", "threads",
                    "boxes", "box_cols", "swizzle", "smem", "producer_regs",
                    "consumer_regs")


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check(name: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           causal: bool, cap: Optional[float], window: Optional[int],
           dtypes=(torch.float32,)) -> torch.device:
    dev = require_cuda(name, q, k, v)
    if not (q.dtype == k.dtype == v.dtype and q.dtype in dtypes):
        raise ValueError(f"{name}: the CUDA kernel takes q, k and v all in "
                         f"one of {dtypes} (got {q.dtype}, {k.dtype}, "
                         f"{v.dtype})")
    # bf16 goes through TMA, which reads from 16-byte aligned bases
    align = 16 if q.dtype == torch.bfloat16 else 4
    if any(t.data_ptr() % align for t in (q, k, v)):
        raise ValueError(f"{name}: the CUDA kernel needs {align}-byte "
                         f"aligned {q.dtype} tensors")
    b, sq, h, d = q.shape
    sk, hk = k.shape[1], k.shape[2]
    if k.shape != (b, sk, hk, d) or v.shape != k.shape or (sq and not sk):
        raise ValueError(f"{name}: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    check_lengths(name, sq, sk, causal, window)
    if d not in HEAD_DIMS or h % hk or h // hk > MAX_GROUP:
        raise ValueError(f"{name}: head_dim {d} (takes {HEAD_DIMS})"
                         f", {h} q heads over {hk} kv heads")
    if cap is not None and cap <= 0:
        raise ValueError(f"{name}: cap must be positive")
    if window is not None and window <= 0:
        raise ValueError(f"{name}: window must be positive")
    return dev


def _options(causal: bool, cap: Optional[float], window: Optional[int]):
    return (int(causal), 0.0 if cap is None else float(cap),
            0 if window is None else int(window))


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, cap: Optional[float] = None,
                         window: Optional[int] = None, lse: bool = False):
    """Model layout on CUDA, fp32 or bf16: q (B, Sq, H, D); k, v (B, Sk,
    Hk, D) -> (B, Sq, H, D) in their dtype.  Any Sq, Sk (Sk != Sq with
    ``causal=False`` and no window); D in ``HEAD_DIMS``; H/Hk at most
    ``MAX_GROUP``.  bf16 runs ``flash_attention_bf16`` (fp32 inside, the
    output rounded once).  With ``lse`` (the training forward) returns
    (out, lse) where lse (B, H, Sq), fp32, is each row's log-sum-exp of
    its scaled (and capped) logits, which ``flash_attention_bwd_cuda``
    takes (``flash_attention_lse_f32`` / ``flash_attention_lse_bf16``;
    the output is the serving kernel's bit for bit)."""
    dev = _check("flash_attention", q, k, v, causal, cap, window,
                 (torch.float32, torch.bfloat16))
    b, s, h, d = q.shape
    out = torch.empty_like(q)
    rows = torch.empty((b, h, s), device=dev) if lse else None
    if b and s:
        dims = (b, s, k.shape[1], h, k.shape[2], d,
                *_options(causal, cap, window))
        if lse:
            kernel = KERNEL_LSE if q.dtype == torch.float32 \
                else KERNEL_LSE_BF16
            kernel.launch(dev, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                          out.data_ptr(), rows.data_ptr(), *dims)
        else:
            kernel = KERNEL if q.dtype == torch.float32 else KERNEL_BF16
            kernel.launch(dev, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                          out.data_ptr(), *dims)
    return (out, rows) if lse else out


def flash_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, out: torch.Tensor,
                             lse: torch.Tensor, dout: torch.Tensor, *,
                             causal: bool = True,
                             cap: Optional[float] = None,
                             window: Optional[int] = None):
    """The gradient of ``flash_attention_cuda(q, k, v, ...)`` at ``dout``
    (B, Sq, H, D), given its output ``out`` and ``lse`` (from ``lse=True``
    with the same options): (dq, dk, dv) in the layouts and dtype of q, k,
    v.  fp32 runs ``flash_attention_bwd_f32``; bf16 (q, k, v, out, dout
    bf16 and 16-byte aligned, lse fp32) ``flash_attention_bwd_bf16``, with
    fp32 sums and each gradient rounded once."""
    dev = _check("flash_attention_bwd", q, k, v, causal, cap, window,
                 (torch.float32, torch.bfloat16))
    require_cuda("flash_attention_bwd", out, lse, dout)
    b, s, h, d = q.shape
    if out.shape != q.shape or dout.shape != q.shape or \
            lse.shape != (b, h, s):
        raise ValueError(f"flash_attention_bwd: out {tuple(out.shape)}, "
                         f"dout {tuple(dout.shape)}, lse {tuple(lse.shape)}"
                         f" for q {tuple(q.shape)}")
    bf16 = q.dtype == torch.bfloat16
    if not (out.dtype == dout.dtype == q.dtype and
            lse.dtype == torch.float32):
        raise ValueError(f"flash_attention_bwd: out and dout in q's dtype "
                         f"{q.dtype} and an fp32 lse (got {out.dtype}, "
                         f"{dout.dtype}, {lse.dtype})")
    if bf16 and any(t.data_ptr() % 16 for t in (out, dout)):
        raise ValueError("flash_attention_bwd: the bf16 kernel needs "
                         "16-byte aligned tensors")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), \
        torch.empty_like(v)
    if b and s:
        sk, hk = k.shape[1], k.shape[2]
        plan = bwd_plan(b, s, sk, h, hk, d, sms=_sms(dev.index), bf16=bf16)
        delta = torch.empty((b, h, s), device=dev)      # scratch
        part = torch.empty(plan["scratch"], device=dev)  # the splits' totals
        kernel = KERNEL_BWD_BF16 if bf16 else KERNEL_BWD
        kernel.launch(dev, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                          out.data_ptr(), dout.data_ptr(), lse.data_ptr(),
                          delta.data_ptr(),
                          part.data_ptr() if plan["scratch"] else None,
                          dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, s,
                          sk, h, hk, d, *_options(causal, cap, window),
                          plan["splits"])
    return dq, dk, dv
