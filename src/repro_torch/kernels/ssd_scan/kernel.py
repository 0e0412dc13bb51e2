"""Bindings of ``csrc/ssd_scan.cu`` (see the source for the design note:
one launch writes both within-chunk terms, C·Bᵀ formed inside it) and of
its gradient, ``csrc/ssd_scan_bwd.cu`` (the training path's backward), with
the backward's launch plan (``bwd_plan``)."""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels._build import CudaKernel, require_cuda

_I, _P = ctypes.c_int, ctypes.c_void_p
KERNEL = CudaKernel("ssd_scan", "ssd_scan_f32",
                    [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I])
#: the backward: its last two ints are ``bwd_plan``'s split count and
#: ranges of N
BWD_KERNEL = CudaKernel("ssd_scan_bwd", "ssd_scan_bwd_f32",
                        [_P] * 16 + [_I] * 8)
MAX_Q, MAX_P, MAX_N = 256, 128, 256
#: rows (and keys) of the backward's tiles (``kT`` in the source), state
#: dims of its C·Bᵀ steps (``kCB``) and of its s_local steps (``kSL``)
BWD_TILE, BWD_CB, BWD_SL = 32, 64, 32
H100_SMS = 132
#: shared memory of an SM, and the most a block may take (bytes)
SMEM_SM, SMEM_BLOCK = 233472, 232448
#: the most shared memory a block may take for two blocks an SM (the card
#: keeps 1 KB of each block's)
TWO_A_SM = SMEM_SM // 2 - 1024
#: column tiles (8 state dims) a sums task takes at most: in the second
#: launch, and in the first where a cluster holds a chunk and group's
#: blocks (at most ``MAX_CLUSTER``)
SUM_TILES, FUSED_TILES, MAX_CLUSTER = 16, 4, 8


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _round8(v: int) -> int:
    return _cdiv(v, 8) * 8


def bwd_smem(p: int, n: int, hs: int) -> int:
    """The first launch's shared memory (bytes) at P and N with ``hs`` heads
    a split: ``Layout`` and ``stages`` in ``csrc/ssd_scan_bwd.cu`` (the card
    holds this mirror to the library's ``ssd_scan_bwd_smem``).  A ring of
    stages, each the larger of C's 64-wide slice and 32 rows of dy or ds:
    four where they leave two blocks an SM, else three, else two; the
    stages' cs; W in two planes; the row sums by column group; B_j; and per
    head x_j, dx_j's sum and ten vectors of 32."""
    t = BWD_TILE
    lp, lb = _round8(p) + 4, _round8(n) + 4
    sf = t * max(BWD_CB + 4, lp)

    def size(ns):
        return 4 * (ns * sf + ns * t + 2 * t * (t + 4) + 4 * t + t * lb
                    + hs * (2 * t * lp + 10 * t))

    for ns in (4, 3):
        if size(ns) <= TWO_A_SM:
            return size(ns)
    return size(2)


def split_heads(hg: int, splits: int, sp: int) -> range:
    """The heads (within its group) of split ``sp``: the C source's
    range."""
    return range(sp * hg // splits, (sp + 1) * hg // splits)


@functools.lru_cache(maxsize=None)
def _bwd_plan(bc: int, h: int, g: int, q: int, p: int, n: int, sms: int,
              splits: Optional[int]):
    if bc <= 0 or h % g or not (0 < q <= MAX_Q and 0 < p <= MAX_P
                                and 0 < n <= MAX_N):
        raise ValueError(f"ssd_scan_bwd: BC {bc}, Q {q}, P {p}, N {n}, {h} "
                         f"heads over {g} groups")
    hg, nt = h // g, _cdiv(q, BWD_TILE)

    def smem(count):
        return bwd_smem(p, n, _cdiv(hg, count))

    fits = [c for c in range(1, hg + 1) if smem(c) <= SMEM_BLOCK]
    if splits is not None:
        if splits not in fits:
            raise ValueError(f"ssd_scan_bwd: {splits} splits of {hg} heads "
                             f"(takes {fits[0]} .. {hg})")
        sp = splits
    else:
        # the fewest splits that fill the card two blocks an SM; else one
        # head a split, the most blocks
        sp = next((c for c in fits if smem(c) <= TWO_A_SM
                   and bc * g * c * nt >= 2 * sms), hg)
    tiles = _round8(n) // 8
    fused = sp * nt <= MAX_CLUSTER
    if fused:       # as many tasks as the cluster has blocks, where N allows
        parts = max(_cdiv(tiles, FUSED_TILES), min(tiles, sp // 2))
    else:           # a wave of the card's blocks, where N allows
        parts = max(_cdiv(tiles, SUM_TILES),
                    min(tiles, sms // (2 * nt * bc * g)))
    parts = _cdiv(tiles, _cdiv(tiles, parts))     # no empty range
    return dict(splits=sp, hs=_cdiv(hg, sp), smem=smem(sp),
                per_sm=2 if smem(sp) <= TWO_A_SM else 1,
                blocks=bc * g * sp * nt, parts=parts, nt=nt, fused=fused,
                grid=(bc * g * sp, nt),
                grid2=None if fused else (nt, 2 * parts, bc * g),
                s_part=sp * bc * g * (nt * (nt + 1) // 2) * BWD_TILE ** 2,
                db_part=sp * bc * g * q * n, dcs_row=bc * h * q * nt,
                esum=bc * h * nt)


def bwd_plan(bc: int, h: int, g: int, q: int, p: int, n: int, *,
             sms: int = H100_SMS,
             splits: Optional[int] = None) -> Dict[str, object]:
    """The backward's launch plan at one shape, from the shape alone.

    The first launch's blocks are one per (chunk, group, split of the group's
    heads, key tile), key tile 0 (the most rows) launched first.  Split ``sp``
    takes the heads of ``split_heads``; the most heads a split sets the shared
    memory (``bwd_smem``), hence the blocks an SM holds.  The split count is
    the fewest whose blocks fill the card (``sms`` x 2) two an SM: more
    splits compute C·Bᵀ again for each, fewer leave the card idle or hold
    one block an SM; where no count fills it, one head a split, the most
    blocks.  ``fused``: a chunk and group's splits x key tiles blocks fit a
    cluster (``MAX_CLUSTER``), so the first launch does the sums too; else
    ``grid2`` is the second launch's.  ``parts``: the sums' ranges of N for
    each of dC and dB, as many as the cluster's blocks (fused) or one wave
    of the card (else) take, where N allows.  Scratch sizes in floats:
    ``s_part`` the splits' S tiles, ``db_part`` their w·E sums, ``dcs_row``
    the row sums by key tile, ``esum`` the s_local sums by key tile.
    ``splits`` forces a count (timing sweeps, tests)."""
    return dict(_bwd_plan(bc, h, g, q, p, n, sms, splits))


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


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
    heads.  One call is one launch count: blocks of a split of a group's
    heads and a key tile, then dB, dC and dcs from their partials, in the
    same launch's clusters or a second launch (``bwd_plan``); the scratch
    holds the partials."""
    dev = require_cuda("ssd_scan_bwd", x, bmat, cmat, cs, dt, dy, ds)
    bc, h, g, q, p, n = _check("ssd_scan_bwd", x, bmat, cmat, cs, dt)
    if dy.shape != x.shape or ds.shape != (bc, h, n, p) \
            or dy.dtype != torch.float32 or ds.dtype != torch.float32:
        raise ValueError(f"ssd_scan_bwd: dy {tuple(dy.shape)} {dy.dtype}, "
                         f"ds {tuple(ds.shape)} {ds.dtype}")
    dx = torch.empty_like(x)
    db, dc = torch.empty_like(bmat), torch.empty_like(cmat)
    dcs, ddt = torch.empty_like(cs), torch.empty_like(dt)
    if bc:
        plan = bwd_plan(bc, h, g, q, p, n, sms=_sms(dev.index))
        scratch = [torch.empty(plan[k], dtype=torch.float32, device=dev)
                   for k in ("s_part", "db_part", "dcs_row", "esum")]
        BWD_KERNEL.launch(dev, *(t.data_ptr() for t in (
            x, bmat, cmat, cs, dt, dy, ds, dx, db, dc, dcs, ddt, *scratch)),
            bc, h, g, q, p, n, plan["splits"], plan["parts"])
    return dx, db, dc, dcs, ddt
