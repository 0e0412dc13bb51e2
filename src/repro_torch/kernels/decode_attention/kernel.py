"""Bindings of ``csrc/decode_attention.cu`` (fp32) and
``csrc/decode_attention_bf16.cu`` (bf16; see the sources for the design
notes): one launch that splits each sequence's live keys, read on the card,
and merges the splits (in bf16 within a thread-block cluster first) in the
block that finishes last."""
from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.common.utils import ceil_div
from repro_torch.kernels._build import CudaKernel, load_library, require_cuda

_I, _F, _P = ctypes.c_int, ctypes.c_float, ctypes.c_void_p
KERNEL = CudaKernel("decode_attention", "decode_attention_f32",
                    [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                     _F, _I])
#: the same on bf16 q, k, v and output (every warp streaming its own keys
#: with cp.async, the splits merged in thread-block clusters; sums in fp32)
KERNEL_BF16 = CudaKernel("decode_attention_bf16", "decode_attention_bf16",
                         KERNEL.argtypes[:-1])
HEAD_DIMS = (16, 32, 64, 96, 128, 256)
#: query heads per kv head at most: the tensor cores' 16 rows
MAX_GROUP = 16
#: the kernel's constants (``kTile``, ``kMinKeys``, ``kMaxSplits``): keys
#: per tile (a split is a whole number of tiles), the fewest live keys a
#: split takes, a sequence's splits at most (the merge's shared memory)
TILE, MIN_KEYS_PER_SPLIT, MAX_SPLITS = 32, 128, 64
#: the bf16 kernel's constants (``kGroup``, ``kStage``, ``kMinKeys``,
#: ``kMaxClusters``, ``kMaxCluster``): a split is whole groups of this many
#: keys; keys a stage; a split's keys at least (but for a shorter
#: sequence's one); a sequence's clusters at most; a cluster's blocks at
#: most
BF16_GROUP, BF16_STAGE, BF16_MIN_KEYS = 8, 64, 64
BF16_MAX_CLUSTERS, BF16_MAX_CLUSTER = 64, 8

#: per (device, head dim, route): the card's SMs and the blocks one holds
#: (fp32); the card's SMs, the blocks one holds and, by cluster size, the
#: clusters the card holds at once (bf16)
_OCCUPANCY: Dict[Tuple[int, int, int], Tuple[int, int]] = {}
_OCCUPANCY_BF16: Dict[Tuple[int, int, int],
                      Tuple[int, int, Dict[int, int]]] = {}
#: per (device, stream): the merge counters, one per (sequence, kv head)
#: (bf16: and rank of a cluster), zero between launches (the last block of
#: each resets its own)
_COUNTERS: Dict[Tuple[int, int], torch.Tensor] = {}


def grid_waves(per_sm: int) -> int:
    """The budget in waves of the blocks the card holds at once: two where
    an SM holds two blocks or more (phi3-mini's D 96: a long slot in 12
    splits of 352 keys, not 4 of 1056, beats the second wave it costs),
    one where it holds one (gemma2-2b's D 256, the group of 16: a second
    wave costs more than the shorter splits save)."""
    return 2 if per_sm >= 2 else 1


def split_blocks(b: int, hk: int, s: int, window: Optional[int],
                 sms: int, per_sm: int) -> int:
    """The blocks of one kv head that the ``b`` sequences share by their
    live keys (the kernel's grid holds at least one a sequence):
    ``grid_waves`` times the blocks the card holds at once (``sms`` x
    ``per_sm``) over the ``hk`` kv heads, and no more than ``b`` sequences
    as long as the cache (or the window) can use."""
    live_max = min(s, window) if window else s
    per_seq = min(MAX_SPLITS, ceil_div(live_max, MIN_KEYS_PER_SPLIT))
    budget = grid_waves(per_sm) * sms * per_sm // hk
    return max(1, min(budget, b * per_seq))


def split_plan(lives: Sequence[int], nb: int) -> List[Tuple[int, int]]:
    """(splits, keys per split) of each sequence, from the sequences' live
    keys ``lives``, as the kernel computes it from kv_len on the card:
    every sequence takes one of the ``nb`` blocks and the others are shared
    in proportion to the live keys (rounded down), at most one split per
    ``MIN_KEYS_PER_SPLIT`` keys (and ``MAX_SPLITS``), equal splits rounded
    up to whole tiles.  A sequence with no live key is one empty split."""
    total, extra = sum(lives), nb - len(lives)
    out = []
    for live in lives:
        n = 1 + (extra * live // total if extra > 0 and total else 0)
        n = max(1, min(n, MAX_SPLITS, ceil_div(live, MIN_KEYS_PER_SPLIT)))
        chunk = max(TILE, ceil_div(ceil_div(live, n), TILE) * TILE)
        out.append((max(1, ceil_div(live, chunk)), chunk))
    return out


def bf16_cluster(b: int, nb: int) -> int:
    """The bf16 kernel's cluster size (``cluster_size`` in the source) for
    ``b`` sequences sharing ``nb`` blocks of a kv head: the largest of 8, 4
    and 2 whose ``b`` first clusters (one a sequence) take at most a third
    of the blocks, else 1 (no cluster)."""
    c = BF16_MAX_CLUSTER
    while c > 1 and 3 * b * c > nb:
        c //= 2
    return c


def bf16_grid(b: int, nb: int) -> Tuple[int, int]:
    """(cluster size, clusters of a kv head) of the bf16 kernel's grid,
    as the launch makes them from ``nb``: at least one cluster a
    sequence."""
    c = bf16_cluster(b, nb)
    return c, max(b, nb // c)


def bf16_blocks(b: int, hk: int, s: int, window: Optional[int], sms: int,
                per_sm: int, clusters: Dict[int, int]) -> int:
    """The blocks of one kv head that the bf16 kernel's ``b`` sequences
    share: what the card holds at once (``sms`` x ``per_sm``, or at the
    cluster size ``bf16_cluster`` chooses, ``clusters[size]`` clusters of
    it) over the ``hk`` kv heads, one wave, and no more than ``b``
    sequences as long as the cache (or the window) can use at
    ``BF16_MIN_KEYS`` keys a split."""
    live_max = min(s, window) if window else s
    nb = sms * per_sm // hk
    c = bf16_cluster(b, nb)
    if c > 1:
        nb = min(nb, clusters[c] // hk * c)
    return max(1, min(nb, b * ceil_div(live_max, BF16_MIN_KEYS)))


def bf16_plan(lives: Sequence[int], b_ncl: int,
              c: int) -> List[Tuple[int, int, int]]:
    """(clusters, keys a split, splits) of each sequence, from the
    sequences' live keys ``lives``, as the bf16 kernel computes it from
    kv_len on the card with ``b_ncl`` clusters of ``c`` blocks a kv head:
    every sequence takes one cluster and the others are shared in
    proportion to the live keys (rounded down), at most one cluster per
    ``c * BF16_MIN_KEYS`` keys (and ``BF16_MAX_CLUSTERS``); the
    clusters' blocks take equal splits in whole ``BF16_GROUP``-key groups
    of at least ``BF16_MIN_KEYS`` keys, and a cluster's blocks past the
    last split are empty.  A sequence with no live key is one empty
    split."""
    total, extra = sum(lives), b_ncl - len(lives)
    out = []
    for live in lives:
        n = 1 + (extra * live // total if extra > 0 and total else 0)
        n = max(1, min(n, BF16_MAX_CLUSTERS,
                       ceil_div(live, c * BF16_MIN_KEYS)))
        chunk = max(BF16_MIN_KEYS,
                    ceil_div(ceil_div(live, n * c), BF16_GROUP) * BF16_GROUP)
        used = max(1, ceil_div(live, chunk))
        out.append((ceil_div(used, c), chunk, used))
    return out


def _bind(name: str, *argtypes):
    fn = getattr(load_library(name), f"{name}_occupancy")
    fn.argtypes = [*argtypes, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    return fn


def _query(dev: torch.device, fn, *args) -> int:
    out = ctypes.c_int(0)
    with torch.cuda.device(dev):
        rc = fn(*args, ctypes.byref(out))
    if rc != 0 or out.value < 1:
        raise RuntimeError(f"{fn.__name__}{args}: CUDA error {rc} "
                           f"({out.value})")
    return out.value


def _occupancy(dev: torch.device, d: int, g: int) -> Tuple[int, int]:
    """The card's SMs and the blocks of the fp32 kernel's instance for
    (d, g) one SM holds at once (``decode_attention_occupancy``; shared
    memory sets it: one block at D 256 or with the group of 16 at D 128,
    two at phi3-mini's D 96)."""
    key = (dev.index, d, g if g <= 2 else 0)
    if key not in _OCCUPANCY:
        fn = _bind(KERNEL.source, ctypes.c_int, ctypes.c_int)
        _OCCUPANCY[key] = (torch.cuda.get_device_properties(
            dev).multi_processor_count, _query(dev, fn, d, g))
    return _OCCUPANCY[key]


def _occupancy_bf16(dev: torch.device, d: int,
                    g: int) -> Tuple[int, int, Dict[int, int]]:
    """The card's SMs, the blocks of the bf16 kernel's instance for (d, g)
    one SM holds at once, and the clusters of 2, 4 and 8 of them the card
    holds at once (``decode_attention_bf16_occupancy``)."""
    key = (dev.index, d, g if g <= 2 else 0)
    if key not in _OCCUPANCY_BF16:
        fn = _bind(KERNEL_BF16.source, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int)
        _OCCUPANCY_BF16[key] = (
            torch.cuda.get_device_properties(dev).multi_processor_count,
            _query(dev, fn, d, g, 1),
            {c: _query(dev, fn, d, g, c) for c in (2, 4, 8)})
    return _OCCUPANCY_BF16[key]


def _counters(dev: torch.device, n: int) -> torch.Tensor:
    key = (dev.index, torch.cuda.current_stream(dev).cuda_stream)
    c = _COUNTERS.get(key)
    if c is None or c.numel() < n:
        c = torch.zeros(max(n, 1024), dtype=torch.int32, device=dev)
        _COUNTERS[key] = c
    return c


def decode_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          kv_len: torch.Tensor, *,
                          cap: Optional[float] = None,
                          window: Optional[int] = None) -> torch.Tensor:
    """Model layout on CUDA, fp32 or bf16: q (B, 1, H, D), k/v (B, S, Hk,
    D), kv_len (B, 1) int32 -> (B, 1, H, D) in their dtype (bf16:
    ``decode_attention_bf16``, fp32 inside; k and v 16-byte aligned, as
    its 16-byte copies read them).  Any S; D in ``HEAD_DIMS``; H/Hk up to
    ``MAX_GROUP``.  kv_len is read on the card (no host sync)
    and must be at least 1, as it is in a decode step (a sequence with no
    visible key gets zeros here; the plain version averages V)."""
    dev = require_cuda("decode_attention", q, k, v, kv_len)
    if not (q.dtype == k.dtype == v.dtype
            and q.dtype in (torch.float32, torch.bfloat16)):
        raise ValueError("decode_attention: the CUDA kernel takes q, k and "
                         "v all float32 or all bfloat16 (got "
                         f"{q.dtype}, {k.dtype}, {v.dtype})")
    if any(t.data_ptr() % 4 for t in (q, k, v)):
        raise ValueError("decode_attention: the CUDA kernel needs 4-byte "
                         "aligned tensors")
    if q.dtype == torch.bfloat16 and any(t.data_ptr() % 16 for t in (k, v)):
        raise ValueError("decode_attention: the bf16 CUDA kernel needs "
                         "16-byte aligned k and v")
    if kv_len.dtype != torch.int32:
        raise ValueError("decode_attention: kv_len must be int32")
    b, one, h, d = q.shape
    s, hk = k.shape[1], k.shape[2]
    if one != 1 or k.shape != (b, s, hk, d) or v.shape != k.shape \
            or kv_len.numel() != b:
        raise ValueError(f"decode_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, kv_len "
                         f"{tuple(kv_len.shape)}")
    if d not in HEAD_DIMS or h % hk or h // hk > MAX_GROUP:
        raise ValueError(f"decode_attention: head_dim {d} (takes "
                         f"{HEAD_DIMS}), {h} q heads over {hk} kv heads "
                         f"(at most {MAX_GROUP} a kv head)")
    if cap is not None and cap <= 0:
        raise ValueError("decode_attention: cap must be positive")
    if window is not None and window <= 0:
        raise ValueError("decode_attention: window must be positive")
    out = torch.empty_like(q)
    if b == 0:
        return out
    g = h // hk
    if q.dtype == torch.bfloat16:
        kernel = KERNEL_BF16
        nb = bf16_blocks(b, hk, s, window, *_occupancy_bf16(dev, d, g))
        c, ncl = bf16_grid(b, nb)
        ws_floats, n_count = hk * ncl * (g * d + 2 * g * c), b * hk * c
    else:
        kernel = KERNEL
        nb = split_blocks(b, hk, s, window, *_occupancy(dev, d, g))
        ws_floats, n_count = hk * max(nb, b) * (g * d + 2 * g), b * hk
    ws = torch.empty(ws_floats, dtype=torch.float32, device=dev)
    kernel.launch(dev, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  kv_len.data_ptr(), out.data_ptr(), ws.data_ptr(),
                  _counters(dev, n_count).data_ptr(), b, s, h, hk, d, nb,
                  0.0 if cap is None else float(cap),
                  0 if window is None else int(window))
    return out
