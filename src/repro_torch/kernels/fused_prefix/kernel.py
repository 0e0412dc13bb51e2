"""Binding of ``csrc/fused_prefix.cu`` (see the source for the design note).

The stage tuple (``ref.py``'s ``spec``) is resolved here, on the host, into
the kernel's descriptor in two steps.  ``compile_spec`` turns every crop
into a window of one of four buffers (the input, the output frame ``x``,
two scratch frames), gives each preprocess stage its destination, and adds
a final copy of the last window to ``x`` when no preprocess stage wrote it
there.  ``cluster_plan`` lays those buffers out over the cluster of
``BLOCKS`` blocks that takes one frame: each buffer in bands of rows, one
band a block, at an offset in every block's shared memory; the reduction
slots; a ``cluster.sync()`` before each stage that needs one; and refuses a
frame whose bands do not fit ``SMEM_BUDGET``.
"""
from __future__ import annotations

import ctypes
from typing import Dict, List, Tuple

import torch

from repro_torch.kernels._build import CudaKernel, load_library, require_cuda
from repro_torch.kernels.fused_prefix.ref import project_rowwise

MAX_STAGES = 16          # kMaxStages in the source
DIFF, COLOR, PREPROCESS, SIGNATURE, COPY = range(5)
INPUT, XOUT, SCRATCH0, SCRATCH1, PREV = range(5)
#: blocks of a frame's cluster: the portable maximum cluster size
BLOCKS = 8
#: dynamic shared memory a block may take: the H100's opt-in maximum of
#: 227 KB (232448 bytes) less 1 KB for the kernel's static shared memory
#: (the block reductions)
SMEM_BUDGET = 232448 - 1024
#: alignment of every buffer and slot array in shared memory (cp.async and
#: float4 access)
ALIGN = 16

_FIELDS = ("kind", "src", "src_h", "src_w", "src_band", "y0", "x0", "h", "w",
           "dst", "dst_h", "dst_w", "dst_band", "factor", "grey", "a", "b",
           "idx", "sync")
_PLAN_FIELDS = ("diff_slots", "color_slots", "sig_slots", "gather", "x_h",
                "x_w", "x_band")


class Stage(ctypes.Structure):
    _fields_ = [(n, ctypes.c_int) for n in _FIELDS] + \
        [("rgb", ctypes.c_float * 3)]


class Spec(ctypes.Structure):
    _fields_ = [("n", ctypes.c_int), ("blocks", ctypes.c_int),
                ("smem", ctypes.c_int), ("off", ctypes.c_int * 5)] + \
        [(n, ctypes.c_int) for n in _PLAN_FIELDS] + \
        [("st", Stage * MAX_STAGES)]


_I, _P, _LL = ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong
KERNEL = CudaKernel("fused_prefix", "fused_prefix_launch",
                    [_P, _P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _LL, _I, _I,
                     _I, _I, ctypes.POINTER(Spec)])


def out_frame_shape(spec, shape: Tuple[int, int, int]
                    ) -> Tuple[int, int, int]:
    """(C, H, W) after the spec's transform stages (grey keeps C: the
    single channel is re-expanded)."""
    c, h, w = shape
    for stage in spec:
        if stage[0] == "crop":
            h, w = stage[1][2], stage[1][3]
        elif stage[0] == "preprocess":
            _, crop, factor, _ = stage
            h, w = crop[2] // factor, crop[3] // factor
    return c, h, w


def _inside(box, view, what):
    y0, x0, h, w = box
    if not (0 <= y0 and 0 <= x0 and h > 0 and w > 0
            and y0 + h <= view["h"] and x0 + w <= view["w"]):
        raise ValueError(f"fused_prefix: {what} {tuple(box)} outside the "
                         f"{view['h']}x{view['w']} frame")


def compile_spec(spec, shape: Tuple[int, int, int]
                 ) -> Tuple[List[Dict[str, object]], int]:
    """Resolve ``spec`` for (C, H, W) frames into the kernel's stages (one
    dict per stage, the fields of ``Stage``) and the scratch plane size
    (floats per channel, 0 when no scratch is needed)."""
    c, h, w = shape
    view = dict(src=INPUT, src_h=h, src_w=w, y0=0, x0=0, h=h, w=w)
    pre = [i for i, s in enumerate(spec) if s[0] == "preprocess"]
    last_pre = pre[-1] if pre else -1
    crop_after = any(s[0] == "crop" for s in spec[last_pre + 1:])
    stages: List[Dict[str, object]] = []
    scratch, ncolor = 0, 0
    for i, st in enumerate(spec):
        kind = st[0]
        if kind == "diff":
            ry, rx = st[1]
            if h % ry or w % rx:        # the diff reads the input frames
                raise ValueError(f"fused_prefix: diff {st[1]} does not "
                                 f"divide {h}x{w}")
            if c * (h // ry) * (w // rx) * 255 >= 2 ** 32:
                raise ValueError("fused_prefix: a diff region this large "
                                 "would overflow its 32-bit sum")
            stages.append(dict(kind=DIFF, src=INPUT, src_h=h, src_w=w, y0=0,
                               x0=0, h=h, w=w, a=ry, b=rx))
        elif kind == "color":
            if c != 3:
                raise ValueError("fused_prefix: colour stages need 3 "
                                 "channels")
            roi = st[2] if st[2] is not None else (0, 0, view["h"],
                                                   view["w"])
            _inside(roi, view, "colour roi")
            stages.append(dict(view, kind=COLOR, y0=view["y0"] + roi[0],
                               x0=view["x0"] + roi[1], h=roi[2], w=roi[3],
                               idx=ncolor, rgb=tuple(st[1])))
            ncolor += 1
        elif kind == "crop":
            _inside(st[1], view, "crop")
            view = dict(view, y0=view["y0"] + st[1][0],
                        x0=view["x0"] + st[1][1], h=st[1][2], w=st[1][3])
        elif kind == "preprocess":
            _, crop, f, grey = st
            _inside(crop, view, "preprocess crop")
            if f <= 0 or crop[2] % f or crop[3] % f:
                raise ValueError(f"fused_prefix: crop {crop} not divisible "
                                 f"by factor {f}")
            if grey and c != 3:
                raise ValueError("fused_prefix: greyscale needs 3 channels")
            ho, wo = crop[2] // f, crop[3] // f
            if i == last_pre and not crop_after:
                dst = XOUT
            else:       # ping-pong: never write the buffer being read
                dst = SCRATCH1 if view["src"] == SCRATCH0 else SCRATCH0
                scratch = max(scratch, ho * wo)
            stages.append(dict(view, kind=PREPROCESS, y0=view["y0"] + crop[0],
                               x0=view["x0"] + crop[1], h=crop[2], w=crop[3],
                               dst=dst, dst_h=ho, dst_w=wo, factor=f,
                               grey=int(grey)))
            view = dict(src=dst, src_h=ho, src_w=wo, y0=0, x0=0, h=ho, w=wo)
        elif kind == "signature":
            gy, gx = st[1]
            if i != len(spec) - 1 or view["h"] % gy or view["w"] % gx:
                raise ValueError(f"fused_prefix: signature {st[1]} must come "
                                 f"last and divide {view['h']}x{view['w']}")
            stages.append(dict(view, kind=SIGNATURE, a=gy, b=gx))
        else:
            raise ValueError(f"unknown fused-prefix stage {kind!r}")
    if view["src"] != XOUT:
        stages.append(dict(view, kind=COPY))
    if len(stages) > MAX_STAGES:
        raise ValueError(f"fused_prefix: {len(stages)} kernel stages, at "
                         f"most {MAX_STAGES}")
    return stages, scratch


def band_rows(h: int, blocks: int = BLOCKS) -> int:
    """Rows of a band when h rows are cut over ``blocks`` blocks: block q
    holds rows [q * band, (q + 1) * band), the last ones fewer or none."""
    return -(-h // blocks)


def first_item(y: int, y0: int, step: int) -> int:
    """The first item i >= 0 of a window at source row y0, of ``step`` rows
    an item, whose first source row y0 + i * step is at or past y (the
    kernel's ``first_item``)."""
    t = y - y0
    return 0 if t <= 0 else -(-t // step)


def owned_items(rank: int, band: int, y0: int, step: int, n: int
                ) -> Tuple[int, int]:
    """The items [lo, hi) of n (window rows, step 1; signature patch rows,
    step ph) that block ``rank`` takes: those whose first source row lies
    in its band."""
    lo = min(n, first_item(rank * band, y0, step))
    return lo, max(lo, min(n, first_item((rank + 1) * band, y0, step)))


def _reads(st) -> set:
    return {INPUT, PREV} if st["kind"] == DIFF else {st["src"]}


def cluster_plan(stages, shape: Tuple[int, int, int], itemsize: int,
                 blocks: int = BLOCKS) -> Dict[str, object]:
    """Lay ``compile_spec``'s stages for (C, H, W) frames of ``itemsize``
    bytes out over a cluster of ``blocks`` blocks (see the source's design
    note).  Returns the plan: the stages with their bands (``src_band``,
    ``dst_band``) and ``sync`` flags; ``off``, each buffer's byte offset
    in a block's shared memory (-1: not held); ``bytes``, each held
    buffer's bytes a block; the offsets of the reduction slots and of the
    preprocess's gather area, and ``area_bytes``, the bytes of each held;
    x's band layout (``x_h``,
    ``x_w``, ``x_band``: 0 unless a preprocess writes x); ``smem``, the
    dynamic shared memory of a block.  Raises ``ValueError`` when that is
    above ``SMEM_BUDGET``."""
    c, h, w = shape
    sizes = {INPUT: c * band_rows(h, blocks) * w * itemsize}
    if any(st["kind"] == DIFF for st in stages):
        sizes[PREV] = sizes[INPUT]
    plan: Dict[str, object] = dict(blocks=blocks, x_h=0, x_w=0, x_band=0)
    out = []
    for st in stages:
        st = dict(st, src_band=band_rows(st["src_h"], blocks), dst_band=0)
        if st["kind"] == PREPROCESS:
            st["dst_band"] = band_rows(st["dst_h"], blocks)
            need = c * st["dst_band"] * st["dst_w"] * 4
            sizes[st["dst"]] = max(sizes.get(st["dst"], 0), need)
            if st["dst"] == XOUT:
                plan.update(x_h=st["dst_h"], x_w=st["dst_w"],
                            x_band=st["dst_band"])
        out.append(st)
    # a cluster.sync() before a stage that reads a band written since the
    # last one, or writes a band written or read since; the first stage
    # reads the bands the load wrote, and also waits there for every block
    # to start (remote slot writes need it)
    dirty, read = {INPUT, PREV}, set()
    for st in out:
        reads = _reads(st)
        writes = {st["dst"]} if st["kind"] == PREPROCESS else set()
        st["sync"] = int(bool(reads & dirty or writes & (dirty | read)))
        if st["sync"]:
            dirty, read = set(), set()
        dirty |= writes
        read |= reads
    assert out[0]["sync"] == 1
    # a signature reads its window's max from the last colour stage on the
    # same window, where no stage has written that buffer since
    window = ("src", "src_h", "src_w", "y0", "x0", "h", "w")
    last = {}
    for st in out:
        if st["kind"] == COLOR:
            last[tuple(st[f] for f in window)] = st["idx"]
        elif st["kind"] == PREPROCESS:
            last = {w: i for w, i in last.items() if w[0] != st["dst"]}
        elif st["kind"] == SIGNATURE:
            st["idx"] = last.get(tuple(st[f] for f in window), -1)
    total = 0

    def alloc(nbytes: int) -> int:
        nonlocal total
        at = total
        total += -(-nbytes // ALIGN) * ALIGN
        return at

    plan["off"] = [alloc(sizes[buf]) if buf in sizes else -1
                   for buf in range(5)]
    plan["bytes"] = dict(sizes)
    areas = {}      # reduction slots and the preprocess's gather area
    for st in out:
        if st["kind"] == DIFF:      # (region, block), 4-byte sums
            areas["diff_slots"] = 4 * st["a"] * st["b"] * blocks
        elif st["kind"] == SIGNATURE and st["idx"] < 0:
            areas["sig_slots"] = 4 * blocks     # the max of each block's rows
        elif st["kind"] == PREPROCESS:      # a block's source rows
            elem = itemsize if st["src"] == INPUT else 4
            need = c * st["dst_band"] * st["factor"] ** 2 * st["dst_w"] * elem
            areas["gather"] = max(areas.get("gather", 0), need)
    ncolor = sum(1 for st in out if st["kind"] == COLOR)
    if ncolor:      # (colour, block) x (max, count normalized, count raw),
        # then (colour, block) x max in every block
        areas["color_slots"] = 16 * ncolor * blocks
    # the predecessor's band is dead once a first-stage diff has read it:
    # the gather area takes its place where it fits (one block an SM fewer
    # at float32 otherwise)
    if out[0]["kind"] == DIFF and 0 < areas.get("gather", 0) <= sizes[PREV]:
        plan["gather"] = plan["off"][PREV]
        del areas["gather"]
    for name in ("diff_slots", "color_slots", "sig_slots", "gather"):
        if name in areas:
            plan[name] = alloc(areas[name])
        else:
            plan.setdefault(name, 0)
    plan["area_bytes"] = areas
    plan["stages"] = out
    plan["smem"] = total
    if total > SMEM_BUDGET:
        raise ValueError(
            f"fused_prefix: a {c}x{h}x{w} frame's buffers take {total} bytes "
            f"of shared memory a block over a cluster of {blocks} blocks, "
            f"above the budget of {SMEM_BUDGET} bytes")
    return plan


def _spec_struct(plan) -> Spec:
    spec = Spec()
    stages = plan["stages"]
    spec.n = len(stages)
    spec.blocks = plan["blocks"]
    spec.smem = plan["smem"]
    spec.off[:] = plan["off"]
    for k in _PLAN_FIELDS:
        setattr(spec, k, int(plan[k]))
    for slot, st in zip(spec.st, stages):
        for k, v in st.items():
            if k == "rgb":
                slot.rgb[:] = [float(x) for x in v]
            else:
                setattr(slot, k, int(v))
    return spec


_PLANS: Dict[str, Spec] = {}


def _plan_struct(spec, shape: Tuple[int, int, int], itemsize: int) -> Spec:
    """The kernel's descriptor for ``spec`` on (C, H, W) frames, made once
    per spec, shape and item size (a plan's fused op calls it every micro-
    batch)."""
    key = repr((spec, shape, itemsize))
    if key not in _PLANS:
        stages, _ = compile_spec(spec, shape)
        _PLANS[key] = _spec_struct(cluster_plan(stages, shape, itemsize))
    return _PLANS[key]


def fused_prefix_cuda(frames: torch.Tensor, prevs=None, proj=None, *, spec):
    """frames (B, C, H, W) uint8 or float32 on CUDA (prevs the same, diff
    stage only; proj (D, EMB_DIM) f32, signature stage only) ->
    ``(d, fracs, x, feats, emb)`` as ``ref.fused_prefix_ref``.  The
    projection ``emb`` is PyTorch work after the kernel, as in the
    reference."""
    has_sig = any(s[0] == "signature" for s in spec)
    if has_sig:
        require_cuda("fused_prefix", frames, proj)
    d, fracs, x, feats = prefix_kernel(frames, prevs, spec=spec)
    emb = project_rowwise(feats, proj) if has_sig else None
    return d, fracs, x, feats, emb


def prefix_kernel(frames: torch.Tensor, prevs=None, *, spec):
    """The kernel's launch alone: ``(d, fracs, x, feats)`` of
    ``fused_prefix_cuda``, without the projection."""
    has_diff = any(s[0] == "diff" for s in spec)
    has_sig = any(s[0] == "signature" for s in spec)
    dev = require_cuda("fused_prefix", frames,
                       *([prevs] if has_diff else []))
    if frames.dtype not in (torch.uint8, torch.float32) or frames.dim() != 4:
        raise ValueError("fused_prefix: the CUDA kernel takes uint8 or "
                         "float32 (B, C, H, W) frames")
    if has_diff and (prevs.dtype != frames.dtype
                     or prevs.shape != frames.shape):
        raise ValueError("fused_prefix: prevs must match the frames")
    b, c, h, w = frames.shape
    spec_c = _plan_struct(spec, (c, h, w), frames.element_size())
    oc, oh, ow = out_frame_shape(spec, (c, h, w))
    out_f32 = any(s[0] == "preprocess" for s in spec)
    x = torch.empty((b, oc, oh, ow), device=dev,
                    dtype=torch.float32 if out_f32 else frames.dtype)
    f32 = dict(device=dev, dtype=torch.float32)
    nreg = ncolor = sig_d = 0
    d = fr = feats = None
    if has_diff:
        ry, rx = next(s[1] for s in spec if s[0] == "diff")
        nreg = ry * rx
        d = torch.empty((b, ry, rx), **f32)
    ncolor = sum(1 for s in spec if s[0] == "color")
    fr = torch.empty((b, ncolor), **f32)
    if has_sig:
        gy, gx = next(s[1] for s in spec if s[0] == "signature")
        sig_d = oc * gy * gx
        feats = torch.empty((b, sig_d), **f32)
    if b:
        ptr = lambda t: None if t is None or not t.numel() \
            else t.data_ptr()  # noqa: E731
        KERNEL.launch(dev, frames.data_ptr(),
                      prevs.data_ptr() if has_diff else None,
                      int(frames.dtype == torch.float32), ptr(d), ptr(fr),
                      x.data_ptr(), ptr(feats), b, c, h, w, oc * oh * ow,
                      int(out_f32), nreg, ncolor, sig_d,
                      ctypes.byref(spec_c))
    return d, tuple(fr[:, i] for i in range(ncolor)), x, feats


def cluster_occupancy(spec, shape: Tuple[int, int, int], dtype: torch.dtype,
                      device: torch.device) -> int:
    """How many clusters of the kernel for ``spec`` on (C, H, W) frames of
    ``dtype`` the card runs at once (``cudaOccupancyMaxActiveClusters``
    through ``fused_prefix_occupancy``; no launch)."""
    spec_c = _plan_struct(spec, tuple(shape),
                          torch.empty((), dtype=dtype).element_size())
    KERNEL._bind()
    fn = load_library(KERNEL.source).fused_prefix_occupancy
    fn.argtypes = [ctypes.c_int, ctypes.POINTER(Spec),
                   ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    n = ctypes.c_int(0)
    with torch.cuda.device(device):
        rc = fn(int(dtype == torch.float32), ctypes.byref(spec_c),
                ctypes.byref(n))
    if rc != 0:
        raise RuntimeError(f"fused_prefix_occupancy: CUDA error {rc}")
    return n.value
