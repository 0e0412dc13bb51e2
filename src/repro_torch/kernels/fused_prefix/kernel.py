"""Binding of ``csrc/fused_prefix.cu`` (see the source for the design note).

The stage tuple (``ref.py``'s ``spec``) is resolved here, on the host, into
the kernel's descriptor: every crop becomes a window of one of four
buffers (the input, the output frame ``x``, two scratch frames), each
preprocess stage gets its destination, and a final copy moves the last
window to ``x`` when no preprocess stage wrote it there.
"""
from __future__ import annotations

import ctypes
from typing import Dict, List, Tuple

import torch

from repro_torch.kernels._build import CudaKernel, require_cuda
from repro_torch.kernels.fused_prefix.ref import project_rowwise

MAX_STAGES = 16          # kMaxStages in the source
DIFF, COLOR, PREPROCESS, SIGNATURE, COPY = range(5)
INPUT, XOUT, SCRATCH0, SCRATCH1 = range(4)

_FIELDS = ("kind", "src", "src_h", "src_w", "y0", "x0", "h", "w", "dst",
           "dst_h", "dst_w", "factor", "grey", "a", "b", "idx")


class Stage(ctypes.Structure):
    _fields_ = [(n, ctypes.c_int) for n in _FIELDS] + \
        [("rgb", ctypes.c_float * 3)]


class Spec(ctypes.Structure):
    _fields_ = [("n", ctypes.c_int), ("st", Stage * MAX_STAGES)]


_I, _P, _LL = ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong
KERNEL = CudaKernel("fused_prefix", "fused_prefix_launch",
                    [_P, _P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _LL,
                     _I, _I, _I, _I, _LL, ctypes.POINTER(Spec)])


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


def _spec_struct(stages) -> Spec:
    spec = Spec()
    spec.n = len(stages)
    for slot, st in zip(spec.st, stages):
        for k, v in st.items():
            if k == "rgb":
                slot.rgb[:] = [float(x) for x in v]
            else:
                setattr(slot, k, int(v))
    return spec


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
    stages, scratch_plane = compile_spec(spec, (c, h, w))
    oc, oh, ow = out_frame_shape(spec, (c, h, w))
    out_f32 = any(s[0] == "preprocess" for s in spec)
    x = torch.empty((b, oc, oh, ow), device=dev,
                    dtype=torch.float32 if out_f32 else frames.dtype)
    f32 = dict(device=dev, dtype=torch.float32)
    nreg = ncolor = sig_d = 0
    d = fr = feats = scratch = None
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
    if scratch_plane:
        scratch = torch.empty((2, b, c * scratch_plane), **f32)
    if b:
        ptr = lambda t: None if t is None or not t.numel() \
            else t.data_ptr()  # noqa: E731
        spec_c = _spec_struct(stages)
        KERNEL.launch(dev, frames.data_ptr(),
                      prevs.data_ptr() if has_diff else None,
                      int(frames.dtype == torch.float32), ptr(d), ptr(fr),
                      x.data_ptr(), ptr(feats), ptr(scratch), b, c, h, w,
                      oc * oh * ow, int(out_f32), nreg, ncolor, sig_d,
                      c * scratch_plane, ctypes.byref(spec_c))
    return d, tuple(fr[:, i] for i in range(ncolor)), x, feats
