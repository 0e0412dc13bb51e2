"""Temporal frame signatures: cheap, batched, on the operators' device.

Counterpart of ``repro/semantic/signature.py``.  A signature is two views
of a downsampled frame:

* ``feats``: per-channel patch means on a coarse grid (at most 8×16
  cells), a spatially aware activity measure;
* ``emb``: a fixed random projection of the grid to ``EMB_DIM`` values,
  whose coarse quantization is the cache's signature bucket.

Raw (uint8-range) vs already-normalized rows are decided per frame.
Inputs are padded to the power-of-two bucket, as in the reference, and the
pad rows sliced off.  The arithmetic is ``kernels/fused_prefix/ref.py``'s
(``signature_feats``, ``project_rowwise``), so the fused prefix's
signatures equal these on one device.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.common.device import DeviceLike, resolve_device
from repro_torch.kernels.fused_prefix.ref import (project_rowwise,
                                                  signature_feats)
from repro_torch.streaming.operators import _bucket_pad

#: dimensionality of the random-projection embedding (bucket keys are
#: tuples of this many quantized ints)
EMB_DIM = 16

#: fixed seed for the projection: signatures must be stable across
#: processes, or a restored cache snapshot would never hit again
_PROJ_SEED = 7


def _grid(n: int, target: int) -> int:
    """Largest divisor of ``n`` that is <= ``target``."""
    for g in range(min(target, n), 0, -1):
        if n % g == 0:
            return g
    return 1


def signature_layout(shape: Tuple[int, int, int],
                     grid: Tuple[int, int] = (8, 16)
                     ) -> Tuple[int, int, int, np.ndarray]:
    """The pooling grid and projection matrix for one frame shape,
    ``(gy, gx, d, proj)``: the one source of truth shared by
    ``TemporalSignature`` and the fused prefix.  The projection comes from
    ``np.random.RandomState(_PROJ_SEED)``, so it is the reference's."""
    c, h, w = shape
    gy, gx = _grid(h, grid[0]), _grid(w, grid[1])
    d = c * gy * gx
    rng = np.random.RandomState(_PROJ_SEED)
    proj = rng.standard_normal((d, EMB_DIM)).astype(np.float32)
    proj /= np.sqrt(d)
    return gy, gx, d, proj


class TemporalSignature:
    """Batched signature extractor; ``device=None`` means CUDA."""

    def __init__(self, grid: Tuple[int, int] = (8, 16),
                 device: DeviceLike = None):
        self.grid = grid
        self.device = resolve_device(device)
        self._layouts: Dict[Tuple, Tuple[int, int, torch.Tensor]] = {}

    def _layout(self, shape: Tuple[int, int, int]):
        if shape not in self._layouts:
            gy, gx, _, proj = signature_layout(shape, self.grid)
            self._layouts[shape] = (gy, gx, torch.from_numpy(proj).to(
                self.device))
        return self._layouts[shape]

    def features(self, frames: np.ndarray
                 ) -> Tuple[np.ndarray, np.ndarray]:
        """(n, C, H, W) frames -> (feats (n, D), emb (n, EMB_DIM))."""
        if frames.ndim != 4 or frames.shape[0] == 0:
            raise ValueError(f"signature: need (n>0, C, H, W), got "
                             f"{frames.shape}")
        n = frames.shape[0]
        bucket = _bucket_pad(n)
        if bucket != n:
            pad = np.zeros((bucket - n,) + frames.shape[1:], frames.dtype)
            frames = np.concatenate([frames, pad], 0)
        gy, gx, proj = self._layout(tuple(frames.shape[1:]))
        x = torch.from_numpy(np.ascontiguousarray(frames)).to(self.device)
        with torch.inference_mode():
            feats = signature_feats(x, gy, gx)
            emb = project_rowwise(feats, proj)
        return feats[:n].cpu().numpy(), emb[:n].cpu().numpy()

    @staticmethod
    def distance(feats_a: np.ndarray, emb_a: np.ndarray,
                 feats_b: np.ndarray, emb_b: np.ndarray) -> float:
        """Scalar dissimilarity of two frames' signatures: patch-grid
        activity and embedding distance, equally weighted."""
        patch = float(np.abs(feats_a - feats_b).mean())
        emb = float(np.linalg.norm(emb_a - emb_b)) / np.sqrt(EMB_DIM)
        return 0.5 * patch + 0.5 * emb

    @staticmethod
    def bucket(emb: np.ndarray, width: float) -> Tuple[int, ...]:
        """Quantize one embedding to its cache bucket."""
        return tuple(int(q) for q in np.floor(emb / max(width, 1e-9)))
