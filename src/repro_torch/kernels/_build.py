"""Build and bind the hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled at first use with ``nvcc`` into a shared library
with a plain C interface under ``build/kernels/`` at the repository root
(listed in ``.gitignore``) and loaded with ``ctypes``.  No PyTorch header is
included, so a source builds in seconds.  ``build()`` starts one ``nvcc``
per stale source, all at once, and waits for them together.

Every C entry point takes raw device pointers, its sizes and the CUDA stream
(PyTorch's current stream) and returns ``cudaGetLastError()`` after the
launch; ``CudaKernel.launch`` raises on a non-zero code and counts the
launch.  A kernel allocates nothing: the Python wrapper allocates outputs.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
#: every kernel the port binds, by name — read by ``launch_counts()``
REGISTRY: Dict[str, "CudaKernel"] = {}


def nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built at "
                           "first use on a host with the CUDA toolkit")
    return path


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    """The library is missing or older than its source or a shared
    ``csrc/*.cuh`` header."""
    so = library_path(name)
    if not so.exists():
        return True
    newest = max(p.stat().st_mtime for p in
                 [CSRC / f"{name}.cu", *CSRC.glob("*.cuh")])
    return so.stat().st_mtime < newest


def build(names: Optional[Sequence[str]] = None,
          force: bool = False) -> Dict[str, Dict[str, object]]:
    """Compile the named sources (default: every ``csrc/*.cu``) that are
    missing or older than their source, one ``nvcc`` process each, all
    started together.  Returns ``{name: {"seconds", "log"}}`` for the
    sources it compiled (``log`` holds ptxas' register/spill report)."""
    if names is None:
        names = sorted(p.stem for p in CSRC.glob("*.cu"))
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = [n for n in names if force or _stale(n)]
    if not todo:
        return {}
    exe = nvcc()
    t0 = time.perf_counter()
    procs = {}
    for n in todo:
        tmp = BUILD_DIR / f"lib{n}.so.{os.getpid()}.tmp"
        cmd = [exe, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp)
    report: Dict[str, Dict[str, object]] = {}
    failed: List[str] = []
    for n, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {n}.cu:\n{log}")
            continue
        os.replace(tmp, library_path(n))
        report[n] = {"seconds": time.perf_counter() - t0, "log": log}
    if failed:
        raise RuntimeError("\n".join(failed))
    return report


class CudaKernel:
    """One C entry point of one ``csrc/<source>.cu``, with a launch count.

    ``launches`` rises by one in ``launch`` and nowhere else, so a run can
    show that the main path went through the kernel."""

    def __init__(self, source: str, symbol: str, argtypes: Sequence):
        self.source = source
        self.symbol = symbol
        self.argtypes = list(argtypes) + [ctypes.c_void_p]   # + stream
        self.launches = 0
        self._fn = None
        REGISTRY[symbol] = self

    def _bind(self):
        with _LOCK:
            if self._fn is None:
                if _stale(self.source):
                    build([self.source])
                lib = ctypes.CDLL(str(library_path(self.source)))
                fn = getattr(lib, self.symbol)
                fn.argtypes = self.argtypes
                fn.restype = ctypes.c_int
                self._fn = fn
        return self._fn

    def launch(self, device: torch.device, *args) -> None:
        fn = self._fn or self._bind()
        stream = torch.cuda.current_stream(device).cuda_stream
        with torch.cuda.device(device):
            rc = fn(*args, stream)
        if rc != 0:
            raise RuntimeError(f"{self.symbol}: CUDA error {rc} at launch")
        self.launches += 1


def require_cuda(name: str, *tensors: torch.Tensor) -> torch.device:
    """The kernels take contiguous tensors on one CUDA device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name}: the CUDA kernel needs every tensor on "
                             f"one CUDA device, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: the CUDA kernel needs contiguous "
                             "tensors")
    return dev
