"""Build and load the hand-written CUDA kernels of ``horovod_tpu_torch/csrc``.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for ``sm_90a`` into its own shared library under ``build/horovod_tpu_torch/``
of the checkout, at first use, and loaded with ``ctypes``.  The library's
file name carries a hash of its source, so an edited kernel is rebuilt and
a stale one is never loaded.  :meth:`Kernel.load` is the only build path;
a caller that wants the kernels built in parallel calls it from one thread
per kernel (each ``nvcc`` is its own process).

Nothing here falls back: a missing ``nvcc``, a compile error, a load error
or a non-zero return from a kernel raises :class:`RuntimeError`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "horovod_tpu_torch")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")
CUDA_NVCC = "/usr/local/cuda/bin/nvcc"   # the toolkit's default location


def _nvcc() -> str:
    path = shutil.which("nvcc") or CUDA_NVCC
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "horovod_tpu_torch need the CUDA toolkit")
    return path


class Kernel:
    """One CUDA source, its C entry point, and its count of launches.

    ``launches`` goes up by one each time :meth:`__call__` launches the
    kernel; callers that must show a path ran through the kernel read it
    and reset it with :func:`reset_launches`."""

    def __init__(self, name: str, symbol: str, argtypes):
        self.name, self.symbol = name, symbol
        self.source = os.path.join(CSRC, name + ".cu")
        self.argtypes = list(argtypes)
        self.launches = 0
        self.build_log = ""
        self._fn = None
        self._lock = threading.Lock()

    def library_path(self) -> str:
        with open(self.source, "rb") as f:
            digest = hashlib.sha1(f.read() + " ".join(NVCC_FLAGS).encode())
        return os.path.join(BUILD_DIR, f"{self.name}-{digest.hexdigest()[:12]}.so")

    def _compile(self, out: str) -> None:
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, self.source],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        self.build_log = proc.stdout
        if proc.returncode != 0:
            if os.path.exists(tmp):
                os.remove(tmp)
            raise RuntimeError(f"nvcc failed on {self.source} "
                               f"(exit {proc.returncode}):\n{proc.stdout}")
        os.replace(tmp, out)   # atomic: a concurrent build sees all or none

    def load(self):
        """Build the library if it is not built yet, load it, and return
        its entry point.  Safe to call from several threads."""
        with self._lock:
            if self._fn is None:
                out = self.library_path()
                if not os.path.exists(out):
                    self._compile(out)
                fn = getattr(ctypes.CDLL(out), self.symbol)
                fn.argtypes = self.argtypes
                fn.restype = ctypes.c_int
                self._fn = fn
            return self._fn

    def __call__(self, *args) -> None:
        rc = self.load()(*args)
        if rc != 0:
            raise RuntimeError(f"{self.name}: kernel launch failed "
                               f"(cudaError {rc})" if rc > 0 else
                               f"{self.name}: unsupported dtype or shape")
        self.launches += 1


KERNELS: dict[str, Kernel] = {}


def register(name: str, symbol: str, argtypes) -> Kernel:
    KERNELS[name] = Kernel(name, symbol, argtypes)
    return KERNELS[name]


def reset_launches() -> None:
    for k in KERNELS.values():
        k.launches = 0


def stream_of(t) -> ctypes.c_void_p:
    """PyTorch's current CUDA stream on ``t``'s device, for a launch."""
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)
