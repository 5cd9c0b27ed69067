"""Build and load the port's own copy of the native coordination core.

``horovod_tpu_torch/core/src`` holds the C++ control plane (negotiation,
fusion, the response cache, heartbeats, elastic reconfiguration, the
Chrome-tracing timeline), copied from ``horovod_tpu/core/src``.  It is
compiled with ``g++`` into one shared library under
``build/horovod_tpu_torch/core/`` of the checkout, at first use, and loaded
with ``ctypes``.  The library's file name carries a hash of every source
and header and of every flag, so an edited source is rebuilt and a stale
library is never loaded.

Several processes (the replicas of a serving fleet, test workers) may ask
for the library at once.  One of them builds it, under an exclusive lock
on a file of the build directory, into a temporary name that is renamed
into place when the link has finished, so no process ever loads a
half-linked library; the others wait on the lock and then load the
finished file.  Nothing here falls back: a missing compiler or a compile
or link error raises :class:`RuntimeError`.

The library is loaded with ``RTLD_LOCAL`` (ctypes' default), so its
symbols and singletons never bind to those of another copy of the core
loaded in the same process.  It also carries its own C++ runtime, linked
statically with its symbols hidden (:data:`LINK_FLAGS`), and binds its
own references to itself, so it never depends on which C++ runtime the
process loaded first (PyTorch's): built by a ``CXX`` other than the
system's, without these flags, every replica of a fleet crashed in the
first ``std::ostringstream`` of an elastic reconfiguration, inside
``std::ostream::_M_insert``.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from concurrent.futures import ThreadPoolExecutor

_HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(_HERE, "src")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build",
                         "horovod_tpu_torch", "core")
SOURCES = ("message", "controller", "tree", "timeline", "half", "engine",
           "c_api")
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-pthread")
LINK_FLAGS = ("-static-libstdc++", "-static-libgcc", "-Wl,--exclude-libs,ALL",
              "-Wl,-Bsymbolic")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _cxx() -> str:
    path = shutil.which(os.environ.get("CXX", "g++"))
    if path is None:
        raise RuntimeError("g++ not found: the native core of "
                           "horovod_tpu_torch needs a C++17 compiler")
    return path


def _flags(cxx: str) -> tuple[str, ...]:
    """:data:`CXX_FLAGS`, plus ``-mf16c`` where the compiler targets F16C
    (the fp16 converters of ``half.cc`` use it when it is there)."""
    probe = subprocess.run([cxx, "-mf16c", "-dM", "-E", "-"], input="",
                           capture_output=True, text=True)
    f16c = probe.returncode == 0 and "__F16C__" in probe.stdout
    return CXX_FLAGS + (("-mf16c",) if f16c else ())


def library_path(flags: tuple[str, ...]) -> str:
    digest = hashlib.sha1(" ".join(flags + LINK_FLAGS).encode())
    for name in sorted(os.listdir(SRC)):
        if name.endswith((".cc", ".h")):
            with open(os.path.join(SRC, name), "rb") as f:
                digest.update(name.encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"libhvdcore-{digest.hexdigest()[:12]}.so")


def _compile(cxx: str, flags: tuple[str, ...], out: str) -> None:
    """One ``g++ -c`` per source, all at once, then the link, in a
    temporary directory; the library is renamed into ``out`` at the end."""
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        def run(cmd):
            proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"{os.path.basename(cxx)} failed "
                                   f"(exit {proc.returncode}): "
                                   f"{' '.join(cmd)}\n{proc.stdout}")

        objs = [os.path.join(tmp, s + ".o") for s in SOURCES]
        with ThreadPoolExecutor(len(SOURCES)) as pool:
            list(pool.map(run, ([cxx, *flags, "-c", "-o", o,
                                 os.path.join(SRC, s + ".cc")]
                                for s, o in zip(SOURCES, objs))))
        lib = os.path.join(tmp, "lib.so")
        run([cxx, "-shared", *flags, *LINK_FLAGS, "-o", lib, *objs])
        os.replace(lib, out)   # atomic: a loader sees all of it or none


def build() -> str:
    """Build the library if it is not built yet; return its path."""
    cxx = _cxx()
    flags = _flags(cxx)
    out = library_path(flags)
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if not os.path.exists(out):
                _compile(cxx, flags, out)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return out


def load() -> ctypes.CDLL:
    """The loaded library, built at the first call.  Thread-safe."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = ctypes.CDLL(build())
        return _lib
