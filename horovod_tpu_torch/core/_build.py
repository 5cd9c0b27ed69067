"""Build and load the port's own copy of the native coordination core.

``horovod_tpu_torch/core/src`` holds the C++ control plane (negotiation,
fusion, the response cache, heartbeats, elastic reconfiguration, the
Chrome-tracing timeline), copied from ``horovod_tpu/core/src``.  It is
compiled with ``g++`` into one shared library under
``build/horovod_tpu_torch/core/`` of the checkout, at first use, and loaded
with ``ctypes``.  The two native tools beside it, the star benchmark and
the deviceless fleet simulator, build into executables of the same
directory (:func:`build_tool`; ``core/tools.py`` runs them).  The
library's file name carries a hash of every source
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

A second variant, the ThreadSanitizer build (``HVD_TPU_CORE_TSAN=1``, the
counterpart of the JAX core Makefile's ``tsan`` target), compiles the same
sources with :data:`TSAN_FLAGS` into ``libhvdcore-tsan-<hash>.so`` of the
same directory.  It links its C++ runtime dynamically, as ThreadSanitizer
needs, and loads only with the ``libtsan`` runtime preloaded
(``LD_PRELOAD``), which ``python -m horovod_tpu_torch.core.check``'s TSAN
leg sets.  Either variant is always built from this package's own sources:
no environment variable names a library path, so the JAX package's library
is never loaded.
"""

from __future__ import annotations

import ctypes
import fcntl
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from concurrent.futures import ThreadPoolExecutor

_HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(_HERE, "src")
TOOLS_SRC = os.path.join(SRC, "tools")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build",
                         "horovod_tpu_torch", "core")
SOURCES = ("message", "controller", "tree", "timeline", "half", "engine",
           "c_api")
# The native tools, each its own source (under ``src/tools``) and the core
# sources it links (``horovod_tpu/core/Makefile``'s ``star_bench`` and
# ``fleet_sim``).
TOOLS = {"star_bench": ("message", "controller", "timeline"),
         "fleet_sim": ("message", "controller", "tree", "timeline")}
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-pthread")
LINK_FLAGS = ("-static-libstdc++", "-static-libgcc", "-Wl,--exclude-libs,ALL",
              "-Wl,-Bsymbolic")
# The ThreadSanitizer variant: ``-O2`` gives way to these.
TSAN_FLAGS = ("-O1", "-g", "-fsanitize=thread")
TSAN_LINK_FLAGS = ("-fsanitize=thread",)

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


def _digest(*parts: str, extra: tuple[str, ...] = ()) -> str:
    """A hash of ``parts``, of every source and header of the library and
    of the ``extra`` files."""
    digest = hashlib.sha1(" ".join(parts).encode())
    files = [os.path.join(SRC, n) for n in sorted(os.listdir(SRC))
             if n.endswith((".cc", ".h"))]
    for path in files + list(extra):
        with open(path, "rb") as f:
            digest.update(os.path.basename(path).encode() + b"\0" + f.read())
    return digest.hexdigest()[:12]


def tsan_requested() -> bool:
    """True when ``HVD_TPU_CORE_TSAN=1`` asks for the ThreadSanitizer
    variant of the library."""
    return os.environ.get("HVD_TPU_CORE_TSAN", "") == "1"


def tsan_runtime() -> str | None:
    """Path of the ``libtsan`` runtime to preload for the ThreadSanitizer
    variant, or None.  Its soname differs by gcc major (``libtsan.so.0``
    on gcc 10, ``.so.2`` from gcc 12) and distributions keep it in
    different directories, so the usual places are searched; the highest
    version wins."""
    for pattern in ("/usr/lib/x86_64-linux-gnu/libtsan.so.*",
                    "/lib/x86_64-linux-gnu/libtsan.so.*",
                    "/usr/lib/gcc/x86_64-linux-gnu/*/libtsan.so",
                    "/usr/lib64/libtsan.so.*"):
        hits = sorted(p for p in glob.glob(pattern) if not p.endswith(".py"))
        if hits:
            return hits[-1]
    return None


def _variant(flags: tuple[str, ...], tsan: bool
             ) -> tuple[str, tuple[str, ...], tuple[str, ...]]:
    """(file-name prefix, compile flags, link flags) of one variant."""
    if not tsan:
        return "libhvdcore", flags, LINK_FLAGS
    return ("libhvdcore-tsan",
            tuple(f for f in flags if f != "-O2") + TSAN_FLAGS,
            TSAN_LINK_FLAGS)


def library_path(flags: tuple[str, ...], tsan: bool = False) -> str:
    prefix, flags, link = _variant(flags, tsan)
    return os.path.join(BUILD_DIR, f"{prefix}-{_digest(*flags, *link)}.so")


def _compile(cxx: str, flags: tuple[str, ...], out: str,
             link_flags: tuple[str, ...] = LINK_FLAGS) -> None:
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
        run([cxx, "-shared", *flags, *link_flags, "-o", lib, *objs])
        os.replace(lib, out)   # atomic: a loader sees all of it or none


def _locked_build(out: str, make) -> str:
    """``make(out)`` under the build directory's lock, unless ``out``
    exists; returns ``out``."""
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if not os.path.exists(out):
                make(out)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return out


def build(tsan: bool = False) -> str:
    """Build the library (its ThreadSanitizer variant if ``tsan``) if it is
    not built yet; return its path."""
    cxx = _cxx()
    base = _flags(cxx)
    _prefix, flags, link = _variant(base, tsan)
    return _locked_build(library_path(base, tsan),
                         lambda out: _compile(cxx, flags, out, link))


def build_tool(name: str) -> str:
    """Build the native tool ``name`` (a key of :data:`TOOLS`) into an
    executable of the build directory, as ``horovod_tpu/core/Makefile``'s
    target of that name builds it, if it is not built yet; return its
    path."""
    cxx = _cxx()
    flags = tuple(f for f in _flags(cxx) if f != "-fPIC")
    tool = os.path.join(TOOLS_SRC, name + ".cc")
    sources = [tool] + [os.path.join(SRC, s + ".cc") for s in TOOLS[name]]

    def make(out):
        # One ``g++ -c`` per source, all at once, then the link.
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            def run(cmd):
                proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True)
                if proc.returncode != 0:
                    raise RuntimeError(
                        f"{os.path.basename(cxx)} failed to build {name} "
                        f"(exit {proc.returncode}): {' '.join(cmd)}\n"
                        f"{proc.stdout}")

            objs = [os.path.join(tmp, f"{i}.o") for i in range(len(sources))]
            with ThreadPoolExecutor(len(sources)) as pool:
                list(pool.map(run, ([cxx, *flags, "-I", SRC, "-c", "-o", o,
                                     src] for src, o in zip(sources, objs))))
            exe = os.path.join(tmp, name)
            run([cxx, *flags, "-o", exe, *objs])
            os.replace(exe, out)

    digest = _digest(name, *flags, extra=(tool,))
    return _locked_build(os.path.join(BUILD_DIR, f"{name}-{digest}"), make)


def load() -> ctypes.CDLL:
    """The loaded library, built at the first call: the ThreadSanitizer
    variant when :func:`tsan_requested`, else the plain one.  Thread-safe."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = ctypes.CDLL(build(tsan=tsan_requested()))
        return _lib
