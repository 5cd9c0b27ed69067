"""The port's pre-PR gate — counterpart of ``horovod_tpu/core/Makefile``'s
``make check``.

Usage::

    python -m horovod_tpu_torch.core.check [werror] [lint] [modelcheck]
                                           [ruff] [tsan]

With no leg named, every leg runs in that order; the exit status is 0 only
when every leg that ran passed (a skipped leg does not fail the gate).

* ``werror`` — each source of ``core/src`` and ``core/src/tools`` compiled
  alone with the Makefile's flags and its ``WERROR_EXTRA`` warnings
  (:data:`WERROR_FLAGS`), one compiler per source, all at once;
* ``lint`` — the port's linter (:mod:`horovod_tpu_torch.analysis.lint`)
  over ``horovod_tpu_torch``, ``tests/test_torch_*.py`` and
  ``chip_smoke.py``;
* ``modelcheck`` — the protocol model check
  (``python -m horovod_tpu_torch.analysis.protocol``, which honours
  ``MODELCHECK_SKIP``/``_DEPTH``/``_SEED``/``_WIDE``);
* ``ruff`` — ``ruff check`` over the same files when ``ruff`` is on the
  path, else reported as skipped;
* ``tsan`` — builds the ThreadSanitizer variant of the port's core
  (``core/_build.py``) and runs the ``tsan``-marked tests of
  ``tests/test_torch_tsan.py`` against it; each test preloads the
  ``libtsan`` runtime into its engine processes and fails on any race
  report whose stack touches the library.

The tests and ``chip_smoke.py`` live in the checkout, so the ``lint``,
``ruff`` and ``tsan`` legs run from one.
"""

from __future__ import annotations

import glob
import os
import runpy
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

from horovod_tpu_torch.core import _build

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# The JAX core Makefile's CXXFLAGS beyond the build's own, and its
# WERROR_EXTRA set.
WERROR_FLAGS = ("-g", "-Wall", "-Wextra", "-Werror", "-Wshadow", "-Wundef",
                "-Wpointer-arith", "-Wcast-qual", "-Wwrite-strings",
                "-Wformat=2", "-Wvla", "-Wnon-virtual-dtor")
TSAN_TESTS = ("tests/test_torch_tsan.py",)
PASSED, FAILED, SKIPPED = "passed", "FAILED", "skipped"


def lint_targets() -> list[str]:
    """The files the ``lint`` and ``ruff`` legs check, relative to the
    checkout."""
    tests = sorted(os.path.relpath(p, REPO) for p in glob.glob(
        os.path.join(REPO, "tests", "test_torch_*.py")))
    return ["horovod_tpu_torch", *tests, "chip_smoke.py"]


def werror() -> str:
    cxx = _build._cxx()
    flags = _build._flags(cxx) + WERROR_FLAGS
    sources = sorted(glob.glob(os.path.join(_build.SRC, "*.cc"))) + sorted(
        glob.glob(os.path.join(_build.TOOLS_SRC, "*.cc")))

    def compile_one(src):
        return src, subprocess.run(
            [cxx, *flags, "-I", _build.SRC, "-c", "-o", os.devnull, src],
            capture_output=True, text=True)

    with ThreadPoolExecutor(len(sources)) as pool:
        results = list(pool.map(compile_one, sources))
    failed = False
    for src, proc in results:
        print(f"  CXX {os.path.relpath(src, REPO)}"
              f"{'' if proc.returncode == 0 else '  FAILED'}")
        if proc.returncode != 0:
            failed = True
            print(proc.stderr)
    return FAILED if failed else PASSED


def lint() -> str:
    from horovod_tpu_torch.analysis.lint import iter_py_files, lint_paths

    paths = [os.path.join(REPO, p) for p in lint_targets()]
    errors = lint_paths(paths)
    for e in errors:
        print(f"  {e.render()}")
    print(f"  {len(errors)} finding(s) in {len(iter_py_files(paths))} "
          f"file(s)")
    return FAILED if errors else PASSED


def modelcheck() -> str:
    try:
        runpy.run_module("horovod_tpu_torch.analysis.protocol",
                         run_name="__main__")
    except SystemExit as e:
        return PASSED if not e.code else FAILED
    return PASSED


def ruff() -> str:
    exe = shutil.which("ruff")
    if exe is None:
        print("  ruff not installed: leg skipped")
        return SKIPPED
    proc = subprocess.run([exe, "check", *lint_targets()], cwd=REPO)
    return PASSED if proc.returncode == 0 else FAILED


def tsan() -> str:
    runtime = _build.tsan_runtime()
    if runtime is None:
        print("  no libtsan runtime found: the TSAN leg cannot run")
        return FAILED
    t0 = time.perf_counter()
    lib = _build.build(tsan=True)
    print(f"  built {os.path.relpath(lib, REPO)} "
          f"({time.perf_counter() - t0:.1f} s); runtime {runtime}")
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-m", "tsan",
         "-p", "no:cacheprovider", *TSAN_TESTS], cwd=REPO, env=env)
    return PASSED if proc.returncode == 0 else FAILED


LEGS = {"werror": werror, "lint": lint, "modelcheck": modelcheck,
        "ruff": ruff, "tsan": tsan}


def main(argv: list[str] | None = None) -> int:
    names = list(sys.argv[1:] if argv is None else argv) or list(LEGS)
    unknown = [n for n in names if n not in LEGS]
    if unknown:
        print(f"unknown leg(s) {unknown}; the legs are {list(LEGS)}",
              file=sys.stderr)
        return 2
    results = {}
    for name in names:
        print(f"== {name} ==", flush=True)
        t0 = time.perf_counter()
        results[name] = LEGS[name]()
        print(f"== {name}: {results[name]} "
              f"({time.perf_counter() - t0:.1f} s) ==", flush=True)
    failed = [n for n, r in results.items() if r == FAILED]
    print("check: " + ", ".join(f"{n} {r}" for n, r in results.items()))
    if failed:
        print(f"check: FAILED ({', '.join(failed)})")
        return 1
    print("check: all gates passed")
    return 0


if __name__ == "__main__":
    sys.exit(main())
