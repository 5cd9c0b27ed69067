"""The benchmark's general machinery: find a cell and everything it names
by name, check the process's imports and device, and print the result.

Everything that belongs to one configuration, traffic mix or per-layer
metric lives in a file of its own, found by the name ``BENCHMARK.json``
gives it:

* ``configs/<config>.json``: the configuration as it is run; its
  ``family`` names ``models/<family>.py`` (the builder of the program's
  model from a seed) and ``reference/<family>.py`` (the plain reference);
* ``traffic/<traffic>.json``: a traffic mix, plain parameters; its
  ``kind`` names the general driver ``kinds/<kind>.py`` that reads it;
* ``metrics/<metric>.py``: one per-layer metric, a ``read(window)``;
* ``limits/<cell>.json``: the limits of the cell's correctness check.

Adding a cell, a mix, a configuration or a metric adds files and an
entry in ``BENCHMARK.json``; no file that is there changes.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
SPEC = os.path.join(ROOT, "BENCHMARK.json")

# Top-level module names that no process of the benchmark may hold: the
# JAX stack and the JAX package that the port was made from.  Compared
# whole: the port's own name begins with the JAX package's.
FORBIDDEN = ("jax", "jaxlib", "flax", "horovod_tpu")
# What the plain references may not import besides: the program.
PROGRAM = "horovod_tpu_torch"


LOG_TAG = ""


def log(msg: str) -> None:
    """A progress line on standard error, with the process's time."""
    import time

    print(f"perfbench{LOG_TAG} [{time.perf_counter():9.2f}] {msg}",
          file=sys.stderr, flush=True)


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def spec(path: str = SPEC) -> dict:
    return load_json(path)


def cell(name: str, bench: dict | None = None) -> dict:
    bench = bench or spec()
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(name: str) -> dict:
    return load_json(os.path.join(HERE, "configs", f"{name}.json"))


def traffic(name: str) -> dict:
    return load_json(os.path.join(HERE, "traffic", f"{name}.json"))


def limits(cell_name: str) -> dict:
    """``{number: limit}`` of a cell; empty where none is set yet, and then
    no run of the cell can come out correct."""
    path = os.path.join(HERE, "limits", f"{cell_name}.json")
    if not os.path.exists(path):
        return {}
    return {k: v["limit"] for k, v in load_json(path).items()}


def kind(name: str):
    return importlib.import_module(f"perfbench.kinds.{name}")


def metric(name: str):
    """The reader of per-layer metric ``name``: ``metrics/<name>.py``,
    loaded by path (metric names hold dots)."""
    path = os.path.join(HERE, "metrics", f"{name}.py")
    mod_name = "perfbench.metrics._" + name.replace(".", "_").replace("-", "_")
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    s = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(s)
    s.loader.exec_module(mod)
    sys.modules[mod_name] = mod
    return mod


def metrics_of(cell_name: str, section: str, bench: dict | None = None):
    """The entries of ``section`` (``end_to_end`` or ``per_layer``) that
    cell ``cell_name`` reports: those whose ``workloads`` list it, and
    those without the key."""
    bench = bench or spec()
    return [m for m in bench[section]
            if cell_name in m.get("workloads", [cell_name])]


def forbidden_modules(modules=None, names=FORBIDDEN) -> list[str]:
    """The loaded modules whose top-level name (before the first dot) is
    one of ``names``, compared whole."""
    modules = sys.modules if modules is None else modules
    return sorted(m for m in list(modules) if m.split(".", 1)[0] in names)


def check_imports(modules=None) -> None:
    """Raise where the process holds JAX or the JAX package."""
    found = forbidden_modules(modules)
    if found:
        raise SystemExit(f"perfbench: forbidden modules loaded: "
                         f"{', '.join(found[:20])}")


def require_cuda(chips: int) -> None:
    """Exit without a result where the card or cards are missing."""
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("perfbench: no CUDA device")
    if torch.cuda.device_count() < chips:
        raise SystemExit(f"perfbench: the cell needs {chips} CUDA devices, "
                         f"{torch.cuda.device_count()} visible")


def device_info(device, chips: int, peak_bytes: int) -> dict:
    import torch

    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": chips,
                "memory_peak_bytes": peak_bytes}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": chips, "memory_peak_bytes": peak_bytes}


def judge(numbers: dict, lims: dict) -> tuple[bool, dict]:
    """``correct`` and ``{number: {"value", "limit"}}``: every number is
    finite and at most its limit, and every limit has its number."""
    checks, ok = {}, bool(lims)
    for k, v in numbers.items():
        lim = lims.get(k)
        checks[k] = {"value": v, "limit": lim}
        if lim is None or v is None or not math.isfinite(v) or v > lim:
            ok = False
    for k in lims:
        if k not in numbers:
            ok = False
            checks[k] = {"value": None, "limit": lims[k]}
    return ok, checks


def emit(result: dict, checks: dict) -> None:
    """The compared numbers as the last lines of standard error, then the
    result as the last line of standard output, ``checks`` its last key."""
    for k, c in checks.items():
        print(f"check {k} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps({**result, "checks": checks}), flush=True)


def env_for_program() -> None:
    """Caches of the program in fixed directories inside the checkout (the
    kernels build under ``build/horovod_tpu_torch/`` by the program's own
    rule), and no library of the program loads JAX by itself."""
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build",
                                                      "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")
