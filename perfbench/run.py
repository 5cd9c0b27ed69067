"""Run one cell of the benchmark once.

    python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout.  Finds the cell in ``BENCHMARK.json``, its
configuration, traffic mix and limits by name (``perfbench/harness.py``),
exits without a result where the card or cards it asks for are missing,
runs the traffic's kind, and prints the result as the last line of
standard output: with ``--trace 0`` the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics, the device's busy time and the
traced window, and the breakdown.  The compared numbers and their limits
are the last lines of standard error and the last key of the result."""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import sys  # noqa: E402
from typing import Any  # noqa: E402

from perfbench import harness  # noqa: E402


@dataclasses.dataclass
class Run:
    """What a kind gets: the cell, its configuration and traffic, the
    run's arguments, the device, and the process's start time."""

    cell: dict
    cfg: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: Any
    t0: float
    chips: int = 1
    # "module:function" calls made in every rank before it runs (tests
    # plant faults with them; a run of the benchmark has none).
    patches: tuple = ()


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="python3 -m perfbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def per_layer(cell_name: str, trace: dict, bench: dict) -> dict:
    """Every per-layer metric of the cell whose reader finds something to
    read in the traced window."""
    out = {}
    for m in harness.metrics_of(cell_name, "per_layer", bench):
        value = harness.metric(m["name"]).read(trace)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def execute(cell_name: str, seed: int, seconds: float, trace: bool,
            device=None, cfg=None, traffic=None, lims=None,
            bench=None, t0=None, patches=()) -> dict:
    """Run the cell and return the result line's object (without
    printing).  ``device``, ``cfg``, ``traffic`` and ``lims`` override
    what the cell names, and ``patches`` plant faults in every rank
    (tests run it small on the CPU)."""
    import torch

    bench = bench or harness.spec()
    cell = harness.cell(cell_name, bench)
    cfg = cfg or harness.config(cell["config"])
    traffic = traffic or harness.traffic(cell["traffic"])
    lims = harness.limits(cell_name) if lims is None else lims
    harness.env_for_program()
    if device is None:
        harness.require_cuda(cell["chips"])
        device = torch.device("cuda", 0)
    device = torch.device(device)
    run = Run(cell=cell, cfg=cfg, traffic=traffic, seed=seed,
              seconds=seconds, trace=trace, device=device,
              t0=T0 if t0 is None else t0, chips=cell["chips"],
              patches=tuple(patches))
    if patches:
        from perfbench import ranks

        ranks.apply_patches(patches)
    out = harness.kind(traffic["kind"]).run(run)
    harness.check_imports()
    correct, checks = harness.judge(out["numbers"], lims)
    info = harness.device_info(device, cell["chips"], out["peak_bytes"])
    result = {"correct": correct, "attempted": out["attempted"],
              "failed": out["failed"]}
    if trace:
        tr = out["trace"]
        result["metrics"] = per_layer(cell_name, tr, bench)
        info["busy_s"] = tr["busy_s"]
        info["window_s"] = tr["window_s"]
        result["device"] = info
        result["breakdown"] = out["window"].breakdown()
    else:
        units = {m["name"]: m["unit"] for m in bench["end_to_end"]}
        result["metrics"] = {
            m["name"]: {"value": out["e2e"][m["name"]],
                        "unit": units[m["name"]]}
            for m in harness.metrics_of(cell_name, "end_to_end", bench)}
        result["device"] = info
    return {"result": result, "checks": checks}


def main(argv=None) -> int:
    args = parse_args(argv)
    out = execute(args.workload, args.seed, args.seconds, bool(args.trace))
    harness.emit(out["result"], out["checks"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
