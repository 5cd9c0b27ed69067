"""A cell on several chips: one process a chip.  The process that ``run``
started is rank 0 and prints the result; it starts ranks 1 … n-1 as
``python3 -m perfbench.ranks <run as JSON> <rank> <port>``, each on its
own card, joins them in one ``torch.distributed`` job over
``tcp://127.0.0.1:<port>``, and waits for every one to end."""

from __future__ import annotations

import importlib
import json
import os
import socket
import subprocess
import sys
import time

from perfbench import harness

JOIN_TIMEOUT_S = 120


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_device(device, rank: int):
    import torch

    if torch.device(device).type == "cuda":
        return torch.device("cuda", rank)
    return torch.device("cpu")


def _encode(run) -> str:
    return json.dumps({"cell": run.cell, "cfg": run.cfg,
                       "traffic": run.traffic, "seed": run.seed,
                       "seconds": run.seconds, "trace": run.trace,
                       "device": str(run.device), "chips": run.chips,
                       "patches": list(run.patches)})


def apply_patches(patches) -> None:
    """Call each ``"module:function"`` of ``patches`` (tests plant faults
    in every rank this way; a run of the benchmark has none)."""
    for spec in patches:
        mod, fn = spec.split(":")
        getattr(importlib.import_module(mod), fn)()


def launch(run, rank_main):
    """Run ``rank_main(run, rank, world, init_method)`` on every rank, this
    process rank 0, and return rank 0's result."""
    world = run.chips
    port = free_port()
    enc = _encode(run)
    env = dict(os.environ)
    env["PYTHONPATH"] = harness.ROOT + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "perfbench.ranks", enc, str(r), str(port)],
        cwd=harness.ROOT, env=env) for r in range(1, world)]
    try:
        out = rank_main(run, 0, world, f"tcp://127.0.0.1:{port}")
    except BaseException:
        for p in procs:
            p.kill()
        raise
    finally:
        deadline = time.monotonic() + JOIN_TIMEOUT_S
        for p in procs:
            try:
                p.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
    bad = [p.returncode for p in procs if p.returncode]
    if bad:
        raise RuntimeError(f"a rank exited with {bad}")
    return out


def main(argv=None) -> int:
    from perfbench.run import Run

    enc, rank, port = (argv or sys.argv[1:])[:3]
    d = json.loads(enc)
    rank = int(rank)
    harness.LOG_TAG = f" rank {rank}"
    harness.env_for_program()
    run = Run(cell=d["cell"], cfg=d["cfg"], traffic=d["traffic"],
              seed=d["seed"], seconds=d["seconds"], trace=d["trace"],
              device=rank_device(d["device"], rank),
              t0=time.perf_counter(), chips=d["chips"],
              patches=tuple(d["patches"]))
    apply_patches(run.patches)
    kind = harness.kind(d["traffic"]["kind"])
    kind.rank_main(run, rank, run.chips, f"tcp://127.0.0.1:{port}")
    harness.check_imports()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
