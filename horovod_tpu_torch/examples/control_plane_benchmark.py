"""``python -m horovod_tpu_torch.examples.control_plane_benchmark`` — the
eager engine's control plane at a given width; counterpart of
``examples/control_plane_benchmark.py``.

The engine's coordinator is a rank-0 TCP star: each tick gathers one frame
a worker and broadcasts the responses.  At the job's width it reports

* ``rendezvous_s``: the wall time of ``init`` (the process group and the
  engine's accept quorum);
* ``per_op_ms``: a lone 4-element allreduce through the engine
  (``allreduce_async`` + ``synchronize``): one negotiation round trip and
  the dispatch of its batch;
* ``names_per_s``: the rate with ``--burst`` outstanding names a round,
  which the negotiation batches, so it isolates the coordinator's frame
  handling from the cycle time;

as one JSON row with the card's ``nvidia-smi`` name and power limit.
``--star P1,P2,...`` instead runs the isolated star harness
(``core/tools.star_bench``: the real gather and broadcast over loopback
threads, no device), one JSON row a width; the tool is built from the
port's own sources on first use.

Run:  python -m horovod_tpu_torch.run -np 4 -- \\
          python -m horovod_tpu_torch.examples.control_plane_benchmark
      python -m horovod_tpu_torch.examples.control_plane_benchmark \\
          --star 63,128,256,512
"""

from __future__ import annotations

import argparse
import json
import time

from horovod_tpu_torch.examples._common import add_device


def run_star(widths: str, ticks: int, names: int) -> list[dict]:
    from horovod_tpu_torch.core import tools

    rows = []
    for p in widths.split(","):
        rows.append(tools.star_bench(int(p), ticks=ticks, names=names))
        print(json.dumps(rows[-1]), flush=True)
    return rows


def measure(rounds: int, burst: int, warmup: int, device) -> dict:
    """Init the job on ``device``, then time the lone op and the bursts."""
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import basics
    from horovod_tpu_torch.train_synthetic import card

    t0 = time.perf_counter()
    hvd.init(device=device)
    rendezvous_s = time.perf_counter() - t0
    x = torch.ones(4, device=basics.device())

    def allreduce(name):
        return hvd.synchronize(hvd.allreduce_async(x, name=name))

    for i in range(warmup):           # the engine's start, first tick
        allreduce(f"warm.{i}")
    t0 = time.perf_counter()
    for i in range(rounds):
        allreduce(f"lone.{i}")
    per_op_ms = (time.perf_counter() - t0) / rounds * 1e3
    t0 = time.perf_counter()
    for r in range(rounds):
        handles = [hvd.allreduce_async(x, name=f"burst.{r}.{i}")
                   for i in range(burst)]
        for h in handles:
            hvd.synchronize(h)
    names_per_s = rounds * burst / (time.perf_counter() - t0)
    return {"np": hvd.size(), "rendezvous_s": rendezvous_s,
            "per_op_ms": per_op_ms, "names_per_s": names_per_s,
            "card": card()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m horovod_tpu_torch.examples"
                                 ".control_plane_benchmark")
    ap.add_argument("--rounds", type=int, default=30)
    ap.add_argument("--burst", type=int, default=100,
                    help="outstanding async tensors a saturated round")
    ap.add_argument("--warmup", type=int, default=5)
    ap.add_argument("--star", default=None,
                    help="comma-separated widths for the isolated star "
                    "harness (no device; e.g. 63,128,256,512)")
    ap.add_argument("--star-ticks", type=int, default=200)
    ap.add_argument("--star-names", type=int, default=1,
                    help="negotiation names per worker frame")
    add_device(ap)
    args = ap.parse_args(argv)

    if args.star:
        run_star(args.star, args.star_ticks, args.star_names)
        return 0

    import horovod_tpu_torch as hvd   # the star path needs no torch

    row = measure(args.rounds, args.burst, args.warmup, args.device)
    if hvd.rank() == 0:
        print(json.dumps(row), flush=True)
    hvd.shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
