"""``python -m horovod_tpu_torch.examples.weak_scaling_benchmark`` — the
weak-scaling harness of the eager engine's data plane; counterpart of
``examples/weak_scaling_benchmark.py``.

Each step is the ``DistributedOptimizer`` cadence stripped to its two
terms: a fixed local matmul loop (``--compute-reps`` products of a
``--compute-dim`` square, on the device) and one engine allreduce of a
``--grad-mb`` buffer (``allreduce_async`` + ``synchronize``).  Run at
``-np 1, 2, 4, ...`` and read ``steps_per_s_per_rank``: with a
bandwidth-optimal allreduce the wire bytes a rank stay ~2V whatever the
width (``wire_model_mb_per_rank_per_step`` = 2(n − 1)/n × V), so the
rate stays flat.  Every rank prints one JSON row, with its card's
``nvidia-smi`` name and power limit.

Run:  python -m horovod_tpu_torch.run -np 2 -- \\
          python -m horovod_tpu_torch.examples.weak_scaling_benchmark
"""

from __future__ import annotations

import argparse
import json
import time

import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch import basics
from horovod_tpu_torch.examples._common import add_device
from horovod_tpu_torch.train_synthetic import card


def make_step(grad: torch.Tensor, a: torch.Tensor, reps: int):
    """The step: the matmul loop, then the engine allreduce; reading the
    two results waits for both."""

    def step(i: int) -> float:
        acc = a
        for _ in range(reps):
            acc = acc @ a
        out = hvd.synchronize(hvd.allreduce_async(grad, average=True,
                                                  name=f"ws.{i}"))
        return float(acc[0, 0]) + float(out[0])

    return step


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m horovod_tpu_torch.examples"
                                 ".weak_scaling_benchmark")
    ap.add_argument("--grad-mb", type=float, default=16.0,
                    help="allreduced bytes a step")
    ap.add_argument("--compute-dim", type=int, default=384,
                    help="square matmul dim of the fixed local compute")
    ap.add_argument("--compute-reps", type=int, default=8)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--warmup", type=int, default=2)
    add_device(ap)
    args = ap.parse_args(argv)

    hvd.init(device=args.device)
    dev = basics.device()
    gen = torch.Generator().manual_seed(hvd.rank())
    grad = torch.rand(int(args.grad_mb * 1e6 / 4), generator=gen).to(dev)
    # Entries in [0, 1/dim): the products stay bounded.
    a = (torch.rand(args.compute_dim, args.compute_dim, generator=gen)
         / args.compute_dim).to(dev)
    step = make_step(grad, a, args.compute_reps)
    for i in range(args.warmup):
        step(-1 - i)
    hvd.barrier(name="ws.start")
    t0 = time.perf_counter()
    for i in range(args.steps):
        step(i)
    dt = time.perf_counter() - t0
    hvd.barrier(name="ws.done")
    n = hvd.size()
    print(json.dumps({
        "rank": hvd.rank(), "workers": n,
        "steps_per_s_per_rank": args.steps / dt,
        "grad_mb": args.grad_mb,
        "wire_model_mb_per_rank_per_step": round(
            2 * (n - 1) / n * args.grad_mb, 2),
        "card": card()}), flush=True)
    hvd.shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
