"""``python -m horovod_tpu_torch.examples.collective_microbench`` — what
the job's collectives sustain against message size, and their dispatch
floor; counterpart of ``examples/collective_microbench.py``.

For each of ``--sizes-mb`` it times ``torch.distributed.all_reduce`` and
``all_gather_into_tensor`` of an f32 buffer over the job's group (NCCL on
the card, gloo on the CPU) and reports the ms a call and the GB/s under
the ring model of the JAX harness: wire bytes a rank are ``2(n − 1)/n``
of the message for the allreduce and ``(n − 1)/n`` for the all-gather (0
at world 1).  Then the dispatch floor: a 128-element allreduce timed alone.
At world 1 on one card that is NCCL's own floor (no byte leaves the card);
it bounds how finely fusion may slice the gradient buckets.  One JSON row
per size and one for the floor, each with the card's ``nvidia-smi`` name
and power limit; on the card each timing window ends in
``torch.cuda.synchronize``.

Run:  python -m horovod_tpu_torch.examples.collective_microbench
          [--sizes-mb 1,4,16,64,256] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import time

import torch
import torch.distributed as dist

import horovod_tpu_torch as hvd
from horovod_tpu_torch import basics
from horovod_tpu_torch.examples._common import add_device
from horovod_tpu_torch.train_synthetic import card


def timed_ms(fn, warmup: int, iters: int, device) -> float:
    """Mean ms of ``fn()`` over ``iters`` calls after ``warmup``."""

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    for _ in range(warmup):
        fn()
    sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    sync()
    return (time.perf_counter() - t0) / iters * 1e3


def ring_gbps(factor: float, nbytes: int, ms: float) -> float:
    return factor * nbytes / (ms * 1e-3) / 1e9 if ms > 0 else 0.0


def measure(sizes_mb, warmup: int, iters: int) -> list[dict]:
    """The rows: one a size, then the dispatch floor."""
    dev, group = basics.device(), basics.process_group()
    n, gpu = hvd.size(), card()
    rows = []
    for mb in sizes_mb:
        elems = int(mb * 1e6 / 4)
        x = torch.full((elems,), float(hvd.rank()), device=dev)
        gathered = torch.empty(n * elems, device=dev)
        ar = timed_ms(lambda: dist.all_reduce(x, group=group), warmup,
                      iters, dev)
        ag = timed_ms(lambda: dist.all_gather_into_tensor(gathered, x,
                                                          group=group),
                      warmup, iters, dev)
        rows.append({
            "size_mb": mb, "workers": n,
            "all_reduce_ms": ar, "all_gather_ms": ag,
            "all_reduce_ring_GBps": ring_gbps(2 * (n - 1) / n, elems * 4,
                                              ar),
            "all_gather_ring_GBps": ring_gbps((n - 1) / n, elems * 4, ag),
            "backend": dist.get_backend(group), "card": gpu})
    tiny = torch.zeros(128, device=dev)
    rows.append({
        "dispatch_floor_ms": timed_ms(
            lambda: dist.all_reduce(tiny, group=group), warmup,
            max(iters, 100), dev),
        "workers": n, "backend": dist.get_backend(group), "card": gpu})
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m horovod_tpu_torch.examples"
                                 ".collective_microbench")
    ap.add_argument("--sizes-mb", default="1,4,16,64,256")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--warmup", type=int, default=3)
    add_device(ap)
    args = ap.parse_args(argv)

    hvd.init(device=args.device)
    rows = measure([float(s) for s in args.sizes_mb.split(",")],
                   args.warmup, args.iters)
    if hvd.rank() == 0:
        for row in rows:
            print(json.dumps(row), flush=True)
    hvd.shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
