"""Eager collectives over ``torch.distributed`` — counterpart of
``horovod_tpu/ops/collective_ops.py``.

Each process contributes one tensor on its own device (the card under
NCCL, the CPU under gloo).  With one process every collective returns its
input, as the JAX package's ``_eager_process_reduce`` does.

:func:`grouped_allreduce` takes the schedule planner's plan
(``ops/schedule_plan.py``), as the JAX package's single-axis path does:
when the plan is chained, the tensors form buckets over the reverse tensor
index, as ``_chained_allreduce`` cuts them, each bucket's flat buffers are
reduced by an asynchronous collective issued in bucket order
(:func:`grouped_allreduce_async`), and :func:`synchronize` waits for them;
otherwise one fused pass.  Within a bucket ``HOROVOD_FUSION_THRESHOLD``
still splits the collective (``ops/fusion.py``).  The JAX package's
in-mesh ``psum`` inside ``shard_map`` and its int8 wire have no
counterpart here.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist

from horovod_tpu_torch import basics
from horovod_tpu_torch.ops import fusion, schedule_plan
from horovod_tpu_torch.ops.compression import Compression


def _process_reduce(x: torch.Tensor) -> torch.Tensor:
    """Sum of ``x`` over the processes (``x`` itself with one)."""
    if basics.size() == 1:
        return x
    out = x.clone()
    dist.all_reduce(out)
    return out


def allreduce(tensor, average: bool = True, compression=Compression.none):
    """Sum (or average) ``tensor`` across all processes; ``compression``
    casts to the wire dtype around the collective."""
    compressed, ctx = compression.compress(tensor)
    reduced = _process_reduce(compressed)
    if average:
        reduced = reduced / basics.size()
    return compression.decompress(reduced, ctx)


@dataclasses.dataclass
class AllreduceHandle:
    """Allreduces in flight over one group of tensors: their flat buffers
    (``fusion.pack``), reduced in place by ``works`` (none with one
    process)."""

    packed: list
    works: list
    ctxs: list
    average: bool
    compression: object


def grouped_allreduce_async(tensors: Sequence, average: bool = True,
                            compression=Compression.none,
                            threshold_bytes: int | None = None
                            ) -> AllreduceHandle:
    """Issue the allreduce of ``tensors`` and return at once: the tensors
    are copied into flat buffers of at most ``threshold_bytes`` each, and
    one ``dist.all_reduce(..., async_op=True)`` is issued per buffer.
    :func:`synchronize` waits and gives the results."""
    comp = [compression.compress(t) for t in tensors]
    packed = fusion.pack([c for c, _ in comp], threshold_bytes)
    works = ([dist.all_reduce(flat, async_op=True) for _, flat in packed]
             if basics.size() > 1 else [])
    return AllreduceHandle(packed, works, [ctx for _, ctx in comp], average,
                           compression)


def synchronize(handle: AllreduceHandle) -> list:
    """Wait for ``handle``'s collectives; its tensors summed (or averaged)
    across the processes, in their own dtypes."""
    for w in handle.works:
        w.wait()
    reduced = fusion.unpack(handle.packed, len(handle.ctxs))
    if handle.average:
        reduced = [r / basics.size() for r in reduced]
    return [handle.compression.decompress(r, ctx)
            for r, ctx in zip(reduced, handle.ctxs)]


def plan_bucket_indices(count: int, plan) -> list[list[int]]:
    """The tensor indices of a chained plan's buckets, in the order they
    are issued: ``_chained_allreduce``'s cut of the reverse tensor index
    into ``plan.chain_depth`` buckets of equal count, or at
    ``plan.bounds``."""
    bounds = (np.linspace(0, count, plan.chain_depth + 1).astype(int)
              if plan.bounds is None else np.asarray(plan.bounds, dtype=int))
    rev = list(range(count))[::-1]
    return [rev[lo:hi] for lo, hi in zip(bounds[:-1], bounds[1:]) if hi > lo]


def fused_allreduce(tensors: Sequence, average: bool = True,
                    compression=Compression.none,
                    threshold_bytes: int | None = None) -> list:
    """Allreduce of many tensors through flat buckets of at most
    ``threshold_bytes`` (``HOROVOD_FUSION_THRESHOLD``): one collective per
    bucket instead of one per tensor, after the caller's tensors all
    exist."""
    comp = [compression.compress(t) for t in tensors]
    reduced = fusion.fused_apply([c for c, _ in comp], _process_reduce,
                                 threshold_bytes)
    if average:
        reduced = [r / basics.size() for r in reduced]
    return [compression.decompress(r, ctx)
            for r, (_, ctx) in zip(reduced, comp)]


def grouped_allreduce(tensors: Sequence, average: bool = True,
                      compression=Compression.none,
                      threshold_bytes: int | None = None,
                      overlap_buckets: int | None = None,
                      planner=None) -> list:
    """Allreduce of many tensors, as the schedule planner decides
    (``ops/schedule_plan.py``): the default ``AdaptivePlanner`` bypasses
    at width 1 and chains 4 buckets at real width; ``overlap_buckets=`` or
    a set ``HOROVOD_OVERLAP_BUCKETS`` pins the static semantics (0 =
    bypass, N = N buckets), and ``planner=`` replaces the policy.  A
    chained plan issues each bucket's collectives asynchronously, in
    bucket order, then waits for all; the bypass is
    :func:`fused_allreduce`.  The decision is observable via
    ``overlap_plan()``."""
    tensors = list(tensors)
    wire = [compression.compress(t)[0] for t in tensors]
    plan = schedule_plan.plan_overlap(wire, width=basics.size(),
                                      override=overlap_buckets,
                                      planner=planner)
    if not plan.chained:
        return fused_allreduce(tensors, average, compression,
                               threshold_bytes)
    handles = [(idx, grouped_allreduce_async(
                   [tensors[i] for i in idx], average, compression,
                   threshold_bytes))
               for idx in plan_bucket_indices(len(tensors), plan)]
    out: list = [None] * len(tensors)
    for idx, h in handles:
        for i, r in zip(idx, synchronize(h)):
            out[i] = r
    return out


def allgather(tensor):
    """Concatenate every process's tensor along dim 0; the dim-0 sizes may
    differ between processes (gathered first, then the tensors padded to
    the largest and sliced back, as the JAX package does)."""
    if basics.size() == 1:
        return tensor
    n = basics.size()
    dim0 = tensor.shape[0]
    sizes = [torch.zeros(1, dtype=torch.int64, device=tensor.device)
             for _ in range(n)]
    dist.all_gather(sizes, torch.tensor([dim0], device=tensor.device))
    sizes = [int(s) for s in sizes]
    padded = tensor.new_zeros((max(sizes),) + tuple(tensor.shape[1:]))
    padded[:dim0] = tensor
    parts = [torch.empty_like(padded) for _ in range(n)]
    dist.all_gather(parts, padded)
    return torch.cat([p[:s] for p, s in zip(parts, sizes)], dim=0)


def broadcast(tensor, root_rank: int = 0):
    """Every process receives ``root_rank``'s value (a new tensor)."""
    if basics.size() == 1:
        return tensor
    out = tensor.clone()
    dist.broadcast(out, src=root_rank)
    return out
