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
still splits the collective (``ops/fusion.py``).

The int8 wire (:func:`quantized_grouped_allreduce`, and ``allreduce`` /
``DistributedOptimizer`` with ``Compression.int8``) is the JAX package's
eager route: each rank quantizes every tensor on its own per-tensor scale
(``core/qwire.py``), the payloads are all-gathered, and every rank sums
them rank by rank in f32, so the result is bit-for-bit the reference's;
the local quantization error comes back as a residual for error feedback.
:func:`alltoall` (even or ragged splits), :func:`allreduce_sparse` /
:func:`sparse_to_dense` and :func:`allgather_object` complete the surface.
Every collective runs over the job's group (``basics.process_group()``,
a subset under ``init(ranks=...)``).  The JAX package's in-mesh ``psum``
inside ``shard_map`` has no counterpart here.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist

import pickle

from horovod_tpu_torch import basics
from horovod_tpu_torch.core import qwire
from horovod_tpu_torch.ops import fusion, schedule_plan
from horovod_tpu_torch.ops.compression import Compression


def _process_reduce(x: torch.Tensor) -> torch.Tensor:
    """Sum of ``x`` over the processes (``x`` itself with one)."""
    if basics.size() == 1:
        return x
    out = x.clone()
    dist.all_reduce(out, group=basics.process_group())
    return out


def allreduce(tensor, average: bool = True, compression=Compression.none,
              prescale_factor: float = 1.0):
    """Sum (or average) ``tensor`` across all processes; ``compression``
    casts to the wire dtype around the collective, and
    ``prescale_factor`` multiplies each process's contribution first (on
    the wire dtype, as the JAX package does).  ``Compression.int8`` goes
    through :func:`quantized_grouped_allreduce` (no error feedback at this
    granularity: ``DistributedOptimizer`` carries it)."""
    if compression is Compression.int8:
        if prescale_factor != 1.0:
            tensor = tensor * prescale_factor
        (reduced,), _ = quantized_grouped_allreduce([tensor], average=average)
        return reduced
    compressed, ctx = compression.compress(tensor)
    if prescale_factor != 1.0:
        compressed = compressed * prescale_factor
    reduced = _process_reduce(compressed)
    if average:
        reduced = reduced / basics.size()
    return compression.decompress(reduced, ctx)


def quantized_grouped_allreduce(tensors: Sequence, errors: Sequence | None =
                                None, average: bool = True
                                ) -> tuple[list, list]:
    """Allreduce of floating ``tensors`` on an int8 wire, the JAX package's
    eager route (``_eager_quantized_reduce`` with ``core/qwire.py``):
    ``errors`` (the residuals of the last call) are added first in each
    tensor's dtype; every tensor is quantized on its own scale; the
    payloads are all-gathered and summed rank by rank in f32, then divided
    by the size when ``average``.  Returns ``(reduced, residuals)`` in each
    input's dtype; a residual is ``a - scale·q`` in f32, and zero for a
    tensor that was not finite (a NaN residual would poison every later
    step)."""
    tensors = list(tensors)
    for t in tensors:
        if not t.dtype.is_floating_point:
            raise ValueError(f"int8 quantization applies to floating "
                             f"gradients, got {t.dtype}")
    if errors is not None:
        tensors = [t + e.to(t.dtype) for t, e in zip(tensors, errors)]
    if not tensors:
        return [], []
    sizes = [t.numel() for t in tensors]
    payload, scales, qs = qwire.pack_int8(tensors)
    n = basics.size()
    if n == 1:
        rows = payload[None]
    else:
        rows = torch.empty((n, payload.numel()), dtype=torch.uint8,
                           device=payload.device)
        dist.all_gather(list(rows.unbind(0)), payload,
                        group=basics.process_group())
    acc = qwire.unpack_sum_int8(rows, sizes)
    if average:
        # A divisor on the device: CUDA divides by a CPU scalar through its
        # reciprocal, which rounds differently from numpy's division.
        acc = acc / torch.full((), float(n), dtype=torch.float32,
                               device=acc.device)
    reduced, resid, off = [], [], 0
    for a, q, scale in zip(tensors, qs, scales):
        reduced.append(acc[off:off + a.numel()].to(a.dtype).view(a.shape))
        local = a.detach().reshape(-1).float() - q.float() * scale
        local = torch.where(torch.isfinite(scale), local,
                            torch.zeros_like(local))
        resid.append(local.to(a.dtype).view(a.shape))
        off += a.numel()
    return reduced, resid


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
    works = ([dist.all_reduce(flat, async_op=True,
                              group=basics.process_group())
              for _, flat in packed] if basics.size() > 1 else [])
    return AllreduceHandle(packed, works, [ctx for _, ctx in comp], average,
                           compression)


def synchronize(handle: AllreduceHandle) -> list:
    """Wait for ``handle``'s collectives (the ``AllreduceHandle`` of
    :func:`grouped_allreduce_async`; the engine's integer handles go to
    ``ops.async_ops.synchronize``, the package's top-level ``synchronize``);
    its tensors summed (or averaged) across the processes, in their own
    dtypes."""
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
    group = basics.process_group()
    sizes = [torch.zeros(1, dtype=torch.int64, device=tensor.device)
             for _ in range(n)]
    dist.all_gather(sizes, torch.tensor([dim0], device=tensor.device),
                    group=group)
    sizes = [int(s) for s in sizes]
    padded = tensor.new_zeros((max(sizes),) + tuple(tensor.shape[1:]))
    padded[:dim0] = tensor
    parts = [torch.empty_like(padded) for _ in range(n)]
    dist.all_gather(parts, padded, group=group)
    return torch.cat([p[:s] for p, s in zip(parts, sizes)], dim=0)


def broadcast(tensor, root_rank: int = 0):
    """Every process receives ``root_rank``'s value (a new tensor)."""
    if basics.size() == 1:
        return tensor
    out = tensor.clone()
    dist.broadcast(out, src=basics.launch_rank(root_rank),
                   group=basics.process_group())
    return out


def alltoall(tensor, splits=None):
    """Scatter dim-0 blocks of ``tensor`` to every process and concatenate
    the blocks received, in rank order.  ``splits`` (one count per rank,
    summing to dim 0) gives the rows sent to each rank, which may differ
    from rank to rank; by default dim 0 is split evenly."""
    n = basics.size()
    if tensor.dim() == 0:
        raise ValueError("alltoall requires at least one dimension")
    if splits is None:
        if tensor.shape[0] % n:
            raise ValueError(f"alltoall default split needs dim 0 "
                             f"({tensor.shape[0]}) divisible by size ({n}); "
                             f"pass explicit splits.")
        splits = [tensor.shape[0] // n] * n
    splits = [int(x) for x in splits]
    if len(splits) != n or sum(splits) != tensor.shape[0] or \
            min(splits) < 0:
        raise ValueError(f"splits must be {n} values summing to dim 0 "
                         f"({tensor.shape[0]}); got {splits}")
    if n == 1:
        return tensor
    group = basics.process_group()
    send = torch.tensor(splits, dtype=torch.int64, device=tensor.device)
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    recv = [int(x) for x in recv]
    out = tensor.new_empty((sum(recv),) + tuple(tensor.shape[1:]))
    dist.all_to_all_single(out, tensor.contiguous(), output_split_sizes=recv,
                           input_split_sizes=splits, group=group)
    return out


def allgather_object(obj) -> list:
    """One picklable object from every process, in rank order: pickled to
    bytes, gathered with their lengths (:func:`allgather` pads the ragged
    payloads), and unpickled."""
    if basics.size() == 1:
        return [obj]
    payload = torch.frombuffer(bytearray(pickle.dumps(obj)),
                               dtype=torch.uint8).to(basics.device())
    sizes = allgather(torch.tensor([payload.numel()],
                                   device=payload.device))
    blob = allgather(payload).cpu().numpy().tobytes()
    out, off = [], 0
    for n in sizes.tolist():
        out.append(pickle.loads(blob[off:off + n]))
        off += n
    return out


def allreduce_sparse(values, indices, average: bool = True):
    """Sparse reduction, the reference's ``IndexedSlices`` route: every
    process's ``values`` (rows) and ``indices`` (their row numbers) are
    all-gathered, not summed; with ``average`` the values are divided by
    the size first.  Returns ``(values, indices)``; :func:`sparse_to_dense`
    adds them up into rows."""
    if average:
        values = values / basics.size()
    return allgather(values), allgather(indices)


def sparse_to_dense(values, indices, dense_dim0: int):
    """``[dense_dim0, ...]`` zeros with ``values[i]`` added into row
    ``indices[i]``, repeated indices summed."""
    out = values.new_zeros((dense_dim0,) + tuple(values.shape[1:]))
    return out.index_add_(0, indices.long(), values)
