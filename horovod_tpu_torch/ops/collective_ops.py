"""Eager collectives over ``torch.distributed`` — counterpart of the eager
(process-level) path of ``horovod_tpu/ops/collective_ops.py``.

Each process contributes one tensor on its own device (the card under
NCCL, the CPU under gloo).  With one process every collective returns its
input, as the JAX package's ``_eager_process_reduce`` does.  The JAX
package's in-mesh branches (``psum`` inside ``shard_map``, the schedule
planner, the int8 wire) have no counterpart here.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.distributed as dist

from horovod_tpu_torch import basics
from horovod_tpu_torch.ops import fusion
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


def grouped_allreduce(tensors: Sequence, average: bool = True,
                      compression=Compression.none,
                      threshold_bytes: int | None = None) -> list:
    """Allreduce of many tensors through flat buckets of at most
    ``threshold_bytes`` (``HOROVOD_FUSION_THRESHOLD``): one collective per
    bucket instead of one per tensor."""
    comp = [compression.compress(t) for t in tensors]
    reduced = fusion.fused_apply([c for c, _ in comp], _process_reduce,
                                 threshold_bytes)
    if average:
        reduced = [r / basics.size() for r in reduced]
    return [compression.decompress(r, ctx)
            for r, (_, ctx) in zip(reduced, comp)]


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
