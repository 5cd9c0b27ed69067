"""Torch tensor collectives over the port's native engine — counterpart of
``horovod_tpu/torch/mpi_ops.py``.

Rebuild of reference horovod/torch/mpi_ops.py (+ the C++ shims
mpi_ops_v2.cc / adapter_v2.cc it drives): sync and async variants, in-place
``_`` forms, ``poll``/``synchronize``.  Tensors go into the engine as they
are, on the card or on the CPU, and the results come back on the input's
device; nothing crosses to numpy on the way.

Autograd: ``allreduce``, ``allgather`` and ``broadcast`` are differentiable
via torch.autograd.Functions — grad(allreduce) = allreduce (reference
mpi_ops.py:110-121), grad(allgather) = allreduce + this rank's dim-0 slice
(:236-254), grad(broadcast) = allreduce delivered to the root only
(:318-332).
"""

from __future__ import annotations

import itertools
import math
from typing import NamedTuple

import torch

from horovod_tpu_torch import basics
from horovod_tpu_torch.core import engine as engine_mod
from horovod_tpu_torch.torch.compression import Compression

_counter = itertools.count()
# handle → metadata needed at synchronize time
_handles: dict[int, dict] = {}


def _auto_name(prefix: str, name: str | None) -> str:
    return name if name is not None else f"{prefix}.noname.{next(_counter)}"


def _enqueue(prefix, tensor, op, name, root_rank=-1, average=False,
             compression=Compression.none, inplace_into=None) -> int:
    eng = engine_mod.get_engine()
    compressed, ctx, wire = tensor, None, engine_mod.WIRE_NATIVE
    if compression is Compression.int8:
        # A wire format, not a cast: the engine ships (scale, int8) per
        # rank and the executor dequant-sums (core/executors.py).
        compression, wire = None, engine_mod.WIRE_INT8
    else:
        compressed, ctx = compression.compress(tensor)
    h = eng.enqueue(_auto_name(prefix, name), compressed.detach(), op,
                    root_rank=root_rank, wire=wire)
    _handles[h] = {"average": average, "compression": compression,
                   "ctx": ctx, "template": tensor,
                   "inplace_into": inplace_into}
    return h


def synchronize(handle: int) -> torch.Tensor:
    """Block until the async op completes; returns (and for ``_`` variants,
    writes back) the result (reference mpi_ops.py:422-438)."""
    eng = engine_mod.get_engine()
    meta = _handles[handle]
    try:
        out_np = eng.synchronize(handle)
    except TimeoutError:
        raise  # handle still live — keep metadata so a retry works
    except Exception:
        _handles.pop(handle, None)
        raise
    _handles.pop(handle, None)
    out = out_np
    if out.dtype != meta["template"].dtype:
        out = out.to(meta["template"].dtype)
    if meta["average"]:
        out = _average(out)
    if meta["compression"] is not None:
        out = meta["compression"].decompress(out, meta["ctx"])
    target = meta["inplace_into"]
    if target is not None:
        with torch.no_grad():
            target.resize_(out.shape).copy_(out)
        return target
    return out


def _average(t: torch.Tensor) -> torch.Tensor:
    """``t`` over the job's size: a float division by a divisor on ``t``'s
    device (CUDA divides by a CPU scalar through its reciprocal), an
    integer one truncated."""
    n = basics.size()
    if t.is_floating_point():
        return t / torch.full((), n, dtype=t.dtype, device=t.device)
    return torch.div(t, n, rounding_mode="trunc")


def poll(handle: int) -> bool:
    """True once ``synchronize`` will not block (reference
    mpi_ops.py:408-419)."""
    return engine_mod.get_engine().poll(handle)


# -- allreduce --------------------------------------------------------------

class _AllreduceFunction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tensor, average, name, compression):
        ctx.average = average
        ctx.name = name
        h = _enqueue("allreduce", tensor, engine_mod.OP_ALLREDUCE, name,
                     average=average, compression=compression)
        return synchronize(h)

    @staticmethod
    def backward(ctx, grad_output):
        # grad(allreduce) = allreduce (reference mpi_ops.py:110-121).
        return allreduce(grad_output, average=ctx.average), None, None, None


def allreduce(tensor: torch.Tensor, average: bool = True,
              name: str | None = None,
              compression=Compression.none) -> torch.Tensor:
    """Synchronous, differentiable allreduce (reference mpi_ops.py:86-121).

    Sparse COO tensors (e.g. ``nn.Embedding(sparse=True)`` gradients) take
    the gather path — concatenate every rank's indices and values — the
    torch analog of the reference's ``tf.IndexedSlices`` handling
    (reference tensorflow/__init__.py:67-78)."""
    if tensor.is_sparse:
        hs = allreduce_sparse_async(tensor, name, compression=compression)
        return synchronize_sparse(hs, tensor.shape, average)
    if tensor.requires_grad:
        return _AllreduceFunction.apply(tensor, average, name, compression)
    return synchronize(allreduce_async(tensor, average, name, compression))


class SparseHandles(NamedTuple):
    """Outstanding handles of one sparse (gather-based) allreduce.

    ``scale``/``sizes`` are set only on the int8 wire: values travel as
    int8 with ONE f32 scale per rank (the per-rank-scales scheme of the
    engine's WIRE_INT8, core/qwire.py) plus a per-rank nnz gather so the
    receiver can dequantize each rank's segment by its own scale."""

    indices: int
    values: int
    scale: int | None
    sizes: int | None
    compression: object
    ctx: object
    values_dtype: torch.dtype


def allreduce_sparse_async(tensor: torch.Tensor, name: str | None = None,
                           compression=Compression.none) -> SparseHandles:
    """Start the sparse (gather-based) allreduce of a COO tensor.  Per-rank
    nnz may differ — the engine's ragged allgather carries dim-0 sizes like
    the reference's ``MPI_Allgatherv`` response.

    ``compression`` applies to the gathered VALUES (embedding-heavy models
    are exactly where wire savings matter): fp16/bf16 cast on the wire
    (reference torch/compression.py:42-63 semantics), or int8 with a
    per-rank scale — a non-finite rank ships q=0 under its non-finite
    scale, so overflow still surfaces as NaN after dequantization."""
    g = tensor.coalesce()
    name = _auto_name("allreduce.sparse", name)
    hi = allgather_async(g.indices().t().contiguous(), name=f"{name}.indices")
    values = g.values()
    if compression is Compression.int8:
        v = values.detach().float()
        amax = float(v.abs().max()) if v.numel() else 0.0
        if math.isfinite(amax):
            s = max(amax / 127.0, torch.finfo(torch.float32).tiny)
            q = torch.clamp(torch.round(v / s), -127, 127).to(torch.int8)
        else:
            s = amax  # inf/nan scale: dequant restores non-finiteness
            q = torch.zeros(v.shape, dtype=torch.int8, device=v.device)
        hv = allgather_async(q, name=f"{name}.values")
        hs = allgather_async(torch.tensor([s], dtype=torch.float32,
                                          device=v.device),
                             name=f"{name}.scale")
        hn = allgather_async(torch.tensor([v.shape[0] if v.ndim else 0],
                                          dtype=torch.int32,
                                          device=v.device),
                             name=f"{name}.nnz")
        return SparseHandles(hi, hv, hs, hn, compression, None, values.dtype)
    compressed, ctx = compression.compress(values)
    hv = allgather_async(compressed, name=f"{name}.values")
    return SparseHandles(hi, hv, None, None, compression, ctx, values.dtype)


def synchronize_sparse(handles: SparseHandles, shape, average: bool = True
                       ) -> torch.Tensor:
    """Complete an ``allreduce_sparse_async``: rebuild one COO tensor whose
    duplicate coordinates sum across ranks (coalesce = the reduction)."""
    indices = synchronize(handles.indices)
    if handles.scale is not None:
        q = synchronize(handles.values).float()
        scales = synchronize(handles.scale).reshape(-1)
        sizes = synchronize(handles.sizes).reshape(-1)
        off = 0
        for r in range(int(sizes.numel())):
            nnz_r = int(sizes[r])
            q[off:off + nnz_r] *= scales[r]
            off += nnz_r
        values = q.to(handles.values_dtype)
    else:
        values = handles.compression.decompress(synchronize(handles.values),
                                                handles.ctx)
    if average:
        values = _average(values)
    return torch.sparse_coo_tensor(indices.t(), values,
                                   tuple(shape)).coalesce()


def allreduce_async(tensor: torch.Tensor, average: bool = True,
                    name: str | None = None,
                    compression=Compression.none) -> int:
    return _enqueue("allreduce", tensor, engine_mod.OP_ALLREDUCE, name,
                    average=average, compression=compression)


def allreduce_(tensor: torch.Tensor, average: bool = True,
               name: str | None = None) -> torch.Tensor:
    """In-place allreduce (reference mpi_ops.py:156-174)."""
    return synchronize(allreduce_async_(tensor, average, name))


def allreduce_async_(tensor: torch.Tensor, average: bool = True,
                     name: str | None = None) -> int:
    return _enqueue("allreduce", tensor, engine_mod.OP_ALLREDUCE, name,
                    average=average, inplace_into=tensor)


# -- allgather --------------------------------------------------------------

class _AllgatherFunction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tensor, name):
        ctx.dim0 = tensor.shape[0]
        return synchronize(allgather_async(tensor, name))

    @staticmethod
    def backward(ctx, grad_output):
        # grad(allgather) = sum each rank's grad for the gathered tensor,
        # then take this rank's dim-0 segment (reference mpi_ops.py:236-254).
        grad = allreduce(grad_output.contiguous(), average=False)
        sizes = allgather(torch.tensor([ctx.dim0], dtype=torch.int64,
                                       device=grad_output.device))
        offset = int(sizes[:basics.rank()].sum())
        return grad[offset:offset + ctx.dim0], None


def allgather(tensor: torch.Tensor, name: str | None = None) -> torch.Tensor:
    """Concatenate along dim 0 across ranks; dim-0 sizes may differ per rank
    (reference mpi_ops.py:228-307).  Differentiable (reference
    HorovodAllgather, mpi_ops.py:236-254)."""
    if tensor.requires_grad:
        return _AllgatherFunction.apply(tensor, name)
    return synchronize(allgather_async(tensor, name))


def allgather_async(tensor: torch.Tensor, name: str | None = None) -> int:
    return _enqueue("allgather", tensor, engine_mod.OP_ALLGATHER, name)


# -- alltoall ---------------------------------------------------------------

def alltoall(tensor: torch.Tensor, splits=None,
             name: str | None = None) -> torch.Tensor:
    """Scatter dim-0 blocks of ``tensor`` to every rank and return the
    blocks received, concatenated (modern-reference ``hvd.alltoall``;
    negotiated + ragged via the engine, ops/async_ops.py:alltoall)."""
    from horovod_tpu_torch.ops import async_ops

    if splits is not None and torch.is_tensor(splits):
        splits = splits.tolist()
    return async_ops.alltoall(tensor.detach(), splits,
                              _auto_name("torch.alltoall", name))


# -- broadcast --------------------------------------------------------------

class _BroadcastFunction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tensor, root_rank, name):
        ctx.root_rank = root_rank
        return synchronize(broadcast_async(tensor, root_rank, name))

    @staticmethod
    def backward(ctx, grad_output):
        # grad(broadcast) = sum of downstream grads, delivered to the root
        # only (reference HorovodBroadcast, mpi_ops.py:318-332).
        grad = allreduce(grad_output.contiguous(), average=False)
        if basics.rank() != ctx.root_rank:
            grad = grad * 0
        return grad, None, None


def broadcast(tensor: torch.Tensor, root_rank: int,
              name: str | None = None) -> torch.Tensor:
    """Synchronous broadcast from ``root_rank`` (reference mpi_ops.py:310-345).
    Differentiable (reference HorovodBroadcast, mpi_ops.py:318-332)."""
    if tensor.requires_grad:
        return _BroadcastFunction.apply(tensor, root_rank, name)
    return synchronize(broadcast_async(tensor, root_rank, name))


def broadcast_async(tensor: torch.Tensor, root_rank: int,
                    name: str | None = None) -> int:
    return _enqueue("broadcast", tensor, engine_mod.OP_BROADCAST, name,
                    root_rank=root_rank)


def broadcast_(tensor: torch.Tensor, root_rank: int,
               name: str | None = None) -> torch.Tensor:
    return synchronize(broadcast_async_(tensor, root_rank, name))


def broadcast_async_(tensor: torch.Tensor, root_rank: int,
                     name: str | None = None) -> int:
    return _enqueue("broadcast", tensor, engine_mod.OP_BROADCAST, name,
                    root_rank=root_rank, inplace_into=tensor)
