"""Process-level reductions with the tensors left on their device — the
bandwidth-optimal route of the eager executor, counterpart of
``horovod_tpu/core/device_reduce.py``.

The reference's eager data plane delegates to ``MPI_Allreduce`` (reference
operations.cc:1242-1268), which moves ~2n bytes per rank whatever the job
size.  The JAX package gets that number with a reduce-scatter -> allgather
over a one-device-per-process mesh; here the same two legs run over
``torch.distributed`` (NCCL for tensors on the card, gloo for CPU
tensors):

* the reduce-scatter is spelled ``all_to_all_single`` + a local sum, so the
  accumulation dtype is ours to choose: fp16/bf16 add up in f32, rank by
  rank in rank order, and round once (the reference's ``half.cc`` staging,
  reference half.cc:43-76); integers add up in int32 (``_acc_dtype``);
* ``all_gather_into_tensor`` of the reduced chunk is the second leg.

Every leg moves a byte view of its buffer, so any dtype rides any backend.

int8 wire (per-rank scales, ``core/qwire.py``): the quantized chunks ride
the same ``all_to_all_single`` (1 byte an element); each rank
dequant-sums its chunk in f32 against the all-gathered per-tensor scales,
requantizes onto the grid ``s2[t] = sum_p scale_p[t]`` (the sum always
fits: ``|sum_p s_p q_p| <= 127 s2``), and the int8 result is all-gathered.
Per-element error is at most ``sum_p s_p``.  A rank that ships a
non-finite scale makes ``s2`` non-finite, and the output NaN on every
rank: an overflow is never laundered into finite values.

8-byte dtypes (int64, float64) are all-gathered and summed rank by rank at
their own precision, as the JAX package's executor does; broadcast is
``dist.broadcast`` (the JAX package's masked sum turns the root's ``-0.0``
into ``+0.0``; this returns the root's bits).

Every process must reach the same collectives in the same order: the
engine's coordinator guarantees that for its batches.  ``wait`` is the
executor's waiter for one ``torch.distributed`` work object
(``core/executors.py``).  Set ``HVD_TPU_EAGER_REDUCE=gather`` for the
executor's other route, the host staging one.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

def enabled() -> bool:
    """The device route is the default; ``HVD_TPU_EAGER_REDUCE=gather``
    selects the host staging route."""
    return os.environ.get("HVD_TPU_EAGER_REDUCE", "device") != "gather"


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    if dtype in (torch.float16, torch.bfloat16, torch.float32):
        return torch.float32
    if dtype in (torch.int64, torch.float64):
        return dtype
    # Integers and bool: int32, as the JAX package sums them (uint8 in its
    # uint32 too: the result modulo 2**8 is the same).  bool sums like
    # the host route: a logical or.
    return torch.int32


def _bytes(t: torch.Tensor) -> torch.Tensor:
    return t.reshape(-1).view(torch.uint8)


def all_to_all(t: torch.Tensor, group, wait) -> torch.Tensor:
    """``t`` (1-D, length a multiple of the group's size) split in equal
    chunks, chunk p to rank p; returns the chunks received, rank order."""
    out = torch.empty_like(t)
    wait(dist.all_to_all_single(_bytes(out), _bytes(t), group=group,
                                async_op=True))
    return out


def process_allgather(t: torch.Tensor, size: int, group,
                      wait) -> torch.Tensor:
    """Every process's ``t`` (the same shape everywhere) as
    ``[size, *t.shape]``."""
    out = torch.empty((size,) + tuple(t.shape), dtype=t.dtype,
                      device=t.device)
    wait(dist.all_gather_into_tensor(_bytes(out), _bytes(t.contiguous()),
                                     group=group, async_op=True))
    return out


def _rank_order_sum(rows: torch.Tensor, acc: torch.dtype) -> torch.Tensor:
    """``rows[0] + rows[1] + ...`` in ``acc``, in rank order."""
    total = rows[0].to(acc, copy=True)
    for r in range(1, rows.shape[0]):
        total += rows[r].to(acc)
    return total


def process_allreduce(inputs: list, size: int, group,
                      wait) -> torch.Tensor:
    """The sum over the processes of the tensors ``inputs`` (one dtype, one
    device; the same sizes on every process), as one flat tensor: the fused
    buffer, reduce-scattered, summed and all-gathered."""
    dtype, device = inputs[0].dtype, inputs[0].device
    n = sum(a.numel() for a in inputs)
    if n == 0:
        return torch.empty(0, dtype=dtype, device=device)
    if dtype.itemsize == 8:
        flat = torch.cat([a.reshape(-1) for a in inputs])
        return _rank_order_sum(process_allgather(flat, size, group, wait),
                               dtype)
    chunk = -(-n // size)
    # The fusion buffer: the inputs copied in once, the pad zeroed.
    row = torch.empty(chunk * size, dtype=dtype, device=device)
    torch.cat([a.reshape(-1) for a in inputs], out=row[:n])
    row[n:].zero_()
    mine = all_to_all(row, group, wait).view(size, chunk)
    red = _rank_order_sum(mine, _acc_dtype(dtype)).to(dtype)
    return process_allgather(red, size, group, wait).view(-1)[:n]


def process_broadcast(t: torch.Tensor, root: int, group,
                      wait) -> torch.Tensor:
    """The job rank ``root``'s ``t`` on every process (``root`` mapped to
    its launch rank for ``dist.broadcast``); ``t`` itself is not written."""
    from horovod_tpu_torch import basics

    out = t.contiguous().clone()
    wait(dist.broadcast(_bytes(out), src=basics.launch_rank(root),
                        group=group, async_op=True))
    return out


def _segments(sizes: list[int], n_pad: int, device) -> torch.Tensor:
    """Each element's tensor index, built on the device (padding under
    tensor 0's scale: it carries q = 0 and is sliced off)."""
    seg = torch.zeros(n_pad, dtype=torch.int64, device=device)
    counts = torch.tensor(sizes, dtype=torch.int64, device=device)
    seg[:sum(sizes)] = torch.repeat_interleave(
        torch.arange(len(sizes), device=device), counts)
    return seg


def process_allreduce_int8(scales: torch.Tensor, qs: list,
                           sizes: list[int], size: int, rank: int, group,
                           wait) -> torch.Tensor:
    """The f32 sum, flat, of the per-rank ``(scales, qs)`` payloads of the
    int8 wire (``core/qwire.py``).  Per-element error is at most
    ``sum_p scale_p[t]``; values on both grids (all-equal tensors) reduce
    exactly."""
    device = scales.device
    n = sum(sizes)
    if n == 0:
        return torch.zeros(0, dtype=torch.float32, device=device)
    chunk = -(-n // size)
    n_pad = chunk * size
    qrow = torch.zeros(n_pad, dtype=torch.int8, device=device)
    torch.cat([q.reshape(-1) for q in qs], out=qrow[:n])
    allsc = process_allgather(scales.float(), size, group, wait)  # [P, nt]
    s2 = _rank_order_sum(allsc, torch.float32)                # [nt]
    mine = all_to_all(qrow, group, wait).view(size, chunk)
    seg = _segments(sizes, n_pad, device)
    segc = seg[rank * chunk:(rank + 1) * chunk]
    prods = allsc[:, segc] * mine.float()                     # [P, chunk]
    red = _rank_order_sum(prods, torch.float32)
    q2 = torch.clamp(torch.round(red / s2[segc]), -127.0, 127.0)
    # A non-finite red (a rank shipped an inf/nan scale) quantizes to 0;
    # the dequant against the equally non-finite s2 restores NaN.
    q2 = torch.where(torch.isfinite(q2), q2, torch.zeros_like(q2))
    g = process_allgather(q2.to(torch.int8), size, group, wait).view(-1)
    return (g.float() * s2[seg])[:n]
