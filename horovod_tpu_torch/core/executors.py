"""Batch executors of the port's native engine — the data-plane half of the
eager path, counterpart of ``horovod_tpu/core/executors.py``.

The native engine negotiates and fuses (``core/src/engine.cc``); an
executor moves the bytes of one :class:`~horovod_tpu_torch.core.engine.
ExecBatch`.  This split replaces the body of the reference's
``PerformOperation`` (reference operations.cc:714-1362): the inputs are
copied into one flat fusion buffer and reduced by ``torch.distributed``
collectives.

* ``local`` — collectives over this process alone: a sum, gather or
  broadcast over one contributor is the identity, while fusion, ordering,
  the response cache and handles still run the whole native path.  The
  serving fleet's ``serving.tick`` runs on it in every replica, so the
  tick's "sum" is rank-local there, as in the JAX package's fleet.
* ``multihost`` — collectives across the job's processes, by one of two
  routes, chosen as the JAX package chooses them and never on failure:

  - the **device** route (the default): the tensors stay on their device;
    allreduce is ``core/device_reduce.py``'s reduce-scatter -> allgather
    (~2n bytes a rank), over the job's group for tensors on the card
    (NCCL) and over the gloo group (``basics.host_group()``) for CPU
    tensors;
  - the **gather** route (``HVD_TPU_EAGER_REDUCE=gather``): the fused
    buffer is staged through the host and all-gathered over the gloo group,
    and every rank sums the rows on the host, fp16/bf16 in f32 through the
    native converters (:func:`_staged_f32_sum`), every other dtype at its
    own precision or wider; the result goes back to the tensors' device.
    This is the reference's ``*CudaOnCPU`` staging.

  Ragged allgather and alltoall pad every rank's rows to the longest
  (``batch.first_dim_sizes``), gather, and cut; broadcast sends the root's
  bytes.  The timeline's phases are the JAX package's
  (``batch_activity``).

Select with ``HVD_TPU_EXECUTOR`` (``local`` | ``multihost``); by default a
job of one process takes ``local``, a larger one ``multihost``.

**A dead peer fails the batch, it does not hang it.**  Every collective is
issued with ``async_op=True``.  A gloo work (the CPU and the gather route)
is polled on the host, and the wait gives up, failing the batch on this
rank, as soon as the engine reports a failed peer (gloo itself raises at
once when the peer's socket closes, and at ``basics.COLLECTIVE_TIMEOUT``).
A NCCL work is ordered on the device (``work.wait()`` blocks no host
thread); a peer lost inside it is bounded by the NCCL group's timeout,
enforced by PyTorch's NCCL watchdog.

On the card the executor works on a stream of its own (:func:`_stream`):
it waits for the event the engine stamped on each input when it was
enqueued, and stamps each result for the caller's stream
(``core/engine.py``), so its copies and collectives overlap backward
without reading a gradient before it is written.

Each executed batch is counted in :func:`stats`: batches, bytes, the
executor's host ms and, for tensors on the card, the span of its stream
from the moment its inputs are ready to its last copy (CUDA events; the
span includes the gaps in which the stream waits for the host to issue
the next operation, so it bounds the device work from above); a trace
gives the device time itself, on the executor's stream and NCCL's
(``utils/trace.measure``'s ``device_ms_by_stream``).
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import os
import threading
import time

import torch


def default_executor(rank: int, size: int):
    choice = os.environ.get("HVD_TPU_EXECUTOR")
    if choice == "local" or (choice is None and size == 1):
        return local_executor
    if choice in (None, "multihost"):
        return multihost_executor
    raise ValueError(f"unknown HVD_TPU_EXECUTOR={choice}")


def local_executor(engine, batch) -> None:
    """Single-process semantics: sum/gather/broadcast over one contributor."""
    engine.batch_activity(batch, "WAIT_FOR_DATA")
    inputs = engine.take_inputs(batch)
    engine.batch_activity(batch, "LOCAL_COPY")
    engine.put_results(batch, inputs)


# -- what the executor did --------------------------------------------------

_stats_lock = threading.Lock()
_stats: dict = {}
# Per-batch records kept: the last this many batches (a training job runs
# the executor for ever; a step of the 162M model is 17-111 batches).
STATS_WINDOW = 4096


def reset_stats() -> None:
    with _stats_lock:
        _stats.clear()
        _stats.update(batches=0, host_ms=0.0,
                      bytes=collections.deque(maxlen=STATS_WINDOW),
                      events=collections.deque(maxlen=STATS_WINDOW))


reset_stats()


def stats(wait_device: bool = True) -> dict:
    """The batches the multihost executor ran since :func:`reset_stats`:
    ``{"batches", "host_ms", "bytes", "stream_ms"}``; ``bytes`` (one entry
    a batch) and ``stream_ms`` cover the last ``STATS_WINDOW`` batches.
    ``stream_ms`` waits for the recorded events; without ``wait_device``
    it is left out, and nothing waits."""
    with _stats_lock:
        events = list(_stats["events"])
        out = {"batches": _stats["batches"], "bytes": list(_stats["bytes"]),
               "host_ms": _stats["host_ms"]}
    if not wait_device:
        return out
    for _, end in events:
        end.synchronize()
    out["stream_ms"] = sum(s.elapsed_time(e) for s, e in events)
    return out


def _record(nbytes: int, host_s: float, events) -> None:
    with _stats_lock:
        _stats["batches"] += 1
        _stats["bytes"].append(nbytes)
        _stats["host_ms"] += host_s * 1e3
        if events is not None:
            _stats["events"].append(events)


# -- waiting on a collective ------------------------------------------------

def _host_wait(engine):
    """The host-side wait for one gloo work object of ``engine``'s batch:
    it gives up as soon as the engine reports a failed peer (gloo raises by
    itself when the peer's socket closes, or at the group's timeout)."""

    def wait(work) -> None:
        pause = 1e-5
        while not work.is_completed():
            report = engine.failure_report()
            if report is not None:
                raise RuntimeError(
                    f"collective abandoned: a peer failed ({report})")
            time.sleep(pause)
            pause = min(pause * 2, 1e-3)
        work.wait()

    return wait


class _Route:
    """Where a batch's tensors on ``device`` are reduced: the group, the
    wait, and whether the bytes are staged through the host."""

    def __init__(self, engine, device: torch.device):
        from horovod_tpu_torch import basics
        from horovod_tpu_torch.core import device_reduce

        self.size = engine.size
        self.rank = engine.rank
        self.device = device
        self.staged = not device_reduce.enabled()
        on_host = self.staged or device.type == "cpu"
        self.group = basics.host_group() if on_host \
            else basics.process_group()
        # NCCL work: ordered on the device, no host thread waits.
        self.wait = _host_wait(engine) if on_host else (lambda w: w.wait())

    def to_host(self, t: torch.Tensor) -> torch.Tensor:
        return t.cpu() if self.staged else t

    def back(self, t: torch.Tensor) -> torch.Tensor:
        return t.to(self.device) if self.staged else t


def _staged_f32_sum(rows: torch.Tensor) -> torch.Tensor:
    """Sum ``[size, n]`` fp16/bf16 CPU rows with float32 accumulation, rank
    by rank, converting through the native converters (``core/src/
    half.cc``) — the analog of the reference's custom fp16-sum MPI op
    (reference half.cc:43-76), which exists so reductions never accumulate
    in the 10/7-bit wire mantissa."""
    from horovod_tpu_torch.core import engine as engine_mod

    lib = engine_mod.lib()
    if rows.dtype == torch.float16:
        to_f32, from_f32 = lib.hvd_half_to_float, lib.hvd_float_to_half
    else:
        to_f32, from_f32 = lib.hvd_bf16_to_float, lib.hvd_float_to_bf16
    rows = rows.contiguous()
    f32 = torch.empty(rows.shape, dtype=torch.float32)
    to_f32(ctypes.c_void_p(rows.data_ptr()), ctypes.c_void_p(f32.data_ptr()),
           rows.numel())
    acc = f32[0].clone()
    for r in range(1, rows.shape[0]):
        acc += f32[r]
    out = torch.empty(acc.shape, dtype=rows.dtype)
    from_f32(ctypes.c_void_p(acc.data_ptr()), ctypes.c_void_p(out.data_ptr()),
             acc.numel())
    return out


def _host_sum(rows: torch.Tensor) -> torch.Tensor:
    """The gather route's sum of ``[size, n]`` host rows, rank by rank:
    fp16/bf16 through :func:`_staged_f32_sum`, integers and bool in int64
    (numpy's widening; a bool sum is a logical or), floats at their own
    precision; the result in the rows' dtype."""
    if rows.dtype in (torch.float16, torch.bfloat16):
        return _staged_f32_sum(rows)
    acc = torch.int64 if not rows.dtype.is_floating_point else rows.dtype
    total = rows[0].to(acc, copy=True)
    for r in range(1, rows.shape[0]):
        total += rows[r].to(acc)
    return total.to(rows.dtype)


def _allreduce(route: _Route, batch, inputs: list) -> torch.Tensor:
    """The flat sum of ``inputs`` (one device) over the processes."""
    from horovod_tpu_torch.core import device_reduce, qwire
    from horovod_tpu_torch.core import engine as engine_mod

    dtype = inputs[0].dtype
    sizes = [a.numel() for a in inputs]
    if batch.wire == engine_mod.WIRE_INT8:
        # int8 wire (core/qwire.py): per-rank, per-tensor scales, no
        # agreement round.
        if not route.staged:
            scales, qs = qwire.quantize_int8(inputs)
            return device_reduce.process_allreduce_int8(
                scales, qs, sizes, route.size, route.rank, route.group,
                route.wait).to(dtype)
        payload, _, _ = qwire.pack_int8(inputs)
        rows = device_reduce.process_allgather(
            route.to_host(payload), route.size, route.group, route.wait)
        return route.back(qwire.unpack_sum_int8(rows, sizes).to(dtype))
    if not route.staged:
        return device_reduce.process_allreduce(inputs, route.size,
                                               route.group, route.wait)
    flat = route.to_host(torch.cat([a.reshape(-1) for a in inputs]))
    rows = device_reduce.process_allgather(flat, route.size, route.group,
                                           route.wait)
    return route.back(_host_sum(rows))


def _by_device(inputs: list) -> list:
    """Indices of ``inputs`` grouped by device, groups in the order of
    their device's name: a fused batch that mixes the CPU and the card
    reduces each part over its own group, in the same order on every
    process."""
    groups: dict = {}
    for i, a in enumerate(inputs):
        groups.setdefault(str(a.device), []).append(i)
    return [groups[k] for k in sorted(groups)]


_streams: dict = {}


def _stream(device: torch.device):
    """The executor's own stream on ``device``: its copies and collectives
    overlap the compute on the caller's stream, ordered by the engine's
    events (``core/engine.py``)."""
    stream = _streams.get(device)
    if stream is None:
        stream = _streams[device] = torch.cuda.Stream(device)
    return stream


def multihost_executor(engine, batch) -> None:
    engine.batch_activity(batch, "WAIT_FOR_DATA")
    staged = engine.take_staged(batch)
    t0 = time.perf_counter()
    cuda = next((s.tensor.device for s in staged if s.tensor.is_cuda), None)
    events = None
    with contextlib.ExitStack() as guard:
        if cuda is not None:
            guard.enter_context(torch.cuda.device(cuda))
            guard.enter_context(torch.cuda.stream(_stream(cuda)))
        inputs = [s.wait() for s in staged]
        if cuda is not None:
            events = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
            events[0].record()
        outs = _execute(engine, batch, inputs)
        if events is not None:
            events[1].record()
        # On the executor's stream: the results' stamps follow its work.
        engine.put_results(batch, outs)
    _record(sum(a.numel() * a.element_size() for a in inputs),
            time.perf_counter() - t0, events)


def _execute(engine, batch, inputs: list) -> list:
    from horovod_tpu_torch.core import device_reduce
    from horovod_tpu_torch.core import engine as engine_mod

    size = engine.size
    outs: list = [None] * len(inputs)

    if batch.type == engine_mod.OP_ALLREDUCE:
        # Fused flat buffer, one collective a device (reference fusion
        # semantics, operations.cc:969-1258; phase names from
        # operations.h:29-46).
        for idx in _by_device(inputs):
            part = [inputs[i] for i in idx]
            route = _Route(engine, part[0].device)
            engine.batch_activity(batch, "MEMCPY_IN_FUSION_BUFFER")
            engine.batch_activity(batch, "PROCESS_ALLREDUCE")
            summed = _allreduce(route, batch, part)
            engine.batch_activity(batch, "MEMCPY_OUT_FUSION_BUFFER")
            off = 0
            for i, a in zip(idx, part):
                outs[i] = summed[off:off + a.numel()].view(a.shape)
                off += a.numel()
    elif batch.type in (engine_mod.OP_ALLGATHER, engine_mod.OP_ALLTOALL):
        # Ragged dim-0 gather using the negotiated per-rank sizes
        # (reference MPI_Allgatherv path, operations.cc:1273-1332).
        # ALLTOALL payloads gather identically; the caller slices each
        # rank's chunk out of the concat at synchronize time using the
        # companion splits gather (ops/async_ops.py:alltoall).
        engine.batch_activity(
            batch, "PROCESS_ALLGATHER" if batch.type ==
            engine_mod.OP_ALLGATHER else "PROCESS_ALLTOALL")
        a = inputs[0]
        route = _Route(engine, a.device)
        sizes = batch.first_dim_sizes
        max_d = max(sizes) if sizes else a.shape[0]
        padded = route.to_host(a).new_zeros((max_d,) + tuple(a.shape[1:]))
        padded[:a.shape[0]] = route.to_host(a)
        if padded.numel() == 0:
            # Every rank's payload is empty (negotiation-consistent), so
            # every rank skips the collective together.
            gathered = padded.new_zeros((size,) + tuple(padded.shape))
        else:
            gathered = device_reduce.process_allgather(
                padded, size, route.group, route.wait)
        outs[0] = route.back(torch.cat([gathered[r, :sizes[r]]
                                        for r in range(size)]))
    elif batch.type == engine_mod.OP_BROADCAST:
        engine.batch_activity(batch, "PROCESS_BROADCAST")
        a = inputs[0]
        route = _Route(engine, a.device)
        outs[0] = route.back(device_reduce.process_broadcast(
            route.to_host(a), batch.root_rank, route.group, route.wait))
    else:
        raise NotImplementedError(f"batch type {batch.type}")
    return outs
