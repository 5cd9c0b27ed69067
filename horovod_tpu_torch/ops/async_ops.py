"""Asynchronous named collectives over the native engine — the eager handle
API, counterpart of ``horovod_tpu/ops/async_ops.py``.

The analog of the reference torch op layer (reference torch/mpi_ops.py:
``allreduce_async/allgather_async/broadcast_async`` + ``poll`` +
``synchronize``): each call announces a tensor to the native engine and
returns an integer handle at once; the engine's background thread
negotiates global readiness and fuses, an executor runs the collective
(``core/executors.py``), and :func:`synchronize` blocks on the handle and
returns the result, a tensor on the input's device.

This is the path whose cross-process order is NOT known ahead of time
(collectives fire from autograd hooks in whatever order backward produces
them), which is why the reference needs its coordinator, and why the port
keeps one.  The collectives of ``ops/collective_ops.py`` run straight over
``torch.distributed`` instead and need every process to issue them in one
order; their ``collective_ops.synchronize`` takes an ``AllreduceHandle``,
this module's :func:`synchronize` an engine handle (an ``int``).
"""

from __future__ import annotations

import itertools
import threading

import torch

from horovod_tpu_torch.core import engine as engine_mod
from horovod_tpu_torch.ops.compression import Compression

_counter = itertools.count()
_meta_lock = threading.Lock()
_meta: dict[int, dict] = {}


def _auto_name(prefix: str, name: str | None) -> str:
    if name is not None:
        return name
    return f"{prefix}.noname.{next(_counter)}"


def _tensor(x) -> torch.Tensor:
    return x if torch.is_tensor(x) else torch.as_tensor(x)


def _drain_splits(eng, h_splits: int) -> None:
    """Best-effort completion of alltoall's companion splits gather so a
    failed payload never leaks the companion handle/result in the engine."""
    try:
        eng.synchronize(h_splits, timeout_s=30.0)
    except Exception:
        pass


def allreduce_async(tensor, average: bool = True, name: str | None = None,
                    compression=Compression.none) -> int:
    """Start a named allreduce; returns a handle (reference
    torch/mpi_ops.py:69-107)."""
    eng = engine_mod.get_engine()
    t = _tensor(tensor)
    if average and not t.dtype.is_floating_point:
        # Integer division would silently truncate toward zero; modern
        # reference builds reject this combination outright rather than
        # return lossy results.
        raise ValueError(
            f"allreduce(average=True) is not supported for integer dtype "
            f"{t.dtype}; use average=False and divide explicitly.")
    if compression is Compression.int8:
        # Not a cast: the engine ships (scale, int8) per rank and the
        # executor dequant-sums (core/executors.py), negotiated like any
        # other wire (mismatched wire formats error on every rank).
        h = eng.enqueue(_auto_name("allreduce", name), t,
                        engine_mod.OP_ALLREDUCE, wire=engine_mod.WIRE_INT8)
        with _meta_lock:
            _meta[h] = {"average": average}
        return h
    compressed, ctx = compression.compress(t)
    h = eng.enqueue(_auto_name("allreduce", name), compressed,
                    engine_mod.OP_ALLREDUCE)
    with _meta_lock:
        _meta[h] = {"average": average, "compression": compression,
                    "ctx": ctx}
    return h


def allgather_async(tensor, name: str | None = None) -> int:
    """Start a named allgather (dim 0 may differ across processes;
    reference torch/mpi_ops.py:228-276)."""
    eng = engine_mod.get_engine()
    h = eng.enqueue(_auto_name("allgather", name), _tensor(tensor),
                    engine_mod.OP_ALLGATHER)
    with _meta_lock:
        _meta[h] = {}
    return h


def broadcast_async(tensor, root_rank: int, name: str | None = None) -> int:
    """Start a named broadcast from ``root_rank`` (reference
    torch/mpi_ops.py:310-380)."""
    eng = engine_mod.get_engine()
    h = eng.enqueue(_auto_name("broadcast", name), _tensor(tensor),
                    engine_mod.OP_BROADCAST, root_rank=root_rank)
    with _meta_lock:
        _meta[h] = {}
    return h


def alltoall_async(tensor, splits=None, name: str | None = None) -> int:
    """Start a named alltoall: scatter dim-0 blocks of ``tensor`` to every
    process and return the blocks received from them, concatenated.

    ``splits`` (optional, length ``size``): rows sent to each rank; defaults
    to an even split.  Per-rank splits may differ — the payload rides the
    engine's ragged-allgather path and a companion int64 splits gather
    tells :func:`synchronize` where every rank's chunk lives.
    """
    eng = engine_mod.get_engine()
    t = _tensor(tensor)
    if t.dim() == 0:
        raise ValueError("alltoall requires at least one dimension")
    name = _auto_name("alltoall", name)
    if splits is None:
        if t.shape[0] % eng.size:
            raise ValueError(
                f"alltoall default split needs dim 0 ({t.shape[0]}) "
                f"divisible by size ({eng.size}); pass explicit splits.")
        splits_t = torch.full((eng.size,), t.shape[0] // eng.size,
                              dtype=torch.int64)
    else:
        splits_t = torch.as_tensor(splits, dtype=torch.int64).cpu()
        if tuple(splits_t.shape) != (eng.size,) or \
                int(splits_t.sum()) != t.shape[0]:
            raise ValueError(
                f"splits must be {eng.size} values summing to dim 0 "
                f"({t.shape[0]}); got {splits_t.tolist()}")
    h_splits = eng.enqueue(f"{name}.splits", splits_t,
                           engine_mod.OP_ALLGATHER)
    try:
        h = eng.enqueue(name, t, engine_mod.OP_ALLTOALL)
    except Exception:
        # Payload enqueue rejected (e.g. duplicate name) — clean up.
        _drain_splits(eng, h_splits)
        raise
    with _meta_lock:
        _meta[h] = {"alltoall_splits": h_splits}
    return h


def alltoall(tensor, splits=None, name: str | None = None) -> torch.Tensor:
    """Synchronous alltoall (see :func:`alltoall_async`)."""
    return synchronize(alltoall_async(tensor, splits, name))


def barrier(name: str | None = None) -> None:
    """Block until every process reaches the barrier: a zero-payload
    negotiated op, so it rides the same coordinator."""
    eng = engine_mod.get_engine()
    h = eng.enqueue(_auto_name("barrier", name),
                    torch.zeros(1, dtype=torch.uint8), engine_mod.OP_BARRIER)
    eng.synchronize(h)


def poll(handle: int) -> bool:
    """True if the collective behind ``handle`` has completed (reference
    torch/mpi_ops.py:408-419)."""
    return engine_mod.get_engine().poll(handle)


def synchronize(handle: int) -> torch.Tensor:
    """Block until the collective behind the engine handle ``handle``
    completes and return its result (reference torch/mpi_ops.py:422-438);
    averaged and decompressed as the call that started it asked."""
    eng = engine_mod.get_engine()
    with _meta_lock:
        meta = _meta.get(handle, {})
    try:
        out = eng.synchronize(handle)
    except TimeoutError:
        raise  # handle still live — metadata kept so a retry works
    except Exception:
        with _meta_lock:
            _meta.pop(handle, None)
        h_splits = meta.get("alltoall_splits")
        if h_splits is not None:
            _drain_splits(eng, h_splits)
        raise
    with _meta_lock:
        _meta.pop(handle, None)
    if out is None:
        return None
    h_splits = meta.get("alltoall_splits")
    if h_splits is not None:
        # The executor delivered the full ragged concat; carve out this
        # process's chunk from every rank's block using the gathered
        # per-rank splits (row r = rank r's send splits).
        sp = eng.synchronize(h_splits).reshape(eng.size, eng.size).tolist()
        me = eng.rank
        pieces, off = [], 0
        for r in range(eng.size):
            start = off + sum(sp[r][:me])
            pieces.append(out[start:start + sp[r][me]])
            off += sum(sp[r])
        out = torch.cat(pieces)
    if meta.get("average"):
        # A divisor on the device: CUDA divides by a CPU scalar through its
        # reciprocal, which rounds differently from numpy's division.
        out = (out / torch.full((), eng.size, dtype=out.dtype,
                                device=out.device)).to(out.dtype)
    comp = meta.get("compression")
    if comp is not None:
        out = comp.decompress(out, meta.get("ctx"))
    return out
