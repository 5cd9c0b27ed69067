"""ctypes shim of the port's native coordination engine — counterpart of
``horovod_tpu/core/engine.py``.

* The C++ core (``core/src``, the port's own copy, built by
  :mod:`horovod_tpu_torch.core._build`) owns the background cycle thread,
  cross-process readiness negotiation over TCP, fusion scheduling, the
  response cache, heartbeats and elastic reconfiguration, the stall checker
  and the Chrome-tracing timeline.
* This module is its Python face: :class:`NativeEngine` enqueues named
  torch tensors, and an **executor thread** polls the engine for fused
  :class:`ExecBatch` es, runs them through the ``executor=`` callable and
  reports completion.  ``core/executors.py`` holds the two executors:
  ``local_executor`` (collectives over this process alone; the serving
  fleet's ``serving.tick`` keeps that rank-local meaning, as the JAX
  package's fleet does) and ``multihost_executor``, which reduces each
  fused batch across the processes over ``torch.distributed``.

**Tensors stay on their device.**  The store holds each enqueued tensor as
it was given (detached, made contiguous), on the card or on the CPU.  A
CUDA tensor is stamped with an event on the enqueuing thread's current
stream (autograd's device thread, for a gradient hook), and the executor
thread makes its own current stream wait on that event before it reads the
tensor: the executor's copies come after the kernel that wrote it, whatever
order the host threads run in.  The executor stamps each result the same
way, and :meth:`NativeEngine.synchronize` makes the caller's current stream
wait on that stamp before it hands the result back.  No stream waits on the
host.  A numpy array (the fleet tick) is enqueued as a CPU tensor and comes
back from ``synchronize`` as numpy.

The shim, its enums and its binary layouts are the JAX package's, line for
line; what differs is where the library comes from (never the JAX
package's build, whatever ``HVD_CORE_LIB`` says) and where rank and size
come from (:mod:`horovod_tpu_torch.basics`).
"""

from __future__ import annotations

import ctypes
import os
import struct
import threading
from typing import Callable

import numpy as np
import torch

from horovod_tpu_torch.core import _build
from horovod_tpu_torch.utils import env

# Wire enums — must match core/src/common.h and message.h.
OP_ALLREDUCE, OP_ALLGATHER, OP_BROADCAST, OP_ALLTOALL, OP_BARRIER = range(5)
OP_NAMES = {OP_ALLREDUCE: "allreduce", OP_ALLGATHER: "allgather",
            OP_BROADCAST: "broadcast", OP_ALLTOALL: "alltoall",
            OP_BARRIER: "barrier"}

# Wire formats (core/src/message.h WireFormat): NATIVE ships the tensor's
# own dtype; INT8 ships (f32 scale, int8 values) per rank — allreduce only.
WIRE_NATIVE, WIRE_INT8 = 0, 1
RESP_ERROR = 5

STATUS_OK = 0
STATUS_UNKNOWN = 1
STATUS_PRECONDITION = 2
STATUS_ABORTED = 3
STATUS_INVALID = 4
STATUS_IN_PROGRESS = 5

DTYPES: dict[str, int] = {
    "uint8": 0, "int8": 1, "int32": 2, "int64": 3, "float16": 4,
    "float32": 5, "float64": 6, "bool": 7, "bfloat16": 8,
}
DTYPE_NAMES = {v: k for k, v in DTYPES.items()}
# The core's dtype ids by torch dtype (the port's tensors).
TORCH_DTYPES: dict[torch.dtype, int] = {
    torch.uint8: 0, torch.int8: 1, torch.int32: 2, torch.int64: 3,
    torch.float16: 4, torch.float32: 5, torch.float64: 6, torch.bool: 7,
    torch.bfloat16: 8,
}


class CollectiveError(RuntimeError):
    """Coordinated error delivered to every rank (reference
    MPIResponse::ERROR → FailedPreconditionError, operations.cc:494-499)."""


class MembershipChanged(CollectiveError):
    """An elastic membership reconfiguration aborted the collective
    (docs/fault_tolerance.md "In-place recovery"): a rank left (shrink) or
    a new rank joined (grow).  The engine is stopped and
    :func:`resize_event` carries the new membership; call
    ``horovod_tpu_torch.elastic.reconfigure()`` to re-form the engine in
    this same process, then reissue work, as the serving fleet's loops
    do."""


def _load_library() -> ctypes.CDLL:
    # Builds at the first call in any process (several replicas may race;
    # _build serializes them on a file lock and renames the finished
    # library into place).  A failed build raises; nothing else is tried.
    lib = _build.load()
    lib.hvd_create.restype = ctypes.c_void_p
    lib.hvd_create.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_double, ctypes.c_longlong,
        ctypes.c_longlong,
        ctypes.c_double, ctypes.c_int, ctypes.c_double, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_int]
    lib.hvd_start.restype = ctypes.c_int
    lib.hvd_start.argtypes = [ctypes.c_void_p,
                              ctypes.POINTER(ctypes.c_int),
                              ctypes.c_char_p, ctypes.c_int]
    lib.hvd_shutdown.argtypes = [ctypes.c_void_p]
    lib.hvd_destroy.argtypes = [ctypes.c_void_p]
    lib.hvd_enqueue.restype = ctypes.c_longlong
    lib.hvd_enqueue.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_longlong), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_char_p, ctypes.c_int]
    lib.hvd_next_batch.restype = ctypes.c_int
    lib.hvd_next_batch.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                   ctypes.c_int, ctypes.c_double]
    lib.hvd_batch_done.argtypes = [ctypes.c_void_p, ctypes.c_longlong,
                                   ctypes.c_int, ctypes.c_char_p]
    lib.hvd_batch_activity.restype = None
    lib.hvd_batch_activity.argtypes = [ctypes.c_void_p, ctypes.c_longlong,
                                       ctypes.c_char_p]
    lib.hvd_timeline_instant.restype = None
    lib.hvd_timeline_instant.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                         ctypes.c_char_p]
    lib.hvd_stall_report.restype = ctypes.c_int
    lib.hvd_stall_report.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                     ctypes.c_int]
    lib.hvd_cache_stats.restype = None
    lib.hvd_cache_stats.argtypes = [ctypes.c_void_p,
                                    ctypes.POINTER(ctypes.c_longlong)]
    lib.hvd_verify_submit.restype = None
    lib.hvd_verify_submit.argtypes = [ctypes.c_void_p, ctypes.c_longlong,
                                      ctypes.c_ulonglong, ctypes.c_char_p]
    lib.hvd_divergence_report.restype = ctypes.c_int
    lib.hvd_divergence_report.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                          ctypes.c_int]
    lib.hvd_failure_report.restype = ctypes.c_int
    lib.hvd_failure_report.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                       ctypes.c_int]
    lib.hvd_resize_event.restype = ctypes.c_int
    lib.hvd_resize_event.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                     ctypes.c_int]
    lib.hvd_resize_ack.restype = None
    lib.hvd_resize_ack.argtypes = [ctypes.c_void_p]
    lib.hvd_shard_put.restype = ctypes.c_int
    lib.hvd_shard_put.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                  ctypes.c_longlong, ctypes.c_char_p,
                                  ctypes.c_longlong]
    lib.hvd_shard_poll.restype = ctypes.c_int
    lib.hvd_shard_poll.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                   ctypes.c_int]
    lib.hvd_shard_ack_poll.restype = ctypes.c_int
    lib.hvd_shard_ack_poll.argtypes = [ctypes.c_void_p,
                                       ctypes.POINTER(ctypes.c_longlong)]
    lib.hvd_ticket_request.restype = ctypes.c_int
    lib.hvd_ticket_request.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                       ctypes.c_longlong, ctypes.c_longlong,
                                       ctypes.c_char_p]
    lib.hvd_ticket_poll.restype = ctypes.c_int
    lib.hvd_ticket_poll.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                    ctypes.c_int]
    lib.hvd_coord_state.restype = ctypes.c_int
    lib.hvd_coord_state.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                    ctypes.c_int]
    lib.hvd_control_plane_stats.restype = None
    lib.hvd_control_plane_stats.argtypes = [ctypes.c_void_p,
                                            ctypes.POINTER(ctypes.c_double)]
    lib.hvd_tree_plan.restype = None
    lib.hvd_tree_plan.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                  ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    lib.hvd_relay_run.restype = ctypes.c_int
    lib.hvd_relay_run.argtypes = [ctypes.c_int, ctypes.c_char_p, ctypes.c_int,
                                  ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                  ctypes.c_int, ctypes.c_longlong,
                                  ctypes.c_int, ctypes.c_char_p, ctypes.c_int,
                                  ctypes.c_longlong]
    lib.hvd_detach_listener.restype = None
    lib.hvd_detach_listener.argtypes = [ctypes.c_void_p]
    lib.hvd_poll.restype = ctypes.c_int
    lib.hvd_poll.argtypes = [ctypes.c_void_p, ctypes.c_longlong]
    lib.hvd_wait.restype = ctypes.c_int
    lib.hvd_wait.argtypes = [ctypes.c_void_p, ctypes.c_longlong,
                             ctypes.c_double]
    lib.hvd_handle_status.restype = ctypes.c_int
    lib.hvd_handle_status.argtypes = [ctypes.c_void_p, ctypes.c_longlong,
                                      ctypes.c_char_p, ctypes.c_int]
    lib.hvd_release.restype = ctypes.c_int
    lib.hvd_release.argtypes = [ctypes.c_void_p, ctypes.c_longlong,
                                ctypes.c_char_p, ctypes.c_int]
    lib.hvd_frame_golden.restype = ctypes.c_int
    lib.hvd_frame_golden.argtypes = [ctypes.c_int, ctypes.c_char_p,
                                     ctypes.c_int]
    for name in ("hvd_half_to_float", "hvd_float_to_half",
                 "hvd_bf16_to_float", "hvd_float_to_bf16"):
        fn = getattr(lib, name)
        fn.restype = None
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong]
    return lib


_lib: ctypes.CDLL | None = None
_lib_lock = threading.Lock()


def lib() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            _lib = _load_library()
        return _lib


def frame_golden(frame_type: int) -> bytes:
    """The native golden wire vector for ``frame_type`` (c_api.cc
    hvd_frame_golden): complete framed bytes with canonical field values.
    Conformance anchor for horovod_tpu/analysis/protocol/wire.py and the
    tests/golden/frames/ fixtures; raises for an unknown frame type."""
    buf = ctypes.create_string_buffer(1 << 16)
    n = lib().hvd_frame_golden(frame_type, buf, len(buf))
    if n == 0:
        raise ValueError(f"no golden frame for type {frame_type}")
    if n < 0:  # grow-and-retry convention (-needed-1)
        buf = ctypes.create_string_buffer(-n - 1)
        n = lib().hvd_frame_golden(frame_type, buf, len(buf))
    return buf.raw[:n]


class ExecBatch:
    """Parsed fused batch from hvd_next_batch (wire layout in c_api.cc)."""

    __slots__ = ("id", "type", "dtype", "root_rank", "wire", "names",
                 "handles", "shapes", "first_dim_sizes")

    def __init__(self, raw: bytes):
        off = 0

        def i32():
            nonlocal off
            v = struct.unpack_from("<i", raw, off)[0]
            off += 4
            return v

        def i64():
            nonlocal off
            v = struct.unpack_from("<q", raw, off)[0]
            off += 8
            return v

        def u8():
            nonlocal off
            v = raw[off]
            off += 1
            return v

        def s():
            nonlocal off
            n = i32()
            v = raw[off:off + n].decode()
            off += n
            return v

        self.id = i64()
        self.type = u8()
        self.dtype = u8()
        self.root_rank = i32()
        self.wire = u8()
        n = i32()
        self.names, self.handles, self.shapes = [], [], []
        for _ in range(n):
            self.names.append(s())
            self.handles.append(i64())
            nd = i32()
            self.shapes.append(tuple(i64() for _ in range(nd)))
        ns = i32()
        self.first_dim_sizes = [i64() for _ in range(ns)]


# Control-plane role codes (c_api.cc hvd_control_plane_stats).
_CP_ROLES = {0: "loopback", 1: "star_coordinator", 2: "star_worker",
             3: "tree_root", 4: "tree_member"}


class _Staged:
    """One tensor between ``enqueue`` (or the executor) and its reader:
    the tensor, the stream it was stamped on and the event after which it
    may be read there (``None`` on the CPU), and whether the caller gave
    numpy."""

    __slots__ = ("tensor", "stream", "ready", "as_numpy")

    def __init__(self, tensor: torch.Tensor, as_numpy: bool = False):
        self.tensor = tensor
        self.as_numpy = as_numpy
        self.stream = self.ready = None
        if tensor.is_cuda:
            self.stream = torch.cuda.current_stream(tensor.device)
            self.ready = torch.cuda.Event()
            self.ready.record(self.stream)

    def wait(self) -> torch.Tensor:
        """The tensor, once the calling thread's current stream has been
        ordered after the event; a reader on another stream is recorded on
        the tensor, so its memory is not reused before that stream's work
        on it is done."""
        if self.ready is not None:
            current = torch.cuda.current_stream(self.tensor.device)
            if current != self.stream:
                current.wait_event(self.ready)
                self.tensor.record_stream(current)
        return self.tensor


class NativeEngine:
    """One per process; wraps the C++ engine + the executor thread."""

    def __init__(self, rank: int, size: int, *,
                 executor: Callable[["NativeEngine", ExecBatch], None] | None = None,
                 coordinator_host: str | None = None,
                 coordinator_port: int = 0,
                 cycle_time_ms: float | None = None,
                 cache_capacity: int | None = None,
                 epoch: int = 0,
                 bulk_port: int = 0):
        self.rank = rank
        self.size = size
        self.epoch = epoch
        self.bulk_port = bulk_port
        # Remembered so an elastic reconfiguration (elastic.py) can re-form
        # the engine in this same process with the same wiring choices —
        # executor is kept UN-resolved so the local/multihost default is
        # re-derived for the new size.  bulk_port rides along because the
        # data-plane listener (dataplane.py) is process-global and survives
        # the reconfiguration; the new HELLO re-advertises the same port.
        self._ctor = dict(executor=executor,
                          coordinator_host=coordinator_host,
                          coordinator_port=coordinator_port,
                          cycle_time_ms=cycle_time_ms,
                          cache_capacity=cache_capacity,
                          bulk_port=bulk_port)
        self._lib = lib()
        self._store: dict[str, _Staged] = {}
        self._results: dict[int, _Staged] = {}
        # The ordinal of the last batch that carried each name, counted
        # as the executor finishes batches: the coordinator orders batches
        # alike on every rank, so two names' ordinals compare alike too.
        self._applied: dict[str, int] = {}
        self._batches_applied = 0
        self._handle_names: dict[int, tuple[str, _Staged]] = {}
        self._store_lock = threading.Lock()
        self._shutdown = threading.Event()
        from horovod_tpu_torch.core import executors

        self._executor = executor or executors.default_executor(rank, size)
        tl = env.timeline_path()
        # Cached so batch_activity can skip the FFI call (which takes the
        # engine-wide mutex) entirely on untimed runs — the common case.
        # Single source of truth: hvd_create's timeline arg derives from it.
        self._timeline_enabled = bool(tl) and rank == 0
        # Cached once: enqueue is on the submission hot path and the
        # verifier is a debug mode (HVD_TPU_VERIFY_SCHEDULE).
        self._verify_enabled = env.verify_schedule()
        self._ptr = self._lib.hvd_create(
            rank, size,
            cycle_time_ms if cycle_time_ms is not None else env.cycle_time_ms(),
            env.fusion_threshold_bytes(),
            cache_capacity if cache_capacity is not None
            else env.cache_capacity(),
            env.stall_warning_seconds(),
            0 if env.stall_check_disabled() else 1,
            env.stall_abort_seconds(),
            env.stall_abort_exit_code(),
            1 if self._verify_enabled else 0,
            env.verify_interval_ticks(),
            epoch,
            tl.encode() if self._timeline_enabled else None,
            (coordinator_host or "127.0.0.1").encode(),
            coordinator_port,
            bulk_port)
        err = ctypes.create_string_buffer(512)
        port = ctypes.c_int(0)
        rc = self._lib.hvd_start(self._ptr, ctypes.byref(port), err, 512)
        if rc != 0:
            raise RuntimeError(f"engine start failed: {err.value.decode()}")
        self.bound_port = port.value
        self._exec_thread = threading.Thread(
            target=self._exec_loop, name="hvd-executor", daemon=True)
        self._exec_thread.start()

    # -- client API ---------------------------------------------------------

    def enqueue(self, name: str, tensor, op: int,
                root_rank: int = -1, wire: int = WIRE_NATIVE) -> int:
        """Announce a tensor; returns an async handle (reference
        EnqueueTensorAllreduce, operations.cc:2025-2061).  ``tensor`` is a
        torch tensor on any device, or a numpy array (its result comes
        back as numpy)."""
        as_numpy = isinstance(tensor, np.ndarray)
        t = torch.from_numpy(np.ascontiguousarray(tensor)) if as_numpy \
            else tensor.detach()
        dtype_id = TORCH_DTYPES.get(t.dtype)
        if dtype_id is None:
            raise TypeError(f"unsupported dtype {t.dtype}")
        if wire == WIRE_INT8 and (op != OP_ALLREDUCE
                                  or not t.dtype.is_floating_point):
            raise ValueError(
                "int8 wire format applies to floating-point allreduce only")
        staged = _Staged(t.contiguous(), as_numpy)
        dims = (ctypes.c_longlong * max(t.dim(), 1))(*t.shape)
        err = ctypes.create_string_buffer(512)
        with self._store_lock:
            if name in self._store:
                # Fast-path duplicate rejection; the native engine enforces
                # the same rule for the window after execution started
                # (reference operations.cc:2035-2040).
                raise CollectiveError(
                    f"Duplicate tensor name '{name}' for "
                    f"{OP_NAMES.get(op, op)}: a previous request with this "
                    f"name has not completed. Collectives submitted in a "
                    f"loop need an explicit, per-iteration name= kwarg "
                    f"(e.g. name=f'grad.{{step}}.{{param}}') — hvd-lint "
                    f"rule HVD102, docs/static_analysis.md.")
            self._store[name] = staged
        h = self._lib.hvd_enqueue(self._ptr, name.encode(), op, dtype_id,
                                  dims, t.dim(), root_rank, wire, err, 512)
        if h < 0:
            with self._store_lock:
                self._store.pop(name, None)
            if self.resize_event() is not None:
                # The engine stopped because the membership changed, not
                # because the job is over: surface the elastic signal so
                # elastic_loop/callers reconfigure and reissue.
                raise MembershipChanged(err.value.decode() or
                                        "membership changed; reconfigure "
                                        "and reissue")
            raise CollectiveError(err.value.decode())
        with self._store_lock:
            self._handle_names[int(h)] = (name, staged)
        if self._verify_enabled:
            self._record_verify(op, name, DTYPE_NAMES[dtype_id],
                                tuple(t.shape))
        return int(h)

    # -- schedule verifier (HVD_TPU_VERIFY_SCHEDULE; analysis/schedule.py) --

    def _record_verify(self, op: int, name: str, dtype: str,
                       shape: tuple) -> None:
        from horovod_tpu_torch.analysis import schedule

        schedule.record_entry(OP_NAMES.get(op, str(op)), name, dtype, shape)
        self.flush_verify()

    def flush_verify(self) -> None:
        """Deliver recorded schedule checkpoints (including any buffered
        before this engine started, e.g. compiled-path traces) to the
        native coordinator stream."""
        from horovod_tpu_torch.analysis import schedule

        for seq, h, desc in schedule.recorder().drain():
            self.verify_submit(seq, h, desc)

    def verify_submit(self, seq: int, hash_: int, desc: str) -> None:
        self._lib.hvd_verify_submit(self._ptr, seq, hash_, desc.encode())

    def divergence_report(self) -> list[tuple[int, int, str]]:
        """Structured schedule-divergence view: ``[(rank, seq, op_desc),
        ...]`` — each rank's first mismatched collective once the verifier
        tripped; [] while the schedule is consistent.  The divergence
        analog of :meth:`stall_report`."""
        buf = ctypes.create_string_buffer(1 << 16)
        n = self._lib.hvd_divergence_report(self._ptr, buf, len(buf))
        if n < -1:
            buf = ctypes.create_string_buffer(-n + 16)
            n = self._lib.hvd_divergence_report(self._ptr, buf, len(buf))
        if n <= 0:
            return []
        raw = buf.raw[:n]
        off = 0

        def i32():
            nonlocal off
            v = struct.unpack_from("<i", raw, off)[0]
            off += 4
            return v

        def i64():
            nonlocal off
            v = struct.unpack_from("<q", raw, off)[0]
            off += 8
            return v

        out = []
        for _ in range(i32()):
            rank = i32()
            seq = i64()
            i64()  # rolling hash: internal detail, not surfaced
            ln = i32()
            desc = raw[off:off + ln].decode()
            off += ln
            out.append((rank, seq, desc))
        return out

    def poll(self, handle: int) -> bool:
        return bool(self._lib.hvd_poll(self._ptr, handle))

    def applied_order(self, name: str) -> int:
        """The ordinal of the last executed batch that carried ``name`` in
        this engine (0 before any): batches run in the coordinator's
        order, the same on every rank, so whether ``a`` ran after ``b``
        reads alike everywhere once both have run."""
        return self._applied.get(name, 0)

    def cache_stats(self) -> dict[str, int]:
        """This rank's response-cache counters (docs/response_cache.md):
        ``hits``/``misses``/``evictions``/``bypassed_ticks`` plus the
        current ``entries`` and configured ``capacity``.  All zeros when
        ``HOROVOD_CACHE_CAPACITY=0``."""
        out = (ctypes.c_longlong * 6)()
        self._lib.hvd_cache_stats(self._ptr, out)
        return {"hits": int(out[0]), "misses": int(out[1]),
                "evictions": int(out[2]), "bypassed_ticks": int(out[3]),
                "entries": int(out[4]), "capacity": int(out[5])}

    def failure_report(self) -> dict | None:
        """Structured peer-failure view (docs/fault_tolerance.md): ``None``
        while every peer is healthy, else a dict naming the failed rank and
        how its death was observed::

            {"failed_rank": 1, "cause": "connection_reset",
             "detail": "...", "last_heard_ms": 4.2,
             "last_collective": "grad.step3"}

        ``cause`` is one of ``connection_reset`` (socket EOF/RST — e.g. a
        SIGKILLed or preempted rank), ``heartbeat_timeout`` (silent past
        ``HVD_TPU_HEARTBEAT_TIMEOUT_MS`` — e.g. a network partition),
        ``frame_corrupt`` / ``frame_desync`` (hardened-wire CRC or framing
        violation), ``version_skew`` (mixed-build peer), or
        ``connection_lost`` (send error).  The peer-death analog of
        :meth:`stall_report` and :meth:`divergence_report`."""
        buf = ctypes.create_string_buffer(1 << 14)
        n = self._lib.hvd_failure_report(self._ptr, buf, len(buf))
        if n < -1:
            buf = ctypes.create_string_buffer(-n + 16)
            n = self._lib.hvd_failure_report(self._ptr, buf, len(buf))
        if n <= 0:
            return None
        raw = buf.raw[:n]
        off = 0

        def i32():
            nonlocal off
            v = struct.unpack_from("<i", raw, off)[0]
            off += 4
            return v

        def i64():
            nonlocal off
            v = struct.unpack_from("<q", raw, off)[0]
            off += 8
            return v

        def s():
            nonlocal off
            ln = i32()
            v = raw[off:off + ln].decode()
            off += ln
            return v

        if i32() == 0:
            return None
        failed_rank = i32()
        cause = s()
        detail = s()
        last_heard_us = i64()
        last_collective = s()
        return {"failed_rank": failed_rank, "cause": cause, "detail": detail,
                "last_heard_ms": (last_heard_us / 1000.0
                                  if last_heard_us >= 0 else None),
                "last_collective": last_collective}

    def resize_event(self) -> dict | None:
        """Structured elastic resize event (docs/fault_tolerance.md
        "In-place recovery"): ``None`` while the membership is stable; after
        a reconfiguration verdict stopped this engine, a dict::

            {"epoch": 1, "old_rank": 2, "new_rank": 1, "old_size": 3,
             "new_size": 2, "failed_rank": 1, "cause": "connection_reset",
             "new_coord_host": "", "new_coord_port": 0}

        ``failed_rank`` is -1 for a grow (a relaunched rank rejoined).
        After a coordinator failover ``new_coord_host``/``new_coord_port``
        name the promoted standby's endpoint (empty host = the coordinator
        did not move).  The engine is stopped at this point —
        ``elastic.reconfigure()`` acks the event and re-forms the engine
        under the new membership."""
        buf = ctypes.create_string_buffer(1 << 12)
        n = self._lib.hvd_resize_event(self._ptr, buf, len(buf))
        if n < -1:
            buf = ctypes.create_string_buffer(-n + 16)
            n = self._lib.hvd_resize_event(self._ptr, buf, len(buf))
        if n <= 0:
            return None
        raw = buf.raw[:n]
        off = 0

        def i32():
            nonlocal off
            v = struct.unpack_from("<i", raw, off)[0]
            off += 4
            return v

        def i64():
            nonlocal off
            v = struct.unpack_from("<q", raw, off)[0]
            off += 8
            return v

        def s():
            nonlocal off
            ln = i32()
            v = raw[off:off + ln].decode()
            off += ln
            return v

        if i32() == 0:
            return None
        epoch = i64()
        old_rank, new_rank, old_size, new_size, failed_rank = (
            i32(), i32(), i32(), i32(), i32())
        cause = s()
        new_coord_host = s()
        new_coord_port = i32()
        return {"epoch": epoch, "old_rank": old_rank, "new_rank": new_rank,
                "old_size": old_size, "new_size": new_size,
                "failed_rank": failed_rank, "cause": cause,
                "new_coord_host": new_coord_host,
                "new_coord_port": new_coord_port}

    def resize_ack(self) -> None:
        """Acknowledge the resize event: stands the native engine's bounded
        reconfig-timeout fallback exit down so this process can re-form the
        engine in place (called by ``elastic.reconfigure``)."""
        self._lib.hvd_resize_ack(self._ptr)

    # -- peer-replicated checkpoint shards (docs/fault_tolerance.md
    # "Async & peer-replicated checkpointing") -----------------------------

    def shard_put(self, target_rank: int, step: int, payload: bytes) -> bool:
        """Push an opaque checkpoint shard toward ``target_rank``'s host
        memory over the control plane (relayed through the coordinator in
        the star topology).  Non-blocking on the inbox side; returns False
        on single-process jobs (no peers) or when the send failed."""
        return bool(self._lib.hvd_shard_put(self._ptr, target_rank, step,
                                            payload, len(payload)))

    def shard_poll(self) -> tuple[int, int, int, bytes] | None:
        """Pop the next shard a peer replicated into this rank's inbox:
        ``(owner_rank, step, epoch, payload)``; ``None`` when empty."""
        buf = ctypes.create_string_buffer(1 << 16)
        n = self._lib.hvd_shard_poll(self._ptr, buf, len(buf))
        if n < -1:
            buf = ctypes.create_string_buffer(-n + 16)
            n = self._lib.hvd_shard_poll(self._ptr, buf, len(buf))
        if n <= 0:
            return None
        raw = buf.raw[:n]
        owner, step, epoch, ln = struct.unpack_from("<iqqq", raw, 0)
        payload = raw[28:28 + ln]
        return (owner, step, epoch, payload)

    def shard_acks(self) -> list[tuple[int, int, int, int]]:
        """Drain the control-plane acks for shards this rank pushed:
        ``[(owner_rank, target_rank, step, epoch), ...]``."""
        out = []
        ack = (ctypes.c_longlong * 4)()
        while self._lib.hvd_shard_ack_poll(self._ptr, ack):
            out.append((int(ack[0]), int(ack[1]), int(ack[2]), int(ack[3])))
        return out

    # -- bulk data plane (docs/fault_tolerance.md "Bulk data plane") --------

    def ticket_request(self, dst_rank: int, step: int, nbytes: int,
                       manifest: bytes = b"") -> bool:
        """Ask the coordinator to authorize a direct rank-to-rank stream of
        ``nbytes`` toward ``dst_rank``'s bulk listener.  The answering
        ticket arrives asynchronously via :meth:`ticket_poll`.  Returns
        False on single-process jobs (no peers) or when the send failed."""
        return bool(self._lib.hvd_ticket_request(self._ptr, dst_rank, step,
                                                 nbytes, manifest))

    def ticket_poll(self) -> dict | None:
        """Pop the next coordinator-issued transfer ticket::

            {"transfer_id": 7, "token": 0x..., "src_rank": 1,
             "dst_rank": 2, "dst_host": "127.0.0.1", "dst_port": 40001,
             "step": 100, "epoch": 0, "manifest": b"..."}

        ``dst_port == 0`` means the destination advertised no bulk
        listener — use the coordinator relay instead.  ``None`` when no
        ticket is queued."""
        buf = ctypes.create_string_buffer(1 << 14)
        n = self._lib.hvd_ticket_poll(self._ptr, buf, len(buf))
        if n < -1:
            buf = ctypes.create_string_buffer(-n + 16)
            n = self._lib.hvd_ticket_poll(self._ptr, buf, len(buf))
        if n <= 0:
            return None
        raw = buf.raw[:n]
        (transfer_id, token, src_rank, dst_rank, dst_port, step,
         epoch) = struct.unpack_from("<qqiiiqq", raw, 0)
        off = 44
        hln = struct.unpack_from("<i", raw, off)[0]
        off += 4
        dst_host = raw[off:off + hln].decode()
        off += hln
        mln = struct.unpack_from("<i", raw, off)[0]
        off += 4
        manifest = raw[off:off + mln]
        return {"transfer_id": transfer_id, "token": token & 0xFFFFFFFFFFFFFFFF,
                "src_rank": src_rank, "dst_rank": dst_rank,
                "dst_host": dst_host, "dst_port": dst_port, "step": step,
                "epoch": epoch, "manifest": manifest}

    def coord_state(self) -> dict | None:
        """The last coordinator-state delta this rank has seen
        (docs/fault_tolerance.md "Coordinator failover"): the coordinator's
        own emission on rank 0, the replicated copy on the designated
        standby, ``None`` elsewhere::

            {"epoch": 0, "joins_admitted": 0, "verify_checked": 12,
             "verify_tick": 40, "lru_order": [3, 1, 0, 2]}

        Observability for the standby-replication stream — tests use it to
        assert the standby's view was current before a coordinator kill."""
        buf = ctypes.create_string_buffer(1 << 14)
        n = self._lib.hvd_coord_state(self._ptr, buf, len(buf))
        if n < -1:
            buf = ctypes.create_string_buffer(-n + 16)
            n = self._lib.hvd_coord_state(self._ptr, buf, len(buf))
        if n <= 0:
            return None
        raw = buf.raw[:n]
        off = 0

        def i32():
            nonlocal off
            v = struct.unpack_from("<i", raw, off)[0]
            off += 4
            return v

        def i64():
            nonlocal off
            v = struct.unpack_from("<q", raw, off)[0]
            off += 8
            return v

        if i32() == 0:
            return None
        epoch = i64()
        joins_admitted = i64()
        verify_checked = i64()
        verify_tick = i64()
        lru_order = [i32() for _ in range(i32())]
        return {"epoch": epoch, "joins_admitted": joins_admitted,
                "verify_checked": verify_checked, "verify_tick": verify_tick,
                "lru_order": lru_order}

    def control_plane_stats(self) -> dict:
        """Control-plane topology and tick-latency view for this rank
        (docs/benchmarks.md "Control-plane scaling")::

            {"role": "tree_root", "depth": 2, "fanout": 64,
             "tick_p50_ms": 0.8, "tick_p99_ms": 2.1,
             "frames_per_tick": 64.0, "ticks": 1200, "frames_rx": 76800}

        ``frames_per_tick`` is the load-bearing scaling number: on a tree
        root it equals the number of aggregator groups (O(fanout), pinned
        by tests/test_tree.py), not the worker count."""
        out = (ctypes.c_double * 8)()
        self._lib.hvd_control_plane_stats(self._ptr, out)
        role = int(out[0])
        return {"role": _CP_ROLES.get(role, str(role)),
                "depth": int(out[1]), "fanout": int(out[2]),
                "tick_p50_ms": out[3], "tick_p99_ms": out[4],
                "frames_per_tick": out[5], "ticks": int(out[6]),
                "frames_rx": int(out[7])}

    def detach_listener(self) -> None:
        """Coordinator, reconfiguration hand-off: release the control-plane
        listen port for the re-formed membership while this stopped
        engine's peer sockets stay open — survivors that have not yet read
        the RECONFIG broadcast must not be RST (``elastic.reconfigure``
        destroys this engine only after the new rendezvous completes)."""
        self._lib.hvd_detach_listener(self._ptr)

    def stall_report(self) -> list[tuple[str, list[int]]]:
        """Structured stall view: [(tensor_name, [missing ranks]), ...].

        Non-empty only on the coordinator (rank 0) while tensors have
        been waiting past the stall-warning window — the machine-readable
        form of the reference's log-only CheckForStalledTensors string."""
        buf = ctypes.create_string_buffer(1 << 16)
        n = self._lib.hvd_stall_report(self._ptr, buf, len(buf))
        if n < -1:
            buf = ctypes.create_string_buffer(-n + 16)
            n = self._lib.hvd_stall_report(self._ptr, buf, len(buf))
        if n <= 0:
            return []
        raw = buf.raw[:n]
        off = 0

        def i32():
            nonlocal off
            v = struct.unpack_from("<i", raw, off)[0]
            off += 4
            return v

        out = []
        for _ in range(i32()):
            ln = i32()
            name = raw[off:off + ln].decode()
            off += ln
            out.append((name, [i32() for _ in range(i32())]))
        return out

    def synchronize(self, handle: int, timeout_s: float = 300.0):
        """Block until done; return the result, a tensor on the input's
        device (numpy for a numpy input), ordered on the caller's current
        stream after the executor's work.  Blocks on the native condition
        variable (the reference instead polls at 1 ms,
        torch/mpi_ops_v2.cc:228-234)."""
        if not self._lib.hvd_wait(self._ptr, handle, timeout_s * 1000.0):
            raise TimeoutError(f"handle {handle} did not complete "
                               f"within {timeout_s}s")
        err = ctypes.create_string_buffer(2048)
        rc = self._lib.hvd_release(self._ptr, handle, err, 2048)
        with self._store_lock:
            result = self._results.pop(handle, None)
            entry = self._handle_names.pop(handle, None)
            if entry is not None and (rc != STATUS_OK or result is None):
                # Two cases leave the staged input orphaned in _store: errors
                # (no executor ever took the input) and natively-finalized ops
                # (BARRIER completes inside DispatchResponses without any
                # executor calling take_inputs).  Free the name so later
                # enqueues aren't rejected as duplicates — but only if the
                # stored entry is still OURS (a newer request may have
                # legally reused the name after this handle finished).
                name, staged = entry
                if self._store.get(name) is staged:
                    self._store.pop(name, None)
        if rc == STATUS_PRECONDITION:
            if self.resize_event() is not None:
                raise MembershipChanged(err.value.decode())
            raise CollectiveError(err.value.decode())
        if rc != STATUS_OK:
            if self.resize_event() is not None:
                raise MembershipChanged(err.value.decode())
            raise RuntimeError(
                f"collective failed (status {rc}): {err.value.decode()}")
        if result is None:
            return None
        out = result.wait()
        if entry is not None and entry[1].as_numpy:
            return out.cpu().numpy()
        return out

    def shutdown(self):
        if self._shutdown.is_set():
            return
        # Request the coordinated stop BEFORE flagging the executor loop:
        # batches the coordinator already broadcast keep draining (every
        # rank dispatched them; a peer may have completed them already) and
        # the loop exits on the engine's own stopped signal (-1).
        self._lib.hvd_shutdown(self._ptr)
        self._exec_thread.join(timeout=10)
        self._shutdown.set()
        if self._exec_thread.is_alive():
            # Executor is stuck inside a collective; destroying the native
            # engine now would be a use-after-free when it resumes.  Leak it
            # (process is exiting anyway) rather than crash.
            import warnings

            warnings.warn("horovod_tpu_torch: executor thread did not exit "
                          "within 10s; native engine leaked", RuntimeWarning)
            return
        self._lib.hvd_destroy(self._ptr)
        self._ptr = None

    # -- executor side ------------------------------------------------------

    def _exec_loop(self):
        buf = ctypes.create_string_buffer(1 << 20)
        while True:
            n = self._lib.hvd_next_batch(self._ptr, buf, len(buf), 100.0)
            if n == 0:
                # Timeout.  _shutdown is only consulted here (not as the
                # loop condition) so an engine stopped mid-drain still hands
                # out its already-broadcast batches before the -1 below —
                # FailUnscheduled (engine.cc) deliberately leaves those
                # alive.  The flag alone still exits the loop for tests
                # that bypass the coordinated path.
                if self._shutdown.is_set():
                    return
                continue
            if n == -1:
                return
            if n < -1:
                buf = ctypes.create_string_buffer(-n + 16)
                continue
            batch = ExecBatch(buf.raw[:n])
            try:
                self._executor(self, batch)
                self._batches_applied += 1
                for name in batch.names:
                    self._applied[name] = self._batches_applied
                self._lib.hvd_batch_done(self._ptr, batch.id, STATUS_OK, None)
            except Exception as e:  # noqa: BLE001 - report, don't kill thread
                self._lib.hvd_batch_done(self._ptr, batch.id, STATUS_UNKNOWN,
                                         str(e).encode())

    def batch_activity(self, batch: ExecBatch, activity: str) -> None:
        """Switch the timeline phase for a batch mid-execution (reference
        in-activity phases, operations.h:29-46); no-op without a timeline."""
        if not self._timeline_enabled:
            return
        self._lib.hvd_batch_activity(self._ptr, batch.id, activity.encode())

    def timeline_instant(self, row: str, label: str) -> None:
        """Instant marker on a named timeline row — the OVERLAP_PLAN
        schedule-planner decisions (ops/schedule_plan.py) land alongside
        the dispatch loop's CACHE_HIT/NEGOTIATED instants; no-op without
        a timeline."""
        if not self._timeline_enabled:
            return
        self._lib.hvd_timeline_instant(self._ptr, row.encode(),
                                       label.encode())

    def take_staged(self, batch: ExecBatch) -> list[_Staged]:
        """The batch's staged tensors, in batch order (``_Staged.wait``
        gives each to the reader's stream)."""
        with self._store_lock:
            return [self._store.pop(name) for name in batch.names]

    def take_inputs(self, batch: ExecBatch) -> list[torch.Tensor]:
        """The batch's tensors, in batch order; the calling thread's
        current stream is ordered after the work that wrote each."""
        return [s.wait() for s in self.take_staged(batch)]

    def put_results(self, batch: ExecBatch, outs: list[torch.Tensor]):
        """Hand the batch's results to their handles, each stamped with an
        event on the calling thread's current stream: call it on the
        stream that wrote them."""
        staged = [_Staged(out) for out in outs]
        with self._store_lock:
            for h, out in zip(batch.handles, staged):
                self._results[h] = out


# -- module-level singleton management (mirrors basics._topology) -----------

_engine: NativeEngine | None = None
_engine_lock = threading.Lock()


def get_engine() -> NativeEngine:
    """Lazily start the engine for the current process topology: rank and
    size of :mod:`horovod_tpu_torch.basics` (``init`` first), the
    coordinator at ``HVD_TPU_COORDINATOR_HOST`` / ``_PORT``."""
    global _engine
    with _engine_lock:
        if _engine is None:
            from horovod_tpu_torch import basics

            host = os.environ.get("HVD_TPU_COORDINATOR_HOST")
            port = int(os.environ.get("HVD_TPU_COORDINATOR_PORT", "0") or 0)
            bulk_port = 0
            if basics.size() > 1 and env.bulk_plane():
                # Bind the process-global bulk listener BEFORE the engine
                # exists so its port rides this rank's HELLO advertisement.
                try:
                    from horovod_tpu_torch import dataplane
                    bulk_port = dataplane.ensure_listener()
                except Exception:
                    bulk_port = 0  # no direct path; transfers fall to relay
            _engine = NativeEngine(basics.rank(), basics.size(),
                                   coordinator_host=host,
                                   coordinator_port=port,
                                   bulk_port=bulk_port)
            if _engine._verify_enabled:
                # Schedule checkpoints recorded before the engine existed
                # join the stream now.
                _engine.flush_verify()
        return _engine


def peek_engine() -> NativeEngine | None:
    """The running engine, or None — never starts one (the schedule
    verifier and report helpers must not boot a control plane as a side
    effect of asking a question)."""
    with _engine_lock:
        return _engine


def replace_engine(old: NativeEngine | None,
                   new: NativeEngine | None) -> None:
    """Swap the module singleton during an elastic reconfiguration
    (elastic.py): only replaces when ``old`` IS the current singleton, so
    explicitly-constructed test engines never hijack an unrelated one."""
    global _engine
    with _engine_lock:
        if _engine is old or _engine is None:
            _engine = new


def stall_report() -> list[tuple[str, list[int]]]:
    """Module-level stall report; [] when the engine was never started
    (nothing can be stalled without the eager control plane)."""
    eng = peek_engine()
    return eng.stall_report() if eng is not None else []


def cache_stats() -> dict[str, int]:
    """Module-level response-cache counters; all zeros when the engine was
    never started."""
    eng = peek_engine()
    if eng is None:
        return {"hits": 0, "misses": 0, "evictions": 0, "bypassed_ticks": 0,
                "entries": 0, "capacity": 0}
    return eng.cache_stats()


def control_plane_stats() -> dict:
    """Module-level control-plane stats; the ``"none"`` role with zeroed
    counters when the engine was never started."""
    eng = peek_engine()
    if eng is None:
        return {"role": "none", "depth": 0, "fanout": 0, "tick_p50_ms": 0.0,
                "tick_p99_ms": 0.0, "frames_per_tick": 0.0, "ticks": 0,
                "frames_rx": 0}
    return eng.control_plane_stats()


def failure_report() -> dict | None:
    """Module-level peer-failure report; ``None`` when the engine was never
    started (no control plane, no peers to lose)."""
    eng = peek_engine()
    return eng.failure_report() if eng is not None else None


def resize_event() -> dict | None:
    """Module-level elastic resize event; ``None`` when the engine was
    never started or the membership is stable."""
    eng = peek_engine()
    return eng.resize_event() if eng is not None else None


def coord_state() -> dict | None:
    """Module-level coordinator-state replica view; ``None`` when the
    engine was never started or this rank is neither the coordinator nor
    the designated standby."""
    eng = peek_engine()
    return eng.coord_state() if eng is not None else None


def shutdown_engine() -> None:
    """Stop the module's engine, if one was started (``basics.shutdown``)."""
    global _engine
    with _engine_lock:
        if _engine is not None:
            _engine.shutdown()
            _engine = None
