"""Runtime schedule verifier — counterpart of
``horovod_tpu/analysis/schedule.py``, kept line for line.

A rank that issues its collectives in a different *order* from its peers,
or skips one, would stall until the stall detector times out.  Under
``HVD_TPU_VERIFY_SCHEDULE=1`` every collective submitted to the native
engine (``NativeEngine.enqueue``) extends a per-process rolling FNV-1a hash
over ``(op, name, dtype, shape)`` and ships ``(seq, hash, desc)`` to the
engine; the coordinator cross-checks the sequences across ranks every
``HVD_TPU_VERIFY_INTERVAL_TICKS`` cycles (``core/src/controller.cc``) and,
on the first mismatched sequence number, fails every pending collective on
every rank with a structured divergence report naming each rank's op at
that point (:func:`divergence_report`) instead of hanging.

Stdlib-only at import time (no ctypes): recording must be cheap and
import-safe from anywhere in the package.
"""

from __future__ import annotations

import threading
from collections import deque

from horovod_tpu_torch.utils import env

_FNV_OFFSET = 0xCBF29CE484222325
_FNV_PRIME = 0x100000001B3
_MASK64 = 0xFFFFFFFFFFFFFFFF


def verify_enabled() -> bool:
    """True when HVD_TPU_VERIFY_SCHEDULE / HOROVOD_VERIFY_SCHEDULE is on."""
    return env.verify_schedule()


def verify_interval_ticks() -> int:
    return env.verify_interval_ticks()


def _fnv1a(h: int, data: bytes) -> int:
    for b in data:
        h = ((h ^ b) * _FNV_PRIME) & _MASK64
    return h


class ScheduleRecorder:
    """Per-process rolling hash + bounded history of submitted collectives.

    ``record`` returns ``(seq, hash, desc)`` where ``hash`` covers every
    submission up to and including ``seq`` — equal hashes at equal seq
    mean equal schedules (up to 64-bit collision odds).
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._seq = 0
        self._hash = _FNV_OFFSET
        # Entries recorded before the engine exists, awaiting delivery.
        self._pending: deque[tuple[int, int, str]] = deque(maxlen=4096)

    def record(self, op: str, name: str, dtype: str,
               shape: tuple) -> tuple[int, int, str]:
        desc = f"{op} name={name} dtype={dtype} shape={tuple(shape)}"
        with self._lock:
            seq = self._seq
            self._seq += 1
            self._hash = _fnv1a(self._hash, desc.encode())
            entry = (seq, self._hash, desc)
            self._pending.append(entry)
        return entry

    def drain(self) -> list[tuple[int, int, str]]:
        with self._lock:
            out = list(self._pending)
            self._pending.clear()
        return out

    def reset(self) -> None:
        with self._lock:
            self._seq = 0
            self._hash = _FNV_OFFSET
            self._pending.clear()


_recorder = ScheduleRecorder()


def recorder() -> ScheduleRecorder:
    return _recorder


# Ops whose dim 0 legitimately differs across ranks (the reference's
# MPI_Allgatherv semantics; the coordinator likewise only enforces
# trailing-dim equality for these) — hashing the full shape would turn
# every ragged allgather into a false divergence.
_RAGGED_DIM0_OPS = ("allgather", "alltoall")


def _normalize_shape(op: str, shape: tuple) -> tuple:
    if any(r in op for r in _RAGGED_DIM0_OPS) and len(shape) > 0:
        return ("*",) + tuple(shape[1:])
    return tuple(shape)


def record_entry(op: str, name: str, dtype, shape) -> None:
    """Record one submission unconditionally (callers gate on
    :func:`verify_enabled` / their cached copy of it)."""
    _recorder.record(op, str(name), str(dtype),
                     _normalize_shape(op, tuple(shape)))


def record(op: str, name: str, dtype, shape) -> None:
    """Record one submission and forward it to the native engine when one
    is running.  No-op unless HVD_TPU_VERIFY_SCHEDULE is set."""
    if not verify_enabled():
        return
    record_entry(op, name, dtype, shape)
    flush_to_engine()


def flush_to_engine() -> None:
    """Deliver buffered entries to the native engine, if it has started.

    Entries recorded before engine start (e.g. compiled-path traces during
    warmup) are kept and delivered on the first flush after start, so the
    cross-rank hash still covers them.
    """
    from horovod_tpu_torch.core import engine as engine_mod

    eng = engine_mod.peek_engine()
    if eng is None:
        return
    for seq, h, desc in _recorder.drain():
        eng.verify_submit(seq, h, desc)


def divergence_report() -> list[tuple[int, int, str]]:
    """Structured schedule-divergence view: ``[(rank, seq, op_desc), ...]``
    — each rank's first mismatched collective, empty when the schedule has
    not diverged (or the engine never ran).  The ``hvd.stall_report()``
    analog for the verifier (docs/static_analysis.md)."""
    from horovod_tpu_torch.core import engine as engine_mod

    eng = engine_mod.peek_engine()
    return eng.divergence_report() if eng is not None else []
