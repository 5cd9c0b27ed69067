"""Deterministic fault injection for the control and data planes —
counterpart of the parts of ``horovod_tpu/faults.py`` that the port's
data plane and elastic membership call.

Injectors (all opt-in; absent env == no faults):

* ``HVD_TPU_FAULT_WIRE_{DROP,CORRUPT,PARTITION,HALFCLOSE}`` =
  ``"<rank>[:<frame>][@<epoch>]"`` — wire-level chaos against the TCP
  control plane, executed natively in ``core/src/controller.cc``; parsed
  here too so :func:`armed` and tests see one plan.  From its
  ``<frame>``-th sent control-plane frame on, the named rank DROPs every
  outgoing frame, CORRUPTs one frame's payload after the CRC is computed,
  PARTITIONs fully, or HALFCLOSEs its write side.  ``@<epoch>`` keys the
  plan to one membership epoch (default 0).
* ``HVD_TPU_FAULT_BULK_{DROP,CORRUPT,TRUNCATE}`` = ``"<rank>[:<nth>]"``
  — data-plane chaos against the rank-to-rank bulk streams
  (``dataplane.py``): rank <rank>'s <nth> bulk SEND (0-based; default 0)
  silently vanishes after the ticket is consumed (DROP), carries one
  flipped chunk CRC the receiver must reject (CORRUPT), or closes the
  socket mid-stream leaving a truncated payload (TRUNCATE).  Every case
  must land on the fallback chain (direct -> coordinator relay), never a
  hang or a torn shard.
* ``HVD_TPU_FAULT_ON_ATTEMPT`` (default 0) — faults fire only when
  ``HVD_TPU_RESTART_ATTEMPT`` matches.

The step-indexed injectors of the JAX package (kill, stall, delay, the
checkpoint persist faults) belong to the training loop's elastic and
checkpoint path, not ported yet.  Tests may bypass env parsing with
:func:`install`.
"""

from __future__ import annotations

import dataclasses
import os
import sys


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Parsed injector configuration (None field == injector disabled).

    The ``wire_*`` injectors are ``(rank, frame, epoch)`` tuples executed
    by the native control plane; the ``bulk_*`` ones ``(rank, nth)``."""

    wire_drop: tuple[int, int, int] | None = None
    wire_corrupt: tuple[int, int, int] | None = None
    wire_partition: tuple[int, int, int] | None = None
    wire_halfclose: tuple[int, int, int] | None = None
    bulk_drop: tuple[int, int] | None = None
    bulk_corrupt: tuple[int, int] | None = None
    bulk_truncate: tuple[int, int] | None = None
    on_attempt: int = 0

    def any_active(self) -> bool:
        return any(v is not None for v in (
            self.wire_drop, self.wire_corrupt,
            self.wire_partition, self.wire_halfclose,
            self.bulk_drop, self.bulk_corrupt, self.bulk_truncate))


def _int_env(name: str) -> int | None:
    raw = os.environ.get(name)
    if raw is None or raw == "":
        return None
    return int(raw)


def _wire_env(name: str) -> tuple[int, int, int] | None:
    """Parse a wire injector's ``"<rank>[:<frame>][@<epoch>]"`` value
    (frame and epoch 0 when omitted) — the grammar
    core/src/controller.cc ParseWireFaultEnv reads."""
    raw = os.environ.get(name)
    if raw is None or raw == "":
        return None
    raw, _, epoch_s = raw.partition("@")
    rank_s, _, frame_s = raw.partition(":")
    return int(rank_s), int(frame_s or 0), int(epoch_s or 0)


def _bulk_env(name: str) -> tuple[int, int] | None:
    """Parse a bulk injector's ``"<rank>[:<nth>]"`` value (nth 0 when
    omitted) — which of the rank's bulk sends the fault hits."""
    raw = os.environ.get(name)
    if raw is None or raw == "":
        return None
    rank_s, _, nth_s = raw.partition(":")
    return int(rank_s), int(nth_s or 0)


def _plan_from_env() -> FaultPlan:
    return FaultPlan(
        wire_drop=_wire_env("HVD_TPU_FAULT_WIRE_DROP"),
        wire_corrupt=_wire_env("HVD_TPU_FAULT_WIRE_CORRUPT"),
        wire_partition=_wire_env("HVD_TPU_FAULT_WIRE_PARTITION"),
        wire_halfclose=_wire_env("HVD_TPU_FAULT_WIRE_HALFCLOSE"),
        bulk_drop=_bulk_env("HVD_TPU_FAULT_BULK_DROP"),
        bulk_corrupt=_bulk_env("HVD_TPU_FAULT_BULK_CORRUPT"),
        bulk_truncate=_bulk_env("HVD_TPU_FAULT_BULK_TRUNCATE"),
        on_attempt=_int_env("HVD_TPU_FAULT_ON_ATTEMPT") or 0,
    )


_plan: FaultPlan | None = None
_bulk_sends = 0


def plan() -> FaultPlan:
    """The active plan (env-derived unless :func:`install` overrode it)."""
    global _plan
    if _plan is None:
        _plan = _plan_from_env()
    return _plan


def install(**kwargs) -> FaultPlan:
    """Programmatic installation (tests) — replaces the env plan."""
    global _plan, _bulk_sends
    _plan = FaultPlan(**kwargs)
    _bulk_sends = 0
    return _plan


def clear() -> None:
    """Drop any installed/cached plan; env is re-read on next use."""
    global _plan, _bulk_sends
    _plan = None
    _bulk_sends = 0


def _attempt() -> int:
    """The launcher's restart attempt counter (0 outside supervision)."""
    return _int_env("HVD_TPU_RESTART_ATTEMPT") or 0


def _rank(explicit: int | None) -> int:
    if explicit is not None:
        return explicit
    from horovod_tpu_torch import basics

    if basics.is_initialized():
        return basics.rank()
    for name in ("RANK", "JAX_PROCESS_ID"):
        value = _int_env(name)
        if value is not None:
            return value
    return 0


def armed() -> bool:
    """True when any injector could fire for this process's attempt."""
    p = plan()
    return p.any_active() and _attempt() == p.on_attempt


def on_bulk_send(rank: int | None = None) -> str | None:
    """Data-plane hook, called by dataplane.send once per outgoing bulk
    stream.  Returns the fault to apply to THIS send — ``"drop"``,
    ``"corrupt"``, ``"truncate"`` — or None.  The send counter advances
    whether or not a fault fires, so ``"<rank>:<nth>"`` plans hit exactly
    the nth stream this process originates."""
    global _bulk_sends
    p = plan()
    n = _bulk_sends
    _bulk_sends += 1
    if _attempt() != p.on_attempt:
        return None
    r = _rank(rank)
    for kind, cfg in (("drop", p.bulk_drop), ("corrupt", p.bulk_corrupt),
                      ("truncate", p.bulk_truncate)):
        if cfg is not None and cfg[0] == r and cfg[1] == n:
            sys.stderr.write(
                f"horovod_tpu_torch.faults: bulk-{kind} on rank {r} send "
                f"#{n} (injected)\n")
            sys.stderr.flush()
            return kind
    return None
