"""Deterministic fault injection — counterpart of
``horovod_tpu/faults.py``, with the same env names, messages and gating.

Every robustness claim of the elastic and checkpoint paths is exercised
by killing a specific rank at a specific step, stalling a rank, delaying
its participation, or damaging a checkpoint on its way to disk — all
driven by environment variables so a scenario replays identically.

Injectors (all opt-in; absent env == no faults):

* ``HVD_TPU_FAULT_KILL_RANK`` / ``HVD_TPU_FAULT_KILL_STEP`` — when the
  named rank reaches the step, it dies by signal
  (``HVD_TPU_FAULT_KILL_SIGNAL``, default SIGKILL) — the preemption
  stand-in.
* ``HVD_TPU_FAULT_STALL_RANK`` / ``HVD_TPU_FAULT_STALL_STEP`` — the rank
  stops participating forever; drives the coordinator's stall warn ->
  abort escalation.
* ``HVD_TPU_FAULT_DELAY_RANK`` / ``HVD_TPU_FAULT_DELAY_STEP`` /
  ``HVD_TPU_FAULT_DELAY_MS`` — one bounded delay (default 500 ms), the
  slow-worker case.
* ``HVD_TPU_FAULT_CORRUPT_STEP`` — after checkpoint ``step`` commits,
  rank 0 overwrites part of its payload with garbage; restore must fall
  back to the previous complete step.
* ``HVD_TPU_FAULT_PERSIST_KILL_STEP`` — rank 0 dies (SIGKILL) during the
  persist of checkpoint ``step``: after the payload is durable but before
  the ``_COMMIT`` manifest exists.  The step must stay invisible.
* ``HVD_TPU_FAULT_TORN_MANIFEST_STEP`` — the commit of checkpoint
  ``step`` leaves a TORN ``_COMMIT`` (half the JSON); readers must treat
  the step as incomplete (``utils/manifest.py`` parses, not stats).
* ``HVD_TPU_FAULT_ENOSPC_STEP`` — the commit of checkpoint ``step``
  raises ``ENOSPC``; the persist path surfaces the error without
  crashing training, and the step stays invisible.
* ``HVD_TPU_FAULT_SLOW_DISK_MS`` — every commit gains this much latency,
  the slow-disk case the async persist thread exists to hide.
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
* ``HVD_TPU_FAULT_DRAIN_HOLD_RANK`` / ``HVD_TPU_FAULT_DRAIN_HOLD_MS`` —
  the port's own: a serving replica of that rank holds for the given
  time (default 5000 ms) between the fleet's drain rendezvous and its
  exit, the widest window for a join to land in a finished fleet
  (``serving/__main__.py``).
* ``HVD_TPU_FAULT_POLL_HOLD_RANK`` / ``HVD_TPU_FAULT_POLL_HOLD_MS`` — the
  port's own: a serving replica of that rank, the first time it reads
  whether the fleet's drain completed after announcing its own, first
  holds for the given time (default 200 ms) while its engine's executor
  runs on: a serving thread that wakes late, and so sees the drain
  complete behind a tick that its peers looked past before it completed.
* ``HVD_TPU_FAULT_ON_ATTEMPT`` (default 0) — faults fire only when the
  launcher-exported ``HVD_TPU_RESTART_ATTEMPT`` matches, so an injected
  crash consumes exactly one restart and the relaunched job runs clean.

Hooks: training loops call :func:`step` once per step (wired through
``training.elastic_loop`` and ``callbacks.PreemptionCheckpointCallback``);
``checkpoint.CheckpointManager`` calls :func:`on_checkpoint_persist`
right before each ``_COMMIT`` write and :func:`on_checkpoint_committed`
right after.  Tests may bypass env parsing with :func:`install`.

Standard library only: the injectors work in processes that never touch
a device (engine-only workers, the launcher's children before ``init``).
"""

from __future__ import annotations

import dataclasses
import os
import signal
import sys
import time


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Parsed injector configuration (None field == injector disabled).

    The ``wire_*`` injectors are ``(rank, frame, epoch)`` tuples executed
    by the native control plane (core/src/controller.cc reads the same
    env); they appear here so ``armed()``/tooling see the whole plan.
    ``epoch`` keys the plan to one membership epoch (elastic resize bumps
    the epoch, disarming epoch-0 plans after a shrink).
    """

    kill_rank: int | None = None
    kill_step: int | None = None
    kill_signal: int = signal.SIGKILL
    stall_rank: int | None = None
    stall_step: int | None = None
    delay_rank: int | None = None
    delay_step: int | None = None
    delay_ms: float = 500.0
    corrupt_step: int | None = None
    persist_kill_step: int | None = None
    torn_manifest_step: int | None = None
    enospc_step: int | None = None
    slow_disk_ms: float | None = None
    wire_drop: tuple[int, int, int] | None = None
    wire_corrupt: tuple[int, int, int] | None = None
    wire_partition: tuple[int, int, int] | None = None
    wire_halfclose: tuple[int, int, int] | None = None
    bulk_drop: tuple[int, int] | None = None
    bulk_corrupt: tuple[int, int] | None = None
    bulk_truncate: tuple[int, int] | None = None
    drain_hold_rank: int | None = None
    drain_hold_ms: float = 5000.0
    poll_hold_rank: int | None = None
    poll_hold_ms: float = 200.0
    on_attempt: int = 0

    def any_active(self) -> bool:
        return any(v is not None for v in (
            self.kill_rank, self.stall_rank, self.delay_rank,
            self.corrupt_step, self.persist_kill_step,
            self.torn_manifest_step, self.enospc_step, self.slow_disk_ms,
            self.wire_drop, self.wire_corrupt,
            self.wire_partition, self.wire_halfclose,
            self.bulk_drop, self.bulk_corrupt, self.bulk_truncate,
            self.drain_hold_rank, self.poll_hold_rank))


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
    sig_raw = os.environ.get("HVD_TPU_FAULT_KILL_SIGNAL", "KILL")
    sig = getattr(signal, f"SIG{sig_raw}", None) if not sig_raw.isdigit() \
        else int(sig_raw)
    if sig is None:
        raise ValueError(f"unknown HVD_TPU_FAULT_KILL_SIGNAL={sig_raw}")
    return FaultPlan(
        kill_rank=_int_env("HVD_TPU_FAULT_KILL_RANK"),
        kill_step=_int_env("HVD_TPU_FAULT_KILL_STEP"),
        kill_signal=int(sig),
        stall_rank=_int_env("HVD_TPU_FAULT_STALL_RANK"),
        stall_step=_int_env("HVD_TPU_FAULT_STALL_STEP"),
        delay_rank=_int_env("HVD_TPU_FAULT_DELAY_RANK"),
        delay_step=_int_env("HVD_TPU_FAULT_DELAY_STEP"),
        delay_ms=float(os.environ.get("HVD_TPU_FAULT_DELAY_MS", "500")),
        corrupt_step=_int_env("HVD_TPU_FAULT_CORRUPT_STEP"),
        persist_kill_step=_int_env("HVD_TPU_FAULT_PERSIST_KILL_STEP"),
        torn_manifest_step=_int_env("HVD_TPU_FAULT_TORN_MANIFEST_STEP"),
        enospc_step=_int_env("HVD_TPU_FAULT_ENOSPC_STEP"),
        slow_disk_ms=(
            None if os.environ.get("HVD_TPU_FAULT_SLOW_DISK_MS") in (None, "")
            else float(os.environ["HVD_TPU_FAULT_SLOW_DISK_MS"])),
        wire_drop=_wire_env("HVD_TPU_FAULT_WIRE_DROP"),
        wire_corrupt=_wire_env("HVD_TPU_FAULT_WIRE_CORRUPT"),
        wire_partition=_wire_env("HVD_TPU_FAULT_WIRE_PARTITION"),
        wire_halfclose=_wire_env("HVD_TPU_FAULT_WIRE_HALFCLOSE"),
        bulk_drop=_bulk_env("HVD_TPU_FAULT_BULK_DROP"),
        bulk_corrupt=_bulk_env("HVD_TPU_FAULT_BULK_CORRUPT"),
        bulk_truncate=_bulk_env("HVD_TPU_FAULT_BULK_TRUNCATE"),
        drain_hold_rank=_int_env("HVD_TPU_FAULT_DRAIN_HOLD_RANK"),
        drain_hold_ms=float(os.environ.get("HVD_TPU_FAULT_DRAIN_HOLD_MS",
                                           "5000")),
        poll_hold_rank=_int_env("HVD_TPU_FAULT_POLL_HOLD_RANK"),
        poll_hold_ms=float(os.environ.get("HVD_TPU_FAULT_POLL_HOLD_MS",
                                          "200")),
        on_attempt=_int_env("HVD_TPU_FAULT_ON_ATTEMPT") or 0,
    )


_plan: FaultPlan | None = None
_delay_fired = False
_poll_held = False
_bulk_sends = 0


def plan() -> FaultPlan:
    """The active plan (env-derived unless :func:`install` overrode it)."""
    global _plan
    if _plan is None:
        _plan = _plan_from_env()
    return _plan


def install(**kwargs) -> FaultPlan:
    """Programmatic installation (tests) — replaces the env plan."""
    global _plan, _delay_fired, _bulk_sends
    _plan = FaultPlan(**kwargs)
    _delay_fired = False
    _bulk_sends = 0
    return _plan


def clear() -> None:
    """Drop any installed/cached plan; env is re-read on next use."""
    global _plan, _delay_fired, _bulk_sends
    _plan = None
    _delay_fired = False
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


def step(step_num: int, rank: int | None = None) -> None:
    """Per-training-step hook: fire any step-indexed injector that matches.

    Cheap when disarmed (one dataclass read, no syscalls); call it from
    every training loop that wants to be fault-testable.
    """
    global _delay_fired
    p = plan()
    if not p.any_active() or _attempt() != p.on_attempt:
        return
    r = _rank(rank)
    if p.delay_rank == r and p.delay_step == step_num and not _delay_fired:
        _delay_fired = True
        time.sleep(p.delay_ms / 1000.0)
    if p.stall_rank == r and p.stall_step is not None \
            and step_num >= p.stall_step:
        sys.stderr.write(
            f"horovod_tpu_torch.faults: rank {r} stalling at step {step_num} "
            f"(injected)\n")
        sys.stderr.flush()
        while True:  # hold the rank hostage: the stall escalation or the
            time.sleep(0.25)  # supervisor must reap us, never this loop
    if p.kill_rank == r and p.kill_step == step_num:
        sys.stderr.write(
            f"horovod_tpu_torch.faults: killing rank {r} at step {step_num} "
            f"with signal {p.kill_signal} (injected)\n")
        sys.stderr.flush()
        sys.stdout.flush()
        os.kill(os.getpid(), p.kill_signal)
        time.sleep(60)  # SIGKILL needs no help; catchable signals get a
        os._exit(128 + p.kill_signal)  # bounded grace, then hard exit


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
                f"horovod_tpu_torch.faults: bulk-{kind} on rank {r} send #{n} "
                f"(injected)\n")
            sys.stderr.flush()
            return kind
    return None


def on_checkpoint_persist(path: str, step_num: int,
                          rank: int | None = None) -> bool:
    """Persist-path hook, called right before ``_COMMIT`` is written
    (payload already durable).  Returns True when the injector wrote a
    (torn) manifest itself and the caller must NOT write the real one.

    Order matters: slow disk delays every commit; ENOSPC raises (the
    persist thread must surface it without crashing training); a torn
    manifest hijacks the write; a persist-kill dies in the widest crash
    window the async split opens — payload durable, no ``_COMMIT``.
    """
    p = plan()
    if _attempt() != p.on_attempt or _rank(rank) != 0:
        return False
    if p.slow_disk_ms is not None:
        time.sleep(p.slow_disk_ms / 1000.0)
    if p.enospc_step == step_num:
        import errno
        raise OSError(errno.ENOSPC, "No space left on device (injected)")
    if p.torn_manifest_step == step_num:
        with open(os.path.join(path, "_COMMIT"), "w") as f:
            f.write('{"step": ')  # half the JSON: mid-write tear
        sys.stderr.write(
            f"horovod_tpu_torch.faults: tore _COMMIT of step {step_num} "
            f"(injected)\n")
        sys.stderr.flush()
        return True
    if p.persist_kill_step == step_num:
        sys.stderr.write(
            f"horovod_tpu_torch.faults: killing rank 0 mid-persist of step "
            f"{step_num} (payload durable, no _COMMIT; injected)\n")
        sys.stderr.flush()
        sys.stdout.flush()
        os.kill(os.getpid(), signal.SIGKILL)
        time.sleep(60)
        os._exit(137)
    return False


def on_checkpoint_committed(path: str, step_num: int,
                            rank: int | None = None) -> None:
    """Post-commit hook: corrupt the payload of checkpoint ``step_num``.

    Overwrites the head of the largest payload file under ``path`` with
    garbage AFTER the commit manifest exists — the nastiest case, where
    completeness metadata says "good" but the bytes are not, so restore's
    fall-back-on-deserialize-failure path is what saves the job.
    """
    p = plan()
    if p.corrupt_step != step_num or _attempt() != p.on_attempt:
        return
    if _rank(rank) != 0:
        return
    victim, vsize = None, -1
    for root, _dirs, files in os.walk(path):
        for f in files:
            fp = os.path.join(root, f)
            try:
                size = os.path.getsize(fp)
            except OSError:
                continue
            if size > vsize and not f.startswith("_COMMIT"):
                victim, vsize = fp, size
    if victim is None:
        return
    with open(victim, "r+b") as f:
        f.write(b"\xde\xad\xbe\xef" * max(1, min(vsize, 4096) // 4))
    sys.stderr.write(
        f"horovod_tpu_torch.faults: corrupted checkpoint payload {victim} "
        f"(step {step_num}, injected)\n")
    sys.stderr.flush()


def on_drained_poll(rank: int | None = None) -> None:
    """Serving-fleet hook, called before a replica that announced its
    drain reads whether it completed: the first time, hold the named rank
    there for ``poll_hold_ms`` (``HVD_TPU_FAULT_POLL_HOLD_*``)."""
    global _poll_held
    p = plan()
    if p.poll_hold_rank is None or _attempt() != p.on_attempt \
            or _poll_held or _rank(rank) != p.poll_hold_rank:
        return
    _poll_held = True
    time.sleep(p.poll_hold_ms / 1000.0)


def on_drain(rank: int | None = None) -> None:
    """Serving-fleet hook, called once a replica's drain rendezvous has
    completed and before it leaves the fleet: hold the named rank there
    for ``drain_hold_ms`` (``HVD_TPU_FAULT_DRAIN_HOLD_*``)."""
    p = plan()
    if p.drain_hold_rank is None or _attempt() != p.on_attempt:
        return
    r = _rank(rank)
    if r != p.drain_hold_rank:
        return
    sys.stderr.write(
        f"horovod_tpu_torch.faults: holding rank {r} after the drain for "
        f"{p.drain_hold_ms:g} ms (injected)\n")
    sys.stderr.flush()
    time.sleep(p.drain_hold_ms / 1000.0)
