"""In-place elastic membership — counterpart of ``horovod_tpu/elastic.py``:
the native engine re-forms under a new membership without a restart.

With ``HVD_TPU_ELASTIC=1`` the control plane shrinks to survive a lost
rank and grows to admit a new one:

* the coordinator broadcasts a ``RECONFIG`` frame carrying the new
  membership epoch: new size, contiguous re-assigned ranks, the failed
  rank's identity (``core/src/controller.cc``);
* every member fails only its in-flight collectives, flushes its
  response-cache replica and verifier hashes, and publishes a structured
  resize event — the engine stops but the PROCESS lives (the next
  ``enqueue`` / ``synchronize`` raises :class:`MembershipChanged`);
* :func:`reconfigure` acknowledges the event, re-forms the native engine
  under the new ``{epoch, rank, size}`` on the same coordinator port;
* every later wire frame is stamped with the new epoch, so a straggler
  from the old membership is rejected (``stale_epoch``).

The grow path: a new process calls :func:`join` — a ``JOIN`` /
``JOIN_ACK`` handshake against the coordinator's listen socket — and is
admitted at the next reconfiguration boundary with a fresh rank, as a
serving fleet's joiner is.  Coordinator death promotes a pre-announced
standby (``HVD_TPU_COORD_FILE`` publishes the new endpoint), as in the
JAX package.  Reconfiguration is bounded by
``HVD_TPU_RECONFIG_TIMEOUT_MS``: an unacknowledged resize, or a
re-rendezvous that cannot complete, falls back to the restartable exit,
so nothing blocks forever.

:func:`reconfigure` also republishes ``rank()``/``size()`` through
``basics._apply_resize`` and fires every :func:`on_reconfigure` callback
(data re-sharding and LR re-scaling hooks); :func:`resize_event` reports
the newest change.  The engine re-forms; a ``torch.distributed`` process
group cannot, so in-place elastic mode serves engine-only processes (the
serving fleet, ``training.elastic_loop`` over the engine's collectives),
and a job on process groups (NCCL, gloo) keeps the launcher's full
restart from its newest checkpoint.
"""

from __future__ import annotations

import dataclasses
import os
import socket
import struct
import threading
import time
import zlib
from typing import Callable, NamedTuple

from horovod_tpu_torch.core import engine as _engine_mod
from horovod_tpu_torch.utils import env

# Re-exported for callers that catch the elastic signal directly.
MembershipChanged = _engine_mod.MembershipChanged

_FRAME_MAGIC = 0x48564446
_WIRE_VERSION = 1
_FRAME_JOIN = 8
_FRAME_JOIN_ACK = 9


@dataclasses.dataclass(frozen=True)
class ResizeEvent:
    """One applied membership change — what :func:`reconfigure` returns
    and what :func:`on_reconfigure` callbacks receive."""

    epoch: int
    old_rank: int
    new_rank: int
    old_size: int
    new_size: int
    failed_rank: int  # -1 for a grow (a relaunched rank rejoined)
    cause: str
    # Coordinator succession (failed_rank == 0): where the promoted standby
    # listens.  Empty/0 for ordinary shrinks and grows — the coordinator
    # did not move.
    new_coord_host: str = ""
    new_coord_port: int = 0

    @property
    def grew(self) -> bool:
        return self.new_size > self.old_size

    @property
    def coordinator_moved(self) -> bool:
        """True when this event is a coordinator failover: a standby was
        promoted and survivors must re-rendezvous at a new endpoint."""
        return self.new_coord_port > 0


class JoinTicket(NamedTuple):
    """Admission verdict from :func:`join`: the membership the joining
    process will rendezvous into."""

    epoch: int
    new_size: int
    assigned_rank: int


def enabled() -> bool:
    """True when in-place elastic recovery is on (``HVD_TPU_ELASTIC=1``)."""
    return env.elastic_enabled()


_callbacks: list[Callable[[ResizeEvent], None]] = []
_last_event: ResizeEvent | None = None


def on_reconfigure(callback: Callable[[ResizeEvent], None]):
    """Register ``callback(event)`` to run after every successful
    :func:`reconfigure` — the hook for re-sharding data and re-scaling the
    learning rate to the new ``size()``.  Usable as a decorator; returns
    the callback."""
    _callbacks.append(callback)
    return callback


def resize_event() -> ResizeEvent | None:
    """The most recent membership change: a pending (un-acked) event
    published by a stopped engine takes precedence, else the last event
    applied by :func:`reconfigure`, else ``None`` while the membership has
    been stable."""
    raw = _engine_mod.resize_event()
    if raw is not None:
        return ResizeEvent(**raw)
    return _last_event


def attach(eng) -> None:
    """Register an explicitly-constructed :class:`NativeEngine` as the
    process's active engine so :func:`reconfigure` can find and re-form
    it.  Engines started by ``core.engine.get_engine`` are registered
    already."""
    _engine_mod.replace_engine(None, eng)


def reconfigure(eng=None) -> ResizeEvent:
    """Apply a pending membership change in place: acknowledge the stopped
    engine's resize event, tear the old engine down, and re-form it under
    the new ``{epoch, rank, size}`` on the same coordinator port — all in
    this same process (no exit, no relaunch).

    Raises :class:`RuntimeError` when no resize event is pending, and
    :class:`MembershipChanged` when this rank was expelled (its new rank is
    -1 — the engine's restartable exit is already scheduled).  The
    re-rendezvous is bounded by ``HVD_TPU_RECONFIG_TIMEOUT_MS``; on expiry
    the underlying connect error propagates and the supervisor's
    full-restart path takes over.

    Returns the applied :class:`ResizeEvent` after firing every
    :func:`on_reconfigure` callback."""
    global _last_event
    if eng is None:
        eng = _engine_mod.peek_engine()
    if eng is None:
        raise RuntimeError(
            "no engine is running; elastic.reconfigure() applies a resize "
            "event published by a stopped engine (NativeEngine.resize_event())")
    raw = eng.resize_event()
    if raw is None:
        raise RuntimeError("no membership change is pending on this engine")
    ev = ResizeEvent(**raw)
    if ev.new_rank < 0:
        raise MembershipChanged(
            f"this rank was removed from the job at epoch {ev.epoch} "
            f"({ev.cause}); it exits restartably and may rejoin with "
            f"join()")
    # Stand the native reconfig-timeout fallback down FIRST: from here on
    # this process owns the recovery.
    eng.resize_ack()
    # Absorb any checkpoint shards still sitting in the native inbox into
    # the process-global host-memory store NOW — the inbox dies with the
    # old engine, and a survivor may need the dead rank's replica for the
    # disk-free restore that follows this reconfiguration.
    from horovod_tpu_torch import replication as _replication

    _replication.drain(eng)
    ctor = dict(eng._ctor)
    if ev.new_rank == 0:
        # The coordinator re-binds its previous effective port (it may have
        # been chosen ephemerally at first start); workers re-connect to
        # the same well-known address they always used.  Only the LISTEN
        # socket is released now: the old engine's peer sockets must stay
        # open through the re-rendezvous, or a survivor that has not yet
        # read the RECONFIG broadcast gets RST and its receive queue —
        # verdict included — is flushed (it would misread the shrink as
        # coordinator death).  Under a coordinator failover this rank is
        # the promoted standby: its ``bound_port`` is the standby listen
        # socket it pre-bound at HELLO time (== ``ev.new_coord_port``), and
        # detach_listener() releases that socket so MakeCoordinator can
        # re-bind the very port the other survivors are already dialing.
        ctor["coordinator_port"] = ev.new_coord_port or eng.bound_port
        eng.detach_listener()
    else:
        if ev.coordinator_moved:
            # Coordinator succession: re-rendezvous at the promoted
            # standby's pre-announced endpoint, not the dead rank 0's.
            ctor["coordinator_host"] = ev.new_coord_host or ctor.get(
                "coordinator_host", "127.0.0.1")
            ctor["coordinator_port"] = ev.new_coord_port
        eng.shutdown()
    # The verifier's rolling hash restarts with the new membership (the
    # native coordinator's streams are rebuilt from scratch).
    from horovod_tpu_torch.analysis import schedule as _schedule

    _schedule.recorder().reset()
    # A tree job re-forms as a STAR (docs/fault_tolerance.md): the shrunk
    # membership invalidates the launcher-placed aggregator layout (group
    # assignment is a function of the old size), and the relays are
    # sidecars with no membership protocol of their own.  Every survivor
    # computes this identically — the topology is a pure function of the
    # knobs, and the knobs now say star.  Permanent for this process, so
    # later reconfigurations stay star too.
    if os.environ.get("HVD_TPU_TREE_ENABLE") \
            or os.environ.get("HOROVOD_TREE_ENABLE"):
        os.environ["HVD_TPU_TREE_ENABLE"] = "0"
        os.environ.pop("HOROVOD_TREE_ENABLE", None)
        os.environ.pop("HVD_TPU_TREE_AGG_MAP", None)
    # Bound the re-rendezvous by the reconfiguration budget, not the
    # generous first-boot connect budget: survivors are already running, so
    # a peer that cannot re-form in time means the membership changed again
    # — fall back to the full-restart path quickly.
    prev_budget = os.environ.get("HVD_TPU_CONNECT_TIMEOUT")
    os.environ["HVD_TPU_CONNECT_TIMEOUT"] = str(
        max(env.reconfig_timeout_ms() / 1000.0, 1.0))
    try:
        new_eng = _engine_mod.NativeEngine(
            ev.new_rank, ev.new_size, epoch=ev.epoch, **ctor)
    except Exception as exc:
        # The re-rendezvous failed (a split-brain loser dialing a standby
        # that never promoted, a membership that changed again mid-form,
        # an expired reconfig budget): this process cannot recover in
        # place, so it takes the same road as an expelled rank — a
        # MembershipChanged the caller can log, with the restartable exit
        # already scheduled behind it so the launcher's full-restart
        # supervision relaunches us instead of seeing a generic crash.
        _schedule_restartable_exit()
        raise MembershipChanged(
            f"in-place reconfiguration to epoch {ev.epoch} "
            f"(rank {ev.new_rank}/{ev.new_size}) failed: {exc}; falling "
            f"back to the restartable full-restart path") from exc
    finally:
        if prev_budget is None:
            os.environ.pop("HVD_TPU_CONNECT_TIMEOUT", None)
        else:
            os.environ["HVD_TPU_CONNECT_TIMEOUT"] = prev_budget
        if ev.new_rank == 0:
            # Every survivor is wired into the new membership (or the
            # rendezvous failed and this process is going down): the old
            # engine and its absorbed peer sockets can finally go.
            eng.shutdown()
    _engine_mod.replace_engine(eng, new_eng)
    from horovod_tpu_torch import basics as _basics

    _basics._apply_resize(ev.new_rank, ev.new_size)
    # Peer-replicated checkpoint shards held in host memory stay valid
    # across a reconfiguration THIS process participated in: re-stamp them
    # to the new epoch so a disk-free restore can still use them.  A
    # straggler that missed the reconfig never gets here, so its stale
    # stamps are invisible to the shard-set election (replication.elect)
    # and it restores from disk.
    from horovod_tpu_torch import replication as _replication

    _replication.bump_epoch(ev.epoch)
    # Re-shard under the new membership: each survivor re-ships its held
    # shards of the newest step to its NEW ring partner, restoring the
    # two-holders-per-shard redundancy the departed rank may have broken.
    # Best effort — a failed ship leaves disk as the last resort, and a
    # failure here must never turn a successful reconfiguration into a
    # crash.
    if _replication.enabled():
        try:
            _replication.reshard(new_eng)
        except Exception:
            pass
    if ev.new_rank == 0:
        # The (possibly newly promoted) coordinator republishes its
        # endpoint so late joiners and the launcher's single-rank relaunch
        # can find the job even after a succession moved rank 0.
        _publish_coordinator(
            ev.new_coord_host
            or ctor.get("coordinator_host")
            or os.environ.get("HVD_TPU_COORDINATOR_HOST", "127.0.0.1"),
            new_eng.bound_port or ev.new_coord_port, ev.epoch)
    _last_event = ev
    for cb in _callbacks:
        cb(ev)
    return ev


def _schedule_restartable_exit() -> None:
    """Mirror the native plane's abort-grace contract for failures that
    happen BETWEEN engines (the old plane is torn down, the new one never
    formed — nothing native is left to schedule the exit): give the caller
    ``HVD_TPU_ABORT_GRACE_MS`` to log its structured report, then take the
    restartable exit so supervision relaunches this rank.  Negative grace
    keeps the native report-only semantics (never exit)."""
    grace_ms = env.abort_grace_ms()
    if grace_ms < 0:
        return

    def _die():
        time.sleep(grace_ms / 1000.0)
        os._exit(env.stall_abort_exit_code())

    threading.Thread(target=_die, name="hvd-restartable-exit",
                     daemon=True).start()


def _publish_coordinator(host: str, port: int, epoch: int) -> None:
    """Atomically record the active coordinator endpoint in
    ``HVD_TPU_COORD_FILE`` (no-op when the env var is unset).  Written by
    whichever rank currently holds rank 0 — at first rendezvous by the
    launcher, and again by the promoted standby after a failover."""
    path = os.environ.get("HVD_TPU_COORD_FILE")
    if not path or port <= 0:
        return
    try:
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            f.write(f"{host} {port} {epoch}\n")
        os.replace(tmp, path)
    except OSError:
        pass  # best-effort: the env-var endpoint still works pre-failover


def _read_coord_file() -> tuple[str, int] | None:
    """``(host, port)`` from ``HVD_TPU_COORD_FILE``, or ``None`` when the
    env var is unset or the file is absent/unparseable."""
    path = os.environ.get("HVD_TPU_COORD_FILE")
    if not path:
        return None
    try:
        with open(path) as f:
            parts = f.read().split()
        if len(parts) >= 2 and int(parts[1]) > 0:
            return parts[0], int(parts[1])
    except (OSError, ValueError):
        pass
    return None


def coordinator_endpoint(
        default_host: str = "127.0.0.1",
        default_port: int = 0) -> tuple[str, int]:
    """The job's current coordinator endpoint: ``HVD_TPU_COORD_FILE``
    (kept current across coordinator failovers) when set and readable,
    else ``HVD_TPU_COORDINATOR_HOST``/``HVD_TPU_COORDINATOR_PORT``, else
    the supplied defaults.  :func:`join` re-reads this every retry, so a
    rejoin that races a succession converges on the new coordinator."""
    published = _read_coord_file()
    if published is not None:
        return published
    host = os.environ.get("HVD_TPU_COORDINATOR_HOST", default_host)
    try:
        port = int(os.environ.get("HVD_TPU_COORDINATOR_PORT", "") or
                   default_port)
    except ValueError:
        port = default_port
    return host, port


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise OSError("connection closed mid-frame")
        buf += chunk
    return buf


def join(host: str, port: int, *, old_rank: int = -1,
         timeout_s: float | None = None) -> JoinTicket:
    """Join a running elastic job: the new process's side of the
    ``JOIN``/``JOIN_ACK`` handshake (a serving replica started with
    ``HVD_TPU_ELASTIC_JOIN=1`` calls it).  Knocks on the coordinator's
    control-plane listen socket with a hardened JOIN frame and retries — through shrink re-rendezvous windows
    where the socket is down or busy — until the coordinator's monitor
    thread admits it at the next reconfiguration boundary.

    Returns the :class:`JoinTicket` naming the epoch, size, and rank to
    rendezvous with; create the engine from it.  Bounded by ``timeout_s``
    (default: the rendezvous budget, ``HVD_TPU_CONNECT_TIMEOUT``).

    When ``HVD_TPU_COORD_FILE`` is set, each retry re-reads the published
    endpoint, so a joiner that raced a coordinator failover converges on
    the promoted standby instead of knocking forever on the dead rank 0's
    port."""
    # Joining implies the membership reconfigured, and reconfiguration
    # always re-forms the control plane as a star (see reconfigure()):
    # drop any inherited tree knobs so the joiner's engine matches the
    # survivors' topology.
    if os.environ.get("HVD_TPU_TREE_ENABLE") \
            or os.environ.get("HOROVOD_TREE_ENABLE"):
        os.environ["HVD_TPU_TREE_ENABLE"] = "0"
        os.environ.pop("HOROVOD_TREE_ENABLE", None)
        os.environ.pop("HVD_TPU_TREE_AGG_MAP", None)
    # The native monitor's PollJoinRequest() hands the knocker's id to a
    # caller that treats negatives as "no join pending" — a -1 payload
    # would park this connection unserviced and wedge every later joiner.
    # Joiners with no prior seat (autoscaled replicas) knock as rank 0.
    old_rank = max(0, old_rank)
    budget = timeout_s
    if budget is None:
        budget = float(os.environ.get("HVD_TPU_CONNECT_TIMEOUT", "300") or 300)
    deadline = time.monotonic() + budget
    delay = 0.05
    last_err: Exception | None = None
    while time.monotonic() < deadline:
        published = _read_coord_file()
        dial = published if published is not None else (host, port)
        sock = None
        try:
            sock = socket.create_connection(dial, timeout=2.0)
            payload = struct.pack("<i", old_rank)
            sock.sendall(struct.pack(
                "<IBBHII", _FRAME_MAGIC, _WIRE_VERSION, _FRAME_JOIN, 0,
                len(payload), zlib.crc32(payload)) + payload)
            sock.settimeout(5.0)
            hdr = _recv_exact(sock, 16)
            magic, _ver, ftype, _flags, plen, crc = struct.unpack(
                "<IBBHII", hdr)
            if magic != _FRAME_MAGIC or ftype != _FRAME_JOIN_ACK:
                raise OSError(f"unexpected frame type {ftype} awaiting "
                              f"JOIN_ACK")
            body = _recv_exact(sock, plen)
            if zlib.crc32(body) != crc:
                raise OSError("JOIN_ACK CRC mismatch")
            epoch, new_size, assigned = struct.unpack_from("<qii", body)
            return JoinTicket(epoch, new_size, assigned)
        except OSError as exc:
            last_err = exc
            time.sleep(min(delay, max(deadline - time.monotonic(), 0)))
            delay = min(delay * 2, 1.0)
        finally:
            if sock is not None:
                sock.close()
    published = _read_coord_file()
    dial = published if published is not None else (host, port)
    raise TimeoutError(
        f"could not rejoin the job at {dial[0]}:{dial[1]} within "
        f"{budget:.0f}s (last error: {last_err}); is the coordinator "
        f"running with HVD_TPU_ELASTIC=1?")
