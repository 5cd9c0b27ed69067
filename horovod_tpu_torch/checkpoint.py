"""Checkpoint / resume — counterpart of ``horovod_tpu/checkpoint.py``: the
reference's distributed contract over ``torch.save`` of host copies.

The reference delegates checkpoint IO to the framework and enforces the
*distributed contract*: (a) only rank 0 writes; (b) on resume, state is
re-broadcast from rank 0 so every worker resumes identically.

Storage: ``save(path, state)`` writes ``state`` — a tree (dicts, lists,
tuples) of tensors, numpy arrays and Python scalars, e.g. a model's and an
optimizer's ``state_dict`` — as ``path/state.pt`` by ``torch.save`` of
host copies, staged in a temporary directory beside ``path``, fsynced,
then renamed into place, so ``path`` is either absent or complete.
``restore`` reads it back on the CPU and puts each tensor on
``map_location``, or, given a ``template`` tree, on the device of the
template's tensor at the same place.  The JAX package stores through
orbax instead; the two formats are not interchangeable, but the
manifest beside them (``utils/manifest.py``) is the same.

The JAX package's optimizer-state tuples (``DistributedState``,
``DistributedEFState``, ``MasterWeightsState``) are optax idiom; here the
same state is the ``state_dict()`` of ``DistributedOptimizer`` (its
``"error_feedback"`` entry is the int8 wire's residuals) and of
``master_weights`` (its ``"master"`` entry), saved like any other tree.
A checkpoint saved under another compression mode than the optimizer
restoring it loads through ``DistributedOptimizer.load_state_dict``,
which zero-starts or drops the residuals with a warning, as the JAX
package's ``_adapt_compression_state`` does.
"""

from __future__ import annotations

import atexit
import os
import shutil
import signal as _signal
import tempfile
import threading
import time
import warnings
from typing import Any, NamedTuple

import numpy as np
import torch

from horovod_tpu_torch import basics, faults, replication, training
from horovod_tpu_torch.utils import env, manifest

PAYLOAD_FILE = "state.pt"


def _multiprocess_env() -> bool:
    """The launcher's environment says this job spans processes, without
    :func:`basics.init` having run: a worker that forgot ``init`` must get
    the loud ``NotInitializedError``, not race as rank 0.  An explicit
    ``WORLD_SIZE`` or ``JAX_NUM_PROCESSES`` is authoritative (the launcher
    sets addresses even for ``-np 1``)."""
    for name in ("WORLD_SIZE", "JAX_NUM_PROCESSES"):
        nproc = os.environ.get(name)
        if nproc is not None:
            try:
                return int(nproc) > 1
            except ValueError:
                return True  # malformed value: be loud rather than race
    return bool(os.environ.get("JAX_COORDINATOR_ADDRESS")
                or os.environ.get("HVD_TPU_COORDINATOR_HOST"))


def _rank() -> int:
    """Rank, defaulting to 0 when ``init()`` was never called in a genuinely
    single-process program (inference, export); a multi-process job that
    forgot ``init()`` raises instead of letting every process write."""
    if basics.is_initialized() or _multiprocess_env():
        return basics.rank()  # raises NotInitializedError with direction
    return 0


def _size() -> int:
    if basics.is_initialized() or _multiprocess_env():
        return basics.size()
    return 1


# -- host copies --------------------------------------------------------------


def _tree_map(fn, tree):
    """``fn`` over every leaf; dicts, lists and plain tuples are
    structure (namedtuples are leaves, as in ``replication``)."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_map(fn, v) for v in tree]
    if isinstance(tree, tuple) and not hasattr(tree, "_fields"):
        return tuple(_tree_map(fn, v) for v in tree)
    return fn(tree)


_ALIGN = 64  # bytes: every tensor of a flat snapshot starts on a 64-B line


def _on_card(v) -> bool:
    return v.device.type == "cuda"


def _host_buffer(nbytes: int) -> torch.Tensor:
    """A flat host buffer for a snapshot, pinned where there is a card to
    copy from."""
    return torch.empty(nbytes, dtype=torch.uint8,
                       pin_memory=torch.cuda.is_available())


def _flat_layout(state) -> tuple[dict, dict]:
    """Where every CUDA tensor of ``state`` goes in the flat buffers of a
    snapshot, one buffer a dtype (``torch.save`` keeps the views of one
    storage in one dtype): ``{id: (dtype, byte offset)}`` in tree order,
    and each buffer's size."""
    offsets: dict = {}
    totals: dict = {}

    def leaf(v):
        if isinstance(v, torch.Tensor) and _on_card(v) \
                and id(v) not in offsets:
            total = totals.get(v.dtype, 0)
            offsets[id(v)] = (v.dtype, total)
            totals[v.dtype] = total + -(
                -v.numel() * v.element_size() // _ALIGN) * _ALIGN
        return v

    _tree_map(leaf, state)
    return offsets, totals


def host_snapshot(state: Any, alloc=None) -> Any:
    """A copy of ``state`` in host memory that the caller's later steps
    cannot touch: every tensor copied to the CPU, every numpy array
    copied, immutable scalars as they are.

    The CUDA tensors land in one pinned host buffer a dtype (each a view
    of it at a 64-byte aligned offset), so a snapshot costs an allocation
    or two and the copies run at the pinned rate; ``alloc(nbytes)``
    supplies those buffers (``uint8`` tensors of exactly ``nbytes``) when
    the caller reuses them, else fresh ones are allocated.  The copies
    are issued on each tensor's current stream, after the kernels that
    produced it (the optimizer step's), and this returns only once an
    event recorded after the last of them has completed: a reader of the
    snapshot can never see bytes of a copy still in flight."""
    offsets, totals = _flat_layout(state)
    flats = {dt: (alloc or _host_buffer)(n) for dt, n in totals.items()}
    views: dict = {}
    pending: set = set()

    def leaf(v):
        if isinstance(v, torch.Tensor):
            key = id(v)
            v = v.detach()
            if key in offsets:
                if key not in views:
                    dt, off = offsets[key]
                    n = v.numel() * v.element_size()
                    out = flats[dt][off:off + n].view(dt).view(v.shape)
                    out.copy_(v, non_blocking=True)
                    if v.device.type == "cuda":
                        pending.add(v.device)
                    views[key] = out
                return views[key]
            return v.clone()
        if isinstance(v, np.ndarray):
            return v.copy()
        return v

    snap = _tree_map(leaf, state)
    for dev in pending:
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(dev))
        done.synchronize()
    return snap


class _PinnedPool:
    """Flat pinned snapshot buffers kept for reuse: a buffer is taken for
    a snapshot and given back once that snapshot is persisted, so a steady
    run of saves allocates pinned memory only while the persist queue
    deepens."""

    KEEP = 2  # free buffers kept for the next saves

    def __init__(self):
        self._free: list[torch.Tensor] = []
        self._lock = threading.Lock()

    def take(self, nbytes: int) -> torch.Tensor:
        with self._lock:
            for i, buf in enumerate(self._free):
                if buf.numel() == nbytes:
                    return self._free.pop(i)
        return _host_buffer(nbytes)

    def give(self, buf: torch.Tensor) -> None:
        with self._lock:
            if len(self._free) < self.KEEP:
                self._free.append(buf)


def _place(raw: Any, template: Any, map_location) -> Any:
    """Put the tensors of a restored tree where they belong: on
    ``map_location`` when given, else on the device of the template's
    tensor at the same place (the CPU without a template)."""
    if map_location is not None or template is None:
        dev = torch.device(map_location) if map_location is not None \
            else None
        return _tree_map(lambda v: v.to(dev) if dev is not None
                         and isinstance(v, torch.Tensor) else v, raw)
    if isinstance(raw, dict) and isinstance(template, dict):
        return {k: _place(v, template.get(k), None) for k, v in raw.items()}
    if isinstance(raw, (list, tuple)) and isinstance(template, (list, tuple)) \
            and len(raw) == len(template):
        return type(raw)(_place(v, t, None) for v, t in zip(raw, template))
    if isinstance(raw, torch.Tensor) and isinstance(template, torch.Tensor):
        return raw.to(template.device)
    return raw


def _check_template(raw, template, path: str = "") -> None:
    """A template restore must find the template's structure: dict keys
    and sequence lengths equal.  Beside an optimizer ``state_dict``
    (``"state"`` and ``"param_groups"``) two differences are tolerated:
    the int8 wire's ``"error_feedback"``, which
    ``DistributedOptimizer.load_state_dict`` adapts, and a template
    ``"state"`` still empty (torch optimizers create their state at the
    first step)."""
    if isinstance(template, dict):
        if not isinstance(raw, dict):
            raise KeyError(f"checkpoint has a {type(raw).__name__} at "
                           f"{path or '/'} where the template has a dict")
        keys, want = set(raw), set(template)
        if {"state", "param_groups"} <= want:
            keys.discard("error_feedback")
            want.discard("error_feedback")
            if not template["state"]:
                keys.discard("state")
                want.discard("state")
        if keys != want:
            missing = sorted(want - keys, key=str)[:5]
            extra = sorted(keys - want, key=str)[:5]
            raise KeyError(f"checkpoint keys at {path or '/'} differ from "
                           f"the template's: missing {missing}, extra "
                           f"{extra}")
        for k in want:
            _check_template(raw[k], template[k], f"{path}/{k}")
    elif isinstance(template, (list, tuple)) \
            and not hasattr(template, "_fields"):
        if not isinstance(raw, (list, tuple)) or len(raw) != len(template):
            raise KeyError(f"checkpoint sequence at {path or '/'} does not "
                           f"match the template's length {len(template)}")
        for i, (r, t) in enumerate(zip(raw, template)):
            _check_template(r, t, f"{path}/{i}")


# -- save / restore -----------------------------------------------------------

_pending_lock = threading.Lock()
_pending: list[threading.Thread] = []


def wait_pending() -> None:
    """Block until every in-flight background :func:`save` has landed
    (no-op when nothing is pending).  Called at exit too, so a program
    that ends right after a background save cannot lose it."""
    while True:
        with _pending_lock:
            if not _pending:
                return
            t = _pending[0]
        t.join()
        with _pending_lock:
            if _pending and _pending[0] is t:
                _pending.pop(0)


register = getattr(threading, "_register_atexit", atexit.register)
register(wait_pending)
atexit.register(wait_pending)


def _write(path: str, snap: Any) -> None:
    """The durable write: ``torch.save`` into a temporary directory beside
    ``path``, fsync of the file and the directory, then a rename over
    ``path`` (an existing ``path`` goes first)."""
    parent = os.path.dirname(path) or "."
    os.makedirs(parent, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=parent, prefix=".save.")
    try:
        f = os.path.join(tmp, PAYLOAD_FILE)
        with open(f, "wb") as fh:
            torch.save(snap, fh)
            fh.flush()
            os.fsync(fh.fileno())
        if os.path.isdir(path):
            shutil.rmtree(path)
        os.replace(tmp, path)
        fd = os.open(parent, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def save(path: str | os.PathLike, state: Any, *, force: bool = True,
         background: bool = False, rank: int | None = None) -> None:
    """Write ``state`` (a tree of tensors, arrays and scalars) at ``path``;
    no-op off rank 0.

    ``background=True`` returns once the state is copied to host memory
    and writes it on a thread (one write in flight at a time; a later
    save, :func:`wait_pending` or exit waits for it).  ``force=False``
    refuses to overwrite an existing checkpoint.  ``rank`` overrides the
    rank-0 gate for engine-only jobs that never call ``init()``.
    """
    if (_rank() if rank is None else rank) != 0:
        return
    path = os.path.abspath(os.fspath(path))
    if not force and os.path.exists(path):
        raise FileExistsError(f"checkpoint {path} exists (force=False)")
    _save_snapshot(path, host_snapshot(state), background)


def _save_snapshot(path: str, snap: Any, background: bool) -> None:
    wait_pending()
    if not background:
        _write(path, snap)
        return
    t = threading.Thread(target=_write, args=(path, snap),
                         name="hvd-ckpt-save", daemon=True)
    with _pending_lock:
        _pending.append(t)
    t.start()


# Counts payload reads served from DISK, so the peer-replicated restore
# path can show "zero disk reads".  Directory listings and manifest parses
# are metadata, not payload reads, and are not counted.
_disk_read_count = 0


def disk_read_count() -> int:
    """Checkpoint payload reads served from disk since import (or the last
    :func:`reset_disk_read_count`)."""
    return _disk_read_count


def reset_disk_read_count() -> None:
    global _disk_read_count
    _disk_read_count = 0


def _read(path: str | os.PathLike) -> Any:
    global _disk_read_count
    wait_pending()  # a pending background save must be visible to reads
    _disk_read_count += 1
    f = os.path.join(os.path.abspath(os.fspath(path)), PAYLOAD_FILE)
    # The tree holds numpy arrays and Python scalars beside tensors: a
    # checkpoint this package wrote, not an untrusted download.
    return torch.load(f, map_location="cpu", weights_only=False)


def restore(path: str | os.PathLike, template: Any | None = None, *,
            broadcast: bool = True, root_rank: int = 0,
            map_location=None) -> Any:
    """Load a checkpoint and (by default) broadcast it from ``root_rank``
    so every worker resumes identically — the reference's resume
    contract.  Only ``root_rank`` touches the filesystem.

    With a ``template`` the checkpoint must have its structure (a
    ``KeyError`` otherwise), and each tensor lands on the device of the
    template's tensor at its place; ``map_location`` names one device for
    every tensor instead (default: the CPU)."""
    def read():
        raw = _read(path)
        if template is not None:
            _check_template(raw, template)
        return raw

    if _size() == 1 or not broadcast:
        state = read()
    else:
        state = read() if _rank() == root_rank else None
        state = training.broadcast_object(state, root_rank=root_rank)
    return _place(state, template, map_location)


def exists(path: str | os.PathLike) -> bool:
    wait_pending()
    return os.path.isdir(os.fspath(path))


def resume_epoch(path: str | os.PathLike, root_rank: int = 0) -> int:
    """Broadcast rank 0's view of the last finished epoch, or **-1 when no
    checkpoint exists** (so a saved epoch 0 is distinguishable from a
    fresh start).  Checkpoints are saved under ``path/epoch_<N>``; only
    rank 0 lists (workers may see stale filesystems)."""
    epoch = -1
    if _rank() == root_rank:
        wait_pending()  # count background saves that are still landing
        if os.path.isdir(os.fspath(path)):
            for entry in os.listdir(os.fspath(path)):
                if entry.startswith("epoch_"):
                    try:
                        epoch = max(epoch, int(entry.split("_", 1)[1]))
                    except ValueError:
                        pass
    if _size() == 1:
        return epoch
    return int(training.broadcast_object(epoch, root_rank=root_rank))


def save_epoch(path: str | os.PathLike, epoch: int, state: Any,
               background: bool = False) -> None:
    save(os.path.join(os.fspath(path), f"epoch_{epoch}"), state,
         background=background)


def restore_epoch(path: str | os.PathLike, epoch: int,
                  template: Any | None = None, **kw) -> Any:
    return restore(os.path.join(os.fspath(path), f"epoch_{epoch}"),
                   template, **kw)


# -- preemption ---------------------------------------------------------------

_preempt_event = threading.Event()
_prev_handlers: dict[int, Any] = {}
_handler_lock = threading.Lock()


def _on_preempt_signal(signum, frame):
    """Signal handler: ONLY set the flag (async-safe); the training loop
    observes it at the next step boundary and drains a checkpoint.  Any
    previously-installed Python handler is chained."""
    _preempt_event.set()
    prev = _prev_handlers.get(signum)
    if callable(prev):
        prev(signum, frame)


def install_preemption_handler(
        signals: tuple[int, ...] = (_signal.SIGTERM, _signal.SIGINT)) -> None:
    """Arm the checkpoint-now flag on preemption signals (the launcher's
    drain forwards SIGTERM to every rank's process group).  Idempotent;
    only the main thread may install."""
    with _handler_lock:
        for signum in signals:
            if signum in _prev_handlers:
                continue
            prev = _signal.signal(signum, _on_preempt_signal)
            _prev_handlers[signum] = (
                prev if prev not in (_signal.SIG_DFL, _signal.SIG_IGN,
                                     _signal.default_int_handler) else None)


def preemption_requested() -> bool:
    """True once a preemption signal (or :func:`request_checkpoint`) fired."""
    return _preempt_event.is_set()


def request_checkpoint() -> None:
    """Raise the checkpoint-now flag programmatically (tests, schedulers)."""
    _preempt_event.set()


def clear_preemption() -> None:
    _preempt_event.clear()


def resume_path() -> str | None:
    """The checkpoint the supervisor selected for this attempt
    (``HVD_TPU_RESUME_DIR``, exported by ``python -m
    horovod_tpu_torch.run --ckpt-dir``), or None on a fresh start."""
    return os.environ.get("HVD_TPU_RESUME_DIR") or None


class ElasticCheckpoint(NamedTuple):
    """A restored checkpoint: the step it was taken at, the state tree,
    and the resume metadata recorded at save time."""

    step: int
    state: Any
    metadata: dict


def _jsonable(obj):
    """Resume metadata round-trips through the JSON manifest exactly:
    array-like leaves become nested lists of ints/floats."""
    if isinstance(obj, dict):
        return {str(k): _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        return float(obj)
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().tolist()
    return obj


# Upper bound on the peer-restore agreement's wait loops: it only turns a
# cascading failure mid-restore into a clean abort instead of a hang.
_PEER_RESTORE_TIMEOUT_S = 120.0


class CheckpointManager:
    """Preemption-safe step checkpointing with a completeness manifest.

    Layout: ``directory/step_<N>/state/`` holds the payload;
    ``directory/step_<N>/_COMMIT`` (``utils/manifest.py``) is written
    strictly after the payload is durable, so a checkpoint is either
    *complete* or invisible — a rank killed mid-save can never shadow the
    last good step.  The launcher's ``--ckpt-dir`` reads the same
    manifest to point a relaunched job at the newest complete step.

    With ``HVD_TPU_CKPT_ASYNC=1`` a ``save`` is split into *snapshot*
    (:func:`host_snapshot`: the copy to host memory, the only part the
    train loop waits for) and *persist* (a background thread writes the
    payload, ``_COMMIT``, and prunes).  A persist failure (ENOSPC, a torn
    disk) leaves the step INVISIBLE and is surfaced via
    :meth:`persist_error`; training is never torn down by checkpoint IO.

    With ``HVD_TPU_CKPT_REPLICATE=1`` every save also shards the snapshot
    into the membership's host memory (``replication.put``);
    :meth:`restore_latest` uses a replica from the current membership
    epoch at least as new as the newest complete step, and reads disk
    only when none survives.

    Only rank 0 writes; restore is coordinated so every rank resumes from
    the same step even when the newest payload turns out to be corrupt
    (fall back to the previous complete step).
    """

    def __init__(self, directory: str | os.PathLike, *, max_to_keep: int = 2,
                 rank: int | None = None, size: int | None = None):
        if max_to_keep < 1:
            raise ValueError("max_to_keep must be >= 1")
        self.directory = os.path.abspath(os.fspath(directory))
        self.max_to_keep = max_to_keep
        # Explicit rank/size override the init() topology — for
        # engine-only elastic workers that track membership through the
        # engine.  ``size=1`` also opts restore_latest out of the
        # coordinated broadcast: every rank reads the shared directory.
        self._rank_override = rank
        self._size_override = size
        self._pending: list[tuple[int, dict | None]] = []
        self._async = env.ckpt_async()
        # _io_lock serializes directory surgery (save's rmtree/makedirs,
        # commit, prune) between the caller and the persist thread.
        self._io_lock = threading.Lock()
        self._persist_cv = threading.Condition()
        self._persist_q: list[tuple[int, dict | None, Any, list]] = []
        self._persist_thread: threading.Thread | None = None
        self._persist_err: BaseException | None = None
        self._last_committed = -1
        self._pool = _PinnedPool()
        if self._my_rank() == 0:
            os.makedirs(self.directory, exist_ok=True)
        register(self.drain)
        atexit.register(self.drain)

    def _my_rank(self) -> int:
        return self._rank_override if self._rank_override is not None \
            else _rank()

    def _my_size(self) -> int:
        return self._size_override if self._size_override is not None \
            else _size()

    # -- writing ------------------------------------------------------------

    def save(self, step: int, state: Any, *, metadata: dict | None = None,
             background: bool | None = None) -> None:
        """Write ``state`` as checkpoint ``step``; no-op off rank 0 (peer
        replication, when enabled, still happens first).

        ``background=True`` writes the payload on a thread and defers the
        commit manifest until the write lands (next ``save``/``drain``/
        exit).  ``background=None`` (the default) defers to
        ``HVD_TPU_CKPT_ASYNC``: in async mode the commit also moves to the
        persist thread, so this call stalls the loop for the snapshot
        only.  ``metadata`` is the resume record (the step is always
        included)."""
        if self._my_rank() != 0:
            self._replicate(step, state, metadata)
            return
        if self._async:
            self._save_async(step, state, metadata)
            return
        self._flush_pending()
        path = manifest.step_dir(self.directory, step)
        if os.path.isdir(path):
            # Re-saving the same step (restart replay): tear the old dir
            # down first — its commit marker goes with it.
            shutil.rmtree(path)
        os.makedirs(path, exist_ok=True)
        snap = host_snapshot(state)
        _save_snapshot(os.path.join(path, "state"), snap, bool(background))
        self._replicate(step, snap, metadata)
        if background:
            self._pending.append((step, metadata))
        else:
            self._commit(step, metadata)
        self._prune()

    def _save_async(self, step: int, state: Any,
                    metadata: dict | None) -> None:
        """The split: *snapshot* here (device-to-host copy at the step
        barrier), *persist* on the background thread (payload write,
        ``_COMMIT``, prune)."""
        path = manifest.step_dir(self.directory, step)
        if os.path.isdir(path):
            # Restart replay of a step that may still be persisting: let
            # every in-flight write land before tearing its directory down.
            self._wait_persisted()
            wait_pending()
        with self._io_lock:
            if os.path.isdir(path):
                shutil.rmtree(path)
            os.makedirs(path, exist_ok=True)
        bufs: list = []

        def take(nbytes):
            bufs.append(self._pool.take(nbytes))
            return bufs[-1]

        snap = host_snapshot(state, take)
        self._replicate(step, snap, metadata)
        limit = env.ckpt_staleness_steps()
        with self._persist_cv:
            if self._persist_thread is None \
                    or not self._persist_thread.is_alive():
                self._persist_thread = threading.Thread(
                    target=self._persist_loop, name="hvd-ckpt-persist",
                    daemon=True)
                self._persist_thread.start()
            # Bounded staleness as backpressure: when the persist queue is
            # already `limit` snapshots deep, stall here until the writer
            # catches up instead of growing host memory.
            while limit and len(self._persist_q) >= limit:
                self._persist_cv.wait(0.2)
            self._persist_q.append((int(step), metadata, snap, bufs))
            self._persist_cv.notify_all()

    def _persist_loop(self) -> None:
        while True:
            with self._persist_cv:
                while not self._persist_q:
                    self._persist_cv.wait(1.0)
                step, md, snap, bufs = self._persist_q[0]
            try:
                path = manifest.step_dir(self.directory, step)
                # The payload goes to a temporary directory inside the
                # step's and is renamed into place, so the loop's own
                # directory surgery need not wait for the disk.
                _write(os.path.join(path, "state"), snap)
                with self._io_lock:
                    self._commit(step, md)
                    self._prune()
            except BaseException as exc:  # noqa: BLE001 - must not die
                # A failed persist leaves the step INVISIBLE (no _COMMIT).
                with self._persist_cv:
                    self._persist_err = exc
                warnings.warn(
                    f"checkpoint step {step} failed to persist "
                    f"({type(exc).__name__}: {exc}); it stays invisible "
                    f"and restore falls back to the previous complete step")
            finally:
                del snap  # the persisted views go before their buffer does
                for buf in bufs:
                    self._pool.give(buf)
                with self._persist_cv:
                    self._persist_q.pop(0)
                    self._persist_cv.notify_all()

    def _wait_persisted(self) -> None:
        with self._persist_cv:
            while self._persist_q:
                self._persist_cv.wait(0.2)

    def _replicate(self, step: int, state: Any,
                   metadata: dict | None) -> None:
        if replication.enabled():
            replication.put(int(step), state,
                            dict(_jsonable(metadata)) if metadata else {})

    def persist_error(self) -> BaseException | None:
        """The most recent background-persist failure, or None.  The
        failed step stayed invisible."""
        with self._persist_cv:
            return self._persist_err

    def last_committed_step(self) -> int:
        """Newest step this manager committed in this process (-1 before
        any)."""
        with self._persist_cv:
            return self._last_committed

    def drain(self) -> None:
        """Block until every in-flight save is durable AND committed — the
        preemption drain: the job exits with a complete last checkpoint,
        never a torn one."""
        if self._my_rank() != 0:
            return
        self._flush_pending()
        self._wait_persisted()

    def _flush_pending(self) -> None:
        if not self._pending:
            return
        wait_pending()
        for step, md in self._pending:
            self._commit(step, md)
        self._pending.clear()

    def _commit(self, step: int, metadata: dict | None) -> None:
        path = manifest.step_dir(self.directory, step)
        doc = dict(_jsonable(metadata) if metadata else {})
        if faults.on_checkpoint_persist(path, step):
            return  # injector hijacked the commit (torn manifest)
        manifest.write_commit(path, step, doc)
        with self._persist_cv:
            self._last_committed = max(self._last_committed, step)
        faults.on_checkpoint_committed(path, step)

    def _prune(self) -> None:
        committed = manifest.complete_steps(self.directory)
        keep = set(committed[-self.max_to_keep:])
        pending = {s for s, _ in self._pending}
        with self._persist_cv:
            pending |= {e[0] for e in self._persist_q}
        newest = committed[-1] if committed else None
        for entry in os.listdir(self.directory):
            step = manifest.parse_step(entry)
            if step is None or step in keep or step in pending:
                continue
            path = os.path.join(self.directory, entry)
            if manifest.is_complete(path):
                shutil.rmtree(path, ignore_errors=True)
            elif newest is not None and step < newest:
                # Torn leftovers from a kill mid-save, older than the
                # newest good step: clean them up.
                shutil.rmtree(path, ignore_errors=True)

    # -- reading ------------------------------------------------------------

    def steps(self) -> list[int]:
        """Committed step numbers, ascending (rank-local filesystem view)."""
        return manifest.complete_steps(self.directory)

    def latest_step(self) -> int | None:
        steps = self.steps()
        return steps[-1] if steps else None

    def restore_latest(self, template: Any | None = None, *,
                       broadcast: bool = True,
                       map_location=None) -> ElasticCheckpoint | None:
        """Restore the newest complete checkpoint, falling back past
        corrupt or unreadable ones; None when none is restorable.

        Coordinated like :func:`restore`: rank 0 picks the step (trying a
        real read, so a payload that fails to load is skipped with a
        warning), broadcasts the verdict, and every rank restores the
        agreed step.  With ``HVD_TPU_CKPT_REPLICATE=1`` a peer-replicated
        snapshot from the CURRENT membership epoch is preferred whenever
        it is at least as new as the newest complete step — zero payload
        reads from disk (:func:`disk_read_count`)."""
        peer = self._restore_from_peers(template, broadcast=broadcast,
                                        map_location=map_location)
        if peer is not None:
            return peer
        coordinated = broadcast and self._my_size() > 1
        picked = self._pick_restorable(template) \
            if not coordinated or self._my_rank() == 0 else None
        if coordinated:
            picked = training.broadcast_object(picked, root_rank=0)
        if picked is None:
            return None
        step, md, state = picked
        return ElasticCheckpoint(step, _place(state, template, map_location),
                                 md)

    def _restore_from_peers(self, template=None, *, broadcast: bool = True,
                            map_location=None) -> ElasticCheckpoint | None:
        """Disk-free restore from the sharded peer-replicated host memory.

        Only shards from the engine's CURRENT epoch are eligible (a
        reconfiguration re-stamps the survivors' shards through
        ``replication.bump_epoch``).  The elected step must also be at
        least as new as the newest complete step on disk — otherwise disk
        wins and this returns None."""
        if not replication.enabled():
            return None
        from horovod_tpu_torch.core import engine as _core_engine
        eng = _core_engine.peek_engine()
        if eng is None:
            return None
        replication.drain(eng)
        # Coordination is keyed on the ENGINE job, not the manager's
        # overrides: elastic workers run one manager per process (size=1)
        # yet must agree on ONE restore step.
        coordinated = broadcast and eng.size > 1
        if not coordinated:
            doc = replication.restore_local(eng.epoch)
            if doc is None:
                return None
            self.drain()
            disk = self.latest_step()
            if disk is not None and int(disk) > int(doc["step"]):
                return None
            return ElasticCheckpoint(
                int(doc["step"]), _place(doc["state"], template, map_location),
                doc.get("metadata") or {})
        # Every rank announces an inventory of the shards it holds, every
        # rank computes the SAME election from the same views, and the
        # lowest-rank holder of each shard streams it to the ranks that
        # lack it.  Each rank drains its own manager first (a no-op off
        # the disk writer), so the directory view below is stable.
        self.drain()
        replication.send_inventory(eng)
        deadline = time.monotonic() + _PEER_RESTORE_TIMEOUT_S
        while True:
            replication.drain(eng)
            invs = replication.inventories(eng.epoch)
            if len(invs) >= eng.size:  # peers + this rank's pinned view
                break
            self._check_restore_liveness(eng, deadline, "peer inventories")
            time.sleep(0.01)
        election = replication.elect(invs)
        disk = self.latest_step()
        disk = -1 if disk is None else int(disk)
        if election is None or disk > election["step"]:
            # Every rank computes this from the same inventories and the
            # same directory, so all take the disk path together.
            replication.note_disk_restore()
            return None
        replication.ship_missing(election, eng)
        while True:
            replication.drain(eng)
            blob = replication.assemble(election, eng.epoch)
            if blob is not None:
                break
            self._check_restore_liveness(eng, deadline, "replica shards")
            time.sleep(0.01)
        doc = replication.decode_snapshot(blob)
        return ElasticCheckpoint(
            int(doc["step"]), _place(doc["state"], template, map_location),
            doc.get("metadata") or {})

    @staticmethod
    def _check_restore_liveness(eng, deadline: float, what: str) -> None:
        """Bound the peer-restore wait loops: a membership change surfaces
        as MembershipChanged (the caller reconfigures and retries at the
        new epoch); a silent stall past the deadline raises."""
        from horovod_tpu_torch.core import engine as _core_engine
        if eng.resize_event() is not None:
            raise _core_engine.MembershipChanged(
                "membership changed during peer-replica restore; "
                "reconfigure and retry")
        if time.monotonic() > deadline:
            raise TimeoutError(
                f"peer-replica restore: {what} did not arrive within "
                f"{_PEER_RESTORE_TIMEOUT_S}s")

    def _state_path(self, step: int) -> str:
        return os.path.join(manifest.step_dir(self.directory, step), "state")

    def _pick_restorable(self, template) -> tuple[int, dict, Any] | None:
        """``(step, metadata, state)`` of the newest complete step whose
        payload actually reads back (rank-0 side of the coordinated
        restore; the state is on the CPU)."""
        self.drain()
        for step in reversed(self.steps()):
            doc = manifest.read_commit(
                manifest.step_dir(self.directory, step)) or {}
            try:
                state = restore(self._state_path(step), template,
                                broadcast=False, map_location="cpu")
            except Exception as exc:  # noqa: BLE001 - any read failure
                warnings.warn(
                    f"checkpoint step {step} is complete-marked but "
                    f"unreadable ({type(exc).__name__}: {exc}); falling "
                    f"back to the previous complete step")
                continue
            return step, doc.get("metadata", {}), state
        return None
