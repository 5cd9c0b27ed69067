"""Process identity and the process group — counterpart of
``horovod_tpu/basics.py``.

The port runs one process per GPU, as the reference Horovod does under
``mpirun``: ``rank`` and ``size`` count processes, each process drives the
one card at ``cuda:local_rank``, and ``num_chips() == size()`` (the JAX
package runs one process per host that drives every chip of it, so there
the two differ).  A ``torch.distributed`` process group takes the place of
the JAX mesh: NCCL on ``cuda`` (the default), gloo with ``device="cpu"``.

:func:`init` reads the process's place in the job from ``RANK`` /
``WORLD_SIZE`` / ``LOCAL_RANK`` / ``LOCAL_WORLD_SIZE`` (``torchrun``), or
from ``JAX_PROCESS_ID`` / ``JAX_NUM_PROCESSES`` / ``JAX_COORDINATOR_ADDRESS``
(what ``horovod_tpu/run.py`` exports; ``python -m horovod_tpu_torch.run``
exports both sets); with none of them set it is a job of one process.
Rendezvous goes through the address it is given
(``init_method``, ``JAX_COORDINATOR_ADDRESS`` as ``tcp://host:port``, or
``MASTER_ADDR``/``MASTER_PORT``); a job of one process without one gets a
file store in a fresh temporary directory, so nothing binds a port.

``init(ranks=[...])`` restricts the job to a subset of the processes, as
the JAX package's does: every process of the launch joins the world group
and enters ``dist.new_group`` (torch requires all of them there), a member's
``rank()`` becomes its position in the list and ``size()`` the list's
length, and every collective of the port runs over that group
(:func:`process_group`).  A process that is not in the list raises.

On ``cuda`` :func:`init` also forms a gloo group over the same members
(:func:`host_group`): the eager engine's executor reduces CPU tensors, and
every tensor on its gather route (``HVD_TPU_EAGER_REDUCE=gather``), over
it.  Every group fails a collective that has not completed in
``COLLECTIVE_TIMEOUT``.  :func:`shutdown` stops the eager engine before it
destroys the groups; :func:`stall_report`, :func:`failure_report`,
:func:`coord_state`, :func:`cache_stats` and :func:`control_plane_stats`
read that engine.
"""

from __future__ import annotations

import atexit
import dataclasses
import datetime
import os
import shutil
import tempfile
import threading

import torch
import torch.distributed as dist

from horovod_tpu_torch.utils.device import resolve_device


class NotInitializedError(RuntimeError):
    """Raised when the API is used before :func:`init`."""

    def __init__(self) -> None:
        super().__init__("horovod_tpu_torch has not been initialized; call "
                         "horovod_tpu_torch.init() first.")


@dataclasses.dataclass(frozen=True)
class Topology:
    """The job as :func:`init` found it."""

    rank: int
    size: int
    local_rank: int      # index among the processes of this host
    local_size: int      # processes on this host
    cross_rank: int      # index of this host
    cross_size: int      # number of hosts
    device: torch.device
    # The launch ranks of the job's members, in rank order (all of them
    # unless init(ranks=...)), and their group (None: the world group).
    members: tuple = ()
    group: object = None
    # A gloo group over the same members (the group itself under gloo).
    host_group: object = None


# How long a collective of the job's groups may take before it fails (a
# peer that never comes; torch's own defaults are 10 and 30 minutes).
COLLECTIVE_TIMEOUT = datetime.timedelta(minutes=10)

_lock = threading.Lock()
_topology: Topology | None = None
_store_dir: str | None = None


def _env_int(*names: str) -> int | None:
    for name in names:
        raw = os.environ.get(name)
        if raw not in (None, ""):
            return int(raw)
    return None


def _rendezvous(size: int) -> str:
    coordinator = os.environ.get("JAX_COORDINATOR_ADDRESS")
    if coordinator:
        return f"tcp://{coordinator}"
    if os.environ.get("MASTER_ADDR") and os.environ.get("MASTER_PORT"):
        return "env://"
    if size == 1:
        global _store_dir
        _store_dir = tempfile.mkdtemp(prefix="hvd_torch_")
        return "file://" + os.path.join(_store_dir, "store")
    raise ValueError(
        f"init: a job of {size} processes needs a rendezvous address: pass "
        f"init_method= (tcp://host:port or file:///path) or set "
        f"JAX_COORDINATOR_ADDRESS or MASTER_ADDR/MASTER_PORT")


def init(*, device=None, init_method: str | None = None,
         rank: int | None = None, size: int | None = None,
         ranks=None) -> None:
    """Join the job: the analog of ``hvd.init()``.

    ``device`` is ``cuda`` unless given (NCCL; raises without a card) or
    ``"cpu"`` (gloo).  ``rank``/``size``/``init_method`` override the
    environment.  ``ranks`` restricts the job to those launch ranks (every
    process of the launch calls ``init`` with the same list; a non-member
    raises ``ValueError`` after the group is formed).  Safe to call more
    than once: later calls are no-ops.
    """
    global _topology
    with _lock:
        if _topology is not None:
            return
        dev = resolve_device(device)
        if rank is None:
            rank = _env_int("RANK", "JAX_PROCESS_ID")
        if size is None:
            size = _env_int("WORLD_SIZE", "JAX_NUM_PROCESSES")
        rank = 0 if rank is None else rank
        size = 1 if size is None else size
        if not 0 <= rank < size:
            raise ValueError(f"init: rank {rank} is not in [0, {size})")
        local_size = _env_int("LOCAL_WORLD_SIZE")
        local_size = size if local_size is None else local_size
        local_rank = _env_int("LOCAL_RANK")
        local_rank = rank % local_size if local_rank is None else local_rank
        if init_method is None:
            init_method = _rendezvous(size)
        if dev.type == "cuda":
            if dev.index is None:
                dev = torch.device("cuda", local_rank)
            torch.cuda.set_device(dev)
            backend = "nccl"
        else:
            backend = "gloo"
        members = tuple(range(size)) if ranks is None else \
            tuple(int(r) for r in ranks)
        if len(set(members)) != len(members) or not members or any(
                not 0 <= r < size for r in members):
            raise ValueError(f"init(ranks={list(ranks)}): ranks must be "
                             f"distinct process indices in [0, {size})")
        try:
            dist.init_process_group(backend, init_method=init_method,
                                    rank=rank, world_size=size,
                                    timeout=COLLECTIVE_TIMEOUT)
            group = None
            if len(members) < size:
                group = dist.new_group(list(members),
                                       timeout=COLLECTIVE_TIMEOUT)
            host_group = group
            if backend != "gloo":
                # Every process of the launch enters new_group, as above.
                host_group = dist.new_group(
                    list(members), timeout=COLLECTIVE_TIMEOUT,
                    backend="gloo")
        except BaseException:
            _remove_store_dir()
            raise
        if rank not in members:
            dist.destroy_process_group()
            _remove_store_dir()
            raise ValueError(
                f"process {rank} is not in init(ranks={list(ranks)}); every "
                f"member passes the same list, and a non-member does not "
                f"join the job")
        _topology = Topology(
            rank=members.index(rank), size=len(members),
            local_rank=local_rank, local_size=local_size,
            cross_rank=rank // local_size,
            cross_size=-(-size // local_size), device=dev, members=members,
            group=group, host_group=host_group)
    atexit.register(shutdown)


def _remove_store_dir() -> None:
    global _store_dir
    if _store_dir is not None:
        shutil.rmtree(_store_dir, ignore_errors=True)
        _store_dir = None


def shutdown() -> None:
    """Leave the job: stop the eager engine, then destroy the process
    groups.  Idempotent."""
    global _topology
    with _lock:
        if _topology is None:
            return
        _topology = None
        from horovod_tpu_torch.core import engine as _engine

        _engine.shutdown_engine()
        if dist.is_initialized():
            dist.destroy_process_group()
        _remove_store_dir()


def is_initialized() -> bool:
    return _topology is not None


def _apply_resize(new_rank: int, new_size: int) -> None:
    """Elastic membership update (``elastic.reconfigure``): republish
    ``rank()``/``size()`` for the surviving membership so data sharding,
    rank-0 gating and LR scaling see the new world.  A no-op before
    :func:`init` (engine-only workers track membership through the engine
    itself).  The process groups are left as formed: a
    ``torch.distributed`` group cannot re-form in place, so in-place
    elastic mode serves engine-only workers, and jobs on process groups
    keep the launcher's full restart (``--max-restarts``)."""
    global _topology
    with _lock:
        if _topology is None:
            return
        _topology = dataclasses.replace(_topology, rank=new_rank,
                                        size=new_size)


def _topo() -> Topology:
    if _topology is None:
        raise NotInitializedError()
    return _topology


def rank() -> int:
    """Process rank (0 is the coordinator; use for checkpoint/log gating)."""
    return _topo().rank


def size() -> int:
    """Number of processes."""
    return _topo().size


def local_rank() -> int:
    return _topo().local_rank


def local_size() -> int:
    return _topo().local_size


def cross_rank() -> int:
    return _topo().cross_rank


def cross_size() -> int:
    return _topo().cross_size


def num_chips() -> int:
    """Total accelerators = data-parallel width (use for LR scaling); one
    per process."""
    return _topo().size


def device() -> torch.device:
    """The device this process computes and communicates on."""
    return _topo().device


def process_group():
    """The ``torch.distributed`` group of the job's members (``None``, the
    world group, unless ``init(ranks=...)``)."""
    return _topo().group


def host_group():
    """The gloo group of the job's members: :func:`process_group` under
    gloo, a group of its own on ``cuda``."""
    return _topo().host_group


def launch_rank(r: int) -> int:
    """The launch (world) rank of the job's rank ``r``."""
    return _topo().members[r]


# -- the eager engine's reports (horovod_tpu/basics.py:336-448) -------------

def stall_report() -> list:
    """``[(tensor_name, [missing ranks]), ...]`` for every collective of
    the eager engine stuck past the stall-warning window
    (``HOROVOD_STALL_WARNING_TIME``); empty off the coordinator, when
    nothing is stalled, or when the engine was never started."""
    _topo()
    from horovod_tpu_torch.core import engine as _engine

    return _engine.stall_report()


def failure_report() -> dict | None:
    """The eager engine's peer-failure report: ``None`` while every peer is
    healthy (or the engine never started), else ``{"failed_rank",
    "cause", "detail", "last_heard_ms", "last_collective"}`` on every
    surviving rank.  Pending collectives fail with ``CollectiveError``, and
    after ``HVD_TPU_ABORT_GRACE_MS`` the process exits with the
    restartable code (75)."""
    _topo()
    from horovod_tpu_torch.core import engine as _engine

    return _engine.failure_report()


def coord_state() -> dict | None:
    """The coordinator state replicated onto this rank (the designated
    standby of an elastic job; the coordinator reports its own): ``{"epoch",
    "joins_admitted", "verify_checked", "verify_tick", "lru_order"}``, or
    ``None``."""
    _topo()
    from horovod_tpu_torch.core import engine as _engine

    return _engine.coord_state()


def cache_stats() -> dict:
    """Response-cache counters of this rank's eager engine: ``{"hits",
    "misses", "evictions", "bypassed_ticks", "entries", "capacity"}``; all
    zeros when the engine was never started or ``HOROVOD_CACHE_CAPACITY=0``.
    """
    _topo()
    from horovod_tpu_torch.core import engine as _engine

    return _engine.cache_stats()


def control_plane_stats() -> dict:
    """Control-plane topology and tick latency of this rank's eager
    engine: ``{"role", "depth", "fanout", "tick_p50_ms", "tick_p99_ms",
    "frames_per_tick", "ticks", "frames_rx"}`` (role ``none`` before the
    engine starts)."""
    _topo()
    from horovod_tpu_torch.core import engine as _engine

    return _engine.control_plane_stats()


def mpi_threads_supported() -> bool:
    """API parity with the reference: there is no MPI; the port is safe to
    drive from several Python threads, so this is True."""
    _topo()
    return True
