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
(what ``horovod_tpu/run.py`` exports); with none of them set it is a job of
one process.  Rendezvous goes through the address it is given
(``init_method``, ``JAX_COORDINATOR_ADDRESS`` as ``tcp://host:port``, or
``MASTER_ADDR``/``MASTER_PORT``); a job of one process without one gets a
file store in a fresh temporary directory, so nothing binds a port.

``init(ranks=[...])`` restricts the job to a subset of the processes, as
the JAX package's does: every process of the launch joins the world group
and enters ``dist.new_group`` (torch requires all of them there), a member's
``rank()`` becomes its position in the list and ``size()`` the list's
length, and every collective of the port runs over that group
(:func:`process_group`).  A process that is not in the list raises.
"""

from __future__ import annotations

import atexit
import dataclasses
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
                                    rank=rank, world_size=size)
            group = None
            if len(members) < size:
                group = dist.new_group(list(members))
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
            group=group)
    atexit.register(shutdown)


def _remove_store_dir() -> None:
    global _store_dir
    if _store_dir is not None:
        shutil.rmtree(_store_dir, ignore_errors=True)
        _store_dir = None


def shutdown() -> None:
    """Leave the job: destroy the process group.  Idempotent."""
    global _topology
    with _lock:
        if _topology is None:
            return
        _topology = None
        if dist.is_initialized():
            dist.destroy_process_group()
        _remove_store_dir()


def is_initialized() -> bool:
    return _topology is not None


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


def launch_rank(r: int) -> int:
    """The launch (world) rank of the job's rank ``r``."""
    return _topo().members[r]
