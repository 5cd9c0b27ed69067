"""horovod_tpu_torch — the PyTorch/CUDA port of horovod_tpu, for NVIDIA H100
cards (``sm_90a``), one process per card.

The package mirrors the layout of ``horovod_tpu`` (``ops/``, ``models/``,
``serving/``, ``utils/``) so each module's counterpart is easy to find, and
imports nothing of it: where it needs a JAX-free module of the JAX package,
it keeps its own copy.  Each TPU kernel on a ported path is a kernel written
by hand for Hopper under ``csrc/``, beside a plain PyTorch version with the
same contract; a CUDA tensor launches the kernel, a CPU tensor takes the
plain version.  Entry points run on ``cuda`` unless the caller passes
``device="cpu"``, and raise when asked for CUDA without it.

Ported so far: the serving path of the decoder transformer (slice 1), its
synchronous data-parallel training step (slice 2): the ``hvd``-style
surface below, the backward kernels of flash attention and RMSNorm, and
``python -m horovod_tpu_torch.train_transformer``; and the rest of the
main path: gradient overlap in ``DistributedOptimizer`` with its bucket
planner (``overlap_plan()``), ResNet and the MNIST models, and
``python -m horovod_tpu_torch.train_resnet``; mixed precision
(:func:`master_weights`), ``TransformerConfig.remat`` and
:func:`accumulate_gradients` in the 162M step, the rest of the collective
surface (``prescale_factor``, ``average=``, :func:`alltoall`,
:func:`allgather_object`, sparse gradients, the int8 wire with error
feedback, ``init(ranks=...)``) and ``callbacks``; the paged KV pool with
shared-prefix reuse and speculation, the router (slice 8); and fleet
serving (slice 9) on the port's own copy of the native control plane
(``core/``: the C++ core, its ctypes shim), with ``dataplane``,
``replication`` and ``elastic``; the eager engine path (slice 10): the
handle API of ``ops/async_ops.py`` (``allreduce_async``, ``poll``,
``synchronize``, ``barrier``, ...) over the native engine and its
cross-process executor (``core/executors.py``, ``core/device_reduce.py``),
the engine's reports, and the ``horovod_tpu_torch.torch`` binding; fault
tolerance (slice 11): the launcher ``python -m horovod_tpu_torch.run``,
``checkpoint`` (manifest-committed, async persist, peer-replicated
restore), ``data`` (sharding, background loading, prefetch to the card),
the fault injectors and :func:`elastic_loop`.  The
top-level :func:`synchronize` takes an engine handle (an ``int``);
``ops.collective_ops.synchronize`` takes the ``AllreduceHandle`` of
:func:`grouped_allreduce_async`.  Importing the package creates no process
group; :func:`init` does.  Names resolve on first use, so the launcher
(``python -m horovod_tpu_torch.run``) and other standard-library-only
modules import no torch.
"""

from __future__ import annotations

import importlib

__version__ = "0.1.0"

# Public name -> the module that defines it, imported on first use.
_ATTR_HOME = {
    **dict.fromkeys((
        "NotInitializedError", "cache_stats", "control_plane_stats",
        "coord_state", "cross_rank", "cross_size", "failure_report", "init",
        "is_initialized", "local_rank", "local_size",
        "mpi_threads_supported", "num_chips", "rank", "shutdown", "size",
        "stall_report"), "horovod_tpu_torch.basics"),
    **dict.fromkeys(("CollectiveError", "MembershipChanged"),
                    "horovod_tpu_torch.core.engine"),
    **dict.fromkeys((
        "allgather", "allgather_object", "allreduce", "allreduce_sparse",
        "alltoall", "broadcast", "grouped_allreduce",
        "quantized_grouped_allreduce", "sparse_to_dense"),
        "horovod_tpu_torch.ops.collective_ops"),
    **dict.fromkeys((
        "allgather_async", "allreduce_async", "alltoall_async", "barrier",
        "broadcast_async", "poll", "synchronize"),
        "horovod_tpu_torch.ops.async_ops"),
    "Compression": "horovod_tpu_torch.ops.compression",
    "softmax_cross_entropy": "horovod_tpu_torch.ops.losses",
    "overlap_plan": "horovod_tpu_torch.ops.schedule_plan",
    **dict.fromkeys((
        "DistributedOptimizer", "accumulate_gradients", "broadcast_object",
        "broadcast_optimizer_state", "broadcast_parameters", "elastic_loop",
        "master_weights", "scale_learning_rate"),
        "horovod_tpu_torch.training"),
    "resolve_device": "horovod_tpu_torch.utils.device",
}
_SUBMODULES = {"callbacks", "checkpoint", "data"}

__all__ = sorted(set(_ATTR_HOME) | _SUBMODULES)


def __getattr__(name: str):
    home = _ATTR_HOME.get(name)
    if home is not None:
        value = getattr(importlib.import_module(home), name)
    elif name in _SUBMODULES:
        value = importlib.import_module(f"horovod_tpu_torch.{name}")
    else:
        raise AttributeError(
            f"module 'horovod_tpu_torch' has no attribute {name!r}")
    globals()[name] = value  # cache: __getattr__ runs once per name
    return value


def __dir__():
    return sorted(set(__all__) | set(globals()))
