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
feedback, ``init(ranks=...)``) and ``callbacks``.  Importing the package
creates no process group; :func:`init` does.
"""

from __future__ import annotations

from horovod_tpu_torch.basics import (NotInitializedError, cross_rank,
                                      cross_size, init, is_initialized,
                                      local_rank, local_size, num_chips,
                                      rank, shutdown, size)
from horovod_tpu_torch.ops.collective_ops import (
    allgather, allgather_object, allreduce, allreduce_sparse, alltoall,
    broadcast, grouped_allreduce, quantized_grouped_allreduce,
    sparse_to_dense)
from horovod_tpu_torch.ops.compression import Compression
from horovod_tpu_torch.ops.losses import softmax_cross_entropy
from horovod_tpu_torch.ops.schedule_plan import overlap_plan
from horovod_tpu_torch.training import (DistributedOptimizer,
                                        accumulate_gradients,
                                        broadcast_object,
                                        broadcast_optimizer_state,
                                        broadcast_parameters, master_weights,
                                        scale_learning_rate)
from horovod_tpu_torch.utils.device import resolve_device

from horovod_tpu_torch import callbacks  # noqa: E402  (imports training)

__version__ = "0.1.0"

__all__ = [
    "Compression", "DistributedOptimizer", "NotInitializedError",
    "accumulate_gradients", "allgather", "allgather_object", "allreduce",
    "allreduce_sparse", "alltoall", "broadcast", "broadcast_object",
    "broadcast_optimizer_state", "broadcast_parameters", "callbacks",
    "cross_rank", "cross_size", "grouped_allreduce", "init",
    "is_initialized", "local_rank", "local_size", "master_weights",
    "num_chips", "overlap_plan", "quantized_grouped_allreduce", "rank",
    "resolve_device", "scale_learning_rate", "shutdown", "size",
    "softmax_cross_entropy", "sparse_to_dense",
]
