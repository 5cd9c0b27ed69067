"""PyTorch binding — the reference's ``horovod.torch`` surface on the port,
counterpart of ``horovod_tpu/torch``.

``import horovod_tpu_torch.torch as hvd`` mirrors ``import
horovod_tpu.torch as hvd``: the same eager API (``hvd.allreduce(_async)
(_)``, ``poll``/``synchronize``, ``DistributedOptimizer`` with gradient
hooks, ``broadcast_parameters``, ``broadcast_optimizer_state``), driven by
the port's native coordination engine (``core/``): the engine negotiates
cross-process readiness and fuses, and the executor moves the tensors over
``torch.distributed``, on the card when they are there.  Results come back
as tensors on the input's device.

This subpackage is named ``torch`` as the reference's is; under absolute
imports (every module of the port) ``import torch`` still names PyTorch,
never this package.

Usage (reference README.md:203-249)::

    import horovod_tpu_torch.torch as hvd
    hvd.init()
    optimizer = hvd.DistributedOptimizer(
        optimizer, named_parameters=model.named_parameters())
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
"""

from __future__ import annotations

from horovod_tpu_torch.basics import (  # noqa: F401
    cross_rank,
    cross_size,
    init,
    is_initialized,
    local_rank,
    local_size,
    mpi_threads_supported,
    rank,
    shutdown,
    size,
)
from horovod_tpu_torch.torch.compression import Compression  # noqa: F401
from horovod_tpu_torch.torch.mpi_ops import (  # noqa: F401
    allgather,
    allgather_async,
    allreduce,
    allreduce_,
    allreduce_async,
    allreduce_async_,
    allreduce_sparse_async,
    alltoall,
    broadcast,
    broadcast_,
    broadcast_async,
    broadcast_async_,
    poll,
    synchronize,
    synchronize_sparse,
)
from horovod_tpu_torch.torch.optimizer import DistributedOptimizer  # noqa: F401
from horovod_tpu_torch.torch.state import (  # noqa: F401
    allgather_object,
    broadcast_object,
    broadcast_optimizer_state,
    broadcast_parameters,
)
