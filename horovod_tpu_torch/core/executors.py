"""Batch executors of the port's native engine — counterpart of
``horovod_tpu/core/executors.py``.

The native engine negotiates and fuses; an executor moves the bytes of
one :class:`~horovod_tpu_torch.core.engine.ExecBatch`.  The port has one so
far:

* ``local`` — collectives over this process alone: a sum, gather or
  broadcast over one contributor is the identity, while fusion, ordering,
  the response cache and handles still run the whole native path.  The
  serving fleet's ``serving.tick`` runs on it in every replica, so the
  tick's "sum" is rank-local there, as in the JAX package's fleet.

An executor that reduces across ranks (over NCCL) is the eager engine
path's, still to be ported; until then a job of more than one process
must name its executor.
"""

from __future__ import annotations

import os


def default_executor(rank: int, size: int):
    choice = os.environ.get("HVD_TPU_EXECUTOR")
    if choice == "local" or (choice is None and size == 1):
        return local_executor
    raise ValueError(
        f"no executor for a job of {size} processes "
        f"(HVD_TPU_EXECUTOR={choice}): the port has only the local one; "
        f"pass executor=local_executor for a control-plane-only engine")


def local_executor(engine, batch) -> None:
    """Single-process semantics: sum/gather/broadcast over one contributor."""
    engine.batch_activity(batch, "WAIT_FOR_DATA")
    inputs = engine.take_inputs(batch)
    engine.batch_activity(batch, "LOCAL_COPY")
    engine.put_results(batch, inputs)
