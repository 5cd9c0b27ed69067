"""Device-side profiling — counterpart of ``horovod_tpu/utils/profiling.py``,
on ``torch.profiler`` where the JAX package has ``jax.profiler``.

The native timeline (``core/src/timeline.cc``, ``HOROVOD_TIMELINE``)
covers the coordination plane; the kernels, copies and collectives on the
card, and the host ops that launched them, belong to the profiler.  One
call captures them:

    from horovod_tpu_torch import profiling

    with profiling.trace("/tmp/torch-trace"):
        for _ in range(10):
            with profiling.annotate("train_step"):
                train_step(model, opt, x, y)

Each trace is a Chrome trace file, ``<path>/rank<r>.<pid>.<n>.pt.trace.json``
(Perfetto, ``chrome://tracing``, or TensorBoard's PyTorch profiler plugin
read it).  Rank-gated like every observability feature of the reference:
only rank 0 traces unless ``all_ranks``.
"""

from __future__ import annotations

import contextlib
import itertools
import os

import torch

from horovod_tpu_torch import basics

_count = itertools.count()


def _rank() -> int:
    return basics.rank() if basics.is_initialized() else 0


@contextlib.contextmanager
def trace(path: str, *, all_ranks: bool = False):
    """Profile the block (host ops and, with a card, its kernels) and write
    its Chrome trace under ``path``; rank 0 only unless ``all_ranks``.
    Yields the ``torch.profiler.profile``, or None where this rank does
    not trace."""
    if not (all_ranks or _rank() == 0):
        yield None
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(path, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        path, f"rank{_rank()}.{os.getpid()}.{next(_count)}.pt.trace.json"))


def annotate(name: str):
    """A named span inside a trace (``torch.profiler.record_function``)."""
    return torch.profiler.record_function(name)
