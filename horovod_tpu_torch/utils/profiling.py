"""Device-side profiling — counterpart of ``horovod_tpu/utils/profiling.py``,
on ``torch.profiler`` where the JAX package has ``jax.profiler``.

The native timeline (``core/src/timeline.cc``, ``HOROVOD_TIMELINE``)
covers the coordination plane; the kernels, copies and collectives on the
card, and the host ops that launched them, belong to the profiler.  One
call captures them:

    from horovod_tpu_torch import profiling

    with profiling.trace("/tmp/torch-trace"):
        for _ in range(10):
            with profiling.span("train_step"):
                train_step(model, opt, x, y)

Each trace is a Chrome trace file, ``<path>/rank<r>.<pid>.<n>.pt.trace.json``
(Perfetto, ``chrome://tracing``, or TensorBoard's PyTorch profiler plugin
read it).  Rank-gated like every observability feature of the reference:
only rank 0 traces unless ``all_ranks``.

The port's own layer boundaries open :func:`span` ranges (the names are
an interface: the benchmark's per-layer metrics read them):

* training: ``train.forward``, ``train.backward`` and ``train.optimizer``
  in ``train_transformer.train_step``, ``train_synthetic.train_step`` and
  each microbatch of ``training.accumulate_gradients``;
  ``optimizer.synchronize`` (the whole averaging of
  ``DistributedOptimizer``), ``master.grads_in`` and ``master.params_out``
  (``master_weights``' casts); ``attention.flash`` (the flash kernels'
  forward and backward);
* serving: ``serve.step`` (``ServingEngine.step``), ``serve.prefill``,
  ``serve.decode`` (decode and verify), ``serve.decode_graph`` (a replay
  of the dense backend's CUDA graph of the cache step, inside
  ``serve.decode``), ``serve.to_host`` (the argmax and the copies to the
  host), ``attention.decode`` (``cached_decode_attention``, once a layer
  of each eager cache step: a replayed graph opens no span inside it),
  and the paged backend's ``paged_gather`` / ``paged_scatter``.

A span costs one boolean call and one context-manager entry while no
profiler records.
"""

from __future__ import annotations

import contextlib
import itertools
import os

import torch

from horovod_tpu_torch import basics

_count = itertools.count()
# What :func:`span` hands back while no profiler records: entering and
# leaving it does nothing, so one serves every caller and thread.
_OFF = contextlib.nullcontext()


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


def span(name: str):
    """A named range in the profiler's trace: ``with span("x"): ...``.

    A ``torch.profiler.record_function`` range where a profiler records on
    the calling thread (the autograd engine's threads inherit the caller's
    profiler state during ``backward()``), asked at every entry, so a
    profiler opened after the caller was built sees its spans; else a
    shared null context."""
    if torch._C._autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF


# The JAX package's name for the same span.
annotate = span
