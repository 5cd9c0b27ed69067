"""Training API — counterpart of ``horovod_tpu/training.py``, with the
interface of ``horovod_tpu/torch/optimizer.py``.

* :func:`DistributedOptimizer` wraps a ``torch.optim.Optimizer`` so that
  ``step()`` first averages every gradient across the processes through
  fused flat buckets (:func:`~horovod_tpu_torch.ops.collective_ops.grouped_allreduce`),
  then runs the wrapped step.
* :func:`broadcast_parameters`, :func:`broadcast_optimizer_state` and
  :func:`broadcast_object` bring every process to the root's state.
* :func:`scale_learning_rate` is the linear-scaling rule.

Averaging gradients (not summing them) keeps hyperparameters comparable to
training on one card; scale the learning rate by ``num_chips()`` for the
linear-scaling recipe.
"""

from __future__ import annotations

import pickle

import torch
from torch import nn

from horovod_tpu_torch import basics
from horovod_tpu_torch.ops import collective_ops
from horovod_tpu_torch.ops.compression import Compression


def DistributedOptimizer(optimizer: torch.optim.Optimizer,
                         named_parameters=None,
                         compression=Compression.none,
                         backward_passes_per_step: int = 1,
                         threshold_bytes: int | None = None):
    """Wrap ``optimizer`` so ``step()`` applies gradients averaged over
    every process.

    ``named_parameters`` (``model.named_parameters()``) is checked as the
    reference checks it: no duplicate names, and every parameter of the
    optimizer named.  ``backward_passes_per_step`` is the number of
    backward passes the caller runs before each ``step()``: the gradients
    they add up in ``.grad`` are averaged once, at the step, so any count
    gives the reference's result.  ``compression`` casts the gradients to
    the wire dtype around the collective; ``threshold_bytes`` bounds a
    fused bucket (default ``HOROVOD_FUSION_THRESHOLD``).
    """
    return _DistributedOptimizer(optimizer, named_parameters, compression,
                                 backward_passes_per_step, threshold_bytes)


class _DistributedOptimizer:
    """Proxy over the wrapped optimizer: :meth:`synchronize` and
    :meth:`step` are its own, everything else is the wrapped one's."""

    def __init__(self, optimizer, named_parameters, compression,
                 backward_passes_per_step, threshold_bytes):
        if backward_passes_per_step < 1:
            raise ValueError("backward_passes_per_step must be >= 1")
        params = [p for g in optimizer.param_groups for p in g["params"]]
        if named_parameters is not None:
            named = list(named_parameters)
            names = [n for n, _ in named]
            if len(set(names)) != len(names):
                raise ValueError("named_parameters contains duplicate names")
            if {id(p) for p in params} - {id(p) for _, p in named}:
                raise ValueError("named_parameters was given, but one or "
                                 "more parameters of the optimizer are not "
                                 "named")
        self._opt = optimizer
        self._params = [p for p in params if p.requires_grad]
        self._compression = compression
        self._threshold_bytes = threshold_bytes

    def synchronize(self) -> None:
        """Average every parameter's ``.grad`` across the processes, in
        place.  A parameter without a gradient contributes zeros, so every
        process runs the same collectives."""
        for p in self._params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in self._params]
        reduced = collective_ops.grouped_allreduce(
            grads, average=True, compression=self._compression,
            threshold_bytes=self._threshold_bytes)
        with torch.no_grad():
            for g, r in zip(grads, reduced):
                g.copy_(r)

    def step(self, closure=None):
        self.synchronize()
        return self._opt.step(closure)

    def __getattr__(self, name):
        if name == "_opt":   # not set yet: no recursion
            raise AttributeError(name)
        return getattr(self._opt, name)

    def __repr__(self):
        return f"DistributedOptimizer({self._opt!r})"


def broadcast_parameters(params, root_rank: int = 0) -> None:
    """Overwrite, in place, every tensor of ``params`` (an ``nn.Module``,
    whose ``state_dict`` holds its parameters and buffers, or a
    ``state_dict``) with ``root_rank``'s values."""
    if basics.size() == 1:
        return
    sd = params.state_dict() if isinstance(params, nn.Module) else params
    with torch.no_grad():
        for t in sd.values():
            t.copy_(collective_ops.broadcast(t, root_rank))


def _to_cpu(obj):
    if isinstance(obj, torch.Tensor):
        return obj.cpu()
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


def broadcast_optimizer_state(optimizer, root_rank: int = 0) -> None:
    """Load ``root_rank``'s optimizer state (moments, step counts and
    hyperparameters) into ``optimizer`` on every process."""
    if basics.size() == 1:
        return
    state = broadcast_object(
        _to_cpu(optimizer.state_dict()) if basics.rank() == root_rank
        else None, root_rank)
    optimizer.load_state_dict(state)


def broadcast_object(obj, root_rank: int = 0):
    """``root_rank``'s picklable ``obj`` on every process: pickled to a
    byte tensor, its length broadcast, then its bytes."""
    if basics.size() == 1:
        return obj
    dev = basics.device()
    if basics.rank() == root_rank:
        payload = torch.frombuffer(bytearray(pickle.dumps(obj)),
                                   dtype=torch.uint8).to(dev)
        n = torch.tensor([payload.numel()], device=dev)
    else:
        n = torch.zeros(1, dtype=torch.int64, device=dev)
    n = int(collective_ops.broadcast(n, root_rank))
    if basics.rank() != root_rank:
        payload = torch.empty(n, dtype=torch.uint8, device=dev)
    payload = collective_ops.broadcast(payload, root_rank)
    return pickle.loads(payload.cpu().numpy().tobytes())


def scale_learning_rate(lr: float, backward_passes_per_step: int = 1) -> float:
    """Linear learning-rate scaling by the number of cards."""
    return lr * basics.num_chips() * backward_passes_per_step
