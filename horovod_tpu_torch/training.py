"""Training API — counterpart of ``horovod_tpu/training.py``, with the
interface of ``horovod_tpu/torch/optimizer.py``.

* :func:`DistributedOptimizer` wraps a ``torch.optim.Optimizer`` so that
  ``step()`` applies every gradient averaged across the processes, through
  fused flat buckets; where the schedule planner chains the buckets
  (``ops/schedule_plan.py``), each bucket's allreduce starts during
  backward, as soon as its last gradient exists.
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
from horovod_tpu_torch.ops import collective_ops, schedule_plan
from horovod_tpu_torch.ops.compression import Compression


def DistributedOptimizer(optimizer: torch.optim.Optimizer,
                         named_parameters=None,
                         compression=Compression.none,
                         backward_passes_per_step: int = 1,
                         threshold_bytes: int | None = None,
                         overlap_buckets: int | None = None,
                         planner=None):
    """Wrap ``optimizer`` so ``step()`` applies gradients averaged over
    every process.

    ``named_parameters`` (``model.named_parameters()``) is checked as the
    reference checks it: no duplicate names, and every parameter of the
    optimizer named.  ``compression`` casts the gradients to the wire
    dtype around the collective; ``threshold_bytes`` bounds a fused
    bucket (default ``HOROVOD_FUSION_THRESHOLD``).

    Overlap is the schedule planner's decision (``ops/schedule_plan.py``),
    made at the first ``step()`` from the parameters' manifest, the number
    of processes and the device headroom; ``overlap_buckets`` (or a set
    ``HOROVOD_OVERLAP_BUCKETS``; 0 disables, N pins N buckets) overrides
    the planner, ``planner=`` replaces it, and ``overlap_plan()`` reports
    it.  When the plan is chained, every parameter gets a
    post-accumulate-grad hook, and each bucket's allreduce is issued as
    soon as its last gradient has arrived, while backward goes on: the
    buckets are the gradients in reverse order (the order backward
    produces them), and they are issued strictly in that order, so every
    process issues the same sequence of collectives whatever order its
    hooks fire in.  ``step()`` issues any bucket still pending (zeros for
    a parameter that got no gradient), waits, and steps.  The first step
    plans, so it reduces at ``step()``; the hooks overlap from the second
    on.  Otherwise (the bypass, e.g. at width 1) no hook is registered
    and ``step()`` reduces every gradient in one fused pass.

    ``backward_passes_per_step`` is the number of backward passes the
    caller runs before each ``step()``: the gradients they add up in
    ``.grad`` are averaged once, after the last pass (the hooks count
    their firings), so any count gives the reference's result.  A second
    allreduce of one gradient before ``step()`` raises.
    """
    return _DistributedOptimizer(optimizer, named_parameters, compression,
                                 backward_passes_per_step, threshold_bytes,
                                 overlap_buckets, planner)


class _DistributedOptimizer:
    """Proxy over the wrapped optimizer: :meth:`synchronize` and
    :meth:`step` are its own, everything else is the wrapped one's."""

    def __init__(self, optimizer, named_parameters, compression,
                 backward_passes_per_step, threshold_bytes, overlap_buckets,
                 planner):
        if backward_passes_per_step < 1:
            raise ValueError("backward_passes_per_step must be >= 1")
        params = [p for g in optimizer.param_groups for p in g["params"]]
        names = {}
        if named_parameters is not None:
            named = list(named_parameters)
            if len({n for n, _ in named}) != len(named):
                raise ValueError("named_parameters contains duplicate names")
            if {id(p) for p in params} - {id(p) for _, p in named}:
                raise ValueError("named_parameters was given, but one or "
                                 "more parameters of the optimizer are not "
                                 "named")
            names = {id(p): n for n, p in named}
        self._opt = optimizer
        self._params = [p for p in params if p.requires_grad]
        self._names = [names.get(id(p), f"param.{i}")
                       for i, p in enumerate(self._params)]
        self._compression = compression
        self._threshold_bytes = threshold_bytes
        self._bpps = backward_passes_per_step
        self._overlap_buckets = overlap_buckets
        self._planner = planner
        self._plan = None
        # The chained plan's state: buckets of parameter indices in issue
        # order, each parameter's bucket, the hook firings and arrivals of
        # this step, the next bucket to issue, and the handles issued.
        self._buckets: list[list[int]] = []
        self._bucket_of: list[int] = []
        self._fires = [0] * len(self._params)
        self._arrived: set[int] = set()
        self._missing: list[int] = []
        self._next = 0
        self._handles: list = []
        self._hooks: list = []

    def _make_plan(self):
        wire = [self._compression.compress(p.detach())[0]
                for p in self._params]
        self._plan = schedule_plan.plan_overlap(
            wire, width=basics.size(), override=self._overlap_buckets,
            planner=self._planner)
        if not self._plan.chained:
            return
        self._buckets = collective_ops.plan_bucket_indices(
            len(self._params), self._plan)
        self._bucket_of = [0] * len(self._params)
        for b, idx in enumerate(self._buckets):
            for i in idx:
                self._bucket_of[i] = b
        self._missing = [len(idx) for idx in self._buckets]
        self._hooks = [p.register_post_accumulate_grad_hook(self._hook(i))
                       for i, p in enumerate(self._params)]

    def _hook(self, i: int):
        def hook(p):
            self._fires[i] += 1
            if self._fires[i] < self._bpps:
                return
            self._fires[i] = 0
            if i in self._arrived:
                raise AssertionError(
                    f"Gradient for {self._names[i]} was allreduced twice "
                    f"before step(); for gradient accumulation pass "
                    f"backward_passes_per_step.")
            self._arrived.add(i)
            self._missing[self._bucket_of[i]] -= 1
            # Strictly in plan order: a bucket complete before an earlier
            # one waits for it.
            while (self._next < len(self._buckets)
                   and not self._missing[self._next]):
                self._issue(self._next)
        return hook

    def _issue(self, b: int) -> None:
        params = [self._params[i] for i in self._buckets[b]]
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        self._handles.append((params, collective_ops.grouped_allreduce_async(
            [p.grad for p in params], average=True,
            compression=self._compression,
            threshold_bytes=self._threshold_bytes)))
        self._next = b + 1

    def synchronize(self) -> None:
        """Average every parameter's ``.grad`` across the processes, in
        place.  A parameter without a gradient contributes zeros, so every
        process runs the same collectives."""
        if self._plan is None:
            self._make_plan()
        if not self._plan.chained:
            for p in self._params:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            grads = [p.grad for p in self._params]
            reduced = collective_ops.fused_allreduce(
                grads, average=True, compression=self._compression,
                threshold_bytes=self._threshold_bytes)
            with torch.no_grad():
                for g, r in zip(grads, reduced):
                    g.copy_(r)
            return
        while self._next < len(self._buckets):
            self._issue(self._next)
        with torch.no_grad():
            for params, handle in self._handles:
                for p, r in zip(params, collective_ops.synchronize(handle)):
                    p.grad.copy_(r)
        # A step ends the accumulation window, whatever the passes seen.
        self._handles.clear()
        self._arrived.clear()
        self._fires = [0] * len(self._params)
        self._missing = [len(idx) for idx in self._buckets]
        self._next = 0

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
