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
* :func:`master_weights` keeps parameters resident in bf16 and steps an
  f32 master copy; :func:`accumulate_gradients` runs microbatches through
  one backward each and leaves the mean gradient.
* :func:`elastic_loop` drives a step function with the fault hooks,
  checkpoints, resume and in-place elastic recovery.

Averaging gradients (not summing them) keeps hyperparameters comparable to
training on one card; scale the learning rate by ``num_chips()`` for the
linear-scaling recipe.
"""

from __future__ import annotations

import pickle
import sys
import warnings

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
                         planner=None, average: bool = True,
                         sparse_as_dense: bool = False):
    """Wrap ``optimizer`` so ``step()`` applies gradients averaged over
    every process (summed with ``average=False``).

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

    ``compression=Compression.int8`` sends every gradient over the int8
    wire (``collective_ops.quantized_grouped_allreduce``) at ``step()``,
    with error feedback: each parameter's quantization residual is kept
    (in the gradient's dtype, so bf16 under :func:`master_weights`),
    added to the next step's gradient, and carried in ``state_dict()``
    under ``"error_feedback"``, as the JAX package's
    ``DistributedEFState`` does.  That route does not overlap.

    A sparse gradient (``nn.Embedding(sparse=True)``) is all-gathered as
    values and row indices (``collective_ops.allreduce_sparse``), not
    summed, and ``.grad`` becomes their sum as a coalesced sparse tensor;
    ``sparse_as_dense=True`` densifies it first instead, as the
    reference's ``horovod/torch`` optimizer does.  Which gradients are
    sparse is read at the first ``step()``.
    """
    return _DistributedOptimizer(optimizer, named_parameters, compression,
                                 backward_passes_per_step, threshold_bytes,
                                 overlap_buckets, planner, average,
                                 sparse_as_dense)


class _DistributedOptimizer:
    """Proxy over the wrapped optimizer: :meth:`synchronize` and
    :meth:`step` are its own, everything else is the wrapped one's."""

    def __init__(self, optimizer, named_parameters, compression,
                 backward_passes_per_step, threshold_bytes, overlap_buckets,
                 planner, average, sparse_as_dense):
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
        # The int8 wire is a format, not a cast: every dense gradient goes
        # through quantized_grouped_allreduce at step(), outside the
        # planner, as the JAX package's int8 branch does.
        self._int8 = compression is Compression.int8
        self._threshold_bytes = threshold_bytes
        self._bpps = backward_passes_per_step
        self._overlap_buckets = overlap_buckets
        self._planner = planner
        self._average = average
        self._sparse_as_dense = sparse_as_dense
        # Indices of the parameters whose gradients are sparse (read at the
        # first step) and of the rest, and the int8 wire's residuals.
        self._sparse: list[int] = []
        self._dense: list[int] = []
        self._errors: list | None = None
        self._planned = False
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
        self._sparse = [i for i, p in enumerate(self._params)
                        if p.grad is not None and p.grad.is_sparse
                        and not self._sparse_as_dense]
        self._dense = [i for i in range(len(self._params))
                       if i not in self._sparse]
        self._planned = True
        if self._int8:
            return
        wire = [self._compression.compress(self._params[i].detach())[0]
                for i in self._dense]
        self._plan = schedule_plan.plan_overlap(
            wire, width=basics.size(), override=self._overlap_buckets,
            planner=self._planner)
        if not self._plan.chained:
            return
        self._buckets = [[self._dense[j] for j in b]
                         for b in collective_ops.plan_bucket_indices(
                             len(self._dense), self._plan)]
        self._bucket_of = [0] * len(self._params)
        for b, idx in enumerate(self._buckets):
            for i in idx:
                self._bucket_of[i] = b
        self._missing = [len(idx) for idx in self._buckets]
        self._hooks = [self._params[i].register_post_accumulate_grad_hook(
                           self._hook(i)) for i in self._dense]

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

    def _dense_grads(self, idx) -> list:
        """The gradients of parameters ``idx``, zeros where there is none
        and dense where ``sparse_as_dense`` asks for it."""
        for i in idx:
            p = self._params[i]
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            elif p.grad.is_sparse:
                p.grad = p.grad.to_dense()
        return [self._params[i].grad for i in idx]

    def _issue(self, b: int) -> None:
        params = [self._params[i] for i in self._buckets[b]]
        grads = self._dense_grads(self._buckets[b])
        self._handles.append((params, collective_ops.grouped_allreduce_async(
            grads, average=self._average, compression=self._compression,
            threshold_bytes=self._threshold_bytes)))
        self._next = b + 1

    def _reduce_sparse(self) -> None:
        for i in self._sparse:
            p = self._params[i]
            if p.grad is None:
                p.grad = torch.sparse_coo_tensor(
                    torch.zeros((p.dim(), 0), dtype=torch.long,
                                device=p.device),
                    p.new_zeros((0,) + tuple(p.shape[1:])), p.shape)
            g = p.grad.coalesce()
            values, rows = collective_ops.allreduce_sparse(
                g.values(), g.indices()[0], average=self._average)
            p.grad = torch.sparse_coo_tensor(rows[None], values,
                                             p.shape).coalesce()

    def synchronize(self) -> None:
        """Average every parameter's ``.grad`` across the processes, in
        place.  A parameter without a gradient contributes zeros, so every
        process runs the same collectives."""
        if not self._planned:
            self._make_plan()
        self._reduce_sparse()
        if self._int8:
            grads = self._dense_grads(self._dense)
            reduced, self._errors = \
                collective_ops.quantized_grouped_allreduce(
                    grads, self._errors, average=self._average)
            with torch.no_grad():
                for g, r in zip(grads, reduced):
                    g.copy_(r)
            return
        if not self._plan.chained:
            grads = self._dense_grads(self._dense)
            reduced = collective_ops.fused_allreduce(
                grads, average=self._average, compression=self._compression,
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

    def state_dict(self):
        """The wrapped optimizer's ``state_dict``, and under the int8 wire
        the error-feedback residuals (``"error_feedback"``, one a dense
        parameter, or None before the first step)."""
        sd = self._opt.state_dict()
        if self._int8:
            sd = {**sd, "error_feedback": self._errors}
        return sd

    def load_state_dict(self, state_dict):
        """Load a ``state_dict``, across compression modes as the JAX
        package's checkpoint restore migrates ``DistributedState`` <->
        ``DistributedEFState``: a state saved without the int8 wire's
        residuals starts them fresh (zero), and one saved with them into
        an optimizer without the int8 wire drops them; both with a
        warning."""
        state_dict = dict(state_dict)
        saved_ef = "error_feedback" in state_dict
        errors = state_dict.pop("error_feedback", None)
        self._opt.load_state_dict(state_dict)
        if self._int8 and not saved_ef:
            warnings.warn(
                "restored a checkpoint saved without int8 error feedback "
                "into an EF optimizer: residuals initialized to zero (fresh "
                "EF start)")
        elif saved_ef and not self._int8 and errors is not None:
            warnings.warn(
                f"restored a checkpoint saved with int8 error feedback into "
                f"a plain optimizer: {len(errors)} residual(s) dropped")
        if self._int8:
            self._errors = None if errors is None else [
                e.to(self._params[0].device) for e in errors]

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


class _MasterWeights(torch.optim.Optimizer):
    """The optimizer :func:`master_weights` returns."""

    def __init__(self, optimizer: torch.optim.Optimizer, master_dtype):
        params = [p for g in optimizer.param_groups for p in g["params"]]
        if not params:
            raise ValueError("master_weights requires params: the wrapped "
                             "optimizer holds none")
        groups = [{**g, "params": list(g["params"])}
                  for g in optimizer.param_groups]
        super().__init__(groups, dict(optimizer.defaults))
        self._inner = optimizer
        self._master_dtype = master_dtype
        masters = {}
        for g in optimizer.param_groups:
            g["params"] = [masters.setdefault(
                p, p.detach().to(master_dtype, copy=True)) for p in g["params"]]
        # State the inner optimizer already holds follows its parameter.
        for p in list(optimizer.state):
            optimizer.state[masters[p]] = optimizer.state.pop(p)

    def masters(self) -> list:
        """The master copies, in the order of :attr:`param_groups`."""
        return [m for g in self._inner.param_groups for m in g["params"]]

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group, inner in zip(self.param_groups,
                                self._inner.param_groups):
            inner.update({k: v for k, v in group.items() if k != "params"})
            for p, m in zip(group["params"], inner["params"]):
                m.grad = None if p.grad is None else \
                    p.grad.to(self._master_dtype)
        self._inner.step()
        for group, inner in zip(self.param_groups,
                                self._inner.param_groups):
            for p, m in zip(group["params"], inner["params"]):
                m.grad = None
                # The JAX package's delta form, in p's dtype.
                p.add_(m.to(p.dtype) - p)
        return loss

    def state_dict(self):
        sd = self._inner.state_dict()
        sd["param_groups"] = super().state_dict()["param_groups"]
        sd["master"] = [m.detach().clone() for m in self.masters()]
        return sd

    def load_state_dict(self, state_dict):
        state_dict = dict(state_dict)
        masters = state_dict.pop("master")
        super().load_state_dict({"state": {},
                                 "param_groups": state_dict["param_groups"]})
        self._inner.load_state_dict(state_dict)
        with torch.no_grad():
            for m, saved in zip(self.masters(), masters):
                m.copy_(saved)

    def __repr__(self):
        return f"master_weights({self._inner!r})"


def master_weights(optimizer: torch.optim.Optimizer,
                   master_dtype=torch.float32) -> torch.optim.Optimizer:
    """Mixed precision: parameters resident in their low-precision dtype
    (a model built with ``param_dtype=torch.bfloat16``), an f32 master copy
    of each stepped by ``optimizer`` — the JAX package's
    ``master_weights``, as a ``torch.optim.Optimizer``.

    The returned optimizer presents the resident parameters in its own
    ``param_groups`` (so ``DistributedOptimizer`` hooks them and a learning
    rate schedule writes there) and rebinds ``optimizer`` to the master
    copies.  Each ``step()`` copies every group's hyperparameters into the
    inner groups, upcasts the gradients once, steps the masters, and lands
    each resident parameter on ``p + (bf16(master) - p)``, computed in p's
    dtype as the JAX package computes it: exactly ``bf16(master)``
    whenever the subtraction is exact (Sterbenz), else off by the delta's
    rounding, half an ulp of the update (near zero more than an ulp of
    the result), and the master carries the truth.  ``state_dict()`` carries the masters
    (``"master"``), so ``broadcast_optimizer_state`` and checkpoints
    restore them.  Compose it inside the distributed optimizer, so that
    the wire carries the bf16 gradients::

        opt = DistributedOptimizer(master_weights(torch.optim.AdamW(...)))

    With ``compression=Compression.int8`` the error-feedback residuals
    then live in bf16, the gradients' dtype."""
    return _MasterWeights(optimizer, master_dtype)


def _split(batch, n: int):
    """``batch`` (a tensor, or a tuple, list or dict of them) as ``n``
    microbatches along the leading axis."""
    if isinstance(batch, torch.Tensor):
        if batch.shape[0] % n:
            raise ValueError(f"leading axis {batch.shape[0]} not divisible "
                             f"by num_microbatches={n}")
        return list(batch.chunk(n))
    if isinstance(batch, dict):
        parts = {k: _split(v, n) for k, v in batch.items()}
        return [{k: v[i] for k, v in parts.items()} for i in range(n)]
    parts = [_split(v, n) for v in batch]
    return [type(batch)(p[i] for p in parts) for i in range(n)]


def accumulate_gradients(loss_fn, batch, num_microbatches: int):
    """Gradient accumulation: ``loss_fn(microbatch) -> scalar loss`` runs
    once per microbatch, each with its own backward, over ``batch`` (a
    tensor, or a tuple, list or dict of tensors) split into
    ``num_microbatches`` equal parts along the leading axis.  Leaves the
    mean gradient over the microbatches in ``.grad`` (add to gradients the
    caller zeroed) and returns the mean loss, detached: for a mean-reduced
    loss, the full batch's gradient, at a microbatch's activation memory.

    The JAX package sums the microbatch gradients, then scales once by
    1/n.  Here each backward is seeded with 1/n instead, so that ``.grad``
    holds the mean as the last backward ends, which is when a
    ``DistributedOptimizer`` hook issues it.  For n a power of two the
    two orders give the same bits (scaling by 2⁻ᵏ is exact); otherwise
    they differ by f32 rounding.  The loss is the JAX order: the sum,
    then one scale.

    With ``DistributedOptimizer``, pass ``backward_passes_per_step`` equal
    to ``num_microbatches``: its hooks count backward passes and average
    once, after the last."""
    if num_microbatches < 1:
        raise ValueError("num_microbatches must be >= 1")
    parts = _split(batch, num_microbatches)
    seed = 1.0 / num_microbatches
    total = None
    for mb in parts:
        loss = loss_fn(mb)
        (loss * seed).backward()
        loss = loss.detach()
        total = loss if total is None else total + loss
    return total * seed


def elastic_loop(step_fn, state, *, num_steps: int, manager=None,
                 checkpoint_every: int = 1, metadata_fn=None,
                 resume: bool = True, on_resume=None):
    """Drive ``step_fn`` with fault hooks and preemption-safe checkpoints
    — counterpart of the JAX package's ``training.elastic_loop``.

    Each step runs ``state = step_fn(step, state)`` after advancing the
    fault-injection clock (``faults.step``); every ``checkpoint_every``
    completed steps (and after the last) the ``manager``
    (``checkpoint.CheckpointManager``) records a complete checkpoint; a
    preemption signal drains a final checkpoint and exits 0, so ``python
    -m horovod_tpu_torch.run`` knows the state is durable.  ``state`` is a
    tree the manager can save: for a torch model, ``{"model":
    model.state_dict(), "optim": opt.state_dict()}``, returned anew by
    ``step_fn`` and loaded back into the live objects by ``on_resume``.

    With ``resume=True`` (default) the loop first restores the newest
    complete checkpoint (its tensors on the devices of ``state``'s) and
    continues from the step after it — restart equals continuation.
    ``on_resume(ckpt)`` (a ``checkpoint.ElasticCheckpoint``) re-seats
    whatever lives outside ``state``: the model's and optimizer's
    tensors, the data position from the resume metadata.

    Under ``HVD_TPU_ELASTIC=1`` a ``MembershipChanged`` from a step — a
    peer died and the survivors shrank, or a rank rejoined — is recovered
    without leaving the process: ``elastic.reconfigure()`` re-forms the
    engine (and fires ``on_reconfigure`` callbacks), the loop restores
    the last complete checkpoint and continues from the step after it;
    with no manager, the aborted step replays.  This serves jobs whose
    collectives run on the native engine; a job on ``torch.distributed``
    groups cannot re-form them in place and takes the launcher's full
    restart.  Without elastic mode the signal propagates like any failure.

    Returns the final state.
    """
    from horovod_tpu_torch import checkpoint as _checkpoint
    from horovod_tpu_torch import faults as _faults
    from horovod_tpu_torch import replication as _replication
    from horovod_tpu_torch.core.engine import MembershipChanged as _Resized

    def _restore_latest(manager, state):
        # A peer can die DURING the restore agreement: reconfigure and
        # retry at the new epoch instead of aborting a recoverable job.
        while True:
            try:
                return manager.restore_latest(template=state)
            except _Resized:
                from horovod_tpu_torch import elastic as _elastic

                if not _elastic.enabled():
                    raise
                _elastic.reconfigure()

    start_step = 0
    if manager is not None:
        _checkpoint.install_preemption_handler()
        if resume:
            ckpt = _restore_latest(manager, state)
            if ckpt is not None:
                state = ckpt.state
                start_step = ckpt.step + 1
                if on_resume is not None:
                    on_resume(ckpt)

    def _metadata(step):
        md = {"step": step}
        if metadata_fn is not None:
            md.update(metadata_fn(step))
        return md

    def _drain_exit(step, state):
        if step >= 0:  # step -1 == preempted before any step completed
            manager.save(step, state, metadata=_metadata(step))
        manager.drain()
        sys.exit(0)

    step = start_step
    while step < num_steps:
        if manager is not None and _checkpoint.preemption_requested():
            _drain_exit(step - 1, state)
        if _replication.enabled():
            # Pump relayed shards into the host-memory replica store every
            # step: a restore after a peer dies can only use what this
            # rank already drained.
            _replication.drain()
        _faults.step(step)
        try:
            state = step_fn(step, state)
        except _Resized:
            from horovod_tpu_torch import elastic as _elastic

            if not _elastic.enabled():
                raise
            # In-place recovery: re-form the engine under the new
            # membership, then resume from the last complete checkpoint so
            # every surviving rank re-enters the step sequence at the same
            # point with matching collective names.
            _elastic.reconfigure()
            if manager is not None:
                ckpt = _restore_latest(manager, state)
                if ckpt is not None:
                    state = ckpt.state
                    step = ckpt.step + 1
                    if on_resume is not None:
                        on_resume(ckpt)
                    continue
            # No checkpoint to rewind to: the failed step's collectives
            # were aborted before completing, so replaying it is safe.
            continue
        except Exception:
            # A peer that drained on the same preemption signal tears the
            # collectives down under us; when OUR flag is up too, that
            # failure IS the drain.  Anything else propagates.
            if manager is not None and _checkpoint.preemption_requested():
                _drain_exit(step - 1, state)
            raise
        if manager is not None:
            if _checkpoint.preemption_requested():
                _drain_exit(step, state)
            if (step + 1) % max(checkpoint_every, 1) == 0 \
                    or step == num_steps - 1:
                manager.save(step, state, metadata=_metadata(step))
        step += 1
    if manager is not None:
        manager.drain()
    return state
