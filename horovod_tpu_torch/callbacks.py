"""Training-loop callbacks — counterpart of ``horovod_tpu/callbacks.py``
(the reference's Keras callback family), for PyTorch loops.

Loops call the hooks at the points Keras does::

    cbs = [BroadcastGlobalVariablesCallback(0), MetricAverageCallback(),
           LearningRateWarmupCallback(initial_lr, warmup_epochs=5)]
    state = run_callbacks(cbs, "on_train_begin", state)

As in the JAX package, a hook takes the training state and returns it:
here any object with ``.model`` (an ``nn.Module``, or a ``state_dict``)
and, optionally, ``.optimizer`` (a ``torch.optim.Optimizer``, or the
``DistributedOptimizer`` over one).  PyTorch state is mutable, so the hooks
update it in place and return the same object.  The learning-rate
callbacks publish the rate through ``lr()`` and write it into every group
of ``state.optimizer``.

Momentum correction: torch's SGD keeps an LR-free momentum buffer
(``buf = m·buf + g``, the step ``-lr·buf``), as optax's ``trace`` does,
so the JAX package's rule carries over unchanged: with
``momentum_correction=True`` (the default) the trajectory already is the
corrected one of "Accurate, Large Minibatch SGD" §2.1 and nothing is
rescaled; with ``False`` each ``momentum_buffer`` is scaled by old/new on
a jump, which reproduces the reference's uncorrected Keras trajectory.

:class:`PreemptionCheckpointCallback` ties a callback loop to the fault
clock and to a ``checkpoint.CheckpointManager``, as the JAX package's
does.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from horovod_tpu_torch import basics, faults, training
from horovod_tpu_torch.ops import collective_ops


class Callback:
    """Hook points mirror ``keras.callbacks.Callback``."""

    def on_train_begin(self, state):
        return state

    def on_epoch_begin(self, epoch: int, state):
        return state

    def on_batch_begin(self, batch: int, state):
        return state

    def on_epoch_end(self, epoch: int, state, logs: dict | None = None):
        return state


def run_callbacks(callbacks, hook: str, state, *args, **kwargs):
    for cb in callbacks:
        state = getattr(cb, hook)(*args, state, **kwargs) if args else \
            getattr(cb, hook)(state, **kwargs)
    return state


class BroadcastGlobalVariablesCallback(Callback):
    """At train begin, ``root_rank``'s parameters (and optimizer state)
    on every process."""

    def __init__(self, root_rank: int = 0):
        self.root_rank = root_rank

    def on_train_begin(self, state):
        training.broadcast_parameters(state.model, self.root_rank)
        if getattr(state, "optimizer", None) is not None:
            training.broadcast_optimizer_state(state.optimizer,
                                               self.root_rank)
        return state


class MetricAverageCallback(Callback):
    """Average the epoch-end metric logs over all processes, in place:
    every number (and 0-d array or tensor) is allreduced in f32, so that
    rank 0's logging and checkpoint decisions see global values; other
    entries are left alone."""

    def on_epoch_end(self, epoch: int, state, logs: dict | None = None):
        if logs:
            for k, v in list(logs.items()):
                if isinstance(v, (int, float, np.floating, np.integer)) or (
                        hasattr(v, "ndim") and getattr(v, "ndim", 1) == 0):
                    t = torch.tensor(float(v), dtype=torch.float32,
                                     device=basics.device())
                    logs[k] = float(collective_ops.allreduce(t,
                                                             average=True))
        return state


def apply_momentum_correction(optimizer, factor: float) -> None:
    """Scale every ``momentum_buffer`` of ``optimizer`` by ``factor``, in
    place (after an LR jump, the uncorrected trajectory).  Under
    ``master_weights`` the buffers are the inner optimizer's, keyed by the
    masters: the walk goes down to it (``DistributedOptimizer`` forwards
    the lookup)."""
    if factor == 1.0:
        return
    while isinstance(getattr(optimizer, "_inner", None),
                     torch.optim.Optimizer):
        optimizer = optimizer._inner
    with torch.no_grad():
        for st in optimizer.state.values():
            buf = st.get("momentum_buffer")
            if buf is not None:
                buf.mul_(factor)


class _LRCallback(Callback):
    """Base of the LR callbacks: owns the published LR."""

    def __init__(self, initial_lr: float, momentum_correction: bool = True):
        self.initial_lr = initial_lr
        self.momentum_correction = momentum_correction
        self._current = initial_lr
        self._prev = initial_lr

    def lr(self) -> float:
        """The current LR."""
        return self._current

    def momentum_correction_factor(self) -> float:
        """The reference's Keras-form factor new_lr / old_lr: only for a
        velocity that absorbs the LR; torch's momentum buffer does not."""
        if not self.momentum_correction or self._prev == 0:
            return 1.0
        return self._current / self._prev

    def _set(self, lr: float, state=None):
        """Publish ``lr``, write it into ``state.optimizer``'s groups, and
        with ``momentum_correction=False`` scale the momentum buffers by
        old/new on a jump."""
        self._prev, self._current = self._current, lr
        opt = getattr(state, "optimizer", None)
        if opt is not None:
            for group in opt.param_groups:
                group["lr"] = lr
            if not self.momentum_correction and \
                    self._prev not in (0.0, lr):
                apply_momentum_correction(opt, self._prev / self._current)
        return state


class LearningRateScheduleCallback(_LRCallback):
    """LR = initial_lr × multiplier(epoch) inside [start_epoch,
    end_epoch); ``multiplier`` is a float or a function of the epoch;
    staircase (per epoch) or smooth (per batch, ``steps_per_epoch``)."""

    def __init__(self, initial_lr: float, multiplier,
                 start_epoch: int = 0, end_epoch: int | None = None,
                 staircase: bool = True, momentum_correction: bool = True,
                 steps_per_epoch: int | None = None):
        super().__init__(initial_lr, momentum_correction)
        self.start_epoch = start_epoch
        self.end_epoch = end_epoch
        self.staircase = staircase
        self.steps_per_epoch = steps_per_epoch
        self.multiplier = multiplier if callable(multiplier) else \
            (lambda epoch: multiplier)
        self._epoch = 0

    def _in_range(self, epoch) -> bool:
        return (epoch >= self.start_epoch
                and (self.end_epoch is None or epoch < self.end_epoch))

    def on_epoch_begin(self, epoch: int, state):
        self._epoch = epoch
        if self.staircase and self._in_range(epoch):
            state = self._set(self.initial_lr * self.multiplier(epoch), state)
        return state

    def on_batch_begin(self, batch: int, state):
        if not self.staircase and self.steps_per_epoch:
            epoch = self._epoch + batch / self.steps_per_epoch
            if self._in_range(epoch):
                state = self._set(self.initial_lr * self.multiplier(epoch),
                                  state)
        return state


class LearningRateWarmupCallback(LearningRateScheduleCallback):
    """Gradual warmup from 1× to ``num_chips()``× over ``warmup_epochs``,
    per batch: multiplier(epoch) = 1 + (size − 1)·epoch / warmup_epochs."""

    def __init__(self, initial_lr: float, warmup_epochs: int = 5,
                 momentum_correction: bool = True,
                 steps_per_epoch: int | None = None, verbose: bool = False):
        size = basics.num_chips() if basics.is_initialized() else 1

        def multiplier(epoch):
            frac = min(epoch / max(warmup_epochs, 1e-9), 1.0)
            return 1.0 + frac * (size - 1)

        super().__init__(initial_lr, multiplier, start_epoch=0,
                         end_epoch=warmup_epochs + 1, staircase=False,
                         momentum_correction=momentum_correction,
                         steps_per_epoch=steps_per_epoch or 1)
        self.verbose = verbose
        self.warmup_epochs = warmup_epochs

    def on_epoch_end(self, epoch: int, state, logs: dict | None = None):
        if self.verbose and epoch == self.warmup_epochs and \
                basics.rank() == 0:
            print(f"Epoch {epoch}: finished gradual learning rate warmup to "
                  f"{self._current}.")
        return state


def allreduce_metrics(logs: dict) -> dict:
    """:class:`MetricAverageCallback` as a function: a new dict."""
    out = dict(logs)
    MetricAverageCallback().on_epoch_end(0, None, out)
    return out


class PreemptionCheckpointCallback(Callback):
    """Elastic-training glue for callback-driven loops.

    Three duties, all at step granularity:

    * advance the fault-injection clock (``faults.step``) so injected
      kills and stalls fire deterministically in callback loops;
    * on ``checkpoint.preemption_requested()`` (SIGTERM from the
      launcher's drain), synchronously save a complete checkpoint through
      ``manager`` and exit 0 — the supervisor then knows the state is
      durable;
    * optionally checkpoint every ``save_every_n_batches`` batches in the
      background (committed at the next boundary, see
      ``CheckpointManager``).

    ``metadata_fn(step) -> dict`` supplies the resume record stored
    alongside each save.  The state handed to the hooks is what the
    manager saves: a tree such as ``{"model": model.state_dict(),
    "optim": opt.state_dict()}``.
    """

    def __init__(self, manager, *, save_every_n_batches: int | None = None,
                 metadata_fn=None, exit_on_preemption: bool = True):
        from horovod_tpu_torch import checkpoint as _checkpoint

        self.manager = manager
        self.save_every_n_batches = save_every_n_batches
        self.metadata_fn = metadata_fn
        self.exit_on_preemption = exit_on_preemption
        self._checkpoint = _checkpoint
        self._step = 0
        _checkpoint.install_preemption_handler()

    def _metadata(self) -> dict:
        md = {"step": self._step}
        if self.metadata_fn is not None:
            md.update(self.metadata_fn(self._step))
        return md

    def on_batch_begin(self, batch: int, state):
        faults.step(self._step)
        if self._checkpoint.preemption_requested():
            self.manager.save(self._step, state, metadata=self._metadata())
            self.manager.drain()
            if self.exit_on_preemption:
                sys.exit(0)
            return state
        if (self.save_every_n_batches
                and self._step % self.save_every_n_batches == 0
                and self._step > 0):
            self.manager.save(self._step, state, metadata=self._metadata(),
                              background=True)
        self._step += 1
        return state

    def on_epoch_end(self, epoch: int, state, logs: dict | None = None):
        self.manager.save(self._step, state, metadata=self._metadata())
        return state
