"""ZeRO-1 — optimizer state sharded over the data-parallel processes,
counterpart of ``horovod_tpu/parallel/zero.py``.

Every parameter's gradient goes into one flat vector, in parameter order
(mixed dtypes promote, as ``torch.cat`` and ``jnp.concatenate`` do; each
parameter gets its own dtype back), padded to a multiple of K.  A step is

    reduce_scatter(grads) -> the inner optimizer on this rank's shard
                          -> all_gather(the updated shard) -> parameters

one reduce-scatter and one all-gather, which together move the bytes of
the one allreduce they replace, while the optimizer state shrinks K-fold:
the inner optimizer holds one flat shard parameter, this rank's
contiguous 1/K of the flattened parameters, refreshed from the parameters
before each step.

The inner optimizer must be elementwise (SGD, momentum, Adam, AdamW...):
it sees only its shard, so anything that needs a reduction over every
parameter (clipping by the global norm) would act per shard.  Gradients
come in unreduced: do not wrap the optimizer in ``DistributedOptimizer``
as well, the reduce-scatter is the averaging.
"""

from __future__ import annotations

import inspect

import torch

from horovod_tpu_torch.parallel.common import (all_gather, group_rank,
                                               group_size, reduce_scatter)


def _flatten(tensors) -> torch.Tensor:
    """One flat vector of ``tensors`` in order, their dtypes promoted."""
    return torch.cat([t.reshape(-1) for t in tensors])


def _pad_to(flat: torch.Tensor, k: int) -> torch.Tensor:
    pad = (-flat.numel()) % k
    return torch.cat([flat, flat.new_zeros(pad)]) if pad else flat


class ZeroOptimizer:
    """``optimizer``'s update with its state sharded over ``group``
    (:func:`zero_optimizer`)."""

    def __init__(self, optimizer: torch.optim.Optimizer, group=None,
                 average: bool = True):
        if len(optimizer.param_groups) != 1:
            raise ValueError("zero_optimizer takes an optimizer of one "
                             "parameter group")
        self.group, self.average = group, average
        self.params = [p for p in optimizer.param_groups[0]["params"]
                       if p.requires_grad]
        self.k, self.rank = group_size(group), group_rank(group)
        self.numel = sum(p.numel() for p in self.params)
        self.chunk = -(-self.numel // self.k)
        dtype = self.params[0].dtype
        for p in self.params[1:]:
            dtype = torch.promote_types(dtype, p.dtype)
        self.shard = torch.nn.Parameter(torch.zeros(
            self.chunk, dtype=dtype, device=self.params[0].device))
        self._load_shard()
        takes = inspect.signature(type(optimizer)).parameters
        hyper = {k: v for k, v in optimizer.param_groups[0].items()
                 if k in takes and k != "params"}
        self.inner = type(optimizer)([self.shard], **hyper)

    def _load_shard(self) -> None:
        """This rank's slice of the flattened parameters into the shard
        (the padding past the last parameter stays zero)."""
        lo, off = self.rank * self.chunk, 0
        hi = lo + self.chunk
        with torch.no_grad():
            for p in self.params:
                a, b = max(lo, off), min(hi, off + p.numel())
                if a < b:
                    self.shard[a - lo:b - lo] = p.detach().reshape(-1)[
                        a - off:b - off]
                off += p.numel()

    def zero_grad(self, set_to_none: bool = True) -> None:
        for p in self.params:
            if set_to_none:
                p.grad = None
            elif p.grad is not None:
                p.grad.zero_()

    def step(self, closure=None):
        """Reduce-scatter the gradients, step the shard, all-gather the
        parameters back.  A parameter without a gradient contributes
        zeros."""
        with torch.no_grad():
            grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                     for p in self.params]
            g = reduce_scatter(_pad_to(_flatten(grads), self.k), self.group)
            if self.average:
                g = g / self.k
            self._load_shard()
            self.shard.grad = g.to(self.shard.dtype)
        loss = self.inner.step(closure)
        with torch.no_grad():
            flat = all_gather(self.shard.detach(), self.group)[:self.numel]
            off = 0
            for p in self.params:
                p.copy_(flat[off:off + p.numel()].view_as(p))
                off += p.numel()
        return loss

    def state_dict(self):
        return self.inner.state_dict()

    def load_state_dict(self, state_dict):
        self.inner.load_state_dict(state_dict)

    @property
    def param_groups(self):
        return self.inner.param_groups

    def state_bytes(self) -> int:
        """Bytes of optimizer state this rank holds."""
        return sum(t.numel() * t.element_size()
                   for s in self.inner.state.values() for t in s.values()
                   if isinstance(t, torch.Tensor))


def zero_optimizer(optimizer: torch.optim.Optimizer, group=None,
                   average: bool = True) -> ZeroOptimizer:
    """Wrap an elementwise ``optimizer`` (one parameter group) with ZeRO-1
    state sharding over ``group`` (``None``: the world): its class and
    hyperparameters step one flat shard of 1/K of the parameters on each
    rank.  ``step()`` averages the gradients (sums with ``average=False``)
    on the way."""
    return ZeroOptimizer(optimizer, group, average)
