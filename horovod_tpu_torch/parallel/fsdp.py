"""FSDP / ZeRO-3 — parameters, gradients and optimizer state sharded over
the data-parallel processes; counterpart of ``horovod_tpu/parallel/fsdp.py``.

The JAX package writes FSDP as sharding annotations and lets XLA insert
the gathers and the gradient scatters.  The port inserts them itself:

* :func:`fsdp_spec` / :func:`fsdp_shardings` choose, for each parameter,
  the dimension it is sharded on (the JAX package's rule, kept as a copy:
  the largest dimension the number of shards divides, the earliest on a
  tie; a parameter below ``min_size`` elements, a scalar, or one with no
  such dimension is replicated);
* :func:`fsdp_device_put` replaces each sharded parameter of a model by
  this rank's shard, in place, and makes the model's forward gather them
  unit by unit: every module of ``units`` (a transformer's blocks) is one
  unit, and the model itself, with the parameters outside them
  (embedding, final norm, head), the root.

A unit's shards are all-gathered along their dimensions just before its
forward and the gathered tensors dropped just after it.  What autograd
would save of a gathered weight (the weight, its cast to the compute
dtype, a transposed view of it) is packed instead as a note of its shard
(``torch.autograd.graph.saved_tensors_hooks``) and gathered again when the
backward pass needs it, so no gathered weight lives from the forward to
the backward.  The gradient of a gathered weight is reduce-scattered onto
its shard, averaged; a replicated parameter's is averaged by an
allreduce.  The optimizer, built after :func:`fsdp_device_put`, steps the
shards: its state is sharded alike.
"""

from __future__ import annotations

import weakref

import numpy as np
import torch
from torch import nn

from horovod_tpu_torch.parallel.common import (all_gather, all_reduce,
                                               group_rank, group_size,
                                               reduce_scatter)

# Leaves smaller than this many elements stay replicated: gathering a bias
# vector costs a collective launch a step and saves nothing material.
DEFAULT_MIN_SIZE = 1024

# Autograd nodes that only view or cast their one input: a saved tensor
# reached from a gather through these is the gathered weight, re-laid.
_VIEWS = frozenset(("ToCopyBackward0", "TBackward0", "TransposeBackward0",
                    "PermuteBackward0", "ViewBackward0", "AliasBackward0",
                    "UnsafeViewBackward0", "ExpandBackward0"))


def fsdp_spec(shape, n_shards: int,
              min_size: int = DEFAULT_MIN_SIZE) -> int | None:
    """The dimension of ``shape`` to shard over ``n_shards``, or ``None``
    to replicate: the largest dimension ``n_shards`` divides (ties to the
    earliest); scalars, leaves below ``min_size`` elements and leaves with
    no divisible dimension replicate."""
    shape = tuple(shape)
    size = int(np.prod(shape, dtype=np.int64)) if shape else 1
    if n_shards <= 1 or size < max(min_size, 1):
        return None
    best = None
    for d, extent in enumerate(shape):
        if extent % n_shards == 0 and (best is None or extent > shape[best]):
            best = d
    return best


def fsdp_shardings(model: nn.Module, group=None,
                   min_size: int = DEFAULT_MIN_SIZE) -> dict:
    """``{parameter name: dimension or None}`` for every parameter of
    ``model`` over ``group`` (``None``: the world)."""
    n = group_size(group)
    return {name: fsdp_spec(p.shape, n, min_size)
            for name, p in model.named_parameters()}


class _Gather(torch.autograd.Function):
    """A shard's gathered tensor forward; the gradient reduce-scattered back
    onto the shard and averaged."""

    @staticmethod
    def forward(ctx, shard, dim, group):
        ctx.dim, ctx.group = dim, group
        return all_gather(shard, group, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        k = group_size(ctx.group)
        return reduce_scatter(g, ctx.group, ctx.dim) / k, None, None


class _Replicated(torch.autograd.Function):
    """A replicated parameter: itself forward, its gradient averaged over
    the group."""

    @staticmethod
    def forward(ctx, p, group):
        ctx.group = group
        return p.view_as(p)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group) / group_size(ctx.group), None


class _Regather:
    """A saved tensor that was a gathered weight: gathered again on
    unpack, and laid out as it was."""

    def __init__(self, fsdp, leaf, t):
        self.fsdp, self.leaf = fsdp, leaf
        self.dtype, self.size = t.dtype, t.size()
        self.stride, self.offset = t.stride(), t.storage_offset()

    def __call__(self):
        _, _, shard, dim = self.leaf
        self.fsdp.regathers += 1
        with torch.no_grad():
            full = all_gather(shard, self.fsdp.group, dim).contiguous()
        return full.to(self.dtype).as_strided(self.size, self.stride,
                                              self.offset)


class FSDP:
    """The sharding of one model (:func:`fsdp_device_put`): ``units`` of
    ``(module, [(owner, name, shard, dim)])``, the last one the root."""

    def __init__(self, model, shardings, group, units):
        self.group = group
        self.k, self.rank = group_size(group), group_rank(group)
        self.gathers = self.regathers = 0
        self._nodes: dict = {}
        self._alive: list = []
        owner_of = {}
        for unit in units:
            for name, p in unit.named_parameters():
                owner_of.setdefault(id(p), unit)
        leaves: dict = {id(u): [] for u in list(units) + [model]}
        named = dict(model.named_parameters())
        for mod_name, mod in model.named_modules():
            for attr, p in list(mod._parameters.items()):
                if p is None:
                    continue
                full_name = f"{mod_name}.{attr}" if mod_name else attr
                dim = shardings.get(full_name)
                if full_name not in named:
                    continue
                if dim is not None:
                    p = nn.Parameter(p.detach().chunk(self.k, dim)[
                        self.rank].clone(), requires_grad=p.requires_grad)
                    mod._parameters[attr] = p
                unit = owner_of.get(id(named[full_name]), model)
                leaves[id(unit)].append((mod, attr, p, dim))
        self.units = [(u, leaves[id(u)]) for u in list(units) + [model]]
        for u, unit_leaves in self.units:
            u.register_forward_pre_hook(self._pre(unit_leaves))
            u.register_forward_hook(self._post(unit_leaves))
        self._hooks = torch.autograd.graph.saved_tensors_hooks(
            self._pack, self._unpack)
        model.register_forward_pre_hook(self._begin, prepend=True)
        model.register_forward_hook(self._end)

    def _begin(self, module, args):
        self._alive.clear()
        self._hooks.__enter__()

    def _end(self, module, args, out):
        # Packing happens during the forward only: the nodes can go.
        self._hooks.__exit__(None, None, None)
        self._nodes.clear()

    def _pre(self, leaves):
        def hook(module, args):
            for leaf in leaves:
                owner, attr, shard, dim = leaf
                if dim is None:
                    full = _Replicated.apply(shard, self.group)
                else:
                    full = _Gather.apply(shard, dim, self.group)
                    self.gathers += 1
                    self._alive.append(weakref.ref(full))
                    if full.grad_fn is not None:
                        self._nodes[full.grad_fn] = leaf
                owner._parameters[attr] = full
        return hook

    def _post(self, leaves):
        def hook(module, args, out):
            for owner, attr, shard, _ in leaves:
                owner._parameters[attr] = shard
        return hook

    def _pack(self, t):
        node = t.grad_fn
        for _ in range(len(_VIEWS) + 1):
            if node is None:
                break
            leaf = self._nodes.get(node)
            if leaf is not None:
                return _Regather(self, leaf, t)
            if node.name() not in _VIEWS:
                break
            node = node.next_functions[0][0]
        # Not the tensor itself: a saved output holding its own node would
        # be a reference cycle, freed only by the garbage collector.
        return t.detach()

    @staticmethod
    def _unpack(x):
        return x() if isinstance(x, _Regather) else x

    def gathered_alive(self) -> int:
        """The last forward's gathered tensors still alive (none once it
        returned)."""
        return sum(r() is not None for r in self._alive)


def fsdp_device_put(model: nn.Module, shardings: dict, group=None,
                    units=()) -> FSDP:
    """Shard ``model``'s parameters in place over ``group`` (``None``: the
    world) as ``shardings`` (:func:`fsdp_shardings`) says, and gather them
    unit by unit in its forward: each module of ``units`` is a unit, the
    model with the rest the root.  Build the optimizer afterwards, over
    ``model.parameters()``: the shards."""
    return FSDP(model, shardings, group, list(units))
