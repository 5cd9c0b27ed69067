"""Shared helpers for the parallelism strategies — counterpart of
``horovod_tpu/parallel/common.py``.

:func:`shard_init_rng` gives each rank of a group its own generator, so
shards start distinct: without it every rank would draw the same values
(collapsing a tensor-parallel layer's width, making every pipeline stage
the same layer, or every expert the same expert).

The collectives below are what the JAX package's in-mesh ``lax.psum``,
``psum_scatter``, ``all_gather`` and ``all_to_all`` become: calls over a
``torch.distributed`` group (``None``: the world), each returning a new
tensor on its input's device.  On NCCL the device tensors go on the wire
as they are; on gloo, which moves no CUDA tensor for most collectives, a
CUDA tensor is staged through host memory (:func:`on_wire`, :func:`home`),
as the ring's exchange is (``parallel/ring_attention.py``).  The route
follows the group's backend.  A reduce-scatter on gloo is an all-to-all
and a sum in rank order, so it puts (n − 1)/n of its input on the wire,
as NCCL's does (gloo's own reduce-scatter is a whole allreduce).

:func:`collective_stats` counts the calls and the payload bytes by kind.
"""

from __future__ import annotations

import collections

import numpy as np
import torch
import torch.distributed as dist

_stats: collections.Counter = collections.Counter()


def collective_stats() -> dict:
    """``{kind: calls}`` and ``{kind + "_bytes": payload bytes}`` since the
    last :func:`reset_collective_stats`; the payload is the tensor a rank
    hands the collective (its input, or for an all-gather its output)."""
    return dict(_stats)


def reset_collective_stats() -> None:
    _stats.clear()


def _count(kind: str, t: torch.Tensor) -> None:
    _stats[kind] += 1
    _stats[kind + "_bytes"] += t.numel() * t.element_size()


def group_size(group=None) -> int:
    return dist.get_world_size(group)


def group_rank(group=None) -> int:
    return dist.get_rank(group)


def global_rank(group, r: int) -> int:
    """The world rank of ``group``'s rank ``r``."""
    return r if group is None or group is dist.group.WORLD else \
        dist.get_global_rank(group, r)


def shard_init_rng(seed: int, group=None,
                   device="cpu") -> torch.Generator:
    """A generator seeded from ``seed`` and this rank's index in ``group``
    (the JAX package folds the index into the key): each rank of the group
    draws its own values, and the same rank the same values every run."""
    index = group_rank(group) if dist.is_initialized() else 0
    state = np.random.SeedSequence([int(seed), index]).generate_state(2)
    return torch.Generator(device=device).manual_seed(
        int(state[0]) << 32 | int(state[1]))


def staged(x: torch.Tensor, group=None) -> bool:
    """Whether ``x`` goes through host memory: a CUDA tensor on gloo."""
    return x.device.type != "cpu" and dist.get_backend(group) == "gloo"


def on_wire(x: torch.Tensor, group=None) -> torch.Tensor:
    """``x`` as the group's backend sends it: contiguous, and on the host
    under gloo."""
    x = x.detach().contiguous()
    return x.cpu() if staged(x, group) else x


def home(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A received tensor back on ``like``'s device."""
    return t.to(like.device)


def all_reduce(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of ``x`` over the group."""
    _count("all_reduce", x)
    t = on_wire(x, group)
    t = t.clone() if t is x else t
    dist.all_reduce(t, group=group)
    return home(t, x)


def all_gather(x: torch.Tensor, group=None, dim: int = 0) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in rank order."""
    n = group_size(group)
    t = on_wire(x.movedim(dim, 0), group)
    out = t.new_empty((n * t.shape[0],) + tuple(t.shape[1:]))
    _count("all_gather", out)
    dist.all_gather_into_tensor(out, t, group=group)
    return home(out, x).movedim(0, dim)


def reduce_scatter(x: torch.Tensor, group=None, dim: int = 0) -> torch.Tensor:
    """This rank's chunk along ``dim`` of the sum of ``x`` over the group;
    ``x.shape[dim]`` divides by the group's size."""
    n = group_size(group)
    _count("reduce_scatter", x)
    t = on_wire(x.movedim(dim, 0), group)
    if t.shape[0] % n:
        raise ValueError(f"reduce_scatter: dim {dim} of {tuple(x.shape)} "
                         f"does not divide by the group's size {n}")
    if dist.get_backend(group) == "gloo":
        rows = torch.empty_like(t)
        dist.all_to_all_single(rows, t, group=group)
        parts = rows.reshape((n, t.shape[0] // n) + tuple(t.shape[1:]))
        out = parts[0].clone()
        for p in parts[1:]:
            out += p
    else:
        out = t.new_empty((t.shape[0] // n,) + tuple(t.shape[1:]))
        dist.reduce_scatter_tensor(out, t, group=group)
    return home(out, x).movedim(0, dim)


def all_to_all(x: torch.Tensor, group=None) -> torch.Tensor:
    """``x`` [n, ...] -> [n, ...]: row ``i`` goes to rank ``i``, and row
    ``i`` of the result came from rank ``i``."""
    _count("all_to_all", x)
    t = on_wire(x, group)
    out = torch.empty_like(t)
    dist.all_to_all_single(out, t, group=group)
    return home(out, x)


def broadcast(x: torch.Tensor, src: int, group=None) -> torch.Tensor:
    """Group rank ``src``'s ``x`` on every rank (``x`` gives the shape and
    dtype elsewhere)."""
    _count("broadcast", x)
    t = on_wire(x, group)
    t = t.clone() if t is x else t
    dist.broadcast(t, src=global_rank(group, src), group=group)
    return home(t, x)


class _ReduceForward(torch.autograd.Function):
    """Sum over the group forward, the identity backward (the row-parallel
    layer's output)."""

    @staticmethod
    def forward(ctx, group, x):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return None, g


class _ReduceBackward(torch.autograd.Function):
    """The identity forward, a sum over the group backward (the
    column-parallel layer's input)."""

    @staticmethod
    def forward(ctx, group, x):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return None, all_reduce(g, ctx.group)


class _AllToAll(torch.autograd.Function):
    """A differentiable all-to-all: its gradient is the reverse exchange,
    the same call."""

    @staticmethod
    def forward(ctx, group, x):
        ctx.group = group
        return all_to_all(x, group)

    @staticmethod
    def backward(ctx, g):
        return None, all_to_all(g, ctx.group)


def reduce_forward(x, group=None):
    return _ReduceForward.apply(group, x)


def reduce_backward(x, group=None):
    return _ReduceBackward.apply(group, x)


def differentiable_all_to_all(x, group=None):
    return _AllToAll.apply(group, x)
