"""Pipeline parallelism — GPipe with one stage a rank, counterpart of
``horovod_tpu/parallel/pipeline.py``.

Every rank of a ``torch.distributed`` group (``None``: the world) holds one
stage's parameters; rank ``s`` applies its stage to each of ``M``
microbatches in turn and sends the result to rank ``s + 1``; stage 0 takes
the microbatches from ``x``, and the last stage banks the outputs and
broadcasts them, so every rank returns the whole batch.  Where the JAX
package scans ``M + P − 1`` ticks of ``lax.ppermute`` and lets autodiff
transpose them, the port runs the schedule itself, both ways:

* the forward keeps each microbatch's stage input (and, without
  ``remat``, the graph of its stage);
* the backward runs the reverse schedule: the last stage takes the mean of
  every rank's output cotangent, then each rank, microbatch by microbatch
  from the last, receives the cotangent of its stage's output from the
  next rank, takes one ``torch.autograd.grad`` over the stage (recomputed
  under ``remat``) and sends its input's gradient to the previous rank.

Every point-to-point message carries its microbatch in its tag (forward
``i``, backward ``M + i``), and on a gloo group a CUDA tensor goes through
host memory (``parallel/common.py``).

Gradient contracts, those of the JAX package: stage parameters get their
exact gradients on their own rank; ``x``'s gradient lands wholly on stage
0 and is zero elsewhere (so a replicated producer, an embedding, sums its
gradient over the group); a replicated consumer of the outputs (a head)
gets the true gradient on every rank.  The loss is computed alike on
every rank from the replicated outputs.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist
from torch import nn

from horovod_tpu_torch.parallel.common import (_count, all_reduce,
                                               broadcast, global_rank,
                                               group_rank, group_size, home,
                                               on_wire, shard_init_rng)


def stage_init_rng(seed: int, group=None, device="cpu") -> torch.Generator:
    """This stage's generator (:func:`~.common.shard_init_rng`)."""
    return shard_init_rng(seed, group, device)


class _Schedule:
    """The GPipe schedule of one :func:`pipeline_apply` call."""

    def __init__(self, stage_fn, params, tensors, group, m, remat):
        self.stage_fn, self.params, self.group = stage_fn, params, group
        self.tensors = tensors
        self.m, self.remat = m, remat
        self.n, self.s = group_size(group), group_rank(group)
        self.inputs: list = []
        self.outputs: list = []

    def _send(self, t, to: int, tag: int, pending: list) -> None:
        _count("send", t)
        wire = on_wire(t, self.group)
        pending.append((wire, dist.isend(
            wire, global_rank(self.group, to), group=self.group, tag=tag)))

    def _recv(self, like, frm: int, tag: int):
        buf = on_wire(torch.empty_like(like), self.group)
        dist.recv(buf, global_rank(self.group, frm), group=self.group,
                  tag=tag)
        return home(buf, like)

    def _stage(self, inp):
        return self.stage_fn(self.params, inp)

    def forward(self, x):
        mbs = x.detach().reshape((self.m, -1) + tuple(x.shape[1:]))
        last = self.s == self.n - 1
        outs = torch.empty_like(mbs)
        pending: list = []
        for i in range(self.m):
            inp = mbs[i] if self.s == 0 else \
                self._recv(mbs[i], self.s - 1, i)
            inp = inp.detach().requires_grad_()
            with torch.set_grad_enabled(not self.remat):
                out = self._stage(inp)
            self.inputs.append(inp)
            if not self.remat:
                self.outputs.append(out)
            if last:
                outs[i] = out.detach().to(outs.dtype)
            else:
                self._send(out.detach().to(outs.dtype), self.s + 1, i,
                           pending)
        for _, work in pending:
            work.wait()
        return broadcast(outs, self.n - 1, self.group).reshape(x.shape)

    def backward(self, g):
        # Every rank consumed the replicated outputs alike: the last stage
        # takes the mean of their cotangents.
        g = (all_reduce(g, self.group) / self.n).reshape(
            (self.m, -1) + tuple(g.shape[1:]))
        wrt = [t for t in self.tensors if t.requires_grad]
        grads = [None] * len(wrt)
        dx = torch.zeros_like(g)
        pending: list = []
        for i in reversed(range(self.m)):
            inp = self.inputs[i]
            go = g[i] if self.s == self.n - 1 else \
                self._recv(g[i], self.s + 1, self.m + i)
            if self.remat:
                with torch.enable_grad():
                    out = self._stage(inp)
            else:
                out = self.outputs[i]
            got = torch.autograd.grad(out, [inp] + wrt, go.to(out.dtype),
                                      allow_unused=True)
            for j, dp in enumerate(got[1:]):
                if dp is not None:
                    grads[j] = dp if grads[j] is None else grads[j] + dp
            if self.s == 0:
                dx[i] = got[0].to(dx.dtype)
            else:
                self._send(got[0].to(g.dtype), self.s - 1, self.m + i,
                           pending)
        for _, work in pending:
            work.wait()
        it = iter(grads)
        return dx.reshape((-1,) + tuple(g.shape[2:])), [
            next(it) if t.requires_grad else None for t in self.tensors]


class _Pipeline(torch.autograd.Function):
    @staticmethod
    def forward(ctx, sched, x, *tensors):
        ctx.sched = sched
        return sched.forward(x)

    @staticmethod
    def backward(ctx, g):
        dx, grads = ctx.sched.backward(g)
        ctx.sched = None
        return (None, dx, *grads)


def pipeline_apply(stage_fn: Callable, params, x,
                   num_microbatches: int | None = None, group=None,
                   remat: bool = False):
    """Run ``stage_fn(params, mb)`` as a GPipe pipeline over ``group``.

    ``params`` are this rank's stage parameters: an ``nn.Module`` or a
    sequence of tensors (their gradients come back through autograd);
    ``stage_fn`` preserves the microbatch's shape.  ``x``: ``[B, ...]``,
    present on every rank; only stage 0's copy is consumed.  Returns the
    ``[B, ...]`` outputs on every rank.  ``num_microbatches`` defaults to
    the number of stages; ``remat=True`` keeps only each microbatch's
    stage input and runs the stage again in the backward pass, with the
    same gradients.
    """
    n = group_size(group)
    m = n if num_microbatches is None else num_microbatches
    if m < 1:
        raise ValueError(f"num_microbatches must be >= 1, got {m}")
    b = x.shape[0]
    if b % m:
        raise ValueError(f"batch {b} not divisible by num_microbatches {m}")
    tensors = list(params.parameters()) if isinstance(params, nn.Module) \
        else [t for t in params if isinstance(t, torch.Tensor)]
    sched = _Schedule(stage_fn, params, tensors, group, m, remat)
    return _Pipeline.apply(sched, x, *tensors)
