"""Tensor parallelism building blocks — Megatron-style sharded layers,
counterpart of ``horovod_tpu/parallel/tensor_parallel.py``.

Each layer shards its weight over a ``torch.distributed`` process group
(``None``: the world) where the JAX package shards it over a mesh axis:

* :class:`ColumnParallelDense` — weight ``[in, out/K]`` a rank; its output
  stays sharded on features (no communication forward);
* :class:`RowParallelDense` — weight ``[in/K, out]`` a rank over a
  feature-sharded input; its output is summed over the group (the one
  collective), then the bias, identical on every rank, is added.

Gradients are Megatron's pair: the column layer's input passes forward
unchanged and its gradient is summed over the group backward; the row
layer's output is summed forward and its gradient passes backward
unchanged.  With them ``dx`` and every shard's ``dW`` are the true
gradients of the dense layer on the gathered weights.  (The JAX layers
inside ``shard_map(check_vma=False)`` pin only the forward.)

Weights are stored as the flax layers store them, ``kernel [in, out]``
and ``bias``, and drawn from :func:`~.common.shard_init_rng`: the column
layer lecun-normal, the row layer a truncated normal of variance 1/(the
global fan-in), biases zero.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

from horovod_tpu_torch.parallel.common import (group_size, reduce_backward,
                                               reduce_forward,
                                               shard_init_rng)

# flax's truncated_normal variance scaling: a normal cut at two standard
# deviations has this standard deviation, so the draw is divided by it.
_TRUNC_STD = 0.87962566103423978


def truncated_normal_(t: torch.Tensor, variance: float,
                      generator: torch.Generator) -> torch.Tensor:
    """flax ``variance_scaling(..., "truncated_normal")``: a normal cut at
    ±2 standard deviations, scaled to ``variance``."""
    std = variance ** 0.5 / _TRUNC_STD
    with torch.no_grad():
        return nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std,
                                     generator=generator)


class ColumnParallelDense(nn.Module):
    """Dense with output features sharded over ``group``: ``features`` is
    the global output width, each rank holds ``features / K`` columns."""

    def __init__(self, in_features: int, features: int, group=None,
                 use_bias: bool = True, seed: int = 0, device=None,
                 dtype=torch.float32):
        super().__init__()
        k = group_size(group)
        if features % k:
            raise ValueError(f"features {features} not divisible by tp={k}")
        self.group = group
        gen = shard_init_rng(seed, group, device or "cpu")
        self.kernel = nn.Parameter(truncated_normal_(
            torch.empty(in_features, features // k, device=device,
                        dtype=dtype), 1.0 / in_features, gen))
        self.bias = nn.Parameter(torch.zeros(
            features // k, device=device, dtype=dtype)) if use_bias else None

    def forward(self, x):
        y = reduce_backward(x, self.group) @ self.kernel.to(x.dtype)
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return y


class RowParallelDense(nn.Module):
    """Dense over input features sharded on ``group``; the output summed
    over the group.  ``in_features`` is the global fan-in."""

    def __init__(self, in_features: int, features: int, group=None,
                 use_bias: bool = True, seed: int = 0, device=None,
                 dtype=torch.float32):
        super().__init__()
        k = group_size(group)
        if in_features % k:
            raise ValueError(
                f"in_features {in_features} not divisible by tp={k}")
        self.group = group
        gen = shard_init_rng(seed, group, device or "cpu")
        # The local kernel sees fan_in/K: its variance is 1/(global fan-in).
        self.kernel = nn.Parameter(truncated_normal_(
            torch.empty(in_features // k, features, device=device,
                        dtype=dtype), 1.0 / in_features, gen))
        # Not per rank: added after the sum, so identical everywhere.
        self.bias = nn.Parameter(torch.zeros(
            features, device=device, dtype=dtype)) if use_bias else None

    def forward(self, x):
        y = reduce_forward(x @ self.kernel.to(x.dtype), self.group)
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return y


def _gelu(x):
    """flax ``nn.gelu``: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


class ParallelMLP(nn.Module):
    """Column -> act -> Row two-layer MLP: exactly one sum over the group
    forward (and one backward)."""

    def __init__(self, in_features: int, hidden: int, features: int,
                 group=None, act: Callable = _gelu, seed: int = 0,
                 device=None, dtype=torch.float32):
        super().__init__()
        self.act = act
        self.up = ColumnParallelDense(in_features, hidden, group, seed=seed,
                                      device=device, dtype=dtype)
        self.down = RowParallelDense(hidden, features, group, seed=seed + 1,
                                     device=device, dtype=dtype)

    def forward(self, x):
        return self.down(self.act(self.up(x)))
