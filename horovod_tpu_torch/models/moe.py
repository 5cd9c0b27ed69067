"""MoE transformer blocks — the model-level surface of expert parallelism,
counterpart of ``horovod_tpu/models/moe.py``.

:class:`MoEMLP` replaces the transformer's dense GLU MLP: a router picks
one expert a token (switch routing), tokens travel to the rank holding
their expert over an all-to-all (``parallel/expert.py``), and the block's
residual carries dropped (over-capacity) tokens unchanged.  Each rank of
the group holds one expert's weights, drawn from its own generator
(``parallel/common.shard_init_rng``); the router is the same on every
rank.  The parameters are float32 and laid out as the flax module lays
them out: ``router [d, E]``, ``gate`` and ``up [d, mlp]``, ``down [mlp,
d]``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from horovod_tpu_torch.parallel.common import group_size
from horovod_tpu_torch.parallel.expert import (expert_init_rng,
                                               expert_parallel_moe)
from horovod_tpu_torch.parallel.tensor_parallel import truncated_normal_


class MoEMLP(nn.Module):
    """Switch-MoE feed-forward: ``[B, S, d] -> [B, S, d]``, one GLU expert
    a rank of ``group``; ``capacity_factor`` bounds each expert's tokens a
    call."""

    def __init__(self, embed_dim: int, mlp_dim: int, group=None,
                 capacity_factor: float = 2.0, dtype=torch.bfloat16,
                 seed: int = 0, device=None):
        super().__init__()
        self.group, self.capacity_factor, self.dtype = \
            group, capacity_factor, dtype
        n = group_size(group)
        gen = torch.Generator(device=device or "cpu").manual_seed(seed)
        egen = expert_init_rng(seed, group, device or "cpu")

        def lecun(*shape, g):
            return nn.Parameter(truncated_normal_(
                torch.empty(shape, device=device), 1.0 / shape[0], g))

        self.router = lecun(embed_dim, n, g=gen)
        self.gate = lecun(embed_dim, mlp_dim, g=egen)
        self.up = lecun(embed_dim, mlp_dim, g=egen)
        self.down = lecun(mlp_dim, embed_dim, g=egen)

    def _expert(self, params, h):
        wg, wu, wd = (w.to(self.dtype) for w in params)
        h = h.to(self.dtype)
        return (F.silu(h @ wg) * (h @ wu)) @ wd

    def forward(self, x):
        b, s, d = x.shape
        out = expert_parallel_moe(
            self._expert, (self.gate, self.up, self.down), self.router,
            x.reshape(b * s, d), capacity_factor=self.capacity_factor,
            group=self.group)
        return out.reshape(b, s, d).to(x.dtype)
