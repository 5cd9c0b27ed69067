"""Ulysses sequence parallelism: an all-to-all swaps the sequence shard for
a head shard — counterpart of ``horovod_tpu/parallel/ulysses.py``.

One all-to-all re-partitions ``[B, S/n, H, D]`` into ``[B, S, H/n, D]``
(split on heads, concatenated on the sequence), so each rank runs plain
attention over the whole sequence for its group of heads; a second
all-to-all restores the sequence shard.  The all-to-alls are
``dist.all_to_all_single`` over the group (``None``: the world), and
differentiable: each one's gradient is the other.  On gloo, which moves no
CUDA tensor, a CUDA tensor is staged through host memory
(``parallel/common.py``); the route follows the group's backend.  Heads
must divide by the group's size.
"""

from __future__ import annotations

import functools

import torch
import torch.distributed as dist

from horovod_tpu_torch.models.transformer import dense_causal_attention
from horovod_tpu_torch.ops.flash_attention import make_flash_attention
from horovod_tpu_torch.parallel.common import all_to_all


def _seq_to_heads(x, group):
    """[B, S/n, H, D] → [B, S, H/n, D]."""
    n = dist.get_world_size(group)
    b, s, h, d = x.shape
    rows = x.reshape(b, s, n, h // n, d).permute(2, 0, 1, 3, 4)
    out = all_to_all(rows, group)                   # [n, B, S/n, H/n, D]
    return out.permute(1, 0, 2, 3, 4).reshape(b, n * s, h // n, d)


def _heads_to_seq(x, group):
    """[B, S, H/n, D] → [B, S/n, H, D]."""
    n = dist.get_world_size(group)
    b, s, h, d = x.shape
    rows = x.reshape(b, n, s // n, h, d).permute(1, 0, 2, 3, 4)
    out = all_to_all(rows, group)                   # [n, B, S/n, H/n, D]
    return out.permute(1, 2, 0, 3, 4).reshape(b, s // n, n * h, d)


class _SeqToHeads(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, x):
        ctx.group = group
        return _seq_to_heads(x, group)

    @staticmethod
    def backward(ctx, g):
        return None, _heads_to_seq(g, ctx.group)


class _HeadsToSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, x):
        ctx.group = group
        return _heads_to_seq(x, group)

    @staticmethod
    def backward(ctx, g):
        return None, _seq_to_heads(g, ctx.group)


def ulysses_attention(q, k, v, group=None, causal: bool = True,
                      inner=dense_causal_attention):
    """Exact attention over a sequence sharded on ``group``: ``[B,
    S_local, H, D]`` a rank, H divisible by the group's size."""
    n = dist.get_world_size(group)
    h = q.shape[2]
    if h % n:
        raise ValueError(
            f"ulysses_attention requires heads ({h}) divisible by the "
            f"sequence-parallel axis size ({n}); use ring_attention instead.")
    qh, kh, vh = (_SeqToHeads.apply(group, t) for t in (q, k, v))
    return _HeadsToSeq.apply(group, inner(qh, kh, vh, causal=causal))


def make_ulysses_attention(group=None, inner=dense_causal_attention):
    """Adapter producing a ``TransformerConfig.attention_fn``."""
    return functools.partial(ulysses_attention, group=group, inner=inner)


def make_ulysses_flash_attention(group=None):
    """Ulysses with the flash kernels (forward and backward) as the local
    attention over the whole sequence of H/n heads (the kernels choose
    their own tiles: the JAX package's tiling arguments have no
    counterpart)."""
    return make_ulysses_attention(group, inner=make_flash_attention())
