"""Planner-driven long-context glue: one ContextPlan wires the layout —
counterpart of ``horovod_tpu/parallel/context.py``.

``ops/schedule_plan.plan_context`` decides the shard width, the plain or
zigzag layout and the remat policy; this module turns the plan into what
a model needs:

* :func:`plan_long_context` — describe the workload, get the plan;
* :func:`context_attention_fn` — a ``TransformerConfig.attention_fn``
  routing to the ring or zigzag flash path over the context group;
* :func:`context_positions` — the rank's global sequence positions under
  the planned layout (RoPE must match the data layout);
* :func:`shard_sequence` / :func:`unshard_sequence` — the permutation that
  makes a contiguous shard over ``plan.width`` ranks land the zigzag
  layout (identity on the plain layout).

Where the JAX package takes a mesh axis name, the port takes a
``torch.distributed`` process group (``None``: the world).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from horovod_tpu_torch.ops.schedule_plan import (ContextPlan,
                                                 ContextWorkload,
                                                 plan_context)
from horovod_tpu_torch.parallel.ring_attention import (
    ring_flash_attention, zigzag_inverse_permutation, zigzag_permutation,
    zigzag_positions, zigzag_ring_flash_attention)


def plan_long_context(seq_len: int, num_heads: int, head_dim: int,
                      width: int, *, batch: int = 1, embed_dim: int = 0,
                      mlp_dim: int = 0, num_layers: int = 1,
                      causal: bool = True, dtype_bytes: int = 2,
                      headroom_mb: float | None = None,
                      **overrides) -> ContextPlan:
    """``plan_context(ContextWorkload(...), width)``; ``overrides``
    (``layout=``, ``remat=``) pass through, above the ``HVD_TPU_CTX_*``
    knobs in precedence."""
    workload = ContextWorkload(
        seq_len=seq_len, num_heads=num_heads, head_dim=head_dim,
        batch=batch, embed_dim=embed_dim, mlp_dim=mlp_dim,
        num_layers=num_layers, causal=causal, dtype_bytes=dtype_bytes)
    return plan_context(workload, width, headroom_mb, **overrides)


def context_attention_fn(group, plan: ContextPlan):
    """``TransformerConfig.attention_fn`` running the plan's layout over
    ``group``; at width 1 the ring is one flash call with no exchange."""
    ring = (zigzag_ring_flash_attention if plan.layout == "zigzag"
            else ring_flash_attention)

    def attn(q, k, v, causal=True):
        return ring(q, k, v, group, causal)

    return attn


def context_positions(group, s_local: int, plan: ContextPlan, device=None):
    """This rank's global sequence positions ([s_local]) under the plan's
    layout: zigzag chunks (r, 2n − 1 − r) or the plain contiguous shard."""
    if plan.layout == "zigzag":
        return zigzag_positions(s_local, group, device)
    return dist.get_rank(group) * s_local + torch.arange(s_local,
                                                         device=device)


def shard_sequence(x, plan: ContextPlan, axis: int = 1):
    """Permute a global-order tensor (tokens, targets) so that a contiguous
    shard over ``plan.width`` ranks lands the planned layout.  Identity on
    the plain layout."""
    if plan.layout != "zigzag":
        return x
    perm = zigzag_permutation(x.shape[axis], plan.width)
    return x.index_select(axis, torch.as_tensor(perm, device=x.device))


def unshard_sequence(x, plan: ContextPlan, axis: int = 1):
    """Inverse of :func:`shard_sequence` (restores natural order)."""
    if plan.layout != "zigzag":
        return x
    inv = zigzag_inverse_permutation(x.shape[axis], plan.width)
    return x.index_select(axis, torch.as_tensor(inv, device=x.device))
