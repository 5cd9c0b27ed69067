"""Expert parallelism — switch-routed MoE over a process group, counterpart
of ``horovod_tpu/parallel/expert.py``.

Each rank of a ``torch.distributed`` group (``None``: the world) holds one
expert.  Routing builds the dense ``[tokens, experts, capacity]`` combine
tensor of the mesh-tensorflow / Switch formulation (no sort, no ragged
scatter), so the layer is two all-to-alls around the expert's products,
and einsums either side.  The all-to-all is ``dist.all_to_all_single`` in
an autograd function whose gradient is the reverse exchange
(``parallel/common.py``), so the backward returns every token's gradient
to the rank it came from.

Gradients: each rank's loss is its own tokens' loss.  A shared
(replicated) parameter's gradient holds its rank's share only, and
:func:`moe_grad_sync` averages it over the group; an expert's gradient
already sums what every rank's loss sent it through the exchange, K times
the gradient of the mean loss, and :func:`moe_grad_sync` divides it by K.
Both then equal the true gradient of the mean of the ranks' losses.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from horovod_tpu_torch.parallel.common import (all_reduce,
                                               differentiable_all_to_all,
                                               group_size, shard_init_rng)

# Tokens routed, and tokens kept as a device tensor (read without a sync
# a call).
_stats: dict = {"tokens": 0, "kept": 0}


def moe_stats() -> dict:
    """``{"tokens", "dropped"}`` routed by :func:`expert_parallel_moe` on
    this rank since the last :func:`reset_moe_stats`; a dropped token is
    one past its expert's capacity (its output is zero)."""
    return {"tokens": _stats["tokens"],
            "dropped": _stats["tokens"] - int(_stats["kept"])}


def reset_moe_stats() -> None:
    _stats.update(tokens=0, kept=0)


def expert_init_rng(seed: int, group=None, device="cpu") -> torch.Generator:
    """This expert's generator (:func:`~.common.shard_init_rng`)."""
    return shard_init_rng(seed, group, device)


def switch_route(x, router_w, n_experts: int, capacity: int):
    """Top-1 routing plan: ``(combine [T, E, C], gate [T])``, both f32.

    ``combine[t, e, c] = 1`` iff token t is slot c of expert e's bucket and
    within capacity; tokens past capacity are dropped (the caller's
    residual carries them).  The softmax is f32, the expert the first of
    the largest probabilities, the slots in token order.
    """
    dt = torch.promote_types(x.dtype, router_w.dtype)     # jnp's promotion
    logits = x.to(dt) @ router_w.to(dt)                     # [T, E]
    probs = torch.softmax(logits.float(), dim=-1)
    expert_idx = torch.argmax(probs, dim=-1)                # [T]
    gate = torch.gather(probs, -1, expert_idx[:, None])[:, 0]
    onehot = F.one_hot(expert_idx, n_experts).float()
    # Slot of each token within its expert's bucket (0-based, in order).
    pos = torch.cumsum(onehot, dim=0) * onehot - onehot     # [T, E]
    within = (pos < capacity).float() * onehot
    combine = within[:, :, None] * F.one_hot(
        pos.clamp(0, capacity - 1).long(), capacity).float()   # [T, E, C]
    return combine, gate


def _default_is_expert(name: str) -> bool:
    """A parameter under a scope named with "moe" (any case) whose own name
    is not "router"."""
    names = [p.lower() for p in name.split(".")]
    return any("moe" in p for p in names) and names[-1] != "router"


def moe_grad_sync(named_parameters, group=None,
                  is_expert: Callable | None = None) -> None:
    """Make a mixed replicated / expert model's gradients the true gradient
    of the mean of the ranks' losses, in place: an expert parameter's
    ``.grad`` divided by K, every other averaged over ``group``.

    ``named_parameters``: ``model.named_parameters()``.  ``is_expert(name)``
    picks the expert parameters; the default takes those under a module
    whose name contains "moe" whose own name is not "router".
    """
    k = group_size(group)
    pred = is_expert or _default_is_expert
    with torch.no_grad():
        for name, p in named_parameters:
            if p.grad is None:
                continue
            if pred(name):
                p.grad.div_(k)
            else:
                p.grad.copy_(all_reduce(p.grad, group) / k)


def expert_parallel_moe(expert_fn: Callable, expert_params, router_w, x,
                        capacity_factor: float = 1.0, group=None):
    """Switch-MoE layer: route, all-to-all dispatch, expert compute, return.

    The group's size is the number of experts, one a rank;
    ``expert_params`` are this rank's expert and ``expert_fn(params, h)``
    maps ``[N, D]`` to ``[N, D]``.  ``x``: ``[T, D]`` local tokens;
    ``router_w``: ``[D, E]``, the same on every rank.  Returns ``[T, D]``:
    gate-scaled expert outputs, zeros for a dropped token (add the
    residual).  ``capacity = max(1, int(T * capacity_factor / E))``.
    """
    n_experts = group_size(group)
    t, d = x.shape
    capacity = max(1, int(t * capacity_factor / n_experts))
    combine, gate = switch_route(x, router_w, n_experts, capacity)
    _stats["tokens"] += t
    _stats["kept"] = _stats["kept"] + combine.sum().detach()

    dispatch = torch.einsum("tec,td->ecd", combine, x.float())   # [E, C, D]
    # Slice e goes to rank e; received row i came from rank i.
    recv = differentiable_all_to_all(dispatch, group)
    h = expert_fn(expert_params,
                  recv.reshape(n_experts * capacity, d).to(x.dtype))
    h = h.float().reshape(n_experts, capacity, d)
    # Each source rank gets its tokens' outputs back (the mirror exchange).
    back = differentiable_all_to_all(h, group)
    out = torch.einsum("tec,ecd->td", combine, back)              # [T, D]
    return (out * gate[:, None]).to(x.dtype)
