"""Parameter / optimizer-state bootstrap for the torch binding, over the
native engine — counterpart of ``horovod_tpu/torch/state.py``.

Rebuild of reference horovod/torch/__init__.py:153-301:

* ``broadcast_parameters`` — in-place broadcast of a ``state_dict()`` or
  ``named_parameters`` iterable from ``root_rank``.
* ``broadcast_optimizer_state`` — broadcasts optimizer state, tensor-izing
  Python scalars exactly like the reference (scalars → 0-d tensors →
  broadcast → cast back via per-key callbacks, :197-247).
* ``broadcast_object`` — pickle → uint8 tensor → broadcast (the reference
  grew this helper in later versions; needed by resume flows that broadcast
  the epoch counter, examples/pytorch_imagenet_resnet50.py:63-72).
"""

from __future__ import annotations

import collections

import torch

from horovod_tpu_torch.torch import mpi_ops


def broadcast_parameters(params, root_rank: int = 0) -> None:
    """In-place broadcast of parameters (reference
    torch/__init__.py:153-182)."""
    if isinstance(params, dict):
        items = sorted(params.items())
    else:
        items = list(params)
    handles = []
    for name, p in items:
        if p is None:
            continue
        if not torch.is_tensor(p):
            raise ValueError(f"invalid params of type: {type(p)}")
        handles.append(mpi_ops.broadcast_async_(p.data, root_rank,
                                                name=f"bcast.{name}"))
    for h in handles:
        mpi_ops.synchronize(h)


def broadcast_optimizer_state(optimizer, root_rank: int = 0) -> None:
    """In-place broadcast of optimizer state (reference
    torch/__init__.py:185-301)."""
    if isinstance(optimizer, torch.optim.LBFGS):
        raise ValueError("cannot broadcast torch.optim.LBFGS state")
    state_dict = optimizer.state_dict()

    # Newly constructed optimizers have empty state; the reference forces
    # state initialization with a zero-grad step (:192-210).
    if not state_dict["state"]:
        for group in optimizer.param_groups:
            for p in group["params"]:
                if p.requires_grad and p.grad is None:
                    p.grad = p.data.new_zeros(p.shape)
        optimizer.step()
        state_dict = optimizer.state_dict()

    callbacks = {}
    occurrences = collections.defaultdict(int)

    def _from_tensor(key, dtype):
        def cast(t):
            return dtype(t.item())
        return cast

    handles = []
    # Broadcast param_groups options (lr, momentum, …): scalars wrapped in
    # tensors with casts back (reference :216-247).
    for gi, group in enumerate(state_dict["param_groups"]):
        for key, value in sorted(group.items()):
            if key == "params":
                continue
            name = f"opt.group{gi}.{key}"
            if isinstance(value, bool):
                t = torch.tensor(int(value))
                callbacks[name] = (group, key, lambda t: bool(t.item()))
            elif isinstance(value, int):
                t = torch.tensor(value)
                callbacks[name] = (group, key, lambda t: int(t.item()))
            elif isinstance(value, float):
                t = torch.tensor(value, dtype=torch.float64)
                callbacks[name] = (group, key, lambda t: float(t.item()))
            elif torch.is_tensor(value):
                t = value
                callbacks[name] = (group, key, lambda t: t)
            else:
                # Non-numeric option (None, tuple of betas, …): object path.
                group[key] = broadcast_object(value, root_rank)
                continue
            handles.append((name, t, mpi_ops.broadcast_async_(
                t, root_rank, name=name)))

    # Broadcast per-param state entries (momentum buffers, exp_avg, step…).
    for pid, pstate in sorted(state_dict["state"].items(),
                              key=lambda kv: str(kv[0])):
        for key, value in sorted(pstate.items()):
            occurrences[key] += 1
            name = f"opt.state.{pid}.{key}.{occurrences[key]}"
            if torch.is_tensor(value):
                handles.append((name, value, mpi_ops.broadcast_async_(
                    value, root_rank, name=name)))
            elif isinstance(value, (int, float, bool)):
                t = torch.tensor(float(value), dtype=torch.float64)
                ty = type(value)
                handles.append((name, t, mpi_ops.broadcast_async_(
                    t, root_rank, name=name)))
                callbacks[name] = (pstate, key,
                                   (lambda ty: lambda t: ty(t.item()))(ty))
            else:
                pstate[key] = broadcast_object(value, root_rank)

    for name, t, h in handles:
        mpi_ops.synchronize(h)
        if name in callbacks:
            container, key, cast = callbacks[name]
            container[key] = cast(t)

    optimizer.load_state_dict(state_dict)


def broadcast_object(obj, root_rank: int = 0):
    """Pickle-based object broadcast across processes (shared engine-level
    scheme, ``core/objects.py``)."""
    from horovod_tpu_torch.core.objects import broadcast_object as _bo

    return _bo(obj, root_rank, name="bcast_obj")


def allgather_object(obj):
    """Gather one picklable object per process, rank-ordered (modern
    reference ``hvd.allgather_object``; shared engine-level scheme)."""
    from horovod_tpu_torch.core.objects import allgather_object as _ao

    return _ao(obj)
