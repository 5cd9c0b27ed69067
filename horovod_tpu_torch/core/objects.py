"""Engine-based broadcast and gather of Python objects — counterpart of
``horovod_tpu/core/objects.py``.

The reference's bindings tensor-ize picklable state to move it through the
collective layer (reference torch/__init__.py:197-228); here the two-phase
scheme (the length, then the payload bytes, as CPU ``uint8`` tensors) lives
once and the torch binding delegates to it.
"""

from __future__ import annotations

import pickle

import torch


def _payload(obj) -> torch.Tensor:
    return torch.frombuffer(bytearray(pickle.dumps(obj)), dtype=torch.uint8)


def broadcast_object(obj, root_rank: int = 0, name: str = "bcast_obj"):
    """Broadcast a picklable object from ``root_rank`` via the engine."""
    from horovod_tpu_torch import basics
    from horovod_tpu_torch.core import engine as engine_mod

    if basics.size() == 1:
        return obj
    eng = engine_mod.get_engine()
    payload = _payload(obj) if basics.rank() == root_rank \
        else torch.zeros(0, dtype=torch.uint8)
    h = eng.enqueue(name + ".len", torch.tensor([payload.numel()]),
                    engine_mod.OP_BROADCAST, root_rank=root_rank)
    n = int(eng.synchronize(h)[0])
    if payload.numel() != n:
        payload = torch.zeros(n, dtype=torch.uint8)
    h = eng.enqueue(name + ".data", payload, engine_mod.OP_BROADCAST,
                    root_rank=root_rank)
    return pickle.loads(eng.synchronize(h).numpy().tobytes())


def allgather_object(obj, name: str = "agather_obj") -> list:
    """Gather one picklable object per process; returns them rank-ordered.

    Rides the engine's ragged allgather — per-rank pickle sizes may differ
    — with a companion size gather to slice the concatenated payload."""
    from horovod_tpu_torch import basics
    from horovod_tpu_torch.core import engine as engine_mod

    if basics.size() == 1:
        return [obj]
    eng = engine_mod.get_engine()
    payload = _payload(obj)
    h_len = eng.enqueue(name + ".len", torch.tensor([payload.numel()]),
                        engine_mod.OP_ALLGATHER)
    h = eng.enqueue(name + ".data", payload, engine_mod.OP_ALLGATHER)
    sizes = [int(s) for s in eng.synchronize(h_len)]
    blob = eng.synchronize(h).numpy().tobytes()
    out, off = [], 0
    for s in sizes:
        out.append(pickle.loads(blob[off:off + s]))
        off += s
    return out
