"""Tensor fusion: flat-bucket packing for collectives — counterpart of
``horovod_tpu/ops/fusion.py``.

Each tensor is flattened; tensors are packed greedily and in order into
buckets of at most ``HOROVOD_FUSION_THRESHOLD`` bytes, a new bucket starting
when the dtype changes; each bucket is padded with zeros to a multiple of
``FUSION_BUFFER_ATOMIC_UNIT`` elements; the collective runs once per
bucket; the results are sliced and reshaped back.  The packing is a pure
function of the shapes and dtypes, so every rank plans the same buckets.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import torch

from horovod_tpu_torch.utils import env


@dataclasses.dataclass(frozen=True)
class _Slot:
    index: int           # position in the original tensor list
    offset: int          # element offset within the bucket
    size: int            # number of elements
    shape: tuple
    dtype: torch.dtype


@dataclasses.dataclass(frozen=True)
class _Bucket:
    dtype: torch.dtype
    slots: tuple
    padded_elems: int


def plan_buckets(shapes_dtypes: Sequence[tuple[tuple, torch.dtype]],
                 threshold_bytes: int | None = None) -> list[_Bucket]:
    """Greedy in-order packing plan: a new bucket starts when the dtype
    changes or the byte budget would be exceeded."""
    if threshold_bytes is None:
        threshold_bytes = env.fusion_threshold_bytes()
    unit = env.FUSION_BUFFER_ATOMIC_UNIT
    buckets: list[_Bucket] = []
    slots: list[_Slot] = []
    cur_dtype = None
    cur_elems = 0

    def close():
        nonlocal slots, cur_elems
        if slots:
            padded = -(-cur_elems // unit) * unit
            buckets.append(_Bucket(cur_dtype, tuple(slots), padded))
        slots = []
        cur_elems = 0

    for i, (shape, dtype) in enumerate(shapes_dtypes):
        n = 1
        for d in shape:
            n *= int(d)
        nbytes = n * dtype.itemsize
        if slots and (dtype != cur_dtype
                      or cur_elems * cur_dtype.itemsize + nbytes
                      > threshold_bytes):
            close()
        cur_dtype = dtype
        slots.append(_Slot(i, cur_elems, n, tuple(shape), dtype))
        cur_elems += n
    close()
    return buckets


def pack(tensors: Sequence[torch.Tensor],
         threshold_bytes: int | None = None) -> list[tuple]:
    """``(bucket, flat buffer)`` for each bucket of :func:`plan_buckets`'
    plan: the bucket's tensors flattened into one new zero-padded buffer."""
    packed = []
    for b in plan_buckets([(t.shape, t.dtype) for t in tensors],
                          threshold_bytes):
        flat = torch.zeros(b.padded_elems, dtype=b.dtype,
                           device=tensors[b.slots[0].index].device)
        for s in b.slots:
            flat[s.offset:s.offset + s.size] = tensors[s.index].reshape(-1)
        packed.append((b, flat))
    return packed


def unpack(packed, count: int) -> list[torch.Tensor]:
    """The ``count`` tensors of :func:`pack`'s buckets, as views of their
    (reduced) flat buffers."""
    out: list = [None] * count
    for b, flat in packed:
        for s in b.slots:
            out[s.index] = flat[s.offset:s.offset + s.size].view(s.shape)
    return out


def fused_apply(tensors: Sequence[torch.Tensor],
                collective: Callable[[torch.Tensor], torch.Tensor],
                threshold_bytes: int | None = None) -> list[torch.Tensor]:
    """Pack ``tensors`` into flat buckets, run ``collective`` once per
    bucket, and unpack.  ``collective`` maps a 1-D buffer to a 1-D buffer of
    the same length (e.g. an allreduce)."""
    tensors = list(tensors)
    return unpack([(b, collective(flat))
                   for b, flat in pack(tensors, threshold_bytes)],
                  len(tensors))
