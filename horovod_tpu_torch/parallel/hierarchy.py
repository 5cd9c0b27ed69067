"""Hierarchical (two-tier) allreduce — within a host, then across hosts;
counterpart of ``horovod_tpu/parallel/hierarchy.py``.

The reference's ``HOROVOD_HIERARCHICAL_ALLREDUCE`` (reference
horovod/common/operations.cc:1025-1177) is a ReduceScatter within the
node, an Allreduce across nodes by each local rank, and an AllGather
within the node, on a buffer padded to divide evenly
(operations.cc:1033-1039).  The port runs the same algebra over two
``torch.distributed`` groups that :func:`~horovod_tpu_torch.basics.init`
forms once, in the same order on every process, when the job has two
tiers (``local_size() > 1`` and ``cross_size() > 1``): the local group
(this host's processes) and the cross group (the processes of this local
rank on every host).  The cross tier carries 1/local_size of the buffer.
"""

from __future__ import annotations

import torch

from horovod_tpu_torch import basics
from horovod_tpu_torch.parallel.common import (all_gather, all_reduce,
                                               group_size, reduce_scatter)


def hierarchical_allreduce(flat: torch.Tensor, groups=None) -> torch.Tensor:
    """The sum of a 1-D buffer over the job, tier by tier.  ``groups`` is
    ``(cross, local)`` (the JAX package's ``(dcn, ici)`` axes), by default
    the job's own; a single group (or a job of one tier) is one flat
    allreduce.  A length that the local size does not divide is padded
    with zeros and sliced back."""
    groups = groups if groups is not None else basics.hierarchy_groups()
    if groups is None:
        return all_reduce(flat, basics.process_group())
    if len(groups) == 1:
        return all_reduce(flat, groups[0])
    cross, local = groups
    n, k = flat.numel(), group_size(local)
    pad = (-n) % k
    padded = torch.cat([flat, flat.new_zeros(pad)]) if pad else flat
    shard = all_reduce(reduce_scatter(padded, local), cross)
    out = all_gather(shard, local)
    return out[:n] if pad else out


def data_allreduce(flat: torch.Tensor) -> torch.Tensor:
    """The collective the fused allreduce runs on one flat bucket:
    hierarchical on a job of two tiers, one allreduce over the job's group
    otherwise."""
    return hierarchical_allreduce(flat)
