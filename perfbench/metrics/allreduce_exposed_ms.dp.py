"""``allreduce_exposed_ms.dp`` (ms): a step's time of NCCL's kernels on
rank 0's card that no other kernel covers: the union of the collective
kernels' intervals in the traced window less the part that the union of
every other kernel's overlaps, over the steps.  Layer: the collectives
(``ops/collective_ops.py`` and the bucket plan of
``ops/schedule_plan.py`` under ``DistributedOptimizer``).  Moves
``train_tokens_per_s``."""

from perfbench import tracing


def read(t):
    if t.get("phase") != "train" or t.get("chips", 1) < 2:
        return None
    ks = tracing.kernels(t["events"])
    comm = [e for e in ks if "nccl" in e["name"].lower()]
    if not comm:
        return None
    rest = [e for e in ks if "nccl" not in e["name"].lower()]
    exposed = tracing.busy_us(comm) - tracing.covered_us(comm, rest)
    return exposed / 1e3 / t["steps"]
