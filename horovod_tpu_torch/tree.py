"""Hierarchical coordinator-tree topology — Python mirror of core/src/tree.h;
the port's copy of ``horovod_tpu/tree.py``, pinned against the port's own
native ``hvd_tree_plan`` (``core/src/tree.cc``).

The launcher (run.py) must know the tree layout BEFORE any engine exists:
it spawns one aggregator-relay sidecar (plus standby) per group and wires
their endpoints into every rank's ``HVD_TPU_TREE_AGG_MAP``.  Rather than
round-trip through the native library for that, the plan is mirrored here
as the same pure function of (size, fanout, threshold, enable) — and
tests/test_tree.py pins this mirror bit-for-bit against the native
``hvd_tree_plan`` so the two can never drift.

Topology (depth 2, docs/benchmarks.md "Control-plane scaling")::

    rank 0 (root, negotiates)
      |- aggregator 0  <- ranks 1..fanout
      |- aggregator 1  <- ranks fanout+1..2*fanout
      `- ...

Rank 0 stays the negotiating coordinator; workers 1..size-1 split into
contiguous groups of ``fanout``.  Below the activation threshold the plan
is inactive and the engine runs the existing rank-0 star bit-for-bit.

The relay tier's transition rules — AGG_STATE replication ordering
(relay replicates before fan-out, root before dispatch), standby replay
of a stale root response, duplicate-broadcast discard, and held-response
GC — live as a checked model in ``horovod_tpu/analysis/protocol``
(``TreeModel``) in the JAX package: the spec the native tree
implementation must satisfy.  See docs/static_analysis.md "Protocol model
checking".
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class TreePlan:
    """Mirror of hvd::TreePlan (core/src/tree.h)."""

    active: bool = False  # False = star, bit-for-bit the existing plane
    size: int = 1
    fanout: int = 0       # members per aggregator group
    num_groups: int = 0   # ceil((size - 1) / fanout)
    depth: int = 1        # frame hops from a member to the root (star: 1)


def plan(size: int, fanout: int, threshold: int, enable: bool) -> TreePlan:
    """Mirror of hvd::PlanTree: tree iff enabled, fanout >= 2, and
    size >= max(threshold, 3).  Pinned against the native answer by
    tests/test_tree.py."""
    size = max(size, 1)
    if not enable or fanout < 2 or size < 3 or size < threshold:
        return TreePlan(size=size)
    return TreePlan(active=True, size=size, fanout=fanout,
                    num_groups=(size - 2) // fanout + 1, depth=2)


def group_of(rank: int, p: TreePlan) -> int:
    """Aggregator group of ``rank`` (-1 for rank 0 / inactive plans)."""
    if not p.active or rank < 1:
        return -1
    return (rank - 1) // p.fanout


def members_of(group: int, p: TreePlan) -> list[int]:
    """Worker ranks served by aggregator ``group`` (mirror of
    hvd::TreeMembersOf)."""
    if not p.active or group < 0 or group >= p.num_groups:
        return []
    lo = group * p.fanout + 1
    hi = min(p.size - 1, (group + 1) * p.fanout)
    return list(range(lo, hi + 1))


def format_agg_map(
        endpoints: list[tuple[tuple[str, int], tuple[str, int] | None]],
) -> str:
    """Build ``HVD_TPU_TREE_AGG_MAP`` from per-group endpoints.

    ``endpoints[g]`` is ``((primary_host, primary_port), standby-or-None)``;
    the wire grammar is ``"0=host:port|host:port,1=host:port,..."``
    (core/src/tree.h), primary first, optional standby after ``|``.
    """
    parts = []
    for g, (primary, standby) in enumerate(endpoints):
        entry = f"{g}={primary[0]}:{primary[1]}"
        if standby is not None:
            entry += f"|{standby[0]}:{standby[1]}"
        parts.append(entry)
    return ",".join(parts)


def parse_agg_map(
        spec: str, num_groups: int,
) -> list[tuple[tuple[str, int], tuple[str, int] | None]] | None:
    """Parse ``HVD_TPU_TREE_AGG_MAP`` (mirror of hvd::ParseAggMap); ``None``
    on malformed input or a group with no endpoint — the launcher validates
    the map it is about to export instead of letting every rank discover
    the problem at engine start."""
    if not spec or num_groups <= 0:
        return None

    def parse_ep(tok: str) -> tuple[str, int] | None:
        host, sep, port = tok.rpartition(":")
        if not sep or not host or not port:
            return None
        try:
            num = int(port)
        except ValueError:
            return None
        return (host, num) if num > 0 else None

    out: list = [None] * num_groups
    for entry in spec.split(","):
        if not entry:
            continue
        g_str, sep, eps = entry.partition("=")
        if not sep:
            return None
        try:
            g = int(g_str)
        except ValueError:
            return None
        if g < 0 or g >= num_groups:
            return None
        primary_str, bar, standby_str = eps.partition("|")
        primary = parse_ep(primary_str)
        if primary is None:
            return None
        standby = None
        if bar:
            standby = parse_ep(standby_str)
            if standby is None:
                return None
        out[g] = (primary, standby)
    if any(e is None for e in out):
        return None  # every group needs an endpoint
    return out
