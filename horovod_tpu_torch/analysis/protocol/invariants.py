"""Safety invariants as predicates over model states.

Each predicate takes a model state and returns ``None`` (holds) or a
human-readable violation detail string; the checker wraps it with the
event trace that reached the state.  These are the properties the
recovery matrix in docs/fault_tolerance.md promises — the model checker
proves them over every interleaving up to the bound, where the chaos
soaks only sample them.

Naming (docs/static_analysis.md "Protocol model checking"):

* ``no-lost-completion``   — an accepted serving request's completion is
                             never destroyed by reconfiguration or exit.
* ``epoch-monotonic``      — no machine ever observes an epoch older than
                             one it already acknowledged, and no worker
                             runs ahead of the coordinator's epoch.
* ``single-coordinator``   — at most one live machine speaks as
                             coordinator for any given epoch (no
                             split-brain after a partition or failover).
* ``ticket-single-use``    — a JOIN_ACK seat (epoch, rank) is issued to
                             at most one joiner, and a joiner holds at
                             most one seat per epoch (retries must be
                             idempotent, not generative).
* ``page-refcount``        — a shared prefix KV page is never freed while
                             a live slot still references it (including
                             across an elastic RECONFIG: slots survive
                             the engine swap, so their references do too).
* ``standby-not-ahead``    — replicated standby state never runs ahead of
                             its primary's authoritative state (else a
                             promotion could replay a future the primary
                             never committed).
* ``quiescence``           — checked by the scheduler on terminal states:
                             every trace ends drained or aborted, never
                             hung (see each model's quiescent_violation).
"""

from __future__ import annotations


def no_lost_completion(s) -> str | None:
    """FleetState: no replica lost a parked completion, and nobody exits
    still holding undelivered ones."""
    for i, w in enumerate(s.workers):
        if w.lost > 0:
            return (f"replica {i} lost {w.lost} accepted completion(s) "
                    f"across a reconfiguration")
        if w.status == "exited" and w.done_pending > 0:
            return (f"replica {i} exited holding {w.done_pending} "
                    f"undelivered completion(s)")
    return None


def shared_page_refcounted(s) -> str | None:
    """FleetState: no replica's shared prefix KV page is freed while any
    live slot on that replica still references it — the PrefixCache
    release contract (free only when the last reference drops)."""
    for i, w in enumerate(s.workers):
        if not w.page_live and w.page_refs > 0:
            return (f"replica {i} freed its shared prefix KV page with "
                    f"{w.page_refs} live slot reference(s) still attached")
    return None


def epoch_not_ahead(s) -> str | None:
    """FleetState: a worker's epoch never exceeds the coordinator's (the
    coordinator is the only epoch author)."""
    for i, w in enumerate(s.workers):
        if w.epoch > s.epoch:
            return (f"replica {i} at epoch {w.epoch} ahead of "
                    f"coordinator epoch {s.epoch}")
    return None


def epoch_never_regressed(s) -> str | None:
    """Models that can replace a machine's epoch record a regression flag
    in apply(); the invariant just reads it."""
    if s.epoch_regressed:
        return "a machine adopted an epoch older than one it acknowledged"
    return None


def single_live_coordinator(s) -> str | None:
    """ElasticModel/TreeModel: s.coordinators() yields (name, epoch) for
    every live machine currently speaking as coordinator or root."""
    seen: dict[int, str] = {}
    for name, epoch in s.coordinators():
        if epoch in seen:
            return (f"split-brain: {seen[epoch]} and {name} both live "
                    f"coordinators at epoch {epoch}")
        seen[epoch] = name
    return None


def ticket_single_use(s) -> str | None:
    """ElasticModel: s.tickets is a tuple of (epoch, rank, joiner_id)."""
    seats: dict[tuple[int, int], int] = {}
    held: dict[tuple[int, int], int] = {}
    for epoch, rank, joiner in s.tickets:
        if seats.setdefault((epoch, rank), joiner) != joiner:
            return (f"seat (epoch {epoch}, rank {rank}) issued to joiner "
                    f"{seats[(epoch, rank)]} AND joiner {joiner}")
        if held.setdefault((epoch, joiner), rank) != rank:
            return (f"joiner {joiner} holds two seats in epoch {epoch}: "
                    f"rank {held[(epoch, joiner)]} and rank {rank}")
    return None


def standby_not_ahead(s) -> str | None:
    """s.replication_pairs() yields (label, primary_progress,
    standby_progress) tuples; progress values are comparable ints."""
    for label, primary, standby in s.replication_pairs():
        if standby > primary:
            return (f"{label}: standby replicated progress {standby} ahead "
                    f"of primary {primary}")
    return None
