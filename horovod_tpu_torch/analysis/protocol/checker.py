"""Explicit-state exploration engine (the TLA+-style scheduler).

A model (machines.py) is any object with::

    initial() -> state              # hashable (nested tuples/NamedTuples)
    events(state) -> [event, ...]   # enabled events, deterministic order;
                                    # each event a tuple of str/int
    apply(state, event) -> state    # pure transition
    invariants -> [(name, fn), ...] # fn(state) -> None, or a violation
                                    # detail string
    quiescent_violation(state) -> None | str
                                    # checked only on TERMINAL states (no
                                    # enabled events); "hung" detector
    truncated(state) -> bool        # True = this terminal state is a
                                    # bounded-horizon cutoff, not a real
                                    # quiescent state — skip the check

Two schedulers:

* ``check_bfs`` — breadth-first over every interleaving with state-hash
  dedup; exhaustive up to ``max_depth``, so a clean result is a proof
  over that horizon, and the first violation's trace is a SHORTEST
  counterexample (easiest to read, cheapest to replay).
* ``check_walk`` — seeded uniform random walks; no dedup, so it reaches
  depths BFS cannot, trading completeness for reach (the model-check leg runs one
  fixed-seed walk on top of the exhaustive sweep).

Traces are plain event lists, which makes them durable artifacts: the two serving
drain counterexamples live in tests/golden/traces/ as JSON and replay
with ``replay_trace`` against both the buggy and the fixed model.
"""

from __future__ import annotations

import dataclasses
import random
from collections import deque
from typing import Any, Callable, Sequence

Event = tuple
State = Any


@dataclasses.dataclass(frozen=True)
class Violation:
    """An invariant breach plus the event path that produced it."""

    invariant: str
    detail: str
    trace: tuple[Event, ...]
    state: State

    def __str__(self) -> str:
        lines = [f"invariant violated: {self.invariant} — {self.detail}",
                 f"counterexample ({len(self.trace)} events):"]
        lines += [f"  {i:3d}. {' '.join(str(x) for x in ev)}"
                  for i, ev in enumerate(self.trace)]
        return "\n".join(lines)


@dataclasses.dataclass
class CheckResult:
    states: int              # distinct states explored (BFS) / visited (walk)
    transitions: int
    depth: int               # deepest level fully expanded
    complete: bool           # True = frontier exhausted before max_depth
    violation: Violation | None = None

    @property
    def ok(self) -> bool:
        return self.violation is None


def _check_state(model, state, trace) -> Violation | None:
    for name, fn in model.invariants:
        detail = fn(state)
        if detail is not None:
            return Violation(name, detail, tuple(trace), state)
    return None


def _check_terminal(model, state, trace) -> Violation | None:
    if getattr(model, "truncated", lambda s: False)(state):
        return None
    detail = model.quiescent_violation(state)
    if detail is not None:
        return Violation("quiescence", detail, tuple(trace), state)
    return None


def _stable(model, enabled) -> bool:
    """True when only *optional* events remain — environment choices like
    crash/partition/QUIT that may never happen.  A stable state is where
    the protocol has finished on its own, so quiescence is judged there:
    a fault budget left unspent must not excuse a wedge."""
    is_opt = getattr(model, "is_optional", lambda ev: False)
    return all(is_opt(ev) for ev in enabled)


def check_bfs(model, max_depth: int = 40,
              max_states: int = 2_000_000) -> CheckResult:
    """Exhaustive BFS up to ``max_depth`` event steps; stops at the first
    violation (shortest counterexample) or when the frontier drains."""
    init = model.initial()
    seen = {init}
    frontier: deque[tuple[State, tuple[Event, ...]]] = deque([(init, ())])
    transitions = 0
    depth = 0
    v = _check_state(model, init, ())
    if v is None and _stable(model, model.events(init)):
        v = _check_terminal(model, init, ())
    if v is not None:
        return CheckResult(1, 0, 0, True, v)
    complete = True
    while frontier:
        state, trace = frontier.popleft()
        depth = max(depth, len(trace))
        if len(trace) >= max_depth:
            complete = False  # horizon, not a drained frontier
            continue
        for ev in model.events(state):
            transitions += 1
            nxt = model.apply(state, ev)
            if nxt in seen:
                continue
            seen.add(nxt)
            ntrace = trace + (ev,)
            v = _check_state(model, nxt, ntrace)
            if v is None and _stable(model, model.events(nxt)):
                v = _check_terminal(model, nxt, ntrace)
            if v is not None:
                return CheckResult(len(seen), transitions, len(ntrace),
                                   False, v)
            if len(seen) >= max_states:
                return CheckResult(len(seen), transitions, len(ntrace),
                                   False, None)
            frontier.append((nxt, ntrace))
    return CheckResult(len(seen), transitions, depth, complete, None)


def check_walk(model, seed: int, steps: int = 400,
               walks: int = 200) -> CheckResult:
    """Seeded random walks: ``walks`` independent runs of up to ``steps``
    uniformly-chosen events each.  Deterministic for a given seed."""
    rng = random.Random(seed)
    visited: set = set()
    transitions = 0
    deepest = 0
    for _ in range(walks):
        state = model.initial()
        trace: list[Event] = []
        visited.add(state)
        for _ in range(steps):
            enabled = model.events(state)
            if _stable(model, enabled):
                v = _check_terminal(model, state, trace)
                if v is not None:
                    return CheckResult(len(visited), transitions,
                                       len(trace), False, v)
            if not enabled:
                break
            ev = enabled[rng.randrange(len(enabled))]
            state = model.apply(state, ev)
            trace.append(ev)
            transitions += 1
            visited.add(state)
            v = _check_state(model, state, trace)
            if v is not None:
                return CheckResult(len(visited), transitions, len(trace),
                                   False, v)
        deepest = max(deepest, len(trace))
    return CheckResult(len(visited), transitions, deepest, False, None)


def replay_trace(model, trace: Sequence[Sequence],
                 check: bool = True) -> Violation | State:
    """Re-run a recorded event list against ``model``.

    Returns the Violation the trace produces, or the final state when the
    model survives it — which is how the golden regression traces assert
    "FAILS on the reverted model, PASSES on the current one".  Raises
    ValueError if an event is not enabled when its turn comes (the trace
    does not apply to this model at all).
    """
    state = model.initial()
    done: list[Event] = []
    for raw in trace:
        ev = tuple(raw)
        if ev not in model.events(state):
            raise ValueError(
                f"event {ev} not enabled at step {len(done)} "
                f"(enabled: {model.events(state)[:6]}...)")
        state = model.apply(state, ev)
        done.append(ev)
        if check:
            v = _check_state(model, state, done)
            if v is None and _stable(model, model.events(state)):
                v = _check_terminal(model, state, done)
            if v is not None:
                return v
    return state


def frames_in_trace(model, trace: Sequence[Sequence]) -> list[tuple]:
    """Every wire frame sent while replaying ``trace``: (frame_name,
    payload_struct, epoch) triples, in send order — the conformance hook
    that ties model vocabulary to the real grammar (models implement
    ``wire_frames(state, event)``)."""
    state = model.initial()
    out: list[tuple] = []
    for raw in trace:
        ev = tuple(raw)
        out.extend(model.wire_frames(state, ev))
        state = model.apply(state, ev)
    return out


InvariantFn = Callable[[State], "str | None"]
