"""Counterexample -> fault-injection schedule translation.

A checker trace is an abstract interleaving; the ``HVD_TPU_FAULT_*``
grammar (faults.py, executed natively by core/src/controller.cc) is how
the same fault is driven against the real control plane.
:func:`env_schedule` walks a trace through the model, counts ticks and
control-plane frames as it goes, and emits the env plan that arms the
trace's fault events at the equivalent point in a real run:

* a crash of replica ``r`` after it completed ``s`` tick cycles ->
  ``HVD_TPU_FAULT_KILL_RANK=r  HVD_TPU_FAULT_KILL_STEP=s``
* a coordinator partition after the coordinator sent ``f`` control-plane
  frames in membership epoch ``e`` ->
  ``HVD_TPU_FAULT_WIRE_PARTITION=0:f@e`` (the split-brain drill: the old
  coordinator stays alive but unreachable — run with
  ``HVD_TPU_MIN_SIZE`` so it takes the exit-75 abort)
* a coordinator crash -> ``HVD_TPU_FAULT_KILL_RANK=0`` keyed to its
  authoritative progress counter
* tree-tier crashes (root / relay primary, the relay-tier spec) -> KILL
  plans against the spec's rank numbering (root 0, members
  ``1 + g*fanout + k``, root standby after the members, relay primaries
  after that) — executable the day the native tier lands.

The frame index uses the same counting rule as controller.cc: the
injector arms from the victim's ``<frame>``-th SENT control-plane frame
onward, so we count the frames the victim put on the wire before the
fault event, via the model's ``wire_frames`` hook.  The emitted dict
round-trips through ``faults._plan_from_env`` of horovod_tpu_torch (see
tests/test_torch_protocol_model.py), which is the same parser the launcher and
the native controller agree on.
"""

from __future__ import annotations

from typing import Sequence

# Frames originated by the coordinator or root side of each link; everything
# else in the vocabulary is worker->coordinator.
_COORD_SENT = frozenset({
    "HELLO_ACK", "RESPONSE", "ABORT", "RECONFIG", "JOIN_ACK", "STATE",
    "TICKET", "SHARD_ACK",
})


def _epoch_of(state) -> int:
    for attr in ("epoch", "c_epoch"):
        if hasattr(state, attr):
            return getattr(state, attr)
    return 0


def env_schedule(model, trace: Sequence[Sequence]) -> dict[str, str]:
    """The ``HVD_TPU_FAULT_*`` env plan reproducing ``trace``'s faults.

    Deterministic: replays the trace through ``model.apply`` (raising
    ValueError via the same not-enabled check as ``replay_trace`` would
    is deliberately NOT done here — schedules for pre-fix models must
    still be derivable), accumulating per-rank tick counts and the
    coordinator's sent-frame count, then keys each fault event to those
    counters.  Returns {} for a fault-free trace (wedges that need no
    injector, e.g. the negative-id JOIN park, reproduce from a clean
    boot).
    """
    state = model.initial()
    env: dict[str, str] = {}
    ticks: dict[int, int] = {}   # completed tick cycles per serving rank
    coord_frames = 0             # control-plane frames the coordinator sent
    for raw in trace:
        ev = tuple(raw)
        kind = ev[0]
        epoch = _epoch_of(state)
        if kind == "crash":                      # serving replica SIGKILL
            r = ev[1]
            env["HVD_TPU_FAULT_KILL_RANK"] = str(r)
            env["HVD_TPU_FAULT_KILL_STEP"] = str(ticks.get(r, 0))
        elif kind == "fail_coord":               # elastic coordinator fault
            if ev[1] == "crash":
                env["HVD_TPU_FAULT_KILL_RANK"] = "0"
                env["HVD_TPU_FAULT_KILL_STEP"] = str(state.c_seq)
            else:
                env["HVD_TPU_FAULT_WIRE_PARTITION"] = \
                    f"0:{coord_frames}@{epoch}"
        elif kind == "crash_root":               # tree root SIGKILL
            env["HVD_TPU_FAULT_KILL_RANK"] = "0"
            env["HVD_TPU_FAULT_KILL_STEP"] = str(max(state.r_last + 1, 0))
        elif kind == "crash_relay":              # tree relay-primary SIGKILL
            g = ev[1]
            rank = 2 + model.g * model.f + g  # after members + root standby
            env["HVD_TPU_FAULT_KILL_RANK"] = str(rank)
            env["HVD_TPU_FAULT_KILL_STEP"] = \
                str(max(state.relays[g].high_seq + 1, 0))
        if hasattr(model, "wire_frames"):
            for name, _payload, _e in model.wire_frames(state, ev):
                if name in _COORD_SENT:
                    coord_frames += 1
        if kind == "step":
            ticks[ev[1]] = ticks.get(ev[1], 0) + 1
        state = model.apply(state, ev)
    return env


def format_repro(model, trace: Sequence[Sequence],
                 violation=None) -> str:
    """A copy-pastable repro block: the env exports plus the abstract
    interleaving as a comment — what `python -m ...protocol` prints under
    a counterexample so the schedule travels with the trace."""
    lines = []
    if violation is not None:
        lines.append(f"# {violation.invariant}: {violation.detail}")
    lines += [f"#   {i:3d}. {' '.join(str(x) for x in ev)}"
              for i, ev in enumerate(tuple(tuple(e) for e in trace))]
    env = env_schedule(model, trace)
    if env:
        lines += [f"export {k}={v}" for k, v in sorted(env.items())]
    else:
        lines.append("# no injector needed: reproduces from a clean boot")
    return "\n".join(lines)
