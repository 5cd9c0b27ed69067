"""``python -m horovod_tpu_torch.analysis.protocol`` — the model-check leg of
``python -m horovod_tpu_torch.core.check``.

Three sweeps, all deterministic:

1. **Spec sweep** — exhaustive BFS over every fixed-flag model (the code
   as shipped / the relay-tier spec).  Any violation fails the run and
   prints the shortest counterexample plus its ``HVD_TPU_FAULT_*`` repro
   schedule (replay.py).
2. **Teeth sweep** — every bug knob flipped one at a time; each MUST
   re-derive its named violation (a knob that stops producing its
   counterexample means the checker lost the regression, which is as
   much a failure as a spec violation).
3. **Walk** — one seeded random-walk per fixed model, reaching depths
   the bounded BFS cannot.

Env knobs (CI widens, laptops narrow):

* ``MODELCHECK_SKIP=1``   — skip entirely.
* ``MODELCHECK_DEPTH=N``  — BFS horizon (default 60).
* ``MODELCHECK_SEED=N``   — walk seed (default 1).
* ``MODELCHECK_WIDE=1``   — add the 4-worker serving sweep (~30s extra).

Exit status 0 only when every sweep lands exactly as specified.
"""

from __future__ import annotations

import os
import sys
import time

from horovod_tpu_torch.analysis.protocol.checker import check_bfs, check_walk
from horovod_tpu_torch.analysis.protocol.machines import (ElasticModel,
                                                    ServingDrainModel,
                                                    TreeModel)
from horovod_tpu_torch.analysis.protocol.replay import format_repro


def _specs():
    """(label, model, min_states) — fixed flags, must pass exhaustively."""
    yield ("serving star+drain   w=2 r=1 c=1", ServingDrainModel(), 500)
    yield ("serving star+drain   w=3 r=2 c=1",
           ServingDrainModel(workers=3, reqs=2, crashes=1), 10_000)
    yield ("elastic succession   seq=2 knocks=2 f=1", ElasticModel(), 1_000)
    yield ("tree relay tier      g=2 f=2 t=2 c=1", TreeModel(), 5_000)
    if os.environ.get("MODELCHECK_WIDE") == "1":
        yield ("serving star+drain   w=4 r=1 c=1 [wide]",
               ServingDrainModel(workers=4, reqs=1, crashes=1), 100_000)


def _teeth():
    """(label, model, expected invariant) — the counterexample pins."""
    yield ("serving deliver_before_tick=False  [lost completion]",
           ServingDrainModel(deliver_before_tick=False),
           "no-lost-completion")
    yield ("serving drain_by_protocol=False    [drain wedge]",
           ServingDrainModel(drain_by_protocol=False), "quiescence")
    yield ("serving refcount_shared_pages=False [prefix-cache bug]",
           ServingDrainModel(reqs=2, refcount_shared_pages=False),
           "page-refcount")
    yield ("elastic promotion_bumps_epoch=False",
           ElasticModel(promotion_bumps_epoch=False), "single-coordinator")
    yield ("elastic clamp_join_id=False        [join sentinel]",
           ElasticModel(clamp_join_id=False), "quiescence")
    yield ("elastic idempotent_reissue=False",
           ElasticModel(idempotent_reissue=False), "ticket-single-use")
    yield ("tree replicate_before_fanout=False",
           TreeModel(replicate_before_fanout=False), "quiescence")
    yield ("tree root_replicate_before_send=False",
           TreeModel(root_replicate_before_send=False), "quiescence")
    yield ("tree root_replays_stale=False",
           TreeModel(root_replays_stale=False), "quiescence")


def main() -> int:
    if os.environ.get("MODELCHECK_SKIP") == "1":
        print("modelcheck: skipped (MODELCHECK_SKIP=1)")
        return 0
    depth = int(os.environ.get("MODELCHECK_DEPTH", "60"))
    seed = int(os.environ.get("MODELCHECK_SEED", "1"))
    failed = False
    total_states = 0

    print(f"== spec sweep (exhaustive BFS, depth {depth}) ==")
    for label, model, floor in _specs():
        t0 = time.time()
        r = check_bfs(model, max_depth=depth)
        dt = time.time() - t0
        total_states += r.states
        line = (f"  {label:40s} states={r.states:7d} "
                f"transitions={r.transitions:8d} depth={r.depth:3d} "
                f"complete={r.complete} {dt:5.1f}s")
        if not r.ok:
            failed = True
            print(line + "  VIOLATION")
            print(format_repro(model, r.violation.trace, r.violation))
        elif not r.complete:
            failed = True
            print(line + f"  INCOMPLETE (raise MODELCHECK_DEPTH>{depth})")
        elif r.states < floor:
            failed = True
            print(line + f"  TOO SMALL (< {floor}: model degenerated?)")
        else:
            print(line + "  ok")

    print("== teeth sweep (every bug knob must re-derive its violation) ==")
    for label, model, want in _teeth():
        r = check_bfs(model, max_depth=depth)
        got = r.violation.invariant if r.violation else None
        if got != want:
            failed = True
            print(f"  {label:40s} expected {want!r}, got {got!r}  LOST")
        else:
            print(f"  {label:40s} {want} in {len(r.violation.trace)} "
                  f"events  ok")

    print(f"== walk sweep (seed {seed}) ==")
    for label, model, _floor in _specs():
        r = check_walk(model, seed=seed)
        if not r.ok:
            failed = True
            print(f"  {label:40s} VIOLATION at depth {r.depth}")
            print(format_repro(model, r.violation.trace, r.violation))
        else:
            print(f"  {label:40s} visited={r.states:7d} "
                  f"deepest={r.depth:3d}  ok")

    print(f"modelcheck: {total_states} distinct states"
          f"{' — FAILED' if failed else ', all invariants hold'}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
