"""One serving replica speaking a line protocol — the soak fleet's unit;
counterpart of ``horovod_tpu/serving/worker.py``.

A worker is an engine-only process (the port's :class:`NativeEngine` and
the :class:`StubBackend`, no model) running the continuous-batching loop
with the ``serving.tick`` collective attached.  Its stdin/stdout is the
request plane for the soak driver (``serving/soak.py``):

parent -> worker::

    REQ <rid> <max_new> <t0,t1,...>   submit a request (R suffix = retry)
    SWAP <version>                    rank 0: hot-swap new weights fleet-wide
    STATS                             dump serving_stats() as one line
    QUIT                              drain and exit 0

worker -> parent::

    READY rank=.. size=.. epoch=..    engine up, accepting requests
    JOINED epoch=.. as=.. size=..     (join mode) admitted via JOIN ticket
    WEIGHTS version=.. crc=.. disk_reads=..   weights landed off the wire
    SWAPPED version=.. crc=..         hot-swap applied between steps
    DONE <rid> ntok=.. crc=.. reason=..       request completed
    RECONFIGURED epoch=.. size=..     survived a membership change
    SHIPPED dst=.. version=.. via=..  donated the weights to a joiner
    AUTOSCALE grow|shrink ...         rank 0: live policy verdict — the
                                      supervisor (soak driver) acts on it
    STATS {...}

Two drain rules hold, as in the JAX package, where each was once a bug:

* completions are delivered before a re-form: a step's DONE lines go out
  before its tick, and a tick aborted by a membership change parks the
  step's completions for the next step (``ServingEngine.step``);
* a worker exits only on the fleet-wide ``serving.drained`` verdict, never
  on a locally drained queue.  On QUIT it keeps ticking with
  ``done_flag`` raised and announces a one-shot polled
  ``serving.drained`` collective: the coordinator dispatches it only once
  every replica has announced, and the whole fleet breaks out after the
  same tick, the first one ordered after it
  (``ServingEngine.at_leave_point``).  A replica that stopped early would
  stall its peers' ``serving.tick``.

Founding mode: argv = ``rank n coordinator_port``; join mode: argv =
``--join coordinator_port``.  On a grow reconfiguration the survivor
that is the joiner's ring neighbour donates the current weights over the
bulk data plane (``autoscale.ship_weights``); the joiner reports
``disk_reads=`` the restores that fell through to disk
(``replication.note_disk_restore``), which stays 0: a worker never reads
weights from disk.
"""

from __future__ import annotations

import os
import queue
import sys
import threading
import time
import zlib

import numpy as np

from horovod_tpu_torch import elastic, replication
from horovod_tpu_torch.core import engine as em
from horovod_tpu_torch.core.engine import MembershipChanged, NativeEngine
from horovod_tpu_torch.core.executors import local_executor
from horovod_tpu_torch.serving import autoscale
from horovod_tpu_torch.serving.engine import (ServingConfig,
                                              ServingEngine, StubBackend)

VOCAB = 256


def make_weights(version: int) -> dict:
    """Deterministic fake model state: any replica can regenerate version
    v, and the joiner's pulled copy is checkable by CRC alone."""
    rng = np.random.RandomState(version)
    return {"version": version,
            "w": rng.randint(0, 1000, size=4096).astype(np.int64)}


def weights_crc(state: dict) -> int:
    return zlib.crc32(state["w"].tobytes()) ^ state["version"]


def expected_completion(prompt, max_new: int, vocab: int = VOCAB):
    """The exact token stream the StubBackend engine produces for this
    request — the soak driver verifies retried requests against it."""
    p = len(prompt)
    toks = [(int(sum(prompt)) + p) % vocab]
    for i in range(max_new - 1):
        toks.append(StubBackend._next(toks[-1], p + 1 + i, vocab))
    return toks[:max_new]


def completion_crc(tokens) -> int:
    return zlib.crc32(np.asarray(tokens, np.int32).tobytes())


def _say(line: str) -> None:
    print(line, flush=True)


def _reader(q: "queue.Queue[str]") -> None:
    for line in sys.stdin:
        q.put(line.strip())
    q.put("QUIT")  # EOF: parent died — drain and leave


def _build_engine(args) -> NativeEngine:
    from horovod_tpu_torch import dataplane

    # The bulk port rides this rank's HELLO, so weight clones stream
    # directly (the JAX package's worker binds the listener but does not
    # advertise it, so its clones take the coordinator relay).
    bulk_port = dataplane.ensure_listener()
    if args[0] == "--join":
        port = int(args[1])
        # old_rank must be >= 0: the native PollJoinRequest() returns the
        # knocker's id and its caller treats negatives as "no join
        # pending", so a -1 would park the connection unserviced forever.
        # A fresh autoscaled replica has no prior seat; 0 reads as "new".
        t = elastic.join("127.0.0.1", port, old_rank=0, timeout_s=60.0)
        _say(f"JOINED epoch={t.epoch} as={t.assigned_rank} "
             f"size={t.new_size}")
        host, cport = elastic.coordinator_endpoint("127.0.0.1", port)
        return NativeEngine(t.assigned_rank, t.new_size,
                            executor=local_executor, coordinator_host=host,
                            coordinator_port=cport, cycle_time_ms=2.0,
                            epoch=t.epoch, bulk_port=bulk_port)
    rank, n, port = int(args[0]), int(args[1]), int(args[2])
    return NativeEngine(rank, n, executor=local_executor,
                        coordinator_host="127.0.0.1", coordinator_port=port,
                        cycle_time_ms=2.0, bulk_port=bulk_port)


def main(argv=None) -> int:
    args = argv if argv is not None else sys.argv[1:]
    joining = args[0] == "--join"
    eng = _build_engine(args)
    elastic.attach(eng)
    version, state = 1, None
    if joining:
        # Pull weights from the donor over the data plane — no disk.
        snap = autoscale.pull_weights(eng, timeout_s=30.0, min_version=1)
        if snap is None:
            _say("WEIGHTS version=-1 crc=0 disk_reads=-1")
            return 4
        version, state = snap["step"], snap["state"]
        disk_reads = replication.replication_stats()["disk_restores"]
        _say(f"WEIGHTS version={version} crc={weights_crc(state)} "
             f"disk_reads={disk_reads}")
    else:
        state = make_weights(version)
    step_s = float(os.environ.get("HVD_TPU_SERVE_STEP_S", "0.003"))
    # Geometry is pinned (the soak's request mix is sized to it); the
    # prefix-cache and speculation knobs ride the env so the chaos soak
    # can run with both fast paths on — completions must stay identical
    # (the stub's stream is a pure function of the prompt either way).
    cfg = ServingConfig.from_env(num_slots=4, buckets=(8, 16, 32),
                                 max_seq_len=128)
    serving = ServingEngine(
        StubBackend(cfg.num_slots, VOCAB, step_s=step_s), cfg,
        collective=eng,
        on_complete=lambda r: _say(
            f"DONE {r.rid} ntok={len(r.tokens)} "
            f"crc={completion_crc(r.tokens)} reason={r.finish_reason}"))
    cmds: "queue.Queue[str]" = queue.Queue()
    threading.Thread(target=_reader, args=(cmds,), daemon=True).start()
    # The live autoscale policy: rank 0 feeds it the serving.tick
    # aggregates every tick and prints its verdicts; the supervisor
    # holding the fleet (soak driver) does the spawning/retiring.
    auto = autoscale.Autoscaler(autoscale.AutoscaleConfig.from_env(),
                                collective=eng)
    _say(f"READY rank={eng.rank} size={eng.size} epoch={eng.epoch}")
    quitting = False
    drained_h = None
    while True:
        try:
            cmd = cmds.get(timeout=0.002)
        except queue.Empty:
            cmd = None
        if cmd == "QUIT":
            quitting = True
        elif cmd == "STATS":
            _say(f"STATS {serving.stats()!r}")
        elif cmd and cmd.startswith("SWAP "):
            version = int(cmd.split()[1])
            state = make_weights(version)
            for dst in range(eng.size):
                if dst != eng.rank:
                    autoscale.ship_weights(eng, dst, version, state)
            _say(f"SWAPPED version={version} crc={weights_crc(state)}")
        elif cmd and cmd.startswith("REQ "):
            _, rid, max_new, toks = cmd.split(None, 3)
            retry = rid.endswith("R")
            serving.submit([int(t) for t in toks.split(",")],
                           int(max_new), rid=int(rid.rstrip("R")),
                           retry=retry)
        mine_done = quitting and not serving.queue \
            and not serving._active_count()
        serving.done_flag = 1.0 if mine_done else 0.0
        try:
            # Always tick — a drained replica that stopped stepping would
            # stall its peers' serving.tick allreduce (engine.done_flag
            # comment); the fleet leaves together via serving.drained.
            serving.step()
            if mine_done and drained_h is None:
                drained_h = serving.announce_drained()
            if drained_h is not None and serving.at_leave_point(drained_h):
                serving.collective.synchronize(drained_h)
                break
            if eng.rank == 0 and not quitting:
                verdict = auto.decide(
                    replicas=eng.size,
                    queued=serving.fleet.get("queued",
                                             float(len(serving.queue))),
                    active_slots=serving.fleet.get(
                        "active", float(serving._active_count())),
                    p99_ttft_ms=serving.stats()["ttft_p99_ms"])
                if verdict is not None:
                    _say(f"AUTOSCALE {verdict} replicas={eng.size}")
            swap = autoscale.poll_weights(eng, version)
            if swap is not None:
                version, state = swap["step"], swap["state"]
                _say(f"SWAPPED version={version} crc={weights_crc(state)}")
        except MembershipChanged:
            ev = elastic.reconfigure()
            eng = em.peek_engine()
            serving.collective = eng
            auto.collective = eng
            drained_h = None  # handle belonged to the replaced engine
            _say(f"RECONFIGURED epoch={ev.epoch} size={ev.new_size}")
            if ev.grew and eng.rank == ev.new_size - 2:
                # I'm the joiner's ring neighbor: donate the weights.
                via = autoscale.ship_weights(eng, ev.new_size - 1, version,
                                             state)
                _say(f"SHIPPED dst={ev.new_size - 1} version={version} "
                     f"via={via}")
        if mine_done:
            time.sleep(0.001)
    _say(f"STATS {serving.stats()!r}")
    eng.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
