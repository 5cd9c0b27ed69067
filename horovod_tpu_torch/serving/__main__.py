"""``python -m horovod_tpu_torch.serving`` — one serving replica on one card.

Builds the 162M decoder (:func:`~horovod_tpu_torch.models.transformer.
config_162m`: flash-attention and RMSNorm kernels on) with seeded random
weights on the device, serves a self-generated open-loop Poisson workload
through the continuous-batching engine, and prints one line
``SERVE_REPORT {...}`` with the load report, the engine's counters, the
kernels' launches over the run and the card's peak memory.

Knobs, as in the JAX package: ``HVD_TPU_SERVE_BACKEND`` (``transformer``
or ``stub``, the model-free token automaton), ``HVD_TPU_SERVE_QPS``,
``HVD_TPU_SERVE_DURATION_S``, the scheduler's ``HVD_TPU_SERVE_SLOTS`` /
``_BUCKETS`` / ``_MAX_LEN`` and the fast paths' ``HVD_TPU_SERVE_PREFIX_PAGES``
/ ``_PAGE_TOKENS`` (with prefix pages set, the model is served on the paged
KV pool, :class:`PagedTransformerBackend`) / ``_SPEC_K``.  ``--device``
picks the device (``cuda`` by default; ``cpu`` runs the plain PyTorch
versions), ``--seed`` the weights, ``--probe N`` serves a fixed prompt
alone, greedily, for N tokens after the run and reports the stream.

**Fleet mode**, as in the JAX package: with ``HVD_TPU_COORDINATOR_PORT``
set and ``JAX_NUM_PROCESSES`` > 1, the replica of rank ``JAX_PROCESS_ID``
joins the fleet's native control plane (rank 0 coordinates on that port)
and ticks the ``serving.tick`` collective every step; it serves its own
arrival stream (seeded by its rank) and keeps ticking until every replica
has drained.  With ``HVD_TPU_ELASTIC=1`` the fleet admits a replica
started with ``HVD_TPU_ELASTIC_JOIN=1``: it builds its model (from its own
``--seed``), joins by ticket, and pulls the weights of its ring neighbour
over the bulk data plane into ``backend.swap_params``, with no disk read;
the neighbour ships its ``model.state_dict()`` on the grow.  A joiner
started with ``--standby`` builds and warms its model, prints ``STANDBY``
and waits for a line on standard input before it knocks: a warm standby
that its supervisor admits when it decides to grow.  Each fleet replica
prints one line when its first request completes, and its report records
where its traffic stood when the fleet grew (``grew_at``).  The fleet's
report adds the tick's host time; the joiner's, the clone's bytes,
transport and pull time, its wait for admission, its time from admission
to its first token, and a CRC per tensor of its weights after the swap; the donor's, the ship's
bytes, transport and time and a CRC per tensor of what it shipped.  The
tick runs on the local executor, so its "sum" is rank-local, as in the
JAX package: the fleet-wide drain is the polled ``serving.drained``
collective, which completes on every replica after the same tick.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from horovod_tpu_torch import dataplane, elastic, faults, replication
from horovod_tpu_torch.core import engine as em
from horovod_tpu_torch.core.engine import (OP_ALLREDUCE, MembershipChanged,
                                           NativeEngine)
from horovod_tpu_torch.core.executors import local_executor
from horovod_tpu_torch.ops import _build
from horovod_tpu_torch.serving import autoscale, loadgen
from horovod_tpu_torch.serving.engine import (PagedTransformerBackend,
                                              ServingConfig, ServingEngine,
                                              StubBackend,
                                              TransformerBackend)
from horovod_tpu_torch.utils import env as env_knobs
from horovod_tpu_torch.utils.device import resolve_device

PROBE_SEED = 1234


def make_backend(cfg: ServingConfig, device=None, seed: int = 0):
    """The replica's backend: the stub under ``HVD_TPU_SERVE_BACKEND=stub``,
    else the 162M decoder with seeded weights on ``device``, on the paged
    KV pool when ``cfg.prefix_cache_pages`` is set.  Returns ``(backend,
    vocab_size)``."""
    if os.environ.get("HVD_TPU_SERVE_BACKEND", "transformer") == "stub":
        return StubBackend(cfg.num_slots), 256
    from horovod_tpu_torch.models.convert import init_params
    from horovod_tpu_torch.models.transformer import Transformer, config_162m

    dev = resolve_device(device)
    mcfg = config_162m(max_seq_len=cfg.max_seq_len)
    model = Transformer(mcfg, device=dev)
    model.load_state_dict(init_params(mcfg, seed))
    if cfg.prefix_cache_pages > 0:
        return PagedTransformerBackend(
            model, cfg.num_slots, cfg.max_seq_len,
            cache_pages=cfg.prefix_cache_pages,
            page_size=cfg.page_size), mcfg.vocab_size
    return TransformerBackend(model, cfg.num_slots, cfg.max_seq_len), \
        mcfg.vocab_size


def probe_prompt(cfg: ServingConfig, vocab: int) -> list[int]:
    """The fixed probe: a seeded prompt that fills the smallest bucket."""
    rng = np.random.default_rng(PROBE_SEED)
    n = max(1, min(cfg.buckets[0], cfg.max_seq_len - 1) - 2)
    return [int(t) for t in rng.integers(1, vocab, size=n)]


def _sync(backend) -> None:
    model = getattr(backend, "model", None)
    if model is not None and next(model.parameters()).is_cuda:
        torch.cuda.synchronize()


def _peak_memory(backend) -> int | None:
    model = getattr(backend, "model", None)
    if model is None or not next(model.parameters()).is_cuda:
        return None
    return torch.cuda.max_memory_allocated()


def _fleet_engine(rank: int, n: int, port: int, joining: bool,
                  info: dict) -> NativeEngine:
    # The bulk listener's port rides this rank's HELLO, so a donor's ticket
    # names it and the weights stream directly (the JAX package's CLI
    # binds the listener but does not advertise it, so its clones take
    # the coordinator relay).
    bulk_port = dataplane.ensure_listener()
    if joining:
        t0 = time.monotonic()
        t = elastic.join("127.0.0.1", port, old_rank=rank, timeout_s=60.0)
        info["admitted_t"] = time.monotonic()
        info["admission_wait_ms"] = (info["admitted_t"] - t0) * 1e3
        host, cport = elastic.coordinator_endpoint("127.0.0.1", port)
        eng = NativeEngine(t.assigned_rank, t.new_size,
                           executor=local_executor, coordinator_host=host,
                           coordinator_port=cport, cycle_time_ms=2.0,
                           epoch=t.epoch, bulk_port=bulk_port)
    else:
        eng = NativeEngine(rank, n, executor=local_executor,
                           coordinator_host="127.0.0.1",
                           coordinator_port=port, cycle_time_ms=2.0,
                           bulk_port=bulk_port)
    elastic.attach(eng)
    return eng


def _pull(eng, backend) -> dict:
    """The joiner's clone: the donor's weights off the data plane into
    ``backend.swap_params``.  Raises when nothing arrives in time."""
    model = getattr(backend, "model", None)
    device = next(model.parameters()).device if model is not None else None
    t0 = time.monotonic()
    snap = autoscale.pull_weights(eng, timeout_s=60.0, device=device)
    if snap is None:
        raise RuntimeError("no weights arrived over the data plane within "
                           "60 s")
    if hasattr(backend, "swap_params"):
        backend.swap_params(snap["state"])
    _sync(backend)
    pull_ms = (time.monotonic() - t0) * 1e3
    dp = dataplane.stats()
    out = {"version": snap["step"], "bytes": dp["bytes_received"],
           "transport": "direct" if dp["streams_received"] else "relay",
           "pull_ms": pull_ms,
           "disk_reads": replication.replication_stats()["disk_restores"]}
    if model is not None:
        out["crcs"] = replication.tensor_crcs(model.state_dict())
    print(f"[serve r{eng.rank}] weights v{snap['step']} pulled over the "
          f"data plane ({out['transport']}, {out['bytes']} B, no disk)",
          flush=True)
    return out


def _ship(eng, dst: int, backend) -> dict:
    """The donor's side of a grow: its weights to the joiner."""
    model = getattr(backend, "model", None)
    state = model.state_dict() if model is not None else {"version": 1}
    t0 = time.monotonic()
    via = autoscale.ship_weights(eng, dst, 1, state)
    out = {"dst": dst, "transport": via,
           "ship_ms": (time.monotonic() - t0) * 1e3,
           "bytes": replication.replication_stats()[
               "bytes_shipped_direct" if via == "direct"
               else "bytes_shipped_relay"]}
    if model is not None:
        out["crcs"] = replication.tensor_crcs(state)
    return out


def _leave(eng) -> None:
    """The last collective of a drained fleet, after which a replica may
    exit.  The coordinator first stops admitting joins (it closes its
    listen socket), then every replica meets in ``serving.leave``.  A join
    admitted before that point broadcasts its RECONFIG ahead of the
    coordinator's ``serving.leave`` on every worker's ordered stream, so
    every replica's leave fails with ``MembershipChanged`` and the fleet
    re-forms with the joiner: no replica can exit while another re-forms
    around it.  A joiner that knocks after the leave finds no listener."""
    if eng.rank == 0:
        eng.detach_listener()
    h = eng.enqueue("serving.leave", np.zeros(1, np.float32), OP_ALLREDUCE)
    eng.synchronize(h)


def _serve_fleet(serving: ServingEngine, w: loadgen.Workload, backend,
                 info: dict) -> dict:
    """Multi-replica serve loop: each rank submits its own arrival stream
    but keeps ticking (the fleet collective must stay in lockstep) until
    EVERY replica has drained.  The drain rendezvous is a one-shot
    ``serving.drained`` collective announced when this rank empties and
    watched while ticking continues: the coordinator dispatches it only
    once all replicas announced, and every replica leaves after the first
    tick ordered after it (``ServingEngine.at_leave_point``), which the
    coordinator orders alike on every rank: a replica that sees the
    drain complete behind an earlier tick ticks once more, with its
    peers, rather than leave them waiting on a tick that never completes.
    Membership changes reconfigure in place; on a grow, the joiner's ring
    neighbour donates the weights over the data plane (``info["shipped"]``).
    A drain that a grow overtakes is void (see :func:`_leave`): the fleet,
    joiner included, serves on and drains again.
    ``info["first_token_t"]`` is the engine-clock time of this replica's
    first token; ``info["grew_at"]`` the requests this replica had
    submitted and completed when the fleet last grew."""
    arrivals = loadgen.make_arrivals(w)
    # Rank 0 runs the live autoscale policy over the tick aggregates;
    # verdicts land as AUTOSCALE timeline instants and one stdout line
    # each, which the supervisor holding the fleet acts on.
    auto = autoscale.Autoscaler(autoscale.AutoscaleConfig.from_env(),
                                collective=serving.collective)
    t0 = serving.clock()
    done, i = [], 0
    drained_h = None
    deadline = t0 + w.duration_s * 20
    while True:
        now = serving.clock() - t0
        while i < len(arrivals) and arrivals[i][0] <= now:
            serving.submit(arrivals[i][1], arrivals[i][2])
            i += 1
        mine_done = (i >= len(arrivals) and not serving.queue
                     and serving._active_count() == 0)
        serving.done_flag = 1.0 if mine_done else 0.0
        try:
            completed = len(done)
            done.extend(serving.step())
            if "first_token_t" not in info and serving.counters["tokens"]:
                info["first_token_t"] = serving.clock()
            if done and not completed:
                print(f"[serve r{serving.collective.rank}] first request "
                      f"completed", flush=True)
            if serving.collective.rank == 0 and not mine_done:
                verdict = auto.decide(
                    replicas=serving.collective.size,
                    queued=serving.fleet.get("queued", 0.0),
                    active_slots=serving.fleet.get("active", 0.0),
                    p99_ttft_ms=serving.stats()["ttft_p99_ms"])
                if verdict is not None:
                    print(f"AUTOSCALE {verdict} "
                          f"replicas={serving.collective.size}", flush=True)
            if mine_done and drained_h is None:
                drained_h = serving.announce_drained()
            if drained_h is not None:
                faults.on_drained_poll(serving.collective.rank)
            if drained_h is not None and \
                    serving.at_leave_point(drained_h):
                serving.collective.synchronize(drained_h)
                faults.on_drain(serving.collective.rank)
                _leave(serving.collective)
                break
        except MembershipChanged:
            ev = elastic.reconfigure()
            serving.collective = em.peek_engine()
            auto.collective = serving.collective
            drained_h = None  # handle belonged to the replaced engine
            if ev.grew:
                info["grew_at"] = {"submitted": i, "completed": len(done),
                                   "offered": len(arrivals)}
            if ev.grew and serving.collective.rank == ev.new_size - 2:
                info["shipped"] = _ship(serving.collective, ev.new_size - 1,
                                        backend)
        if serving.clock() > deadline:
            break
        if mine_done:
            time.sleep(0.001)
    return loadgen.report(done, max(serving.clock() - t0, 1e-9),
                          offered=len(arrivals))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m horovod_tpu_torch.serving")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; raises without one)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights (and of the workload "
                         "of a replica outside a fleet)")
    ap.add_argument("--probe", type=int, default=0, metavar="N",
                    help="after the run, serve a fixed prompt alone for N "
                         "greedy tokens and report them")
    ap.add_argument("--standby", action="store_true",
                    help="a joiner: once its model is built and warm, "
                         "print STANDBY and wait for a line on standard "
                         "input before joining the fleet")
    args = ap.parse_args(argv)
    rank = int(os.environ.get("JAX_PROCESS_ID", "0"))
    n = int(os.environ.get("JAX_NUM_PROCESSES", "1"))
    port = os.environ.get("HVD_TPU_COORDINATOR_PORT")
    fleet = port is not None and n > 1
    joining = fleet and os.environ.get("HVD_TPU_ELASTIC_JOIN") == "1"
    cfg = ServingConfig.from_env()
    backend, vocab = make_backend(cfg, args.device, args.seed)
    # Warm-up: one short request, so the measured run does not pay the
    # first cuBLAS and allocator calls.
    warm = ServingEngine(backend, cfg)
    warm.submit(probe_prompt(cfg, vocab), 2)
    warm.run_until_idle()
    info: dict = {}
    eng = None
    if fleet:
        if joining and args.standby:
            print("STANDBY", flush=True)
            sys.stdin.readline()
        eng = _fleet_engine(rank, n, int(port), joining, info)
        if joining:
            info["pulled"] = _pull(eng, backend)
    serving = ServingEngine(backend, cfg, collective=eng)
    w = loadgen.Workload(qps=env_knobs.serve_qps(),
                         duration_s=env_knobs.serve_duration_s(),
                         seed=rank if fleet else args.seed,
                         prompt_lens=tuple(b - 2 for b in cfg.buckets[:3]),
                         vocab=vocab)
    _sync(backend)
    _build.reset_launches()
    if eng is None:
        rep = loadgen.run_load(serving, w, max_wall_s=w.duration_s * 20)
    else:
        rep = _serve_fleet(serving, w, backend, info)
    _sync(backend)
    out = {"rank": serving.collective.rank if fleet else rank, **rep,
           **serving.stats(), **serving.tick_stats(),
           "launches": {k: v.launches for k, v in _build.KERNELS.items()},
           "max_memory_allocated": _peak_memory(backend)}
    if joining:
        out["pulled"] = info["pulled"]
        out["admission_wait_ms"] = info["admission_wait_ms"]
        if "first_token_t" in info:
            out["join_to_first_token_ms"] = \
                (info["first_token_t"] - info["admitted_t"]) * 1e3
    for key in ("shipped", "grew_at"):
        if key in info:
            out[key] = info[key]
    if args.probe:
        probe = ServingEngine(backend, cfg)
        req = probe.submit(probe_prompt(cfg, vocab), args.probe)
        probe.run_until_idle()
        out["probe"] = req.tokens
    print("SERVE_REPORT " + json.dumps(out), flush=True)
    if eng is not None:
        em.peek_engine().shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
