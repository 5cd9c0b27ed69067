"""The engine scenarios of ``tests/test_response_cache.py``,
``tests/test_schedule_verify.py`` and ``tests/test_stall.py`` on the port's
engine: ``horovod_tpu_torch.core.engine.NativeEngine`` with the port's
``multihost`` executor, every multi-process job a gloo job of its own
(``init(device="cpu")`` over a file store), so every batch the coordinator
orders is reduced across the processes.

Where the JAX tests run the ``local`` executor, an identity data plane
(each rank gets its own input back), these see the sums: a value the JAX
test pins as ``rank`` or ``rank + 1`` is the sum over the ranks here, and
a ragged allgather returns every rank's rows.  The control-plane facts
each scenario pins (cache hits and misses, bypassed ticks, coordinated
errors, the verifier's report, the stall report and its escalation) are
the JAX tests' own.  Their ThreadSanitizer case needs a TSAN build of the
port's core, which ``core/_build.py`` does not make (ROADMAP)."""

import multiprocessing
import os
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest

from _timing import scaled
from horovod_tpu_torch.analysis.schedule import ScheduleRecorder
from horovod_tpu_torch.core.engine import (OP_ALLGATHER, OP_ALLREDUCE,
                                           OP_BROADCAST, CollectiveError,
                                           NativeEngine)
from horovod_tpu_torch.core.executors import multihost_executor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    from horovod_tpu_torch.serving.soak import free_port

    return free_port()


def _median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2]


@pytest.fixture()
def world1(monkeypatch):
    import horovod_tpu_torch as hvd

    for name in ("RANK", "WORLD_SIZE", "JAX_PROCESS_ID", "JAX_NUM_PROCESSES",
                 "JAX_COORDINATOR_ADDRESS", "MASTER_ADDR", "MASTER_PORT",
                 "HVD_TPU_VERIFY_SCHEDULE", "HOROVOD_VERIFY_SCHEDULE",
                 "HOROVOD_TIMELINE"):
        monkeypatch.delenv(name, raising=False)
    hvd.init(device="cpu")
    yield
    hvd.shutdown()


def _engine(rank=0, size=1, **kw):
    return NativeEngine(rank, size, executor=multihost_executor, **kw)


# -- one process: stats, fast path, eviction, invalidation --------------------

def test_cache_hits_and_bypassed_ticks(world1):
    eng = _engine(cycle_time_ms=1.0, cache_capacity=16)
    try:
        for _ in range(4):
            for n in range(3):
                out = eng.synchronize(eng.enqueue(
                    f"c{n}", np.full(4, 2.0, np.float32), OP_ALLREDUCE))
                np.testing.assert_array_equal(out, np.full(4, 2.0,
                                                           np.float32))
        stats = eng.cache_stats()
    finally:
        eng.shutdown()
    assert stats["misses"] == 3 and stats["hits"] == 9, stats
    assert stats["entries"] == 3 and stats["capacity"] == 16, stats
    assert stats["bypassed_ticks"] > 0, stats


def test_cache_disabled_is_inert(world1):
    eng = _engine(cycle_time_ms=1.0, cache_capacity=0)
    try:
        for _ in range(3):
            out = eng.synchronize(eng.enqueue(
                "off", np.ones(4, np.float32), OP_ALLREDUCE))
            np.testing.assert_array_equal(out, np.ones(4, np.float32))
        stats = eng.cache_stats()
    finally:
        eng.shutdown()
    assert stats == {"hits": 0, "misses": 0, "evictions": 0,
                     "bypassed_ticks": 0, "entries": 0, "capacity": 0}, stats


def test_cache_hit_latency_beats_cycle_time(world1):
    cycle_ms = 200.0

    def per_op_ms(eng, n_ops):
        samples = []
        for _ in range(n_ops):
            t0 = time.perf_counter()
            eng.synchronize(eng.enqueue("lat", np.ones(64, np.float32),
                                        OP_ALLREDUCE))
            samples.append((time.perf_counter() - t0) * 1000.0)
        return _median(samples)

    warm_eng = _engine(cycle_time_ms=cycle_ms, cache_capacity=8)
    try:
        warm_eng.synchronize(warm_eng.enqueue(
            "lat", np.ones(64, np.float32), OP_ALLREDUCE))
        warm = per_op_ms(warm_eng, 5)
        assert warm_eng.cache_stats()["hits"] >= 5
    finally:
        warm_eng.shutdown()
    cold_eng = _engine(cycle_time_ms=cycle_ms, cache_capacity=0)
    try:
        cold = per_op_ms(cold_eng, 5)
    finally:
        cold_eng.shutdown()
    assert warm < cycle_ms / 2, (warm, cold)
    assert cold > cycle_ms / 2, (warm, cold)
    assert cold > 2 * warm, (warm, cold)


def test_lru_eviction_stays_correct(world1):
    eng = _engine(cycle_time_ms=1.0, cache_capacity=2)
    try:
        for _ in range(3):
            for n in range(4):   # working set (4) > capacity (2): thrash
                out = eng.synchronize(eng.enqueue(
                    f"ev{n}", np.full(2, float(n), np.float32),
                    OP_ALLREDUCE))
                np.testing.assert_array_equal(
                    out, np.full(2, float(n), np.float32))
        stats = eng.cache_stats()
    finally:
        eng.shutdown()
    assert stats["evictions"] > 0 and stats["entries"] <= 2, stats


def test_signature_change_invalidates_and_repopulates(world1):
    eng = _engine(cycle_time_ms=1.0, cache_capacity=8)
    try:
        for _ in range(2):
            eng.synchronize(eng.enqueue("sig", np.ones(2, np.float32),
                                        OP_ALLREDUCE))
        s1 = eng.cache_stats()
        for _ in range(2):
            out = eng.synchronize(eng.enqueue("sig", np.ones(5, np.float32),
                                              OP_ALLREDUCE))
            assert out.shape == (5,)
        s2 = eng.cache_stats()
    finally:
        eng.shutdown()
    assert s1["hits"] == 1 and s1["misses"] == 1, s1
    assert s2["misses"] == 2 and s2["hits"] == 2, s2
    assert s2["entries"] == 1, s2


def test_cached_ops_cover_all_types(world1):
    eng = _engine(cycle_time_ms=1.0, cache_capacity=8)
    try:
        x = np.arange(6, dtype=np.int64).reshape(2, 3)
        for _ in range(3):
            np.testing.assert_array_equal(
                eng.synchronize(eng.enqueue("t.ag", x, OP_ALLGATHER)), x)
            np.testing.assert_array_equal(
                eng.synchronize(eng.enqueue("t.bc", x, OP_BROADCAST,
                                            root_rank=0)), x)
        stats = eng.cache_stats()
    finally:
        eng.shutdown()
    assert stats["misses"] == 2 and stats["hits"] == 4, stats


def test_timeline_tags_cache_hit_vs_negotiated(world1, tmp_path,
                                               monkeypatch):
    path = tmp_path / "timeline.json"
    monkeypatch.setenv("HOROVOD_TIMELINE", str(path))
    eng = _engine(cycle_time_ms=1.0, cache_capacity=8)
    try:
        for _ in range(3):
            eng.synchronize(eng.enqueue("tl.c", np.ones(4, np.float32),
                                        OP_ALLREDUCE))
    finally:
        eng.shutdown()
    text = path.read_text()
    assert "NEGOTIATED" in text and "CACHE_HIT" in text
    assert "NEGOTIATE_ALLREDUCE" in text


# -- several processes, each a gloo rank --------------------------------------

def _run_spawn(fn, tmp_path, nprocs=2, messages_per_proc=1):
    ctx = multiprocessing.get_context("spawn")
    port = _free_port()
    store = str(tmp_path / "store")
    q = ctx.Queue()
    procs = [ctx.Process(target=_boot, args=(fn, r, nprocs, port, store, q))
             for r in range(nprocs)]
    for p in procs:
        p.start()
    ok = False
    try:
        results = [q.get(timeout=scaled(120))
                   for _ in range(nprocs * messages_per_proc)]
        ok = True
        return results
    finally:
        for p in procs:
            if ok:
                p.join(timeout=scaled(30))
            if p.is_alive():
                p.kill()
                p.join(timeout=10)


def _boot(fn, rank, size, port, store, q):
    """Join the gloo job, then run the scenario ``fn``."""
    import horovod_tpu_torch as hvd

    hvd.init(device="cpu", init_method=f"file://{store}", rank=rank,
             size=size)
    try:
        fn(rank, size, port, q)
    except Exception as e:  # noqa: BLE001
        q.put(("err", rank, repr(e)))
    finally:
        hvd.shutdown()


def _tcp_engine(rank, size, port, **kw):
    return _engine(rank, size, coordinator_host="127.0.0.1",
                   coordinator_port=port, cycle_time_ms=2.0, **kw)


def _worker_stream(rank, size, port, q):
    eng = _tcp_engine(rank, size, port, cache_capacity=32)
    for step in range(4):
        out = eng.synchronize(eng.enqueue(
            "s.a", np.full(4, float(rank), np.float32), OP_ALLREDUCE),
            timeout_s=scaled(30))
        assert out[0] == 1.0, out          # 0 + 1
        if step >= 2:   # a new tensor joins the schedule mid-stream
            out = eng.synchronize(eng.enqueue(
                "s.b", np.full(2, float(rank), np.float32), OP_ALLREDUCE),
                timeout_s=scaled(30))
            assert out[0] == 1.0, out
    stats = eng.cache_stats()
    eng.shutdown()
    q.put(("ok", rank, stats))


def test_new_name_mid_stream_then_hits(tmp_path):
    results = _run_spawn(_worker_stream, tmp_path)
    assert {r[0] for r in results} == {"ok"}, results
    for _, rank, stats in results:
        assert stats["misses"] == 2 and stats["hits"] == 4, (rank, stats)


def _worker_coordinated_reshape(rank, size, port, q):
    eng = _tcp_engine(rank, size, port, cache_capacity=32)
    for shape in (3, 5):
        for _ in range(2):
            out = eng.synchronize(eng.enqueue(
                "r.x", np.full(shape, 1.0, np.float32), OP_ALLREDUCE),
                timeout_s=scaled(30))
            assert out.shape == (shape,) and out[0] == 2.0, out
    stats = eng.cache_stats()
    eng.shutdown()
    q.put(("ok", rank, stats))


def test_coordinated_shape_change_renegotiates(tmp_path):
    results = _run_spawn(_worker_coordinated_reshape, tmp_path)
    assert {r[0] for r in results} == {"ok"}, results
    for _, rank, stats in results:
        assert stats["misses"] == 2 and stats["hits"] == 2, (rank, stats)


def _worker_lone_reshape(rank, size, port, q):
    eng = _tcp_engine(rank, size, port, cache_capacity=32)
    for _ in range(2):
        eng.synchronize(eng.enqueue("l.x", np.ones(4, np.float32),
                                    OP_ALLREDUCE), timeout_s=scaled(30))
    x = np.ones(4 + (1 if rank == 0 else 0), np.float32)
    h = eng.enqueue("l.x", x, OP_ALLREDUCE)
    try:
        eng.synchronize(h, timeout_s=scaled(30))
        q.put(("no-error", rank, None))
    except CollectiveError as e:
        q.put(("collective-error", rank, str(e)))
    eng.shutdown()


def test_lone_shape_change_is_coordinated_error(tmp_path):
    results = _run_spawn(_worker_lone_reshape, tmp_path)
    assert {r[0] for r in results} == {"collective-error"}, results
    assert all("Mismatched shapes" in r[2] for r in results), results


def _worker_mixed_capacity(rank, size, port, q):
    eng = _tcp_engine(rank, size, port,
                      cache_capacity=32 if rank == 0 else 0)
    for _ in range(3):
        out = eng.synchronize(eng.enqueue(
            "m.x", np.full(4, 1.0, np.float32), OP_ALLREDUCE),
            timeout_s=scaled(30))
        assert out[0] == 2.0, out
    eng.shutdown()
    q.put(("ok", rank, None))


def test_mismatched_capacity_degrades_not_deadlocks(tmp_path):
    results = _run_spawn(_worker_mixed_capacity, tmp_path)
    assert {r[0] for r in results} == {"ok"}, results


def _worker_verify_interop(rank, size, port, q):
    os.environ["HVD_TPU_VERIFY_SCHEDULE"] = "1"
    os.environ["HVD_TPU_VERIFY_INTERVAL_TICKS"] = "2"
    eng = _tcp_engine(rank, size, port, cache_capacity=32)
    for _ in range(6):
        eng.synchronize(eng.enqueue("v.x", np.ones(4, np.float32),
                                    OP_ALLREDUCE), timeout_s=scaled(30))
    stats = eng.cache_stats()
    div = eng.divergence_report()
    eng.shutdown()
    q.put(("ok", rank, (stats["hits"], div)))


def test_schedule_verifier_cross_checks_cached_path(tmp_path):
    results = _run_spawn(_worker_verify_interop, tmp_path)
    assert {r[0] for r in results} == {"ok"}, results
    for _, rank, (hits, div) in results:
        assert hits >= 4, (rank, hits)
        assert div == [], (rank, div)


# -- the schedule verifier (tests/test_schedule_verify.py) --------------------

def test_rolling_hash_deterministic_and_order_sensitive():
    a, b, c = ScheduleRecorder(), ScheduleRecorder(), ScheduleRecorder()
    ops = [("allreduce", "g0", "float32", (4,)),
           ("allgather", "g1", "int32", (2, 3)),
           ("broadcast", "w", "float32", (8,))]
    for op in ops:
        a.record(*op)
        b.record(*op)
    for op in reversed(ops):
        c.record(*op)
    ha = [h for _, h, _ in a.drain()]
    hb = [h for _, h, _ in b.drain()]
    hc = [h for _, h, _ in c.drain()]
    assert ha == hb and ha[-1] != hc[-1]
    assert len(set(ha)) == len(ha)


def test_recorder_distinguishes_metadata():
    a, b = ScheduleRecorder(), ScheduleRecorder()
    a.record("allreduce", "g", "float32", (4,))
    b.record("allreduce", "g", "float16", (4,))
    (_, ha, _), = a.drain()
    (_, hb, _), = b.drain()
    assert ha != hb


def test_record_noop_when_disabled(monkeypatch):
    monkeypatch.delenv("HVD_TPU_VERIFY_SCHEDULE", raising=False)
    monkeypatch.delenv("HOROVOD_VERIFY_SCHEDULE", raising=False)
    from horovod_tpu_torch.analysis import schedule

    before = len(schedule.recorder().drain())
    schedule.record("allreduce", "x", "float32", (4,))
    assert len(schedule.recorder().drain()) == before == 0


def _worker_divergent(rank, size, port, q):
    os.environ["HVD_TPU_VERIFY_SCHEDULE"] = "1"
    os.environ["HVD_TPU_VERIFY_INTERVAL_TICKS"] = "2"
    eng = _tcp_engine(rank, size, port)
    t0 = time.monotonic()
    try:
        handles = []
        for i in range(4):
            if i == 2 and rank == 1:
                continue   # rank 1 skips one collective: divergence
            handles.append(eng.enqueue(f"step.{i}", np.ones(4, np.float32),
                                       OP_ALLREDUCE))
        for h in handles:
            eng.synchronize(h, timeout_s=scaled(60))
        q.put(("no-error", rank, None, time.monotonic() - t0))
    except CollectiveError as e:
        q.put(("diverged", rank, str(e), time.monotonic() - t0))
    finally:
        deadline = time.monotonic() + scaled(30)
        report = eng.divergence_report()
        while not report and time.monotonic() < deadline:
            time.sleep(0.02)
            report = eng.divergence_report()
        q.put(("report", rank, report, None))
        eng._shutdown.set()   # the engine already stopped itself


def test_divergent_job_aborts_with_report(tmp_path):
    results = _run_spawn(_worker_divergent, tmp_path, messages_per_proc=2)
    assert not [r for r in results if r[0] == "err"], results
    errors = {r[1]: r for r in results if r[0] == "diverged"}
    reports = [r for r in results if r[0] == "report"]
    assert 0 in errors, results
    _, _, msg, elapsed = errors[0]
    assert "schedule divergence" in msg.lower(), msg
    assert "step.2" in msg and "step.3" in msg, msg
    assert "rank 0" in msg and "rank 1" in msg, msg
    assert elapsed < scaled(30), elapsed
    assert len(reports) == 2, results
    for _, rank, report, _ in reports:
        assert [r for r, _, _ in report] == [0, 1], (rank, report)
        assert {s for _, s, _ in report} == {2}, report
        descs = sorted(d for _, _, d in report)
        assert "step.2" in descs[0] and "step.3" in descs[1], report


def _worker_clean(rank, size, port, q):
    os.environ["HVD_TPU_VERIFY_SCHEDULE"] = "1"
    os.environ["HVD_TPU_VERIFY_INTERVAL_TICKS"] = "2"
    eng = _tcp_engine(rank, size, port)
    outs = []
    for i in range(6):
        h = eng.enqueue(f"t.{i}", np.full(8, rank + 1.0, np.float32),
                        OP_ALLREDUCE)
        outs.append(float(eng.synchronize(h, timeout_s=scaled(60))[0]))
    g = eng.synchronize(eng.enqueue("gather", np.ones((rank + 1, 2),
                                                      np.float32),
                                    OP_ALLGATHER), timeout_s=scaled(60))
    report = eng.divergence_report()
    eng.shutdown()
    q.put(("ok", rank, (outs, g.shape, report)))


def test_clean_job_runs_clean_under_verifier(tmp_path):
    results = _run_spawn(_worker_clean, tmp_path)
    assert {r[0] for r in results} == {"ok"}, results
    for _, rank, (outs, gshape, report) in results:
        assert outs == [3.0] * 6, (rank, outs)            # 1 + 2
        # The ragged allgather (dim 0 per rank) does not trip the
        # verifier, and brings every rank's rows.
        assert tuple(gshape) == (3, 2), (rank, gshape)
        assert report == [], report


def test_engine_skips_verify_plumbing_when_disabled(world1, monkeypatch):
    from horovod_tpu_torch.analysis import schedule

    schedule.recorder().reset()
    eng = _engine(cycle_time_ms=1.0)
    try:
        assert eng._verify_enabled is False
        eng.synchronize(eng.enqueue("off.t", np.ones(4, np.float32),
                                    OP_ALLREDUCE))
        assert schedule.recorder().drain() == []
        assert eng.divergence_report() == []
    finally:
        eng.shutdown()


def test_verify_enabled_single_process_roundtrip(world1, monkeypatch):
    monkeypatch.setenv("HVD_TPU_VERIFY_SCHEDULE", "1")
    from horovod_tpu_torch.analysis import schedule

    schedule.recorder().reset()
    eng = _engine(cycle_time_ms=1.0)
    try:
        x = np.arange(6, dtype=np.float32)
        out = eng.synchronize(eng.enqueue("v.t0", x, OP_ALLREDUCE))
        np.testing.assert_array_equal(out, x)
        assert eng.divergence_report() == []
    finally:
        eng.shutdown()
        schedule.recorder().reset()


# -- stall detection (tests/test_stall.py) ------------------------------------

_STALL_BOOT = textwrap.dedent("""
    import sys, time
    import numpy as np
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.core.engine import NativeEngine, OP_ALLREDUCE
    from horovod_tpu_torch.core.executors import multihost_executor

    rank, port, store = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    hvd.init(device="cpu", init_method="file://" + store, rank=rank, size=2)
    eng = NativeEngine(rank, 2, executor=multihost_executor,
                       coordinator_host="127.0.0.1", coordinator_port=port,
                       cycle_time_ms=2.0)
""")

STALL_SCRIPT = _STALL_BOOT + textwrap.dedent("""
    if rank == 0:
        # Only rank 0 announces: the tensor can never become ready.
        eng.enqueue("lonely", np.ones(4, np.float32), OP_ALLREDUCE)
    time.sleep(1.2)
    print("ALIVE", flush=True)
    if rank == 0:
        print("REPORT", eng.stall_report(), flush=True)
    eng._shutdown.set()   # skip the graceful shutdown: the peer may be gone
""")

ABORT_SCRIPT = _STALL_BOOT + textwrap.dedent("""
    if rank == 0:
        eng.enqueue("wedged", np.ones(4, np.float32), OP_ALLREDUCE)
        for _ in range(40):
            time.sleep(0.25)
        print("SURVIVED", flush=True)   # must never be reached on rank 0
    else:
        for _ in range(8):   # outlive the coordinator's abort
            time.sleep(0.25)
    eng._shutdown.set()
""")


def _run_pair(script, tmp_path, extra_env):
    env = {**os.environ, "PYTHONPATH": REPO, **extra_env}
    port, store = _free_port(), str(tmp_path / "store")
    procs = [subprocess.Popen(
        [sys.executable, "-c", script, str(r), str(port), store],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env, text=True,
        cwd=REPO) for r in range(2)]
    try:
        outs = [p.communicate(timeout=scaled(90)) for p in procs]
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        raise
    return procs, outs


def test_stall_warning_and_report(tmp_path):
    procs, outs = _run_pair(STALL_SCRIPT, tmp_path,
                            {"HOROVOD_STALL_WARNING_TIME": "0.3"})
    assert "ALIVE" in outs[0][0] and "ALIVE" in outs[1][0], outs
    stderr0 = outs[0][1]
    assert "Stalled op: lonely" in stderr0, stderr0
    assert "missing ranks: 1" in stderr0, stderr0
    assert "REPORT [('lonely', [1])]" in outs[0][0], outs[0][0]


def test_stall_escalates_to_restartable_abort(tmp_path):
    procs, outs = _run_pair(ABORT_SCRIPT, tmp_path,
                            {"HOROVOD_STALL_WARNING_TIME": "0.2",
                             "HVD_TPU_STALL_ABORT_SECONDS": "0.6"})
    assert procs[0].returncode == 75, (procs[0].returncode, outs[0])
    assert "SURVIVED" not in outs[0][0]
    assert "HVD_TPU_STALL_ABORT_SECONDS" in outs[0][1], outs[0][1]
