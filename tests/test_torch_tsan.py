"""The JAX suite's ThreadSanitizer scenarios on the port's engine.

Each ``tsan`` test drives the same scenario as its JAX twin
(``tests/test_engine.py::test_engine_tsan_smoke``,
``tests/test_multiprocess.py::test_engine_under_tsan``,
``tests/test_response_cache.py::test_cache_tsan_concurrent_hits_and_shutdown``,
``tests/test_failure_detection.py::test_monitor_thread_under_tsan`` and the
three of ``tests/test_elastic_reconfig.py``) against the ThreadSanitizer
variant of the port's core: ``HVD_TPU_CORE_TSAN=1`` makes
``core/_build.py`` build and load ``libhvdcore-tsan-<hash>.so`` from the
port's own sources, and the ``libtsan`` runtime is preloaded into each
child.  No race report whose stack touches the library (``hvdcore``) may
appear; uninstrumented CPython, numpy and torch may report races of their
own, which are not findings.  The children run the ``local`` executor and
import no ``torch.distributed`` job, as the JAX children run without
``jax.distributed``.

They are marked ``tsan`` and ``slow``, as the JAX ones are, so the tier-1
run leaves them out; ``python -m horovod_tpu_torch.core.check tsan``
builds the library and runs them.  The unmarked tests pin how the variant
is found and that it never loads another package's library.
"""

import os
import subprocess
import sys
import textwrap

import pytest

from _timing import scaled

from horovod_tpu_torch.core import _build

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

FAST_HB = {
    "HVD_TPU_HEARTBEAT_MS": "50",
    "HVD_TPU_HEARTBEAT_TIMEOUT_MS": str(int(scaled(800))),
    "HVD_TPU_ABORT_GRACE_MS": "300",
    "HVD_TPU_CONNECT_TIMEOUT": str(scaled(60)),
}

# Every child prints the library it loaded, so a test can tell that the
# scenario really ran on the TSAN variant.
_LIB_LINE = textwrap.dedent("""
    from horovod_tpu_torch.core import engine as _em
    print("LIB " + _em.lib()._name, flush=True)
""")


def _free_port() -> int:
    from horovod_tpu_torch.serving.soak import free_port

    return free_port()


def _tsan_env(*extra: dict) -> dict:
    runtime = _build.tsan_runtime()
    if runtime is None:
        pytest.skip("libtsan runtime not installed")
    _build.build(tsan=True)
    return {**os.environ, "PYTHONPATH": REPO, "HVD_TPU_CORE_TSAN": "1",
            "LD_PRELOAD": runtime,
            "TSAN_OPTIONS": "report_bugs=1 halt_on_error=0 exitcode=0",
            **{k: v for d in extra for k, v in d.items()}}


def _spawn(script: str, args_of, n: int, env: dict, timeout: float):
    """Start ``n`` children of ``script`` (argv from ``args_of(rank)``);
    return ``(procs, [(stdout, stderr), ...])``."""
    procs = [subprocess.Popen(
        [sys.executable, "-c", _LIB_LINE + script, *map(str, args_of(r))],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=REPO) for r in range(n)]
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=timeout))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
    return procs, outs


def _assert_no_core_race(outs, ran=range(10 ** 6)):
    for r, (out, err) in enumerate(outs):
        if r in ran:
            assert "libhvdcore-tsan-" in out, (r, out[-2000:], err[-2000:])
        # Only a report whose stack touches the library is a finding.
        for chunk in err.split("WARNING: ThreadSanitizer")[1:]:
            assert "hvdcore" not in chunk.split("=" * 18)[0], (
                f"tsan race in libhvdcore on rank {r}:\n{chunk[:4000]}")


# ---------------------------------------------------------------------------
# How the variant is found
# ---------------------------------------------------------------------------

def test_tsan_variant_is_named_and_flagged_apart():
    flags = _build.CXX_FLAGS
    plain, tsan = _build.library_path(flags), _build.library_path(
        flags, tsan=True)
    assert os.path.dirname(plain) == os.path.dirname(tsan) == \
        _build.BUILD_DIR
    assert os.path.basename(plain).startswith("libhvdcore-")
    assert os.path.basename(tsan).startswith("libhvdcore-tsan-")
    _prefix, cflags, link = _build._variant(flags, True)
    assert "-O2" not in cflags and {"-O1", "-g", "-fsanitize=thread"} <= \
        set(cflags)
    assert link == ("-fsanitize=thread",)
    assert _build._variant(flags, False) == ("libhvdcore", flags,
                                             _build.LINK_FLAGS)


def test_tsan_request_reads_only_its_own_knob(monkeypatch):
    monkeypatch.delenv("HVD_TPU_CORE_TSAN", raising=False)
    assert not _build.tsan_requested()
    monkeypatch.setenv("HVD_TPU_CORE_TSAN", "1")
    assert _build.tsan_requested()
    monkeypatch.setenv("HVD_TPU_CORE_TSAN", "0")
    assert not _build.tsan_requested()


def test_tsan_load_never_falls_back_to_another_library(monkeypatch,
                                                       tmp_path):
    from horovod_tpu_torch.core import engine as core_engine

    fake = tmp_path / "g++"
    fake.write_text("#!/bin/sh\necho 'error: refused' >&2\nexit 3\n")
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "_cxx", lambda: str(fake))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(core_engine, "_lib", None)
    monkeypatch.setenv("HVD_TPU_CORE_TSAN", "1")
    # The JAX package's TSAN library, named the way its Makefile names it.
    monkeypatch.setenv("HVD_CORE_LIB", os.path.join(
        REPO, "horovod_tpu", "core", "libhvdcore_tsan.so"))
    with pytest.raises(RuntimeError, match="refused"):
        core_engine.lib()
    assert _build._lib is None and core_engine._lib is None
    assert [p.name for p in (tmp_path / "build").iterdir()] == [".lock"]


def test_tsan_runtime_discovery_finds_a_shared_object():
    runtime = _build.tsan_runtime()
    if runtime is None:
        pytest.skip("libtsan runtime not installed")
    assert os.path.isfile(runtime) and "libtsan.so" in runtime


# ---------------------------------------------------------------------------
# test_engine.py::test_engine_tsan_smoke
# ---------------------------------------------------------------------------

TSAN_SMOKE = textwrap.dedent("""
    import numpy as np
    from horovod_tpu_torch.core.engine import NativeEngine, OP_ALLREDUCE, \\
        OP_ALLGATHER, OP_BARRIER
    from horovod_tpu_torch.core.executors import local_executor
    import threading

    eng = NativeEngine(0, 1, executor=local_executor, cycle_time_ms=1.0)

    def pound(tid):
        for i in range(20):
            h = eng.enqueue(f"s{tid}.{i}", np.ones(32, np.float32),
                            OP_ALLREDUCE)
            eng.synchronize(h)

    ts = [threading.Thread(target=pound, args=(t,)) for t in range(3)]
    for t in ts: t.start()
    for t in ts: t.join()
    eng.synchronize(eng.enqueue("g", np.ones((2, 2), np.float32),
                                OP_ALLGATHER))
    eng.synchronize(eng.enqueue("bar", np.zeros(1, np.uint8), OP_BARRIER))
    eng.shutdown()
    print("SMOKE OK", flush=True)
""")


@pytest.mark.tsan
@pytest.mark.slow
def test_engine_tsan_smoke():
    """Single-process lap of the engine under the TSAN variant: concurrent
    clients, the executor and the background thread."""
    _procs, outs = _spawn(TSAN_SMOKE, lambda r: (), 1, _tsan_env(),
                          scaled(240))
    assert "SMOKE OK" in outs[0][0], outs[0][1][-3000:]
    _assert_no_core_race(outs)


# ---------------------------------------------------------------------------
# test_multiprocess.py::test_engine_under_tsan
# ---------------------------------------------------------------------------

TSAN_WORKER = textwrap.dedent("""
    import sys, threading
    import numpy as np
    from horovod_tpu_torch.core.engine import NativeEngine, \\
        CollectiveError, OP_ALLREDUCE, OP_ALLGATHER, OP_BROADCAST, \\
        OP_BARRIER
    from horovod_tpu_torch.core.executors import local_executor

    rank = int(sys.argv[1]); cport = int(sys.argv[2]); n = int(sys.argv[3])
    t_out = float(sys.argv[4])
    eng = NativeEngine(rank, n, executor=local_executor,
                       coordinator_host="127.0.0.1", coordinator_port=cport,
                       cycle_time_ms=1.0)

    def pound(tid):
        for i in range(40):
            h = eng.enqueue(f"t{tid}.{i}", np.full(64, rank, np.float32),
                            OP_ALLREDUCE)
            eng.synchronize(h, timeout_s=t_out)

    threads = [threading.Thread(target=pound, args=(t,)) for t in range(4)]
    for t in threads: t.start()
    for t in threads: t.join()

    # other op types + a coordinated error, with the engine's background
    # and executor threads still live
    for i in range(10):
        eng.synchronize(eng.enqueue(f"g{i}", np.ones((rank + 1, 2),
                                                     np.float32),
                                    OP_ALLGATHER), timeout_s=t_out)
        eng.synchronize(eng.enqueue(f"b{i}", np.ones(4, np.float32),
                                    OP_BROADCAST, root_rank=0),
                        timeout_s=t_out)
        eng.synchronize(eng.enqueue(f"bar{i}", np.zeros(1, np.uint8),
                                    OP_BARRIER), timeout_s=t_out)
    try:
        eng.synchronize(eng.enqueue("bad", np.ones(4 + rank, np.float32),
                                    OP_ALLREDUCE), timeout_s=t_out)
    except CollectiveError:
        pass
    eng.shutdown()
    print(f"RANK{rank} OK", flush=True)
""")


@pytest.mark.tsan
@pytest.mark.slow
@pytest.mark.parametrize("nprocs", [2, 4])
def test_engine_under_tsan(nprocs):
    """The engine across processes (TCP coordinator, fusion scheduler,
    handle table, timeline) under the TSAN variant with concurrent
    clients and a coordinated error."""
    port = _free_port()
    procs, outs = _spawn(TSAN_WORKER, lambda r: (r, port, nprocs,
                                                 scaled(60)),
                         nprocs, _tsan_env(), scaled(360))
    for r, (out, err) in enumerate(outs):
        assert f"RANK{r} OK" in out, (procs[r].returncode, err[-3000:])
    _assert_no_core_race(outs)


# ---------------------------------------------------------------------------
# test_response_cache.py::test_cache_tsan_concurrent_hits_and_shutdown
# ---------------------------------------------------------------------------

TSAN_CACHE = textwrap.dedent("""
    import numpy as np, threading
    from horovod_tpu_torch.core.engine import NativeEngine, OP_ALLREDUCE
    from horovod_tpu_torch.core.executors import local_executor

    eng = NativeEngine(0, 1, executor=local_executor, cycle_time_ms=1.0,
                       cache_capacity=8)

    def pound(tid):
        # Per-thread names so every iteration past the first is a cache hit
        # racing the cycle condvar, the drain, and the other threads.
        for i in range(30):
            h = eng.enqueue(f"c{tid}", np.ones(16, np.float32), OP_ALLREDUCE)
            eng.synchronize(h)

    ts = [threading.Thread(target=pound, args=(t,)) for t in range(3)]
    for t in ts: t.start()
    for t in ts: t.join()
    assert eng.cache_stats()["hits"] >= 3 * 29, eng.cache_stats()
    eng.shutdown()  # exercises the cycle_cv_ shutdown wake-up under tsan
    print("CACHE TSAN OK", flush=True)
""")


@pytest.mark.tsan
@pytest.mark.slow
def test_cache_tsan_concurrent_hits_and_shutdown():
    _procs, outs = _spawn(TSAN_CACHE, lambda r: (), 1, _tsan_env(),
                          scaled(240))
    assert "CACHE TSAN OK" in outs[0][0], outs[0][1][-3000:]
    _assert_no_core_race(outs)


# ---------------------------------------------------------------------------
# test_failure_detection.py::test_monitor_thread_under_tsan
# ---------------------------------------------------------------------------

TSAN_MONITOR = textwrap.dedent("""
    import sys, threading, time
    import numpy as np
    from horovod_tpu_torch.core.engine import NativeEngine, OP_ALLREDUCE, \\
        CollectiveError
    from horovod_tpu_torch.core.executors import local_executor

    rank, port, n = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3])
    mode = sys.argv[4]
    eng = NativeEngine(rank, n, executor=local_executor,
                       coordinator_host="127.0.0.1", coordinator_port=port,
                       cycle_time_ms=1.0)

    stop = threading.Event()

    def pound(tid):
        i = 0
        while not stop.is_set() and i < 200:
            try:
                h = eng.enqueue(f"t{tid}.{i}", np.ones(16, np.float32),
                                OP_ALLREDUCE)
                eng.synchronize(h, timeout_s=60.0)
            except (CollectiveError, RuntimeError, TimeoutError):
                stop.set()
                return
            i += 1

    threads = [threading.Thread(target=pound, args=(t,)) for t in range(2)]
    for t in threads: t.start()
    if mode == "die" and rank == 1:
        time.sleep(0.5)
        import os, signal
        os.kill(os.getpid(), signal.SIGKILL)
    if mode == "clean":
        time.sleep(0.8)
        stop.set()
        for t in threads: t.join()
        eng.shutdown()   # clean shutdown races the live monitor thread
        print(f"RANK{rank} OK", flush=True)
    else:
        for t in threads: t.join()
        print(f"RANK{rank} REPORT={eng.failure_report()!r}", flush=True)
        time.sleep(60)
""")


@pytest.mark.tsan
@pytest.mark.slow
@pytest.mark.parametrize("mode", ["clean", "die"])
def test_monitor_thread_under_tsan(mode):
    """The heartbeat monitor under the TSAN variant: client enqueues, the
    cycle thread and the monitor thread through (a) a clean shutdown with
    the monitor live and (b) a real SIGKILL peer death with the
    coordinated abort (exit 75)."""
    port = _free_port()
    # TSAN is ~10x slower: only the injected death may fire, and the
    # slowed Python side needs a wide abort grace to get its REPORT line out.
    env = _tsan_env(FAST_HB, {
        "HVD_TPU_HEARTBEAT_TIMEOUT_MS": str(int(scaled(8000))),
        "HVD_TPU_ABORT_GRACE_MS": "5000"})
    procs, outs = _spawn(TSAN_MONITOR, lambda r: (r, port, 2, mode), 2, env,
                         scaled(240))
    if mode == "clean":
        for r in range(2):
            assert f"RANK{r} OK" in outs[r][0], outs[r][1][-3000:]
        _assert_no_core_race(outs)
    else:
        assert procs[0].returncode == 75, (procs[0].returncode,
                                           outs[0][1][-3000:])
        assert "'failed_rank': 1" in outs[0][0], outs[0][0][-2000:]
        _assert_no_core_race(outs, ran=(0,))


# ---------------------------------------------------------------------------
# test_elastic_reconfig.py: reconfigure, promotion and shard replication
# ---------------------------------------------------------------------------

ELASTIC_ENV = {**FAST_HB,
               # TSAN is ~10x slower: only injected deaths may fire, and
               # the reconfig hand-off needs real slack.
               "HVD_TPU_HEARTBEAT_TIMEOUT_MS": str(int(scaled(8000))),
               "HVD_TPU_ABORT_GRACE_MS": "5000",
               "HVD_TPU_RECONFIG_TIMEOUT_MS": str(int(scaled(60000))),
               "HVD_TPU_ELASTIC": "1"}

_POUND = textwrap.dedent("""
    import sys, threading, time
    import numpy as np
    from horovod_tpu_torch.core.engine import NativeEngine, OP_ALLREDUCE, \\
        CollectiveError, MembershipChanged
    from horovod_tpu_torch.core import engine as em
    from horovod_tpu_torch.core.executors import local_executor
    from horovod_tpu_torch import elastic

    rank, port, n = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3])
    eng = NativeEngine(rank, n, executor=local_executor,
                       coordinator_host="127.0.0.1", coordinator_port=port,
                       cycle_time_ms=1.0)
    elastic.attach(eng)
    resized = threading.Event()
    stop = threading.Event()

    def pound(tid):
        i = 0
        while not stop.is_set() and i < 200:
            try:
                e = em.peek_engine()
                h = e.enqueue(f"t{tid}.{i}", np.ones(16, np.float32),
                              OP_ALLREDUCE)
                e.synchronize(h, timeout_s=60.0)
            except MembershipChanged:
                resized.set()
                return
            except (CollectiveError, RuntimeError, TimeoutError):
                stop.set()
                return
            i += 1

    threads = [threading.Thread(target=pound, args=(t,)) for t in range(2)]
    for t in threads: t.start()
""")

TSAN_ELASTIC = _POUND + textwrap.dedent("""
    if rank == 1:
        time.sleep(0.5)
        import os, signal
        os.kill(os.getpid(), signal.SIGKILL)
    # Rank 0: wait for the resize signal, reconfigure (to size 1 —
    # loopback) while the pound threads drain, then immediately shut the
    # fresh engine down: reconfigure vs client threads vs teardown.
    assert resized.wait(timeout=120), "no resize observed"
    ev = elastic.reconfigure()
    stop.set()
    for t in threads: t.join()
    e = em.peek_engine()
    h = e.enqueue("post.reconfig", np.ones(4, np.float32), OP_ALLREDUCE)
    e.synchronize(h, timeout_s=60.0)
    e.shutdown()
    print(f"RANK{rank} OK epoch={ev.epoch}", flush=True)
""")


@pytest.mark.tsan
@pytest.mark.slow
def test_concurrent_reconfigure_and_shutdown_under_tsan():
    """A real peer death triggers the elastic RECONFIG path while client
    threads pound enqueues, followed by an immediate post-reconfigure
    collective and teardown."""
    port = _free_port()
    _procs, outs = _spawn(TSAN_ELASTIC, lambda r: (r, port, 2), 2,
                          _tsan_env(ELASTIC_ENV), scaled(240))
    assert "RANK0 OK epoch=1" in outs[0][0], (outs[0][0][-2000:],
                                              outs[0][1][-3000:])
    _assert_no_core_race(outs, ran=(0,))


# The promotion path is the racy part of failover — CloseListener, the
# standby port re-bind, the monitor thread's verdict synthesis, and the
# replicated-state swap all overlap with application enqueues.
TSAN_FAILOVER = _POUND + textwrap.dedent("""
    if rank == 0:
        time.sleep(0.5)
        import os, signal
        os.kill(os.getpid(), signal.SIGKILL)
    # Survivors: the standby (rank 1) PROMOTES while its pound threads are
    # still draining against the dead plane, then tears the fresh engine
    # down right after one proving collective.
    assert resized.wait(timeout=120), "no resize observed"
    ev = elastic.reconfigure()
    stop.set()
    for t in threads: t.join()
    e = em.peek_engine()
    h = e.enqueue("post.promote", np.ones(4, np.float32), OP_ALLREDUCE)
    e.synchronize(h, timeout_s=60.0)
    e.shutdown()
    print(f"RANK{rank} OK epoch={ev.epoch} as={ev.new_rank}", flush=True)
""")


@pytest.mark.tsan
@pytest.mark.slow
def test_concurrent_promotion_and_shutdown_under_tsan():
    """The coordinator dies while client threads pound enqueues on both
    survivors; the standby promotes itself racing those threads, runs one
    post-promotion collective, and shuts down at once."""
    port = _free_port()
    _procs, outs = _spawn(TSAN_FAILOVER, lambda r: (r, port, 3), 3,
                          _tsan_env(ELASTIC_ENV), scaled(300))
    assert "RANK1 OK epoch=1 as=0" in outs[1][0], (outs[1][0][-2000:],
                                                   outs[1][1][-3000:])
    assert "RANK2 OK epoch=1 as=1" in outs[2][0], (outs[2][0][-2000:],
                                                   outs[2][1][-3000:])
    _assert_no_core_race(outs, ran=(1, 2))


TSAN_SHARD = textwrap.dedent("""
    import sys, threading
    import numpy as np
    from horovod_tpu_torch.core.engine import NativeEngine, OP_ALLREDUCE
    from horovod_tpu_torch.core.executors import local_executor
    from horovod_tpu_torch import replication

    rank, port, n = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3])
    eng = NativeEngine(rank, n, executor=local_executor,
                       coordinator_host="127.0.0.1", coordinator_port=port,
                       cycle_time_ms=2.0)
    stop = threading.Event()

    def putter():
        step = 0
        while not stop.is_set() and step < 400:
            replication.put(step, {"w": np.full(64, float(step),
                                                np.float32)}, {}, eng=eng)
            step += 1

    t = threading.Thread(target=putter, daemon=True)
    t.start()
    for i in range(40):
        h = eng.enqueue(f"ts.{i}", np.ones(32, np.float32), OP_ALLREDUCE)
        eng.synchronize(h, timeout_s=120.0)
        replication.drain(eng)
    stop.set()
    t.join()
    replication.drain(eng)
    s = replication.stats()
    assert s["puts"] > 0 and s["drained"] > 0, s
    print(f"RANK{rank} SHARD OK puts={s['puts']} "
          f"drained={s['drained']}", flush=True)
    eng.shutdown()
""")


@pytest.mark.tsan
@pytest.mark.slow
def test_shard_replication_concurrency_under_tsan():
    """SHARD_PUT/SHARD_ACK under the TSAN variant: the replication putter
    thread races the collective cycle thread and the drain loop on the
    native shard inbox."""
    port = _free_port()
    env = _tsan_env(FAST_HB, {
        "HVD_TPU_HEARTBEAT_TIMEOUT_MS": str(int(scaled(8000))),
        "HVD_TPU_ABORT_GRACE_MS": "5000"})
    _procs, outs = _spawn(TSAN_SHARD, lambda r: (r, port, 2), 2, env,
                          scaled(300))
    for r, (out, err) in enumerate(outs):
        assert f"RANK{r} SHARD OK" in out, (out[-2000:], err[-3000:])
    _assert_no_core_race(outs)
