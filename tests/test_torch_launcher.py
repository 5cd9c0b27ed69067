"""The port's launcher, ``python -m horovod_tpu_torch.run``, through the
scenarios of ``tests/test_run_launcher.py`` and the launcher case of
``tests/test_failure_detection.py``: ranks come up wired together (a gloo
job and the eager engine), the first abnormal exit aborts the job with
its code, supervision restarts, the crash-loop breaker, elastic
single-rank relaunches and the SIGTERM drain.  ``_child_env`` exports
every name the JAX package's launcher does, with the same values, beside
torch's."""

import os
import signal
import subprocess
import sys
import textwrap
import time

from _timing import scaled

from horovod_tpu import run as jrun
from horovod_tpu_torch import run as trun

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

OK_SCRIPT = textwrap.dedent("""
    import torch
    import horovod_tpu_torch as hvd
    hvd.init(device="cpu")
    t = torch.full((3,), float(hvd.rank() + 1))
    torch.distributed.all_reduce(t)
    out = hvd.synchronize(hvd.allreduce_async(
        torch.full((3,), float(hvd.rank() + 1)), average=False,
        name="launch.ar"))
    expect = hvd.size() * (hvd.size() + 1) / 2
    assert torch.equal(out, torch.full((3,), expect)), out
    assert torch.equal(t, out)
    print(f"RANK{hvd.rank()} SUM={out[0]:.0f} LOCAL={hvd.local_rank()}",
          flush=True)
    hvd.shutdown()
""")

CRASH_SCRIPT = textwrap.dedent("""
    import sys, time
    import horovod_tpu_torch as hvd
    hvd.init(device="cpu")
    if hvd.rank() == 1:
        sys.exit(7)
    time.sleep(120)   # must be terminated by the launcher, not run out
""")


def _env(**extra):
    return {**os.environ, "PYTHONPATH": REPO, **extra}


def _launch(np_, script, timeout):
    return subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.run", "-np", str(np_),
         sys.executable, "-c", script],
        cwd=REPO, capture_output=True, text=True, timeout=timeout,
        env=_env())


def test_two_ranks_allreduce_with_tagged_output():
    res = _launch(2, OK_SCRIPT, timeout=scaled(120))
    assert res.returncode == 0, res.stdout + res.stderr
    for rank in (0, 1):
        assert f"[{rank}]: RANK{rank} SUM=3 LOCAL={rank}" in res.stdout, \
            res.stdout


def test_crashed_rank_aborts_job_with_its_exit_code():
    res = _launch(2, CRASH_SCRIPT, timeout=scaled(120))
    assert res.returncode == 7, res.stdout + res.stderr
    assert "rank 1 exited with code 7" in res.stderr


def test_rejects_hosts_flag():
    res = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.run", "-np", "2", "-H",
         "a:1,b:1", "true"],
        cwd=REPO, capture_output=True, text=True, timeout=scaled(60))
    assert res.returncode != 0
    assert "-H/--hosts is not supported" in res.stderr


FLAKY_SCRIPT = textwrap.dedent("""
    import os, sys
    attempt = int(os.environ.get("HVD_TPU_RESTART_ATTEMPT", "0"))
    print(f"ATTEMPT={attempt}", flush=True)
    sys.exit(7 if attempt == 0 else 0)
""")

ALWAYS_FAIL_SCRIPT = "import sys; sys.exit(9)"

GRANDCHILD_SCRIPT = textwrap.dedent("""
    import subprocess, sys, time
    p = subprocess.Popen([sys.executable, "-c",
                          "import time; time.sleep(300)"])
    print(f"GRANDCHILD={p.pid}", flush=True)
    for _ in range(1200):
        time.sleep(0.25)
""")

ORIGINATOR_SCRIPT = textwrap.dedent("""
    import os, sys, time
    rank = int(os.environ["RANK"])
    attempt = int(os.environ.get("HVD_TPU_RESTART_ATTEMPT", "0"))
    if rank == 1 and attempt == 0:
        time.sleep(0.3)   # let the peers reach their sleep first
        sys.exit(7)
    if attempt > 0:
        sys.exit(0)       # relaunched job runs clean
    time.sleep(120)       # terminated by the launcher, not run out
""")


def _supervised(np_, script, *flags, timeout):
    return subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.run", "-np", str(np_),
         *flags, "--", sys.executable, "-c", script],
        cwd=REPO, capture_output=True, text=True, timeout=timeout,
        env=_env(HVD_TPU_RESTART_BACKOFF="0.05"))


def test_secondary_sigterm_exits_never_mask_originator():
    res = _supervised(3, ORIGINATOR_SCRIPT, "--max-restarts", "1",
                      timeout=scaled(60))
    assert res.returncode == 0, res.stdout + res.stderr
    assert "rank 1 exited with code 7" in res.stderr, res.stderr
    assert "job failed with exit code 7" in res.stderr, res.stderr
    assert "exit code 143" not in res.stderr, res.stderr

    res = _supervised(3, ORIGINATOR_SCRIPT, timeout=scaled(60))
    assert res.returncode == 7, res.stdout + res.stderr


def test_restart_recovers_flaky_job():
    res = _supervised(2, FLAKY_SCRIPT, "--max-restarts", "2",
                      timeout=scaled(60))
    assert res.returncode == 0, res.stdout + res.stderr
    assert "ATTEMPT=0" in res.stdout and "ATTEMPT=1" in res.stdout
    assert "restarting (attempt 1" in res.stderr, res.stderr


def test_restart_budget_exhausts_with_original_code():
    res = _supervised(1, ALWAYS_FAIL_SCRIPT, "--max-restarts", "1",
                      timeout=scaled(60))
    assert res.returncode == 9, res.stdout + res.stderr
    assert "restart budget exhausted" in res.stderr, res.stderr
    assert res.stderr.count("restarting (attempt") == 1, res.stderr


def test_no_restart_by_default():
    res = _supervised(1, ALWAYS_FAIL_SCRIPT, timeout=scaled(60))
    assert res.returncode == 9
    assert "restarting" not in res.stderr


ELASTIC_ACCOUNTING_SCRIPT = textwrap.dedent("""
    import os, sys, time
    rank = int(os.environ["RANK"])
    joined = os.environ.get("HVD_TPU_ELASTIC_JOIN") == "1"
    if rank == 1 and not joined:
        time.sleep(0.3)
        sys.exit(75)          # the expelled/aborted-rank exit
    if rank == 1 and joined:
        print("REJOINED attempt="
              + os.environ.get("HVD_TPU_RESTART_ATTEMPT", "?"), flush=True)
        sys.exit(0)
    time.sleep(2.0)           # survivors keep running through the rejoin
    sys.exit(0)
""")


def test_elastic_single_rank_relaunch_accounting_and_breaker_reset():
    res = _supervised(3, ELASTIC_ACCOUNTING_SCRIPT, "--elastic",
                      "--max-restarts", "1", timeout=scaled(60))
    assert res.returncode == 0, res.stdout + res.stderr
    assert "elastic mode: relaunching only rank 1" in res.stderr, res.stderr
    assert "REJOINED attempt=1" in res.stdout, res.stdout
    assert "supervisor summary: full_restarts=0 single_rank_relaunches=1" \
        in res.stderr, res.stderr
    assert "terminating remaining ranks" not in res.stderr, res.stderr
    assert "restarting (attempt" not in res.stderr, res.stderr


def test_elastic_rank0_death_relaunches_the_seat_alone():
    script = textwrap.dedent("""
        import os, sys, time
        rank = int(os.environ["RANK"])
        joined = os.environ.get("HVD_TPU_ELASTIC_JOIN") == "1"
        if rank == 0 and not joined:
            time.sleep(0.3)
            sys.exit(75)
        if rank == 0 and joined:
            print("COORD_SEAT_REJOINED attempt="
                  + os.environ.get("HVD_TPU_RESTART_ATTEMPT", "?"),
                  flush=True)
            sys.exit(0)
        time.sleep(2.0)           # survivor keeps running through failover
        sys.exit(0)
    """)
    res = _supervised(2, script, "--elastic", "--max-restarts", "1",
                      timeout=scaled(60))
    assert res.returncode == 0, res.stdout + res.stderr
    assert "elastic mode: relaunching only rank 0" in res.stderr, res.stderr
    assert "COORD_SEAT_REJOINED attempt=1" in res.stdout, res.stdout
    assert "supervisor summary: full_restarts=0 single_rank_relaunches=1" \
        in res.stderr, res.stderr
    assert "restarting (attempt" not in res.stderr, res.stderr


def test_sigterm_reaps_grandchildren():
    p = subprocess.Popen(
        [sys.executable, "-m", "horovod_tpu_torch.run", "-np", "1", "--",
         sys.executable, "-c", GRANDCHILD_SCRIPT],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=_env())
    try:
        gpid = None
        deadline = time.monotonic() + scaled(30)
        for line in p.stdout:
            if "GRANDCHILD=" in line:
                gpid = int(line.rsplit("=", 1)[1])
                break
            assert time.monotonic() < deadline, "no grandchild line"
        assert gpid is not None
        p.send_signal(signal.SIGTERM)
        p.wait(timeout=scaled(30))
        deadline = time.monotonic() + scaled(10)
        while time.monotonic() < deadline:
            try:
                os.kill(gpid, 0)
            except ProcessLookupError:
                break
            time.sleep(0.1)
        else:
            os.kill(gpid, 9)
            raise AssertionError(f"grandchild {gpid} survived the drain")
    finally:
        if p.poll() is None:
            p.kill()


# The launcher case of tests/test_failure_detection.py: engine-only
# children, an injected SIGKILL at a step, the survivor's structured peer
# failure report and restartable exit, and a clean relaunched attempt.
LAUNCHED = textwrap.dedent("""
    import os, signal, sys, time
    import numpy as np
    from horovod_tpu_torch.core.engine import NativeEngine, OP_ALLREDUCE, \\
        CollectiveError
    from horovod_tpu_torch.core.executors import local_executor
    from horovod_tpu_torch import faults

    signal.signal(signal.SIGTERM, signal.SIG_IGN)
    rank = int(os.environ["RANK"])
    n = int(os.environ["WORLD_SIZE"])
    port = int(os.environ["HVD_TPU_COORDINATOR_PORT"])
    eng = NativeEngine(rank, n, executor=local_executor,
                       coordinator_host="127.0.0.1", coordinator_port=port,
                       cycle_time_ms=2.0)
    try:
        for i in range(12):
            faults.step(i, rank=rank)
            h = eng.enqueue(f"g{i}", np.ones(4, np.float32), OP_ALLREDUCE)
            eng.synchronize(h, timeout_s=120.0)
        print(f"RANK{rank} DONE attempt="
              f"{os.environ.get('HVD_TPU_RESTART_ATTEMPT')}", flush=True)
        eng.shutdown()
    except CollectiveError:
        print(f"RANK{rank} REPORT={eng.failure_report()!r}", flush=True)
        time.sleep(30)  # engine grace exits 75
""")


def test_launcher_restarts_after_heartbeat_detected_kill():
    env = _env(HVD_TPU_HEARTBEAT_MS="50",
               HVD_TPU_HEARTBEAT_TIMEOUT_MS=str(int(scaled(800))),
               HVD_TPU_ABORT_GRACE_MS="300",
               HVD_TPU_CONNECT_TIMEOUT=str(scaled(60)),
               HVD_TPU_RESTART_BACKOFF="0.1",
               HVD_TPU_FAULT_KILL_RANK="1", HVD_TPU_FAULT_KILL_STEP="6")
    res = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.run", "-np", "2",
         "--max-restarts", "2", "--", sys.executable, "-c", LAUNCHED],
        cwd=REPO, capture_output=True, text=True, timeout=scaled(120),
        env=env)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-2000:]
    assert "killing rank 1 at step 6" in res.stdout, res.stdout[-3000:]
    assert "REPORT=" in res.stdout and "'failed_rank': 1" in res.stdout, \
        res.stdout[-3000:]
    assert "restarting (attempt 1" in res.stderr, res.stderr[-2000:]
    assert "RANK0 DONE attempt=1" in res.stdout, res.stdout[-3000:]
    assert "RANK1 DONE attempt=1" in res.stdout, res.stdout[-3000:]


def test_child_env_holds_every_reference_name_and_torch_names(monkeypatch):
    monkeypatch.delenv("HVD_TPU_EXECUTOR", raising=False)
    for join, resume, coord_file, extra in (
            (False, None, None, None),
            (True, "/ck/step_3", "/tmp/coord", {"HVD_TPU_TREE_ENABLE": "1"})):
        want = jrun._child_env(2, 4, 1111, 2222, None, 3, resume, join=join,
                               coord_file=coord_file, extra=extra)
        got = trun._child_env(2, 4, 1111, 2222, 3, resume, join=join,
                              coord_file=coord_file, extra=extra)
        for name, value in want.items():
            assert got.get(name) == value, name
        assert {k: got[k] for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK",
                                    "LOCAL_WORLD_SIZE", "MASTER_ADDR",
                                    "MASTER_PORT")} == {
            "RANK": "2", "WORLD_SIZE": "4", "LOCAL_RANK": "2",
            "LOCAL_WORLD_SIZE": "4", "MASTER_ADDR": "127.0.0.1",
            "MASTER_PORT": "1111"}
        assert got["MASTER_ADDR"] + ":" + got["MASTER_PORT"] == \
            got["JAX_COORDINATOR_ADDRESS"]
        # The launcher pins no platform: the child picks its device.
        assert set(got) - set(want) == {"RANK", "WORLD_SIZE", "LOCAL_RANK",
                                        "LOCAL_WORLD_SIZE", "MASTER_ADDR",
                                        "MASTER_PORT"}
