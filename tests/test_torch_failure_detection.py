"""The failure-detection scenarios of ``tests/test_failure_detection.py``
on the port's engine: heartbeats, hardened frames and the wire-fault
injectors of the port's copy of the native core, with the port's
``multihost`` executor over a gloo job (``init(device="cpu")`` over a file
store), so the streamed allreduces really cross the processes.

Each child streams collectives until the control plane reports the
failure, prints ``failure_report()``, and lets the engine's abort grace
exit it with the restartable code 75, as the JAX children do; a gloo
collective in flight when a peer dies gives up as soon as the engine
reports the failure (``core/executors.py``).  The scenarios with a fake
peer (a truncated frame, a malformed shard payload) and the version-skew
handshake form no gloo job: their engine never orders a batch.

The elastic chaos soak re-forms the engine at size 2 in place; a
``torch.distributed`` group cannot re-form so, and the port's in-place
elastic mode serves engine-only workers (``basics._apply_resize``), so
those children run the ``local`` executor, as ``chip_smoke.py``'s
``train_elastic_3proc`` does.  The launcher case is
``tests/test_torch_launcher.py``'s; the ThreadSanitizer case needs a TSAN
build of the port's core, which ``core/_build.py`` does not make
(ROADMAP)."""

import os
import signal
import socket
import struct
import subprocess
import sys
import textwrap
import time
import zlib

import pytest

from _timing import scaled

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

FAST_HB = {
    "HVD_TPU_HEARTBEAT_MS": "50",
    "HVD_TPU_HEARTBEAT_TIMEOUT_MS": str(int(scaled(800))),
    "HVD_TPU_ABORT_GRACE_MS": "300",
    "HVD_TPU_CONNECT_TIMEOUT": str(scaled(60)),
}


def _free_port() -> int:
    from horovod_tpu_torch.serving.soak import free_port

    return free_port()


# argv = [rank, port, nprocs, store ("-": no gloo job)].
_BOOT = textwrap.dedent("""
    import sys, time
    import numpy as np
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.core.engine import NativeEngine, OP_ALLREDUCE, \\
        CollectiveError
    from horovod_tpu_torch.core.executors import multihost_executor

    rank, port, n, store = (int(sys.argv[1]), int(sys.argv[2]),
                            int(sys.argv[3]), sys.argv[4])
    if store != "-":
        hvd.init(device="cpu", init_method="file://" + store, rank=rank,
                 size=n)
""")

WORKER = _BOOT + textwrap.dedent("""
    eng = NativeEngine(rank, n, executor=multihost_executor,
                       coordinator_host="127.0.0.1", coordinator_port=port,
                       cycle_time_ms=2.0)
    i = 0
    try:
        while True:
            h = eng.enqueue(f"s{i}", np.ones(8, np.float32), OP_ALLREDUCE)
            out = eng.synchronize(h, timeout_s=120.0)
            assert out[0] == n, out     # the sum over every rank
            i += 1
            if i == 5:
                print(f"RANK{rank} STEADY", flush=True)
    except CollectiveError:
        print(f"RANK{rank} REPORT={eng.failure_report()!r}", flush=True)
        time.sleep(30)  # the engine's abort grace must _Exit(75) us
    print(f"RANK{rank} FELL-THROUGH", flush=True)
""")


def _spawn(script, nprocs, extra_env, tmp_path=None, port=None):
    port = port or _free_port()
    store = "-" if tmp_path is None else str(tmp_path / "store")
    env = {**os.environ, "PYTHONPATH": REPO, **FAST_HB, **extra_env}
    procs = [subprocess.Popen(
        [sys.executable, "-c", script, str(r), str(port), str(nprocs),
         store], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=env, cwd=REPO) for r in range(nprocs)]
    return procs, port


def _wait_steady(proc, deadline):
    lines = []
    for line in proc.stdout:
        lines.append(line)
        if "STEADY" in line:
            return lines
        assert time.monotonic() < deadline, "".join(lines[-30:])
    raise AssertionError("stream ended early:\n" + "".join(lines[-30:]))


def _drain(procs, timeout):
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out or "")
    return outs


def test_sigkill_peer_detected_fast_with_report_and_exit_75(tmp_path):
    procs, _ = _spawn(WORKER, 3, {}, tmp_path)
    try:
        deadline = time.monotonic() + scaled(90)
        head = [_wait_steady(p, deadline) for p in procs]
        procs[2].kill()
        t_kill = time.monotonic()
        outs = _drain(procs, timeout=scaled(30))
        detect_s = time.monotonic() - t_kill
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert procs[0].returncode == 75, (procs[0].returncode, outs[0][-2000:])
    assert procs[1].returncode == 75, (procs[1].returncode, outs[1][-2000:])
    for r in (0, 1):
        full = "".join(head[r]) + outs[r]
        assert "'failed_rank': 2" in full, full[-2000:]
        assert "REPORT=" in full and \
            "None" not in full.split("REPORT=")[1][:8]
    assert detect_s <= scaled(4.0), detect_s


STALL_WORKER = _BOOT + textwrap.dedent("""
    eng = NativeEngine(rank, n, executor=multihost_executor,
                       coordinator_host="127.0.0.1", coordinator_port=port,
                       cycle_time_ms=2.0)
    if rank == 0:
        # Only rank 0 announces: rank 1 is live (socket and heartbeats
        # healthy) but silent.  This must stay a stall, never a failure.
        eng.enqueue("lonely", np.ones(4, np.float32), OP_ALLREDUCE)
        for _ in range(60):
            time.sleep(0.25)
            if eng.stall_report():
                break
        print(f"RANK0 STALL={eng.stall_report()!r}", flush=True)
        print(f"RANK0 FAILURE={eng.failure_report()!r}", flush=True)
        for _ in range(160):   # now ride the stall-abort escalation
            time.sleep(0.25)
        print("RANK0 SURVIVED", flush=True)   # must never be reached
    else:
        for _ in range(200):
            time.sleep(0.25)
""")


def test_live_but_silent_rank_stalls_does_not_trip_peer_failure(tmp_path):
    procs, _ = _spawn(STALL_WORKER, 2, {
        "HOROVOD_STALL_WARNING_TIME": "0.4",
        "HVD_TPU_STALL_ABORT_SECONDS": str(scaled(2.0)),
        "HVD_TPU_HEARTBEAT_MS": "50",
        "HVD_TPU_HEARTBEAT_TIMEOUT_MS": "600",
    }, tmp_path)
    outs = _drain(procs, timeout=scaled(90))
    assert procs[0].returncode == 75, (procs[0].returncode, outs[0][-2000:])
    assert "STALL=[('lonely', [1])]" in outs[0], outs[0][-2000:]
    assert "FAILURE=None" in outs[0], outs[0][-2000:]
    assert "SURVIVED" not in outs[0]
    assert "HVD_TPU_STALL_ABORT_SECONDS" in outs[0], outs[0][-2000:]


def test_wire_corrupt_frame_rejected_with_structured_report(tmp_path):
    procs, _ = _spawn(WORKER, 2, {"HVD_TPU_FAULT_WIRE_CORRUPT": "1:40"},
                      tmp_path)
    t0 = time.monotonic()
    outs = _drain(procs, timeout=scaled(60))
    dt = time.monotonic() - t0
    assert procs[0].returncode == 75, (procs[0].returncode, outs[0][-2000:])
    assert procs[1].returncode == 75, (procs[1].returncode, outs[1][-2000:])
    assert "'cause': 'frame_corrupt'" in outs[0], outs[0][-2000:]
    assert "'failed_rank': 1" in outs[0], outs[0][-2000:]
    assert "CRC mismatch" in outs[0], outs[0][-2000:]
    assert dt <= scaled(30.0), dt


def _frame(ftype, payload):
    return struct.pack("<IBBHII", 0x48564446, 1, ftype, 0, len(payload),
                       zlib.crc32(payload)) + payload


def _fake_peer(port):
    """Rank 1 as a raw socket: connected, the hardened HELLO sent and its
    ack read."""
    peer = None
    deadline = time.monotonic() + scaled(60)
    while peer is None:   # rank 0's listener comes up after its imports
        try:
            peer = socket.create_connection(("127.0.0.1", port), timeout=5)
        except OSError:
            assert time.monotonic() < deadline, "coordinator never listened"
            time.sleep(0.1)
    peer.sendall(_frame(1, struct.pack("<ii", 1, 0)))   # HELLO rank 1
    ack = peer.recv(16)
    assert len(ack) == 16 and ack[:4] == b"FDVH", ack   # HELLO_ACK
    return peer


def _hang_up(peer):
    # FIN, not RST: half-close and drain until the abort.
    peer.shutdown(socket.SHUT_WR)
    peer.settimeout(scaled(20))
    try:
        while peer.recv(4096):
            pass
    except OSError:
        pass
    finally:
        peer.close()


def _lone_rank0():
    """Rank 0 of two, with no gloo job; rank 1 is the test's socket."""
    port = _free_port()
    env = {**os.environ, "PYTHONPATH": REPO, **FAST_HB}
    p0 = subprocess.Popen([sys.executable, "-c", WORKER, "0", str(port),
                           "2", "-"], stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True, env=env,
                          cwd=REPO)
    return p0, port


def test_truncated_frame_structured_error():
    p0, port = _lone_rank0()
    peer = _fake_peer(port)
    # A REQUEST header promising 64 payload bytes; 8 arrive; the peer dies.
    peer.sendall(struct.pack("<IBBHII", 0x48564446, 1, 3, 0, 64,
                             zlib.crc32(b"x" * 64)) + b"headless")
    _hang_up(peer)
    out0 = _drain([p0], timeout=scaled(40))[0]
    assert p0.returncode == 75, (p0.returncode, out0[-2000:])
    assert "truncated mid-frame" in out0, out0[-2000:]
    assert "'failed_rank': 1" in out0, out0[-2000:]


@pytest.mark.parametrize("shape", ["oversized", "truncated"])
def test_malformed_shard_payload_structured_error_never_desyncs(shape):
    p0, port = _lone_rank0()
    peer = _fake_peer(port)
    if shape == "oversized":
        # SHARD_PUT (type 12) advertising 65 MiB, past the frame cap.
        peer.sendall(struct.pack("<IBBHII", 0x48564446, 1, 12, 0, 65 << 20,
                                 0))
    else:
        peer.sendall(struct.pack("<IBBHII", 0x48564446, 1, 12, 0, 4096,
                                 zlib.crc32(b"s" * 4096)))
        peer.sendall(b"s" * 100)
    _hang_up(peer)
    out0 = _drain([p0], timeout=scaled(40))[0]
    assert p0.returncode == 75, (p0.returncode, out0[-2000:])
    assert "'failed_rank': 1" in out0, out0[-2000:]
    if shape == "oversized":
        assert "'cause': 'frame_corrupt'" in out0, out0[-2000:]
        assert "absurd frame length" in out0, out0[-2000:]
    else:
        assert "truncated mid-frame" in out0, out0[-2000:]


def test_version_skew_rejected_at_connect():
    boot = _BOOT + textwrap.dedent("""
        try:
            NativeEngine(rank, n, executor=multihost_executor,
                         coordinator_host="127.0.0.1",
                         coordinator_port=port, cycle_time_ms=2.0)
            print(f"RANK{rank} STARTED", flush=True)
        except RuntimeError as e:
            print(f"RANK{rank} REJECTED: {e}", flush=True)
    """)
    port = _free_port()
    env = {**os.environ, "PYTHONPATH": REPO, **FAST_HB,
           "HVD_TPU_CONNECT_TIMEOUT": str(scaled(40))}
    p0 = subprocess.Popen([sys.executable, "-c", boot, "0", str(port), "2",
                           "-"], stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True, env=env,
                          cwd=REPO)
    p1 = subprocess.Popen([sys.executable, "-c", boot, "1", str(port), "2",
                           "-"], stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True,
                          env={**env, "HVD_TPU_WIRE_VERSION": "9"}, cwd=REPO)
    outs = _drain([p0, p1], timeout=scaled(90))
    assert "REJECTED" in outs[0] and "version skew" in outs[0], outs[0]
    assert "REJECTED" in outs[1] and "version skew" in outs[1], outs[1]
    assert "speaks v9" in outs[0] and "speaks v1" in outs[0], outs[0]


CHAOS_SEED = int(os.environ.get("HVD_CHAOS_SEED", "20260804"))


@pytest.mark.parametrize("mode", ["KILL", "DROP", "CORRUPT", "PARTITION",
                                  "HALFCLOSE"])
def test_chaos_soak_never_hangs(mode, tmp_path):
    frame = 30 + (CHAOS_SEED + sum(map(ord, mode))) % 40
    extra = {}
    if mode != "KILL":
        extra[f"HVD_TPU_FAULT_WIRE_{mode}"] = f"1:{frame}"
    procs, _ = _spawn(WORKER, 2, extra, tmp_path)
    try:
        if mode == "KILL":
            deadline = time.monotonic() + scaled(90)
            for p in procs:
                _wait_steady(p, deadline)
            procs[1].send_signal(signal.SIGKILL)
        outs = _drain(procs, timeout=scaled(90))   # never deadlocks
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert procs[0].returncode == 75, (mode, procs[0].returncode,
                                       outs[0][-2000:])
    assert "'failed_rank':" in outs[0], (mode, outs[0][-2000:])
    assert "'cause': '" in outs[0], (mode, outs[0][-2000:])
    if mode != "KILL":
        assert procs[1].returncode == 75, (mode, procs[1].returncode,
                                           outs[1][-2000:])


ELASTIC_CHAOS_WORKER = textwrap.dedent("""
    import sys, time
    import numpy as np
    from horovod_tpu_torch.core.engine import NativeEngine, OP_ALLREDUCE, \\
        CollectiveError, MembershipChanged
    from horovod_tpu_torch.core import engine as em
    from horovod_tpu_torch.core.executors import local_executor
    from horovod_tpu_torch import elastic

    rank, port, n = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3])
    eng = NativeEngine(rank, n, executor=local_executor,
                       coordinator_host="127.0.0.1", coordinator_port=port,
                       cycle_time_ms=2.0)
    elastic.attach(eng)
    i, done_after_resize = 0, 0
    while True:
        try:
            h = eng.enqueue(f"s{i}", np.ones(8, np.float32), OP_ALLREDUCE)
            eng.synchronize(h, timeout_s=120.0)
            i += 1
            if i == 5:
                print(f"RANK{rank} STEADY", flush=True)
            if eng.epoch > 0:
                done_after_resize += 1
                if done_after_resize >= 10:
                    print(f"RANK{rank} SHRUNK-OK size={eng.size} "
                          f"epoch={eng.epoch}", flush=True)
                    break
        except MembershipChanged:
            try:
                ev = elastic.reconfigure()
            except MembershipChanged as e:
                print(f"RANK{rank} EXPELLED {e}", flush=True)
                time.sleep(30)
                sys.exit(3)
            eng = em.peek_engine()
            i = ev.epoch * 1000
        except CollectiveError as e:
            print(f"RANK{rank} ABORTED {e}", flush=True)
            time.sleep(30)   # the abort grace exits 75
            sys.exit(3)
    eng.shutdown()
""")


@pytest.mark.parametrize("mode", ["KILL", "DROP", "CORRUPT", "PARTITION",
                                  "HALFCLOSE"])
def test_chaos_soak_elastic_shrinks_or_aborts_never_hangs(mode):
    frame = 30 + (CHAOS_SEED + sum(map(ord, mode))) % 40
    extra = {"HVD_TPU_ELASTIC": "1",
             "HVD_TPU_RECONFIG_TIMEOUT_MS": str(int(scaled(20000)))}
    if mode != "KILL":
        extra[f"HVD_TPU_FAULT_WIRE_{mode}"] = f"2:{frame}@0"
    procs, _ = _spawn(ELASTIC_CHAOS_WORKER, 3, extra)
    try:
        if mode == "KILL":
            deadline = time.monotonic() + scaled(90)
            for p in procs:
                _wait_steady(p, deadline)
            procs[2].send_signal(signal.SIGKILL)
        outs = _drain(procs, timeout=scaled(90))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r in (0, 1):
        assert procs[r].returncode == 0, (mode, procs[r].returncode,
                                          outs[r][-2500:])
        assert "SHRUNK-OK size=2 epoch=1" in outs[r], (mode,
                                                       outs[r][-2500:])
    if mode != "KILL":
        assert procs[2].returncode == 75, (mode, procs[2].returncode,
                                           outs[2][-2500:])
