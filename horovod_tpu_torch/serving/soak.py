"""Autoscale / replica-kill soak driver — the serving fleet's chaos leg;
counterpart of ``horovod_tpu/serving/soak.py``.

Spawns N founding serving workers (``python -m
horovod_tpu_torch.serving.worker``: engine-only replicas over the stub
backend), drives the deterministic Poisson workload at them round-robin,
and injects the two events the autoscaler story must survive:

* **grow under load** — rank 0 runs the live :class:`Autoscaler` policy
  over its serving.tick aggregates (aggressive thresholds, set below, so
  the bursty Poisson load can trip it) and prints ``AUTOSCALE grow``;
  this driver is the supervisor that acts on the verdict, spawning a
  joiner that is admitted mid-traffic via the JOIN/RECONFIG machinery
  and pulls the weights from its ring neighbour over the bulk data plane
  (the driver asserts the pulled CRC matches and ``disk_reads=0``).  A
  fallback deadline backstops the policy, so every run exercises the
  join even when the offered load never queues.
* **SIGKILL mid-traffic** — one replica dies hard; every request it had
  accepted but not completed is resubmitted to a survivor, and because
  the token automaton is deterministic the retried completion is
  byte-identical, so the driver can assert that no accepted request is
  lost or corrupted.

Every wait is deadline-bounded and every port is a free one.
"""

from __future__ import annotations

import os
import signal
import socket
import subprocess
import sys
import threading
import time

from horovod_tpu_torch.serving import loadgen, worker as worker_mod

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

FLEET_ENV = {
    "HVD_TPU_ELASTIC": "1",
    "HVD_TPU_HEARTBEAT_MS": "50",
    "HVD_TPU_HEARTBEAT_TIMEOUT_MS": "2000",
    "HVD_TPU_ABORT_GRACE_MS": "300",
    "HVD_TPU_RECONFIG_TIMEOUT_MS": "30000",
}


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


class Replica:
    """One worker subprocess + a reader thread collecting its lines."""

    def __init__(self, argv, env):
        self.proc = subprocess.Popen(
            argv, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True, bufsize=1, env=env,
            cwd=_REPO)
        self.lines: list[str] = []
        self._cv = threading.Condition()
        self.alive = True
        threading.Thread(target=self._pump, daemon=True).start()

    def _pump(self):
        for line in self.proc.stdout:
            with self._cv:
                self.lines.append(line.rstrip("\n"))
                self._cv.notify_all()
        with self._cv:
            self.alive = False
            self._cv.notify_all()

    def send(self, line: str) -> None:
        try:
            self.proc.stdin.write(line + "\n")
            self.proc.stdin.flush()
        except (BrokenPipeError, OSError):
            pass

    def wait_line(self, prefix: str, timeout_s: float) -> str | None:
        deadline = time.monotonic() + timeout_s
        seen = 0
        with self._cv:
            while True:
                for i in range(seen, len(self.lines)):
                    if self.lines[i].startswith(prefix):
                        return self.lines[i]
                seen = len(self.lines)
                left = deadline - time.monotonic()
                if left <= 0 or (not self.alive and self.proc.poll()
                                 is not None):
                    return None
                self._cv.wait(min(left, 0.1))

    def wait_eof(self, timeout_s: float) -> None:
        """Block until the pump thread hit EOF — after SIGKILL +
        ``proc.wait()`` a DONE the victim delivered just before dying may
        still sit in the pipe, and reading ``done_rids()`` early would
        resubmit (double-execute) an already-completed request."""
        deadline = time.monotonic() + timeout_s
        with self._cv:
            while self.alive:
                left = deadline - time.monotonic()
                if left <= 0:
                    return
                self._cv.wait(min(left, 0.1))

    def done_rids(self) -> dict[int, str]:
        out = {}
        with self._cv:
            for line in self.lines:
                if line.startswith("DONE "):
                    out[int(line.split()[1])] = line
        return out


def run_fleet(n: int = 2, qps: float = 40.0, duration_s: float = 4.0,
              kill: bool = True, join: bool = True, swap: bool = False,
              seed: int = 0, step_s: float = 0.003,
              timeout_s: float = 120.0, prefix_cache: bool = False,
              spec_k: int = 0) -> dict:
    """Run the soak scenario; returns metrics and raises AssertionError on
    any lost/corrupted request, a disk read on the clone path, or a hang
    (everything is deadline-bounded).  ``prefix_cache``/``spec_k`` turn
    the engine fast paths on inside every worker: the stub's completion
    stream is a pure function of the prompt either way, so the
    zero-lost/zero-corrupted assertions are unchanged — which is exactly
    the point of soaking with them enabled."""
    t_start = time.monotonic()
    port = free_port()
    env = {**os.environ, **FLEET_ENV, "PYTHONPATH": _REPO,
           "HVD_TPU_SERVE_STEP_S": str(step_s),
           # Aggressive autoscale thresholds: the soak's load is light
           # (the point is chaos, not saturation), so give rank 0's live
           # policy a realistic chance of tripping GROW on a Poisson
           # burst; the fallback deadline below covers the quiet case.
           "HVD_TPU_SERVE_QUEUE_HIGH": "2",
           "HVD_TPU_SERVE_P99_MS": "25",
           "HVD_TPU_SERVE_COOLDOWN_S": "0.5"}
    if prefix_cache:
        env["HVD_TPU_SERVE_PREFIX_PAGES"] = "16"
        env["HVD_TPU_SERVE_PAGE_TOKENS"] = "8"
    if spec_k:
        env["HVD_TPU_SERVE_SPEC_K"] = str(spec_k)
    argv = [sys.executable, "-m", "horovod_tpu_torch.serving.worker"]
    fleet = [Replica(argv + [str(r), str(n), str(port)], env)
             for r in range(n)]
    try:
        for rep in fleet:
            assert rep.wait_line("READY", timeout_s) is not None, \
                "founding replica never came up:\n" + "\n".join(rep.lines)
        w = loadgen.Workload(qps=qps, duration_s=duration_s, seed=seed,
                             prompt_lens=(4, 8, 20), short_new=4,
                             long_new=24, long_frac=0.2,
                             vocab=worker_mod.VOCAB)
        arrivals = loadgen.make_arrivals(w)
        assert arrivals, "workload produced no arrivals"
        join_pending = join
        join_fallback = duration_s * 0.3
        kill_at = duration_s * 0.6 if kill else None
        owner: dict[int, int] = {}
        expect: dict[int, int] = {}
        retried_rids: set[int] = set()
        joiner = None
        join_spawned_at = None
        killed_idx = None
        t0 = time.monotonic()
        i = 0
        rr = 0
        join_ms = None
        while i < len(arrivals) or join_pending or (kill_at is not None):
            now = time.monotonic() - t0
            if join_pending:
                # The supervisor half of the autoscaler: grow when rank
                # 0's live policy says so, else at the fallback deadline
                # (the soak must exercise the join path every run).
                grow = fleet[0].wait_line("AUTOSCALE grow", 0.0)
                if grow is not None or now >= join_fallback:
                    join_pending = False
                    join_spawned_at = now
                    joiner = Replica(argv + ["--join", str(port)], env)
                    fleet.append(joiner)
            if joiner is not None and join_ms is None:
                line = joiner.wait_line("READY", 0.0)
                if line is not None:
                    join_ms = (time.monotonic() - t0 - join_spawned_at) * 1e3
            if kill_at is not None and now >= kill_at:
                kill_at = None
                killed_idx = n - 1  # never rank 0: that seat coordinates
                victim = fleet[killed_idx]
                victim.proc.send_signal(signal.SIGKILL)
                victim.proc.wait(timeout=10)
                victim.wait_eof(10)  # pipe may outlive the process
                done = victim.done_rids()
                live = [r for j, r in enumerate(fleet)
                        if j != killed_idx and r.alive]
                for rid, who in list(owner.items()):
                    if who == killed_idx and rid not in done:
                        rr_live = live[rid % len(live)]
                        prompt, max_new = _req_of(arrivals, rid)
                        rr_live.send(f"REQ {rid}R {max_new} "
                                     + ",".join(map(str, prompt)))
                        owner[rid] = fleet.index(rr_live)
                        retried_rids.add(rid)
            if i < len(arrivals) and arrivals[i][0] <= now:
                _, prompt, max_new = arrivals[i]
                targets = [j for j, r in enumerate(fleet)
                           if j != killed_idx and r.alive]
                tgt = targets[rr % len(targets)]
                rr += 1
                fleet[tgt].send(f"REQ {i} {max_new} "
                                + ",".join(map(str, prompt)))
                owner[i] = tgt
                expect[i] = worker_mod.completion_crc(
                    worker_mod.expected_completion(prompt, max_new))
                i += 1
            else:
                time.sleep(0.001)
        if swap:
            fleet[0].send("SWAP 2")
            crc = worker_mod.weights_crc(worker_mod.make_weights(2))
            for j, rep in enumerate(fleet):
                if j == killed_idx or not rep.alive:
                    continue
                line = rep.wait_line("SWAPPED version=2", timeout_s)
                assert line is not None and f"crc={crc}" in line, \
                    f"replica {j} never swapped:\n" + "\n".join(
                        rep.lines[-20:])
        # Every accepted request must complete (possibly as a retry).
        deadline = time.monotonic() + timeout_s
        pending = set(owner)
        while pending and time.monotonic() < deadline:
            # A DONE from the victim BEFORE the kill still counts — the
            # response was delivered; only its undelivered rids were
            # resubmitted.
            done_all = {}
            for rep in fleet:
                done_all.update(rep.done_rids())
            pending = set(owner) - set(done_all)
            if pending:
                time.sleep(0.05)
        assert not pending, f"lost requests (hang/drop): {sorted(pending)}"
        for rid, line in done_all.items():
            got = int(line.split("crc=")[1].split()[0])
            assert got == expect[rid], \
                f"rid {rid} corrupted: {line} (want crc={expect[rid]})"
        checks = {}
        if joiner is not None:
            wline = joiner.wait_line("WEIGHTS", timeout_s)
            assert wline is not None, \
                "joiner never got weights:\n" + "\n".join(joiner.lines)
            checks["join_disk_reads"] = int(
                wline.split("disk_reads=")[1].split()[0])
            assert checks["join_disk_reads"] == 0, wline
            want = worker_mod.weights_crc(worker_mod.make_weights(1))
            assert f"crc={want}" in wline or swap, wline
            checks["join_ms"] = join_ms
        for rep in fleet:
            if rep.alive:
                rep.send("QUIT")
        for j, rep in enumerate(fleet):
            if j == killed_idx:
                continue
            try:
                rep.proc.wait(timeout=timeout_s)
            except subprocess.TimeoutExpired:
                rep.proc.kill()
                raise AssertionError(
                    f"replica {j} hung on QUIT:\n" + "\n".join(
                        rep.lines[-20:]))
        return {"accepted": len(owner), "completed": len(done_all),
                "lost": 0, "killed": int(killed_idx is not None),
                "retried": len(retried_rids),
                "wall_s": time.monotonic() - t_start, **checks}
    finally:
        for rep in fleet:
            if rep.proc.poll() is None:
                rep.proc.kill()


def _req_of(arrivals, rid: int):
    _, prompt, max_new = arrivals[rid]
    return prompt, max_new
