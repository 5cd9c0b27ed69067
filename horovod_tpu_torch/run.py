"""``python -m horovod_tpu_torch.run`` — the launcher, analog of
``mpirun -np N``; the port's copy of ``horovod_tpu/run.py``.

What it does for each of the N ranks:

* exports the job's shape twice over: torch's names (``RANK``,
  ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``,
  ``MASTER_PORT``), which ``basics.init`` reads, and every name the JAX
  package's launcher exports (``JAX_PROCESS_ID``, ``JAX_NUM_PROCESSES``,
  ``JAX_COORDINATOR_ADDRESS`` — the same rendezvous address as
  ``MASTER_ADDR:MASTER_PORT`` — and ``HVD_TPU_COORDINATOR_HOST`` /
  ``_PORT`` for the native control plane), so an engine-only child that
  reads those finds them;
* selects the multihost eager executor (``HVD_TPU_EXECUTOR=multihost``)
  unless the caller pinned one;
* tags each line of child output with ``[rank]:`` (mpirun's
  ``--tag-output``), and on the first abnormal child exit terminates the
  remaining ranks and exits with that rank's code — mpirun's job-abort
  contract, so a crashed rank can never leave the job hung.

Beyond mpirun (the elastic/torchrun lineage):

* **Supervision** — ``--max-restarts N`` relaunches the whole job after an
  abnormal exit, with exponential backoff between attempts and a
  crash-loop breaker: only failures within ``--restart-window`` seconds of
  launch consume restart budget; a job that ran longer earns its counter
  back.  Every attempt rendezvouses on freshly reserved ports, so a
  relaunched job never meets the dead attempt's process groups.
* **Restart-from-checkpoint** — with ``--ckpt-dir``, every attempt points
  children at the newest *complete* checkpoint (``utils/manifest.py``
  commit protocol) via ``HVD_TPU_RESUME_DIR``; ``HVD_TPU_RESTART_ATTEMPT``
  carries the attempt counter (the fault injectors key off it).
* **Preemption drain** — SIGTERM/SIGINT to the launcher forwards the
  signal to every rank's *process group* (``os.killpg`` — grandchildren
  such as data-loader workers cannot be orphaned), waits up to
  ``--drain-secs`` for ranks to checkpoint and exit (see
  ``checkpoint.install_preemption_handler``), then escalates to SIGKILL.
  No restarts after a drain request.
* **Elastic** — ``--elastic`` relaunches a dead rank alone with
  ``HVD_TPU_ELASTIC_JOIN=1`` so it rejoins the survivors' engine.

It sets no platform: a child runs on the card unless its own entry point
asks for the CPU (``init(device="cpu")``).  Multi-host dispatch
(``-H host1:2,...``) is not implemented; one launcher runs one host's
processes.
"""

from __future__ import annotations

import argparse
import os
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time

# Standard-library imports only: the supervising parent must stay a
# lightweight process (it may live for days babysitting restarts).
from horovod_tpu_torch.utils import manifest
from horovod_tpu_torch.utils.backoff import Backoff

_TERM_GRACE_SECONDS = 5.0


def _free_port() -> int:
    return _free_ports(1)[0]


def _free_ports(n: int) -> list[int]:
    """Reserve ``n`` distinct ephemeral ports in one batch.

    Every reserving socket stays open until all ``n`` ports are picked:
    closing them one at a time lets the kernel re-hand a freed port to a
    later reservation in the same batch (observed as relay bind collisions
    at fleet widths in the simulator)."""
    socks = [socket.socket() for _ in range(n)]
    try:
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def _pump(stream, rank: int, tag: bool, lock: threading.Lock) -> None:
    """Forward a child's merged output line-by-line, optionally tagged."""
    prefix = f"[{rank}]: " if tag else ""
    for line in iter(stream.readline, b""):
        text = line.decode("utf-8", "replace")
        with lock:
            sys.stdout.write(prefix + text)
            sys.stdout.flush()
    stream.close()


def _child_env(rank: int, np_: int, jax_port: int, coord_port: int,
               attempt: int, resume_dir: str | None, join: bool = False,
               coord_file: str | None = None,
               extra: dict[str, str] | None = None) -> dict[str, str]:
    env = dict(os.environ)
    if extra:
        env.update(extra)
    env["JAX_COORDINATOR_ADDRESS"] = f"127.0.0.1:{jax_port}"
    env["JAX_NUM_PROCESSES"] = str(np_)
    env["JAX_PROCESS_ID"] = str(rank)
    # torch.distributed's names for the same job: one host, so the local
    # rank is the rank.
    env["RANK"] = str(rank)
    env["WORLD_SIZE"] = str(np_)
    env["LOCAL_RANK"] = str(rank)
    env["LOCAL_WORLD_SIZE"] = str(np_)
    env["MASTER_ADDR"] = "127.0.0.1"
    env["MASTER_PORT"] = str(jax_port)
    env["HVD_TPU_COORDINATOR_HOST"] = "127.0.0.1"
    env["HVD_TPU_COORDINATOR_PORT"] = str(coord_port)
    if coord_file:
        # Failover-aware rendezvous: whichever rank holds the coordinator
        # seat republishes its endpoint here (elastic._publish_coordinator),
        # so joiners racing a standby promotion converge on the successor.
        env["HVD_TPU_COORD_FILE"] = coord_file
    env.setdefault("HVD_TPU_EXECUTOR", "multihost")
    env["HVD_TPU_RESTART_ATTEMPT"] = str(attempt)
    if join:
        # Single-rank elastic relaunch: the child must JOIN the surviving
        # job (elastic.join) instead of rendezvousing as a founding member.
        env["HVD_TPU_ELASTIC_JOIN"] = "1"
    else:
        env.pop("HVD_TPU_ELASTIC_JOIN", None)
    if resume_dir is not None:
        env["HVD_TPU_RESUME_DIR"] = resume_dir
    else:
        env.pop("HVD_TPU_RESUME_DIR", None)
    return env


def _signal_job(procs: list[subprocess.Popen], sig: int) -> None:
    """Deliver ``sig`` to every live rank's WHOLE process group.

    Children are session leaders (start_new_session), so killpg reaches
    grandchildren too — a preempted supervisor must not orphan data-loader
    or build subprocesses.  Racing a just-exited child is fine: the
    process-group id stays valid until the child is reaped, and a gone
    group is exactly the done case."""
    for p in procs:
        if p.poll() is not None:
            continue
        try:
            os.killpg(p.pid, sig)
        except (ProcessLookupError, PermissionError):
            try:
                p.send_signal(sig)
            except (ProcessLookupError, OSError):
                pass


class _StopRequest:
    """Set by the launcher's own SIGTERM/SIGINT: drain, don't restart."""

    def __init__(self):
        self.event = threading.Event()
        self.signum = signal.SIGTERM


def _run_once(command: list[str], args, attempt: int,
              resume_dir: str | None, stop: _StopRequest,
              lock: threading.Lock, stats: dict | None = None) -> int:
    """Launch all ranks once; return the job's exit code (0 = clean).

    In elastic mode (``--elastic`` / ``HVD_TPU_ELASTIC=1``,
    docs/fault_tolerance.md "In-place recovery") an abnormal exit from a
    NON-coordinator rank while rank 0 survives does not abort the job:
    only that rank is relaunched (with ``HVD_TPU_ELASTIC_JOIN=1``, so it
    rejoins via JOIN) — the survivors shrank in place and keep training.
    Single-rank relaunches are accounted in ``stats`` separately from
    full-job restarts; a relaunched rank that later exits cleanly marks
    ``rejoin_success`` so the supervisor's crash-loop breaker resets.
    Rank-0 death is covered too: the in-job standby promotes itself to
    coordinator and republishes the endpoint in ``HVD_TPU_COORD_FILE``, so
    the launcher relaunches the dead seat as a joiner against whichever
    process now holds rank 0 (docs/fault_tolerance.md "Coordinator
    failover")."""
    stats = stats if stats is not None else {}
    # Hierarchical coordinator tree (docs/benchmarks.md "Control-plane
    # scaling"): the launcher computes the SAME pure topology function the
    # ranks will, and when it activates, spawns one aggregator-relay
    # sidecar (plus a standby) per group and wires their endpoints into
    # every rank's HVD_TPU_TREE_AGG_MAP.  All ports — jax, coordinator,
    # and relay — come from one reservation batch.
    from horovod_tpu_torch import tree as tree_topo
    from horovod_tpu_torch.utils import env as hvd_env
    plan = tree_topo.plan(args.np_, hvd_env.tree_fanout(),
                          hvd_env.tree_threshold(), hvd_env.tree_enable())
    want_standby = os.environ.get("HVD_TPU_TREE_STANDBY", "1") \
        not in ("0", "false", "False")
    per_group = 2 if want_standby else 1
    ports = _free_ports(
        2 + (plan.num_groups * per_group if plan.active else 0))
    jax_port, coord_port = ports[0], ports[1]
    relay_ports = ports[2:]
    tree_env: dict[str, str] | None = None
    relay_procs: list[subprocess.Popen] = []
    elastic = bool(getattr(args, "elastic", False))
    # The coordinator-endpoint file: seeded with rank 0's initial address,
    # rewritten by the promoted standby after a failover.  An inherited
    # HVD_TPU_COORD_FILE is respected (multi-launcher setups); otherwise an
    # elastic job gets a private one for its lifetime.
    coord_file = os.environ.get("HVD_TPU_COORD_FILE") or None
    own_coord_file = False
    if elastic and coord_file is None:
        fd, coord_file = tempfile.mkstemp(prefix="hvd_coord_",
                                          suffix=".addr")
        os.close(fd)
        own_coord_file = True
    if elastic and coord_file:
        try:
            with open(coord_file, "w") as f:
                f.write(f"127.0.0.1 {coord_port} 0\n")
        except OSError:
            pass
    procs: list[subprocess.Popen] = []
    pumps: list[threading.Thread] = []
    try:
        if plan.active:
            agg_eps = []
            for g in range(plan.num_groups):
                pport = relay_ports[g * per_group]
                standby_ep = (("127.0.0.1", relay_ports[g * per_group + 1])
                              if want_standby else None)
                agg_eps.append((("127.0.0.1", pport), standby_ep))
            # Pin every tree knob explicitly in the children's env so the
            # ranks' native PlanTree answer can never drift from the plan
            # the relays were placed for.
            tree_env = {
                "HVD_TPU_TREE_ENABLE": "1",
                "HVD_TPU_TREE_FANOUT": str(plan.fanout),
                "HVD_TPU_TREE_THRESHOLD": str(hvd_env.tree_threshold()),
                "HVD_TPU_TREE_AGG_MAP": tree_topo.format_agg_map(agg_eps),
            }
            base = [sys.executable, "-m", "horovod_tpu_torch.relay",
                    "--parent-host", "127.0.0.1",
                    "--parent-port", str(coord_port),
                    "--size", str(args.np_),
                    "--fanout", str(plan.fanout),
                    "--threshold", str(hvd_env.tree_threshold())]
            relay_env = dict(os.environ)
            relay_env.update(tree_env)
            for g, (primary, standby_ep) in enumerate(agg_eps):
                relay_procs.append(subprocess.Popen(
                    base + ["--agg-id", str(g),
                            "--listen-port", str(primary[1])],
                    env=relay_env, start_new_session=True))
                if standby_ep is not None:
                    relay_procs.append(subprocess.Popen(
                        base + ["--agg-id", str(g),
                                "--listen-port", str(standby_ep[1]),
                                "--standby", "--peer-host", primary[0],
                                "--peer-port", str(primary[1])],
                        env=relay_env, start_new_session=True))
        for rank in range(args.np_):
            p = subprocess.Popen(
                command,
                env=_child_env(rank, args.np_, jax_port, coord_port,
                               attempt, resume_dir,
                               coord_file=coord_file if elastic else None,
                               extra=tree_env),
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                start_new_session=True)
            procs.append(p)
            t = threading.Thread(target=_pump,
                                 args=(p.stdout, rank,
                                       not args.no_tag_output, lock),
                                 daemon=True)
            t.start()
            pumps.append(t)
    except BaseException:
        # A failed spawn (fork EAGAIN, bad command) must not leak the ranks
        # already started — they'd sit in the rendezvous for its full budget.
        _signal_job(procs, signal.SIGKILL)
        _signal_job(relay_procs, signal.SIGKILL)
        raise

    # Expose the live procs to the launcher's signal handler.
    _current_procs[:] = procs

    exit_code = 0
    remaining = set(range(args.np_))
    drain_deadline: float | None = None

    def _coordinator_reachable(dead_rank: int) -> bool:
        """Whether somebody can still admit a rejoin.  True while the
        original rank 0 lives; after rank 0's own death, true either for
        rank 0's seat itself (the standby's promotion is in flight — the
        joiner's retry loop absorbs the window) or once the promoted
        standby has republished the endpoint with a bumped epoch."""
        if 0 in remaining:
            return True
        if dead_rank == 0:
            return bool(remaining)
        if coord_file:
            try:
                with open(coord_file) as f:
                    parts = f.read().split()
                return len(parts) >= 3 and int(parts[2]) > 0
            except (OSError, ValueError):
                pass
        return False

    # Elastic single-rank relaunch state (see docstring).
    relaunch_counts: dict[int, int] = {}
    relaunched: set[int] = set()
    relaunch_backoff = Backoff(
        initial_s=float(os.environ.get("HVD_TPU_RESTART_BACKOFF", "1.0")
                        or 1.0),
        max_s=max(30.0, float(os.environ.get("HVD_TPU_RESTART_BACKOFF",
                                             "1.0") or 1.0)))
    try:
        while remaining:
            if stop.event.is_set() and drain_deadline is None:
                # Drain: forward the signal to every process group and give
                # ranks --drain-secs to checkpoint and exit cleanly.
                drain_deadline = time.monotonic() + args.drain_secs
                _signal_job(procs, stop.signum)
            if drain_deadline is not None \
                    and time.monotonic() >= drain_deadline:
                _signal_job(procs, signal.SIGKILL)
                drain_deadline = float("inf")  # escalate once
            done = [r for r in remaining if procs[r].poll() is not None]
            if not done:
                time.sleep(0.05)
                continue
            # Within one poll batch, examine signal-terminated ranks LAST:
            # after the first abnormal exit the launcher SIGTERMs the rest,
            # and a survivor's secondary -15 (rc 143) landing in the same
            # batch as the originating crash must never be the code the
            # supervisor sees — restart accounting keys off the originator
            # (e.g. 137 = SIGKILLed/preempted, 75 = peer-failure abort).
            done.sort(key=lambda r: (procs[r].returncode < 0, r))
            for r in done:
                remaining.discard(r)
                rc = procs[r].returncode
                if rc < 0:  # killed by signal: report as 128+signum
                    rc = 128 - rc
                if rc == 0 and r in relaunched:
                    # The rejoin worked end to end: the relaunched rank ran
                    # to clean completion.  The supervisor's crash-loop
                    # breaker resets on this (main()).
                    stats["rejoin_success"] = True
                if rc != 0 and elastic and remaining \
                        and _coordinator_reachable(r) \
                        and not stop.event.is_set() and exit_code == 0:
                    # Elastic grow path: survivors shrank in place; bring
                    # ONLY this rank back and let it JOIN.  Rank 0's seat
                    # qualifies too — the standby promotes in-job and the
                    # joiner finds it through HVD_TPU_COORD_FILE.  Per-rank
                    # cap so a rank that can never rejoin still aborts the
                    # job.
                    spent = relaunch_counts.get(r, 0)
                    if spent < max(args.max_restarts, 1):
                        delay = relaunch_backoff.delay(spent)
                        with lock:
                            sys.stderr.write(
                                f"horovod_tpu_torch.run: rank {r} exited with "
                                f"code {rc}; elastic mode: relaunching only "
                                f"rank {r} to rejoin in {delay:.2f}s "
                                f"(single-rank relaunch {spent + 1})\n")
                        if stop.event.wait(timeout=delay):
                            # Drain requested mid-backoff: no relaunch, but
                            # the abnormal exit still counts as the job's.
                            if exit_code == 0:
                                exit_code = rc
                            continue
                        relaunch_counts[r] = spent + 1
                        stats["single_rank_relaunches"] = (
                            stats.get("single_rank_relaunches", 0) + 1)
                        # The relaunched rank's injectors key off a fresh
                        # attempt counter, so the fault that killed it does
                        # not re-fire in the rejoined incarnation.
                        p = subprocess.Popen(
                            command,
                            env=_child_env(r, args.np_, jax_port, coord_port,
                                           attempt + relaunch_counts[r],
                                           resume_dir, join=True,
                                           coord_file=coord_file,
                                           extra=tree_env),
                            stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT,
                            start_new_session=True)
                        procs[r] = p
                        _current_procs[:] = procs
                        t = threading.Thread(
                            target=_pump,
                            args=(p.stdout, r, not args.no_tag_output, lock),
                            daemon=True)
                        t.start()
                        pumps.append(t)
                        remaining.add(r)
                        relaunched.add(r)
                        continue
                    with lock:
                        sys.stderr.write(
                            f"horovod_tpu_torch.run: rank {r} exhausted its "
                            f"single-rank relaunch budget; falling back to "
                            f"a full-job restart\n")
                if rc != 0 and exit_code == 0:
                    exit_code = rc
                    if not stop.event.is_set():
                        with lock:
                            sys.stderr.write(
                                f"horovod_tpu_torch.run: rank {r} exited "
                                f"with code {rc}; terminating remaining "
                                f"ranks\n")
                        # mpirun contract: first abnormal exit aborts the
                        # job (SIGTERM first, SIGKILL after the grace).
                        live = [procs[o] for o in remaining]
                        _signal_job(live, signal.SIGTERM)
                        deadline = time.monotonic() + _TERM_GRACE_SECONDS
                        for other in remaining:
                            left = deadline - time.monotonic()
                            try:
                                procs[other].wait(timeout=max(left, 0.01))
                            except subprocess.TimeoutExpired:
                                pass
                        _signal_job(live, signal.SIGKILL)
    finally:
        _signal_job(procs, signal.SIGKILL)
        for p in procs:
            try:
                p.wait(timeout=2.0)
            except subprocess.TimeoutExpired:
                pass
        # Relays exit on their own once the tree shuts down (clean) or
        # their root uplink EOFs (abort); the kill is the backstop that
        # keeps a wedged sidecar from outliving the attempt.
        _signal_job(relay_procs, signal.SIGKILL)
        for p in relay_procs:
            try:
                p.wait(timeout=2.0)
            except subprocess.TimeoutExpired:
                pass
        for t in pumps:
            t.join(timeout=2.0)
        _current_procs[:] = []
        if own_coord_file and coord_file:
            try:
                os.unlink(coord_file)
            except OSError:
                pass
    return exit_code


# Live ranks of the current attempt — the signal handler's view.
_current_procs: list[subprocess.Popen] = []


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m horovod_tpu_torch.run",
        description="Launch N cooperating horovod_tpu_torch processes on "
                    "this host (the mpirun -np analog).")
    parser.add_argument("-np", "--num-proc", type=int, required=True,
                        dest="np_", metavar="N",
                        help="number of processes to launch")
    parser.add_argument("-H", "--hosts", default=None,
                        help="not supported: one launcher runs the "
                             "processes of one host")
    parser.add_argument("--no-tag-output", action="store_true",
                        help="do not prefix child output with '[rank]: '")
    parser.add_argument("--max-restarts", type=int, default=0,
                        help="relaunch the whole job up to N times after an "
                             "abnormal exit (default 0: mpirun's abort-only "
                             "contract)")
    parser.add_argument("--restart-window", type=float, default=60.0,
                        metavar="SECS",
                        help="crash-loop breaker: only failures within SECS "
                             "of launch consume restart budget; a longer run "
                             "resets the spent counter (default 60)")
    parser.add_argument("--ckpt-dir", default=None,
                        help="checkpoint root (checkpoint.CheckpointManager "
                             "layout); each attempt resolves the newest "
                             "COMPLETE step and exports HVD_TPU_RESUME_DIR "
                             "to children")
    parser.add_argument("--drain-secs", type=float, default=30.0,
                        help="grace between forwarding SIGTERM to ranks and "
                             "SIGKILL escalation (default 30)")
    parser.add_argument("--elastic", action="store_true",
                        help="in-place elastic recovery (implied by "
                             "HVD_TPU_ELASTIC=1): a dead rank is relaunched "
                             "ALONE with HVD_TPU_ELASTIC_JOIN=1 and rejoins "
                             "the surviving, still-running job; rank-0 "
                             "death promotes the in-job standby and the "
                             "dead seat rejoins via HVD_TPU_COORD_FILE "
                             "(docs/fault_tolerance.md)")
    parser.add_argument("--serve", action="store_true",
                        help="serving mode: the default command becomes "
                             "'python -m horovod_tpu_torch.serving' (one "
                             "continuous-batching replica per rank) and "
                             "--elastic is implied so dead replicas rejoin "
                             "and clone weights over the data plane")
    parser.add_argument("command", nargs=argparse.REMAINDER,
                        help="program and arguments (e.g. python train.py)")
    args = parser.parse_args(argv)

    if args.hosts is not None:
        parser.error("-H/--hosts is not supported: start one launcher per "
                     "host")
    if args.np_ < 1:
        parser.error("-np must be >= 1")
    if args.max_restarts < 0:
        parser.error("--max-restarts must be >= 0")
    command = args.command
    if command and command[0] == "--":
        command = command[1:]
    if args.serve:
        args.elastic = True
        if not command:
            command = [sys.executable, "-m", "horovod_tpu_torch.serving"]
    if not command:
        parser.error("no command given (e.g. ... -np 2 python train.py)")
    if os.environ.get("HVD_TPU_ELASTIC", "") not in ("", "0", "false",
                                                     "False"):
        args.elastic = True
    if args.elastic:
        # Children read HVD_TPU_ELASTIC natively (core/src/c_api.cc): the
        # flag and the env spelling must agree.
        os.environ["HVD_TPU_ELASTIC"] = "1"

    lock = threading.Lock()
    stop = _StopRequest()

    def _on_signal(signum, frame):
        stop.signum = signal.SIGTERM if signum == signal.SIGTERM \
            else signal.SIGINT
        stop.event.set()
        # Forward immediately too: _run_once's loop would also do it within
        # a poll tick, but a second Ctrl-C must escalate promptly.
        _signal_job(list(_current_procs), stop.signum)

    signal.signal(signal.SIGINT, _on_signal)
    signal.signal(signal.SIGTERM, _on_signal)

    # HVD_TPU_RESTART_BACKOFF tunes the first restart delay (tests shrink
    # it); the schedule is the shared bounded-exponential-with-jitter
    # policy (utils/backoff.py).
    initial = float(os.environ.get("HVD_TPU_RESTART_BACKOFF", "1.0") or 1.0)
    backoff = Backoff(initial_s=initial, max_s=max(30.0, initial))

    attempt = 0
    spent_restarts = 0
    total_single_relaunches = 0

    def _finish(code: int) -> int:
        # Supervisor summary: full-job restarts and single-rank (elastic
        # rejoin) relaunches are accounted separately — an elastic job that
        # shrinks and regrows for hours should read as "N rejoins", not as
        # a crash loop.
        with lock:
            sys.stderr.write(
                f"horovod_tpu_torch.run: supervisor summary: full_restarts="
                f"{attempt} single_rank_relaunches="
                f"{total_single_relaunches}\n")
        return code

    while True:
        resume_dir = None
        if args.ckpt_dir:
            newest = manifest.latest_complete(args.ckpt_dir)
            if newest is not None:
                resume_dir = newest[1]
        if attempt > 0:
            with lock:
                sys.stderr.write(
                    f"horovod_tpu_torch.run: relaunching attempt {attempt} "
                    + (f"from checkpoint {resume_dir}\n" if resume_dir
                       else "from scratch (no complete checkpoint)\n"))
        started = time.monotonic()
        stats: dict = {}
        exit_code = _run_once(command, args, attempt, resume_dir, stop, lock,
                              stats)
        ran_s = time.monotonic() - started
        total_single_relaunches += stats.get("single_rank_relaunches", 0)
        if stop.event.is_set():
            # Drained on request: the children's own exit codes tell whether
            # the checkpoint landed (0 = clean drain).  Never restart.
            return _finish(exit_code)
        if exit_code == 0:
            return _finish(0)
        if ran_s >= args.restart_window or stats.get("rejoin_success"):
            # Healthy run before the failure — or a proven in-place rejoin
            # — earns the jittered-backoff/crash-loop-breaker state back:
            # an elastic job that shrinks and regrows for hours must not
            # eventually be killed by a budget meant for crash loops.
            spent_restarts = 0
        if spent_restarts >= args.max_restarts:
            if args.max_restarts > 0:
                with lock:
                    sys.stderr.write(
                        f"horovod_tpu_torch.run: restart budget exhausted "
                        f"({args.max_restarts} within {args.restart_window:g}"
                        f"s); giving up with exit code {exit_code}\n")
            return _finish(exit_code)
        delay = backoff.delay(spent_restarts)
        spent_restarts += 1
        attempt += 1
        with lock:
            sys.stderr.write(
                f"horovod_tpu_torch.run: job failed with exit code "
                f"{exit_code} after {ran_s:.1f}s; restarting (attempt "
                f"{attempt}, {spent_restarts}/{args.max_restarts} restarts "
                f"spent) in {delay:.2f}s\n")
        # Interruptible backoff: a drain request during the sleep exits
        # immediately instead of launching another attempt.
        if stop.event.wait(timeout=delay):
            return _finish(exit_code)


if __name__ == "__main__":
    sys.exit(main())
