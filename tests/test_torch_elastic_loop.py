"""The port's ``training.elastic_loop`` with its checkpoint manager, fault
injectors, launcher and elastic engine, through the scenarios of
``tests/test_elastic.py`` (a rank killed mid-training and the job
restarted from the last complete checkpoint; the SIGTERM drain) and of
``tests/test_elastic_reconfig.py`` (in-place shrink with a disk restore,
with a peer-replica restore, and a single-rank relaunch that rejoins).
The scripts use the JAX package's small-integer gradients, so the port's
``FINAL=`` equals the JAX package's with no tolerance, as the kill-restart
scenario checks against the JAX launcher's own run.  A 2-layer, 64-wide
port transformer through a kill and a resume ends bitwise equal to its
uninterrupted run."""

import os
import signal
import socket
import subprocess
import sys
import textwrap
import time

from _timing import scaled

from horovod_tpu_torch.utils import manifest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# argv: ckpt_dir num_steps [step_sleep_s]; launched by either launcher.
TRAIN_SCRIPT = textwrap.dedent("""
    import sys, time
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import checkpoint, training

    hvd.init(device="cpu")
    ckpt_dir, steps = sys.argv[1], int(sys.argv[2])
    step_sleep = float(sys.argv[3]) if len(sys.argv) > 3 else 0.0
    mgr = checkpoint.CheckpointManager(ckpt_dir, max_to_keep=2)

    def step_fn(step, state):
        if step_sleep:
            time.sleep(step_sleep)
        grad = torch.full((4,), float((step + 1) * (hvd.rank() + 1)))
        g = hvd.synchronize(hvd.allreduce_async(
            grad, average=False, name=f"elastic.g{step}"))
        print(f"STEP {step} rank={hvd.rank()}", flush=True)
        return {"params": state["params"] + g}

    state = {"params": torch.zeros(4)}
    state = training.elastic_loop(step_fn, state, num_steps=steps,
                                  manager=mgr, checkpoint_every=1)
    print(f"[rank {hvd.rank()}] FINAL={state['params'].tolist()}",
          flush=True)
    hvd.shutdown()
""")

JAX_TRAIN_SCRIPT = textwrap.dedent("""
    import sys
    import numpy as np
    import horovod_tpu as hvd
    from horovod_tpu import checkpoint, training

    hvd.init()
    ckpt_dir, steps = sys.argv[1], int(sys.argv[2])
    mgr = checkpoint.CheckpointManager(ckpt_dir, max_to_keep=2)

    def step_fn(step, state):
        grad = np.full(4, float((step + 1) * (hvd.rank() + 1)), np.float32)
        g = hvd.synchronize(hvd.allreduce_async(
            grad, average=False, name=f"elastic.g{step}"))
        return {"params": state["params"] + g}

    state = training.elastic_loop(step_fn, {"params": np.zeros(4,
                                                               np.float32)},
                                  num_steps=steps, manager=mgr,
                                  checkpoint_every=1)
    print(f"[rank {hvd.rank()}] FINAL={state['params'].tolist()}",
          flush=True)
""")


def _env(**extra):
    env = {**os.environ, "PYTHONPATH": REPO,
           "HVD_TPU_RESTART_BACKOFF": "0.1", **extra}
    env.pop("JAX_PLATFORMS", None)
    return env


def _launch(np_, *args, extra_env=None, launcher_flags=(),
            module="horovod_tpu_torch.run", script=TRAIN_SCRIPT):
    return subprocess.run(
        [sys.executable, "-m", module, "-np", str(np_), *launcher_flags,
         "--", sys.executable, "-c", script, *[str(a) for a in args]],
        cwd=REPO, capture_output=True, text=True, timeout=scaled(180),
        env=_env(**(extra_env or {})))


def _finals(stdout: str) -> dict[int, str]:
    out = {}
    for line in stdout.splitlines():
        if "FINAL=" in line:
            rank = int(line.split("[rank ", 1)[1].split("]")[0])
            out[rank] = line.split("FINAL=", 1)[1].split(" pid=")[0].strip()
    return out


def _expected_final(steps: int, np_: int) -> list[float]:
    total = sum((s + 1) * sum(r + 1 for r in range(np_))
                for s in range(steps))
    return [float(total)] * 4


def test_kill_rank_mid_training_restart_resumes_bit_exact(tmp_path):
    """Rank 1 SIGKILLed at step 3 on attempt 0: the launcher tears the
    job down, relaunches it from the newest complete checkpoint, and the
    final parameters are what the JAX package's launcher prints for the
    uninterrupted run."""
    steps, np_ = 6, 2
    ref = _launch(np_, tmp_path / "jax", steps, module="horovod_tpu.run",
                  launcher_flags=("--platform", "cpu"),
                  script=JAX_TRAIN_SCRIPT)
    assert ref.returncode == 0, ref.stdout[-3000:] + ref.stderr[-2000:]
    want = _finals(ref.stdout)
    assert want == {0: str(_expected_final(steps, np_)),
                    1: str(_expected_final(steps, np_))}

    faulted = _launch(
        np_, tmp_path / "faulted", steps,
        launcher_flags=("--max-restarts", "2",
                        "--ckpt-dir", str(tmp_path / "faulted")),
        extra_env={"HVD_TPU_FAULT_KILL_RANK": "1",
                   "HVD_TPU_FAULT_KILL_STEP": "3"})
    assert faulted.returncode == 0, \
        faulted.stdout[-3000:] + faulted.stderr[-2000:]
    assert "killing rank 1 at step 3" in faulted.stdout + faulted.stderr
    assert "restarting (attempt 1" in faulted.stderr, faulted.stderr[-2000:]
    assert "from checkpoint" in faulted.stderr, faulted.stderr[-2000:]
    assert _finals(faulted.stdout) == want, faulted.stdout[-3000:]
    # Attempt 1 resumed: it does not replay step 0.
    attempt1 = faulted.stdout.split("restart", 1)[-1]
    assert "STEP 0 rank=0" not in attempt1.split("STEP 3", 1)[-1]


def test_sigterm_drains_complete_checkpoint_and_exits_clean(tmp_path):
    ckpt = tmp_path / "drain"
    p = subprocess.Popen(
        [sys.executable, "-m", "horovod_tpu_torch.run", "-np", "2",
         "--drain-secs", "60", "--",
         sys.executable, "-c", TRAIN_SCRIPT, str(ckpt), "500", "0.2"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=_env())
    try:
        lines = []
        deadline = time.monotonic() + scaled(120)
        for line in p.stdout:
            lines.append(line)
            if "STEP 2 rank=0" in line:
                break
            assert time.monotonic() < deadline, "".join(lines[-50:])
        p.send_signal(signal.SIGTERM)
        rc = p.wait(timeout=scaled(120))
        rest = p.stdout.read()
        assert rc == 0, "".join(lines[-30:]) + rest[-2000:]
    finally:
        if p.poll() is None:
            p.kill()
    latest = manifest.latest_complete(ckpt)
    assert latest is not None, os.listdir(ckpt)
    assert manifest.is_complete(latest[1])


# -- in-place elastic recovery on engine-only workers -----------------------

FAST_HB = {
    "HVD_TPU_HEARTBEAT_MS": "50",
    "HVD_TPU_HEARTBEAT_TIMEOUT_MS": str(int(scaled(800))),
    "HVD_TPU_ABORT_GRACE_MS": "300",
    "HVD_TPU_CONNECT_TIMEOUT": str(scaled(60)),
    "HVD_TPU_RECONFIG_TIMEOUT_MS": str(int(scaled(20000))),
    "HVD_TPU_ELASTIC": "1",
}

# argv: rank port nprocs ckpt_dir steps
ELASTIC_TRAIN = textwrap.dedent("""
    import os, sys
    import torch
    from horovod_tpu_torch.core.engine import NativeEngine, OP_ALLREDUCE
    from horovod_tpu_torch.core import engine as em
    from horovod_tpu_torch.core.executors import local_executor
    from horovod_tpu_torch import checkpoint, elastic, training

    rank, port, n = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3])
    ckpt_dir, steps = sys.argv[4], int(sys.argv[5])
    eng = NativeEngine(rank, n, executor=local_executor,
                       coordinator_host="127.0.0.1", coordinator_port=port,
                       cycle_time_ms=2.0)
    elastic.attach(eng)
    pid = os.getpid()
    mgr = checkpoint.CheckpointManager(ckpt_dir, max_to_keep=2, rank=rank,
                                       size=1)

    def step_fn(step, state):
        e = em.peek_engine()   # the engine can be re-formed between steps
        grad = torch.full((4,), float(step + 1))
        g = e.synchronize(e.enqueue(f"el.g{step}", grad, OP_ALLREDUCE),
                          timeout_s=120.0)
        print(f"STEP {step} rank={rank}", flush=True)
        return {"params": state["params"] + g}

    state = training.elastic_loop(step_fn, {"params": torch.zeros(4)},
                                  num_steps=steps, manager=mgr,
                                  checkpoint_every=1)
    print(f"[rank {rank}] FINAL={state['params'].tolist()} pid={pid} "
          f"now={os.getpid()} size={em.peek_engine().size} "
          f"reads={checkpoint.disk_read_count()}", flush=True)
    em.peek_engine().shutdown()
""")


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _elastic_run(tmp_path, tag, extra_env, steps=6):
    ckpt = tmp_path / tag
    ckpt.mkdir()
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-c", ELASTIC_TRAIN, str(r), str(port), "3",
         str(ckpt), str(steps)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=_env(**FAST_HB, JAX_PROCESS_ID=str(r),
                 HVD_TPU_FAULT_KILL_RANK="2", HVD_TPU_FAULT_KILL_STEP="3",
                 **extra_env),
        cwd=REPO) for r in range(3)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=scaled(120))[0] or "")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return procs, outs


def _check_shrunk_and_resumed(procs, outs, steps, reads_zero):
    expected = str([float(sum(s + 1 for s in range(steps)))] * 4)
    assert procs[0].returncode == 0, outs[0][-2500:]
    assert procs[1].returncode == 0, outs[1][-2500:]
    assert procs[2].returncode != 0  # the killed rank
    finals = _finals(outs[0] + outs[1])
    assert finals == {0: expected, 1: expected}, (finals, expected)
    for r in (0, 1):
        line = [ln for ln in outs[r].splitlines() if "FINAL=" in ln][0]
        pid = line.split("pid=", 1)[1].split()[0]
        assert pid == line.split("now=", 1)[1].split()[0], line
        assert "size=2" in line, line
        if reads_zero:
            assert "reads=0" in line, line
    # The job rewound to the step-2 checkpoint: step 3 completed once,
    # after the membership change.
    assert outs[0].count("STEP 3 rank=0") == 1, outs[0][-2500:]
    assert outs[0].index("Membership changed") \
        < outs[0].index("STEP 3 rank=0"), outs[0][-2500:]


def test_elastic_loop_shrinks_and_resumes_bit_exact_from_checkpoint(
        tmp_path):
    """3 ranks, rank 2 SIGKILLed at step 3: the survivors shrink to size 2
    in the same processes and resume from the step-2 checkpoint on disk,
    with the uninterrupted run's final parameters."""
    procs, outs = _elastic_run(tmp_path, "disk", {})
    _check_shrunk_and_resumed(procs, outs, 6, reads_zero=False)


def test_elastic_loop_peer_restore_zero_disk_reads_bit_exact(tmp_path):
    """The same with ``HVD_TPU_CKPT_REPLICATE=1`` and async persist: the
    survivors restore step 2 from the peer replica, with no disk read."""
    procs, outs = _elastic_run(tmp_path, "peer",
                               {"HVD_TPU_CKPT_REPLICATE": "1",
                                "HVD_TPU_CKPT_ASYNC": "1"})
    _check_shrunk_and_resumed(procs, outs, 6, reads_zero=True)


LAUNCHED_ELASTIC = textwrap.dedent("""
    import os, sys, time
    import numpy as np
    from horovod_tpu_torch.core.engine import NativeEngine, OP_ALLREDUCE, \\
        CollectiveError, MembershipChanged
    from horovod_tpu_torch.core import engine as em
    from horovod_tpu_torch.core.executors import local_executor
    from horovod_tpu_torch import elastic, faults

    rank = int(os.environ["RANK"])
    n = int(os.environ["WORLD_SIZE"])
    port = int(os.environ["HVD_TPU_COORDINATOR_PORT"])
    if os.environ.get("HVD_TPU_ELASTIC_JOIN") == "1":
        t = elastic.join("127.0.0.1", port, old_rank=rank,
                         timeout_s=float(os.environ.get(
                             "HVD_TPU_CONNECT_TIMEOUT", "60")))
        print(f"RANK{rank} TICKET epoch={t.epoch} size={t.new_size} "
              f"as={t.assigned_rank}", flush=True)
        host, cport = elastic.coordinator_endpoint("127.0.0.1", port)
        eng = NativeEngine(t.assigned_rank, t.new_size,
                           executor=local_executor, coordinator_host=host,
                           coordinator_port=cport, cycle_time_ms=2.0,
                           epoch=t.epoch)
        i = t.epoch * 1000
    else:
        eng = NativeEngine(rank, n, executor=local_executor,
                           coordinator_host="127.0.0.1",
                           coordinator_port=port, cycle_time_ms=2.0)
        i = 0
    elastic.attach(eng)
    while True:
        try:
            faults.step(i, rank=eng.rank if eng.size == n else -1)
            h = eng.enqueue(f"s{i}", np.ones(8, np.float32), OP_ALLREDUCE)
            eng.synchronize(h, timeout_s=120.0)
            i += 1
            if eng.size == n and eng.epoch >= 2 and i >= eng.epoch * 1000 + 20:
                print(f"RANK{rank} DONE size={eng.size} as={eng.rank} "
                      f"epoch={eng.epoch}", flush=True)
                break
            time.sleep(0.05)
        except MembershipChanged:
            ev = elastic.reconfigure()
            eng = em.peek_engine()
            i = ev.epoch * 1000
            print(f"RANK{rank} RECONFIGURED epoch={ev.epoch} "
                  f"size={ev.new_size}", flush=True)
        except CollectiveError as e:
            print(f"RANK{rank} ABORTED {e}", flush=True)
            time.sleep(30)
            sys.exit(3)
    eng.shutdown()
""")


def test_launcher_relaunches_single_rank_which_rejoins():
    """``--elastic``: rank 2 SIGKILLed by the injector is relaunched alone,
    JOINs the shrunk job, and every member finishes at size 3."""
    res = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.run", "-np", "3",
         "--elastic", "--max-restarts", "2", "--",
         sys.executable, "-c", LAUNCHED_ELASTIC],
        cwd=REPO, capture_output=True, text=True, timeout=scaled(180),
        env=_env(**FAST_HB, HVD_TPU_FAULT_KILL_RANK="2",
                 HVD_TPU_FAULT_KILL_STEP="10"))
    assert res.returncode == 0, res.stdout[-4000:] + res.stderr[-2000:]
    assert "killing rank 2 at step 10" in res.stdout, res.stdout[-4000:]
    assert "RANK0 RECONFIGURED epoch=1 size=2" in res.stdout, \
        res.stdout[-4000:]
    assert "relaunching only rank 2" in res.stderr, res.stderr[-2000:]
    assert "RANK2 TICKET epoch=2 size=3 as=2" in res.stdout, \
        res.stdout[-4000:]
    for r in range(3):
        assert f"RANK{r} DONE size=3" in res.stdout, res.stdout[-4000:]
    assert "supervisor summary: full_restarts=0 single_rank_relaunches=1" \
        in res.stderr, res.stderr[-2000:]
    assert "restarting (attempt" not in res.stderr, res.stderr[-2000:]


# -- a port transformer through a kill and a resume --------------------------

# argv: ckpt_dir; prints the final state's CRCs.
MODEL_SCRIPT = textwrap.dedent("""
    import json, os, sys, zlib
    import numpy as np
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import checkpoint, data, train_transformer as tt
    from horovod_tpu_torch.training import elastic_loop

    hvd.init(device="cpu")
    cfg = tt.train_config(vocab_size=64, num_layers=2, num_heads=2,
                          head_dim=32, embed_dim=64, mlp_dim=128,
                          dtype=torch.float32, logits_dtype=torch.float32)
    model, opt = tt.make_trainer(cfg, "cpu", seed=3)
    mgr = checkpoint.CheckpointManager(sys.argv[1], max_to_keep=2)
    pos = {"next": 0, "it": None}

    def batches(start):
        for s in range(start, 5):
            yield s, np.random.RandomState(10 + s).randint(0, 64, (2, 16))

    def state_of():
        return {"model": model.state_dict(), "optim": opt.state_dict()}

    def step_fn(step, state):
        if pos["it"] is None or pos["next"] != step:
            pos["it"] = data.prefetch_to_device(
                data.BackgroundLoader(batches(step)), device="cpu")
        s, tokens = next(pos["it"])
        assert s == step
        loss = tt.train_step(model, opt, tokens)
        pos["next"] = step + 1
        print(f"STEP {step} loss={float(loss)!r}", flush=True)
        return state_of()

    def on_resume(ckpt):
        model.load_state_dict(ckpt.state["model"])
        opt.load_state_dict(ckpt.state["optim"])
        pos["next"] = ckpt.metadata["data_position"]
        print(f"RESUMED {ckpt.step}", flush=True)

    elastic_loop(step_fn, state_of(), num_steps=5, manager=mgr,
                 checkpoint_every=1,
                 metadata_fn=lambda s: {"data_position": s + 1},
                 on_resume=on_resume)
    crcs = {k: zlib.crc32(v.numpy().tobytes())
            for k, v in model.state_dict().items()}
    for i, st in opt.state_dict()["state"].items():
        for k in ("exp_avg", "exp_avg_sq"):
            crcs[f"{i}.{k}"] = zlib.crc32(st[k].numpy().tobytes())
    print("CRCS " + json.dumps(crcs, sort_keys=True), flush=True)
    hvd.shutdown()
""")


def test_port_transformer_kill_and_resume_is_bitwise_the_clean_run(tmp_path):
    def run(tag, fault):
        flags = ("--max-restarts", "1", "--ckpt-dir",
                 str(tmp_path / tag)) if fault else ()
        env = {"HVD_TPU_FAULT_KILL_RANK": "0",
               "HVD_TPU_FAULT_KILL_STEP": "3"} if fault else {}
        res = _launch(1, tmp_path / tag, launcher_flags=flags,
                      extra_env=env, script=MODEL_SCRIPT)
        assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-2000:]
        return res

    clean, faulted = run("clean", False), run("faulted", True)
    assert "killing rank 0 at step 3" in faulted.stdout + faulted.stderr
    assert "RESUMED 2" in faulted.stdout
    crcs = [next(ln for ln in r.stdout.splitlines() if "CRCS " in ln)
            .split("CRCS ", 1)[1] for r in (clean, faulted)]
    assert crcs[0] == crcs[1]
    losses = [[ln.split("loss=")[1] for ln in r.stdout.splitlines()
               if "STEP 4 " in ln] for r in (clean, faulted)]
    assert losses[0] == losses[1] and len(losses[0]) == 1
