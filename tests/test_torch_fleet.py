"""Fleet serving of the port against the JAX package's: the native core's
wire bytes, the ``serving.tick`` collective, the snapshot codec, the
worker's line protocol and the soak.

Both packages run on the CPU on the same inputs: the port's own copy of the
C++ core (built into ``build/horovod_tpu_torch/core/``) beside the JAX
package's, each loaded with ``RTLD_LOCAL``, in one process.  Multi-process
tests use free ports and deadlines.
"""

import os
import subprocess
import sys
import textwrap
import zlib

import numpy as np
import pytest
import torch

from horovod_tpu import dataplane as jdataplane
from horovod_tpu import faults as jfaults
from horovod_tpu import replication as jreplication
from horovod_tpu.analysis import schedule as jschedule
from horovod_tpu.core import engine as jem
from horovod_tpu.core.executors import local_executor as jlocal
from horovod_tpu.serving import autoscale as jauto
from horovod_tpu.serving import engine as jeng
from horovod_tpu.serving import router as jrouter
from horovod_tpu.serving import worker as jworker
from horovod_tpu.utils import backoff as jbackoff
from horovod_tpu.utils import env as jenv
from horovod_tpu_torch import dataplane as tdataplane
from horovod_tpu_torch import faults as tfaults
from horovod_tpu_torch import replication as treplication
from horovod_tpu_torch.analysis import schedule as tschedule
from horovod_tpu_torch.core import engine as tem
from horovod_tpu_torch.core.engine import MembershipChanged
from horovod_tpu_torch.core.executors import local_executor as tlocal
from horovod_tpu_torch.serving import autoscale as tauto
from horovod_tpu_torch.serving import engine as teng
from horovod_tpu_torch.serving import router as trouter
from horovod_tpu_torch.serving import soak
from horovod_tpu_torch.serving import worker as tworker
from horovod_tpu_torch.utils import backoff as tbackoff
from horovod_tpu_torch.utils import env as tenv

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FRAMES_DIR = os.path.join(REPO, "tests", "golden", "frames")


# ---------------------------------------------------------------------------
# The native core: the port's own library, the golden wire bytes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fname", sorted(os.listdir(FRAMES_DIR)))
def test_port_core_reproduces_golden_frame(fname):
    with open(os.path.join(FRAMES_DIR, fname), "rb") as f:
        fixture = f.read()
    assert tem.frame_golden(int(fname[:2])) == fixture


def test_both_cores_load_side_by_side():
    # Two copies of the core in one process: each shim drives its own
    # library, and a port engine and a JAX engine run at once.
    assert tem.lib()._name != jem.lib()._name
    assert "build/horovod_tpu_torch/core/" in tem.lib()._name
    engines = [mod.NativeEngine(0, 1, executor=ex,
                                coordinator_host="127.0.0.1",
                                coordinator_port=soak.free_port(),
                                cycle_time_ms=1.0)
               for mod, ex in ((tem, tlocal), (jem, jlocal))]
    try:
        for e, mod in zip(engines, (tem, jem)):
            h = e.enqueue("x", np.arange(4, dtype=np.float32),
                          mod.OP_ALLREDUCE)
            np.testing.assert_array_equal(e.synchronize(h), np.arange(4))
    finally:
        for e in engines:
            e.shutdown()


def test_enums_match_jax():
    for name in ("OP_ALLREDUCE", "OP_ALLGATHER", "OP_BROADCAST",
                 "OP_ALLTOALL", "OP_BARRIER", "WIRE_NATIVE", "WIRE_INT8",
                 "STATUS_OK", "STATUS_PRECONDITION", "STATUS_ABORTED",
                 "DTYPES", "OP_NAMES"):
        assert getattr(tem, name) == getattr(jem, name), name


def test_default_executor_is_local_at_one_process_only(monkeypatch):
    from horovod_tpu_torch.core import executors

    monkeypatch.delenv("HVD_TPU_EXECUTOR", raising=False)
    assert executors.default_executor(0, 1) is tlocal
    # More than one process: the cross-rank executor of the eager path.
    assert executors.default_executor(0, 2) is executors.multihost_executor
    monkeypatch.setenv("HVD_TPU_EXECUTOR", "local")
    assert executors.default_executor(1, 2) is tlocal
    monkeypatch.setenv("HVD_TPU_EXECUTOR", "multihost")
    assert executors.default_executor(0, 1) is executors.multihost_executor
    monkeypatch.setenv("HVD_TPU_EXECUTOR", "mpi")
    with pytest.raises(ValueError, match="HVD_TPU_EXECUTOR"):
        executors.default_executor(0, 2)


# ---------------------------------------------------------------------------
# The serving.tick collective (tests/test_serving.py's asserts, then the
# port's tick vectors against the JAX engine's, tick by tick)
# ---------------------------------------------------------------------------

def _tick_run(eng_mod, em_mod, executor):
    coll = em_mod.NativeEngine(0, 1, executor=executor,
                               coordinator_host="127.0.0.1",
                               coordinator_port=soak.free_port(),
                               cycle_time_ms=1.0)
    try:
        eng = eng_mod.ServingEngine(eng_mod.StubBackend(2),
                                    eng_mod.ServingConfig(
                                        num_slots=2, buckets=(8,),
                                        max_seq_len=64), collective=coll)
        ticks = []
        for k in range(5):
            eng.submit([k + 1, k + 2], 6)
            eng.step()
            ticks.append(dict(eng.fleet))
        while eng.queue or eng._active_count():
            eng.step()
            ticks.append(dict(eng.fleet))
        return eng, ticks, coll.cache_stats()
    finally:
        coll.shutdown()


def test_tick_collective_warm_cache_and_fleet_counters():
    eng, ticks, cs = _tick_run(teng, tem, tlocal)
    steps = eng.counters["steps"]
    assert steps > 2
    # Fleet aggregate (size 1: equals local counters).
    assert eng.fleet["completed"] == 5.0
    assert eng.fleet["steps"] == float(steps)
    assert eng.fleet["done_replicas"] == 0.0
    # One fixed-signature allreduce a tick: the first negotiates, every
    # later one is a response-cache hit.
    assert cs["misses"] <= 1, cs
    assert cs["hits"] >= steps - 1, (cs, steps)
    assert eng.tick_stats()["ticks"] == steps


def test_tick_vectors_equal_jax_engine():
    teng_, tticks, tcs = _tick_run(teng, tem, tlocal)
    jeng_, jticks, jcs = _tick_run(jeng, jem, jlocal)
    assert tticks == jticks
    # Every counter equal; the latencies are wall-clock.
    assert {k: v for k, v in teng_.stats().items() if "ms" not in k} == \
        {k: v for k, v in jeng_.stats().items() if "ms" not in k}
    assert (tcs["misses"], tcs["hits"]) == (jcs["misses"], jcs["hits"])


class _Recorder:
    """A collective that records the timeline instants it is given and
    sums over one contributor."""

    def __init__(self):
        self.instants = []

    def timeline_instant(self, row, label):
        self.instants.append((row, label))

    def enqueue(self, name, vec, op):
        return vec

    def synchronize(self, h):
        return h


@pytest.mark.parametrize("spec_k,prefix_pages", [(0, 0), (3, 16)])
def test_serving_instants_equal_jax(spec_k, prefix_pages):
    runs = []
    for mod in (teng, jeng):
        coll = _Recorder()
        eng = mod.ServingEngine(
            mod.StubBackend(2, period=5),
            mod.ServingConfig(num_slots=2, buckets=(8, 16), max_seq_len=64,
                              spec_k=spec_k, prefix_cache_pages=prefix_pages,
                              page_size=8), collective=coll)
        shared = list(range(1, 9))
        for k in range(4):
            eng.submit(shared + [k + 1, k + 2], 5)
        eng.submit(list(range(40)), 3)             # rejected: too long
        eng.run_until_idle()
        runs.append((coll.instants, eng.fleet))
    assert runs[0] == runs[1]
    rows = {row for row, _ in runs[0][0]}
    assert {"SERVING_ADMIT", "SERVING_EVICT", "SERVING_REJECT"} <= rows
    if prefix_pages:
        assert "SERVING_PREFIX_HIT" in rows
    if spec_k:
        assert "SERVING_SPEC_ACCEPT" in rows


def test_completions_survive_aborted_tick():
    # A reconfiguration aborts the serving.tick allreduce with
    # MembershipChanged AFTER the step's evictions.  The completion must
    # still reach on_complete and the step() return value must not
    # vanish: it is parked and handed over by the next successful step.
    class _FlakyCollective:
        def __init__(self):
            self.blow = False

        def timeline_instant(self, *a, **k):
            pass

        def enqueue(self, name, vec, op):
            if self.blow:
                self.blow = False
                raise MembershipChanged("reconfig mid-tick")
            return "h"

        def synchronize(self, h):
            return np.zeros(9, np.float32)

    coll = _FlakyCollective()
    seen = []
    eng = teng.ServingEngine(teng.StubBackend(1), teng.ServingConfig(
        num_slots=1, buckets=(8,), max_seq_len=64), collective=coll,
        on_complete=seen.append)
    req = eng.submit([1, 2, 3], 1)  # completes on its admission step
    coll.blow = True
    with pytest.raises(MembershipChanged):
        eng.step()
    assert [r.rid for r in seen] == [req.rid]  # delivered before the tick
    assert eng._active_count() == 0  # evicted — the slot really freed
    nxt = eng.submit([4, 5], 1)
    done = eng.step()  # post-reconfigure step flushes the parked request
    assert [r.rid for r in done] == [req.rid, nxt.rid]
    assert [r.rid for r in seen] == [req.rid, nxt.rid]  # no double DONE


def test_parked_completions_drain_through_run_until_idle():
    class _Once:
        blown = False

        def timeline_instant(self, *a):
            pass

        def enqueue(self, name, vec, op):
            if not self.blown:
                self.blown = True
                raise MembershipChanged("reconfig")
            return vec

        def synchronize(self, h):
            return h

    eng = teng.ServingEngine(teng.StubBackend(1), teng.ServingConfig(
        num_slots=1, buckets=(8,), max_seq_len=64), collective=_Once())
    req = eng.submit([1, 2], 1)
    with pytest.raises(MembershipChanged):
        eng.step()
    assert [r.rid for r in eng.run_until_idle()] == [req.rid]


# ---------------------------------------------------------------------------
# AUTOSCALE instants of the policy and the router
# ---------------------------------------------------------------------------

def test_autoscale_instants_equal_jax():
    out = []
    for mod in (tauto, jauto):
        coll, t = _Recorder(), [0.0]
        auto = mod.Autoscaler(mod.AutoscaleConfig(
            min_replicas=1, max_replicas=3, queue_high=4.0, idle_s=1.0,
            cooldown_s=2.0), collective=coll, clock=lambda: t[0])
        verdicts = []
        for q in (40, 40, 0, 0, 0, 0, 0):
            verdicts.append(auto.decide(2, queued=q, active_slots=q,
                                        p99_ttft_ms=12.0))
            t[0] += 1.5
        out.append((verdicts, coll.instants))
    assert out[0] == out[1]
    verdicts, instants = out[0]
    assert "grow" in verdicts and "shrink" in verdicts
    assert [(row, label.split()[0]) for row, label in instants] == [
        ("AUTOSCALE", v) for v in verdicts if v is not None]


def test_router_autoscale_instants_equal_jax():
    out = []
    for eng_mod, rmod, amod in ((teng, trouter, tauto),
                                (jeng, jrouter, jauto)):
        def make():
            return eng_mod.ServingEngine(eng_mod.StubBackend(2),
                                         eng_mod.ServingConfig(
                                             num_slots=2, buckets=(8,),
                                             max_seq_len=64))

        specs = [rmod.ModelSpec("chat"), rmod.ModelSpec("code")]
        coll = _Recorder()
        router = rmod.Router(collective=coll)
        router.add_model(specs[0], [make()])
        router.add_model(specs[1], [make(), make()])
        for _ in range(20):
            router.submit("chat", [1, 2], 4)
        t = [0.0]
        auto = rmod.RouterAutoscaler(
            specs, budget=3, collective=coll,
            config=amod.AutoscaleConfig(min_replicas=1, max_replicas=4,
                                        queue_high=4.0, idle_s=1.0,
                                        cooldown_s=0.0),
            clock=lambda: t[0])
        first = auto.decide(router)
        t[0] += 2.0
        out.append((first, auto.decide(router), coll.instants))
    assert out[0] == out[1]
    assert out[0][1] == [("code", "shrink"), ("chat", "grow")]
    assert [label.split()[0] for _, label in out[0][2]] == [
        "model=code", "model=chat"]


# ---------------------------------------------------------------------------
# Snapshot codec
# ---------------------------------------------------------------------------

_NUMPY_TREES = {
    "flat": {"w": np.arange(12, dtype=np.float32).reshape(3, 4),
             "b": np.zeros(3, np.int64)},
    "nested": {"layers": [{"k": np.ones((2, 2), np.float16)},
                          {"k": np.full((2, 2), 3, np.int32)}],
               "meta": (1, 2.5, "x"), "step": 7},
    "worker": tworker.make_weights(3),
}


@pytest.mark.parametrize("name", sorted(_NUMPY_TREES))
def test_snapshot_blob_byte_identical_to_jax(name):
    tree = _NUMPY_TREES[name]
    blob = treplication.encode_snapshot(5, tree, {"who": "donor"})
    assert blob == jreplication.encode_snapshot(5, tree, {"who": "donor"})
    got, want = (mod.decode_snapshot(blob) for mod in (treplication,
                                                         jreplication))
    assert got["step"] == want["step"] == 5
    assert got["metadata"] == want["metadata"] == {"who": "donor"}
    _assert_tree_equal(got["state"], want["state"])
    _assert_tree_equal(got["state"], tree)


def _assert_tree_equal(a, b):
    assert type(a) is type(b)
    if isinstance(a, dict):
        assert list(a) == list(b) or sorted(a) == sorted(b)
        for k in a:
            _assert_tree_equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_tree_equal(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


def _state_dict(dtype):
    g = torch.Generator().manual_seed(0)
    sd = {f"blocks.{i}.w": torch.randn(16, 8, generator=g).to(dtype)
          for i in range(3)}
    sd["embed.weight"] = torch.randn(32, 8, generator=g).to(dtype)
    sd["norm.scale"] = torch.ones(8, dtype=dtype)
    return sd


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_torch_state_dict_round_trips_bit_for_bit(dtype):
    sd = _state_dict(dtype)
    blob = treplication.encode_snapshot(1, sd)
    state = treplication.decode_snapshot(blob, device="cpu")["state"]
    assert list(state) == sorted(sd)
    for k, v in sd.items():
        got = state[k]
        assert got.dtype == dtype and got.shape == v.shape
        assert torch.equal(got.view(torch.int16 if dtype == torch.bfloat16
                                    else torch.int32),
                           v.view(torch.int16 if dtype == torch.bfloat16
                                  else torch.int32))
    assert treplication.tensor_crcs(state) == treplication.tensor_crcs(sd)
    # A bf16 tensor travels as its uint16 view: the numpy payload of the
    # leaf holds the raw bits.
    leaf = treplication._tensor_leaf(sd["norm.scale"])
    if dtype == torch.bfloat16:
        assert leaf.array.dtype == np.uint16
        assert (leaf.array == 0x3F80).all()       # bf16 1.0
    model = torch.nn.Linear(8, 4).to(dtype)
    model.load_state_dict(treplication.decode_snapshot(
        treplication.encode_snapshot(2, model.state_dict()))["state"])


def test_store_restores_a_shipped_blob_at_its_epoch():
    treplication.clear()
    try:
        blob = treplication.encode_snapshot(3, _state_dict(torch.bfloat16))
        assert treplication.absorb_remote_shard(
            owner=1, step=3, epoch=0, shard_index=0, cut_size=len(blob),
            total_len=len(blob), payload=blob, via="direct")
        assert not treplication.absorb_remote_shard(   # torn: never stored
            owner=1, step=4, epoch=0, shard_index=0, cut_size=len(blob),
            total_len=len(blob), payload=blob[:-1], via="direct")
        assert treplication.restore_local(1) is None   # other epoch
        treplication.bump_epoch(1)
        snap = treplication.restore_local(1)
        assert snap["step"] == 3
        assert treplication.tensor_crcs(snap["state"]) == \
            treplication.tensor_crcs(_state_dict(torch.bfloat16))
        assert treplication.replication_stats()["disk_restores"] == 0
    finally:
        treplication.clear()


# ---------------------------------------------------------------------------
# The JAX-free helpers the port copied: same answers as the originals
# ---------------------------------------------------------------------------

def test_bulk_token_matches_jax():
    for tid, epoch, src, dst in ((0, 0, 0, 1), (7, 3, 2, 0),
                                 (2**40 + 5, 11, 1, 63)):
        assert tdataplane._token(tid, epoch, src, dst) == \
            jdataplane._token(tid, epoch, src, dst)


def test_schedule_hash_matches_jax():
    tr, jr = tschedule.ScheduleRecorder(), jschedule.ScheduleRecorder()
    for op, name, shape in (("allreduce", "serving.tick", (9,)),
                            ("allgather", "g", (3, 2)),
                            ("allreduce", "serving.drained", (1,))):
        assert tr.record(op, name, "float32", shape) == \
            jr.record(op, name, "float32", shape)


def test_backoff_schedule_matches_jax():
    for kw in ({"seed": 3}, {"jitter": False, "initial_s": 0.2,
                             "max_s": 1.0}):
        assert list(tbackoff.Backoff(**kw).delays(8)) == \
            list(jbackoff.Backoff(**kw).delays(8))


_KNOBS = ("cycle_time_ms", "timeline_path", "cache_capacity",
          "stall_check_disabled", "stall_warning_seconds",
          "stall_abort_seconds", "stall_abort_exit_code", "abort_grace_ms",
          "verify_schedule", "verify_interval_ticks", "elastic_enabled",
          "reconfig_timeout_ms", "ckpt_replicate", "bulk_plane",
          "bulk_chunk_bytes", "bulk_timeout_ms", "bulk_max_bytes",
          "fusion_threshold_bytes")


@pytest.mark.parametrize("environ", [
    {},
    {"HVD_TPU_CYCLE_TIME": "2", "HOROVOD_CACHE_CAPACITY": "0",
     "HVD_TPU_STALL_CHECK_DISABLE": "1", "HVD_TPU_ELASTIC": "1",
     "HVD_TPU_BULK_PLANE": "0", "HVD_TPU_BULK_CHUNK_BYTES": "100",
     "HVD_TPU_BULK_TIMEOUT_MS": "bad", "HVD_TPU_VERIFY_SCHEDULE": "true",
     "HVD_TPU_RECONFIG_TIMEOUT_MS": "1500", "HVD_TPU_TIMELINE": "/t.json",
     "HVD_TPU_CKPT_REPLICATE": "1", "HVD_TPU_ABORT_GRACE_MS": "-1"}],
    ids=["defaults", "set"])
def test_native_knobs_match_jax(monkeypatch, environ):
    for name in list(os.environ):
        if name.startswith(("HVD_TPU_", "HOROVOD_")):
            monkeypatch.delenv(name)
    for k, v in environ.items():
        monkeypatch.setenv(k, v)
    for knob in _KNOBS:
        assert getattr(tenv, knob)() == getattr(jenv, knob)(), knob


def test_bulk_fault_plan_matches_jax(monkeypatch):
    monkeypatch.setenv("HVD_TPU_FAULT_BULK_CORRUPT", "1:2")
    monkeypatch.setenv("HVD_TPU_FAULT_WIRE_DROP", "2:5@1")
    for mod in (tfaults, jfaults):
        mod.clear()
    try:
        tp, jp = tfaults.plan(), jfaults.plan()
        for field in ("bulk_corrupt", "bulk_drop", "wire_drop", "on_attempt"):
            assert getattr(tp, field) == getattr(jp, field)
        assert tfaults.armed() == jfaults.armed() is True
        got = [(tfaults.on_bulk_send(1), jfaults.on_bulk_send(1))
               for _ in range(4)]
        assert got == [(None, None), (None, None), ("corrupt", "corrupt"),
                       (None, None)]
    finally:
        for mod in (tfaults, jfaults):
            mod.clear()


# ---------------------------------------------------------------------------
# Processes: the clone over the data plane, the worker, the fleet CLI, the
# soak
# ---------------------------------------------------------------------------

_CLONE = textwrap.dedent("""
    import sys, json, torch
    from horovod_tpu_torch import dataplane, elastic, replication
    from horovod_tpu_torch.core.engine import NativeEngine
    from horovod_tpu_torch.core.executors import local_executor
    from horovod_tpu_torch.serving import autoscale
    rank, port, dtype = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    eng = NativeEngine(rank, 2, executor=local_executor,
                       coordinator_host="127.0.0.1", coordinator_port=port,
                       cycle_time_ms=2.0, bulk_port=dataplane.ensure_listener())
    elastic.attach(eng)
    g = torch.Generator().manual_seed(0)
    sd = {f"w{i}": torch.randn(64, 32, generator=g).to(getattr(torch, dtype))
          for i in range(4)}
    if rank == 0:
        print("VIA", autoscale.ship_weights(eng, 1, 1, sd), flush=True)
    else:
        snap = autoscale.pull_weights(eng, timeout_s=30.0, min_version=1)
        state = snap["state"]
        print("CRCS", json.dumps([replication.tensor_crcs(state),
                                  replication.tensor_crcs(sd),
                                  str(state["w0"].dtype)]), flush=True)
    eng.shutdown()
""")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_state_dict_clone_over_the_direct_stream(dtype):
    port = soak.free_port()
    procs = [subprocess.Popen([sys.executable, "-c", _CLONE, str(r),
                               str(port), dtype], cwd=REPO,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    try:
        outs = [p.communicate(timeout=90)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert [p.returncode for p in procs] == [0, 0], outs
    assert "VIA direct" in outs[0], outs[0]
    line = next(ln for ln in outs[1].splitlines() if ln.startswith("CRCS"))
    import json
    got, want, got_dtype = json.loads(line.split(" ", 1)[1])
    assert got == want and got_dtype == f"torch.{dtype}"


def test_worker_done_crcs_equal_jax_expected_completion():
    prompts = [([3, 1, 4, 1, 5], 6), ([9, 2, 6], 1), (list(range(1, 20)), 24)]
    for prompt, max_new in prompts:
        assert tworker.expected_completion(prompt, max_new) == \
            jworker.expected_completion(prompt, max_new)
    assert tworker.weights_crc(tworker.make_weights(2)) == \
        jworker.weights_crc(jworker.make_weights(2))
    port = soak.free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "horovod_tpu_torch.serving.worker", "0", "1",
         str(port)], cwd=REPO, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True,
        env={**os.environ, "HVD_TPU_SERVE_STEP_S": "0"})
    lines = "".join(f"REQ {i} {m} {','.join(map(str, p))}\n"
                    for i, (p, m) in enumerate(prompts)) + "QUIT\n"
    try:
        out = proc.communicate(lines, timeout=60)[0]
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, out
    done = {int(ln.split()[1]): ln for ln in out.splitlines()
            if ln.startswith("DONE ")}
    assert sorted(done) == [0, 1, 2], out
    for i, (p, m) in enumerate(prompts):
        want = jworker.completion_crc(jworker.expected_completion(p, m))
        assert f"crc={want}" in done[i] and f"ntok={m}" in done[i]


def test_fleet_cli_joiner_clones_and_serves_alike():
    # python -m horovod_tpu_torch.serving in fleet mode on the stub: two
    # founders, then a joiner admitted mid-traffic that pulls the weights
    # over the direct stream; every request completes, every replica
    # serves the probe alike.
    import json

    port = soak.free_port()
    env = {**os.environ, **soak.FLEET_ENV,
           "HVD_TPU_COORDINATOR_PORT": str(port),
           "HVD_TPU_SERVE_BACKEND": "stub", "HVD_TPU_SERVE_QPS": "10",
           "HVD_TPU_SERVE_DURATION_S": "2"}
    argv = [sys.executable, "-m", "horovod_tpu_torch.serving", "--probe", "4"]
    fleet = [soak.Replica(argv, {**env, "JAX_PROCESS_ID": str(r),
                                 "JAX_NUM_PROCESSES": "2"})
             for r in range(2)]
    try:
        import time
        time.sleep(1.0)
        fleet.append(soak.Replica(argv + ["--seed", "1"], {
            **env, "JAX_PROCESS_ID": "2", "JAX_NUM_PROCESSES": "3",
            "HVD_TPU_ELASTIC_JOIN": "1"}))
        reps = []
        for r in fleet:
            line = r.wait_line("SERVE_REPORT ", 90)
            assert line is not None, "\n".join(r.lines)
            reps.append(json.loads(line.split(" ", 1)[1]))
            assert r.proc.wait(timeout=30) == 0
    finally:
        for r in fleet:
            if r.proc.poll() is None:
                r.proc.kill()
    for rep in reps:
        assert rep["completed"] == rep["offered"] and not rep["timed_out"]
        # Every step ticks; the one a membership change cut did not finish
        # its tick.
        assert 0 < rep["ticks"] <= rep["steps"] <= rep["ticks"] + 1
    shipped = [r["shipped"] for r in reps if "shipped" in r]
    assert len(shipped) == 1 and shipped[0]["transport"] == "direct"
    pulled = reps[-1]["pulled"]
    assert pulled["transport"] == "direct" and pulled["disk_reads"] == 0
    assert pulled["bytes"] == shipped[0]["bytes"] > 0
    assert reps[-1]["rank"] == 2 and reps[-1]["admission_wait_ms"] >= 0
    assert reps[-1]["join_to_first_token_ms"] > reps[-1]["pulled"]["pull_ms"]
    assert len({tuple(r["probe"]) for r in reps}) == 1


def test_fleet_cli_join_landing_in_the_drain_reforms_the_fleet():
    # A join admitted between the founders' drain rendezvous and their
    # exit: the coordinator is held there by the drain-hold injector, and
    # the joiner starts only once it is held.  The drain is void, the
    # fleet re-forms at three, the joiner pulls the weights and serves
    # its own traffic, and every replica ends with its report.
    import json

    port = soak.free_port()
    env = {**os.environ, **soak.FLEET_ENV,
           "HVD_TPU_COORDINATOR_PORT": str(port),
           "HVD_TPU_SERVE_BACKEND": "stub", "HVD_TPU_SERVE_QPS": "10",
           "HVD_TPU_SERVE_DURATION_S": "1",
           "HVD_TPU_FAULT_DRAIN_HOLD_RANK": "0",
           "HVD_TPU_FAULT_DRAIN_HOLD_MS": "15000"}
    argv = [sys.executable, "-m", "horovod_tpu_torch.serving", "--probe", "4"]
    fleet = [soak.Replica(argv, {**env, "JAX_PROCESS_ID": str(r),
                                 "JAX_NUM_PROCESSES": "2"})
             for r in range(2)]
    try:
        held = fleet[0].wait_line("horovod_tpu_torch.faults: holding rank 0",
                                  60)
        assert held is not None, "\n".join(fleet[0].lines)
        joiner_env = {k: v for k, v in env.items()
                      if not k.startswith("HVD_TPU_FAULT_")}
        fleet.append(soak.Replica(argv + ["--seed", "1"], {
            **joiner_env, "JAX_PROCESS_ID": "2", "JAX_NUM_PROCESSES": "3",
            "HVD_TPU_ELASTIC_JOIN": "1"}))
        reps = []
        for r in fleet:
            line = r.wait_line("SERVE_REPORT ", 90)
            assert line is not None, "\n".join(r.lines)
            reps.append(json.loads(line.split(" ", 1)[1]))
            assert r.proc.wait(timeout=30) == 0
    finally:
        for r in fleet:
            if r.proc.poll() is None:
                r.proc.kill()
    for rep in reps:
        assert rep["completed"] == rep["offered"] and not rep["timed_out"]
    assert [r["rank"] for r in reps] == [0, 1, 2]
    shipped = [r["shipped"] for r in reps if "shipped" in r]
    assert len(shipped) == 1 and shipped[0]["transport"] == "direct"
    assert reps[-1]["pulled"]["disk_reads"] == 0
    assert reps[-1]["offered"] > 0
    assert len({tuple(r["probe"]) for r in reps}) == 1


def test_soak_two_replicas_join_loses_nothing():
    r = soak.run_fleet(n=2, join=True, kill=False, timeout_s=60)
    assert r["lost"] == 0 and r["completed"] == r["accepted"] > 0, r
    assert r["join_disk_reads"] == 0, r


@pytest.mark.slow
def test_serving_autoscale_soak():
    """Grow under load + SIGKILL mid-traffic + fleet-wide hot swap, with
    the prefix cache and speculation on in every worker: no accepted
    request lost or corrupted, weights cloned with zero disk reads."""
    reps = int(os.environ.get("SERVING_SOAK_REPS", "1"))
    for rep in range(reps):
        r = soak.run_fleet(n=3, qps=40.0, duration_s=4.0, kill=True,
                           join=True, swap=(rep % 2 == 0), seed=rep,
                           prefix_cache=True, spec_k=3)
        assert r["lost"] == 0 and r["completed"] == r["accepted"], r
        assert r["join_disk_reads"] == 0, r
        assert r["killed"] == 1, r


def test_crc_of_a_bf16_tensor_is_that_of_its_bits():
    t = torch.tensor([1.0, -2.0], dtype=torch.bfloat16)
    assert treplication.tensor_crcs({"t": t}) == {
        "t": zlib.crc32(np.array([0x3F80, 0xC000], np.uint16).tobytes())}


def test_stream_waits_for_the_engine_being_registered(monkeypatch):
    # A stream that lands between the receiver's rendezvous and the
    # registration of its engine waits for the engine, up to the bulk
    # timeout, instead of being rejected.
    eng = object()
    seen = iter([None, None, eng])
    monkeypatch.setattr(tdataplane.core_engine, "peek_engine",
                        lambda: next(seen))
    assert tdataplane._await_engine() is eng
    monkeypatch.setattr(tdataplane.core_engine, "peek_engine", lambda: None)
    monkeypatch.setenv("HVD_TPU_BULK_TIMEOUT_MS", "30")
    assert tdataplane._await_engine() is None
