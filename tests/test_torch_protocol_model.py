"""The port's protocol model checker (``horovod_tpu_torch.analysis.protocol``)
against its own wire and fault grammar, and against the JAX package's
checker on the same inputs.

The first half ports every test of ``tests/test_protocol_model.py``: the
wire mirror pinned to the golden fixtures and to the PORT's native encoder
(``horovod_tpu_torch.core.engine.frame_golden``, ``hvd_bulk_token`` of the
port's library, never the JAX package's), the regression traces, the spec
and teeth sweeps, the model-to-wire conformance, the fault-schedule
translation through the PORT's parser (``horovod_tpu_torch.faults``), and
the CLI.  The second half holds the port against
``horovod_tpu.analysis.protocol``: equal golden bytes, equal BFS and walk
results for every model and bug knob, and equal replays, schedules and
repros of the checked-in traces.
"""

import ctypes
import json
import os
import subprocess
import sys

import pytest

from horovod_tpu_torch.analysis.protocol import wire
from horovod_tpu_torch.analysis.protocol.checker import (check_bfs,
                                                         check_walk,
                                                         frames_in_trace,
                                                         replay_trace)
from horovod_tpu_torch.analysis.protocol.machines import (ElasticModel,
                                                          ServingDrainModel,
                                                          TreeModel)
from horovod_tpu_torch.analysis.protocol.replay import (env_schedule,
                                                        format_repro)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FRAMES_DIR = os.path.join(REPO, "tests", "golden", "frames")
TRACES_DIR = os.path.join(REPO, "tests", "golden", "traces")
TRACE_FILES = sorted(os.listdir(TRACES_DIR))


def _load_trace(fname):
    with open(os.path.join(TRACES_DIR, fname)) as f:
        return json.load(f)


# ---------------------------------------------------------------------------
# Wire conformance
# ---------------------------------------------------------------------------

def test_golden_frames_cover_every_frame_type():
    got = {t for t, _name, _b in wire.golden_frames()}
    assert got == set(wire.FRAME_NAMES), "a FrameType has no golden vector"
    assert len(got) == 17


@pytest.mark.parametrize("ftype,name,framed",
                         wire.golden_frames(),
                         ids=[n for _t, n, _b in wire.golden_frames()])
def test_golden_fixture_pins_python_mirror(ftype, name, framed):
    path = os.path.join(FRAMES_DIR, f"{ftype:02d}_{name}.bin")
    with open(path, "rb") as f:
        fixture = f.read()
    assert fixture == framed, (
        f"{name}: the port's wire.py no longer reproduces the checked-in "
        f"golden bytes")


@pytest.mark.parametrize("ftype,name,framed",
                         wire.golden_frames(),
                         ids=[n for _t, n, _b in wire.golden_frames()])
def test_golden_fixture_pins_port_native_encoder(ftype, name, framed):
    from horovod_tpu_torch.core import engine
    native = engine.frame_golden(ftype)
    assert native == framed, (
        f"{name}: the port's c_api.cc hvd_frame_golden disagrees with the "
        f"port's wire.py — its message.cc and the mirror drifted apart")


def test_native_encoder_is_the_ports_own_library():
    from horovod_tpu_torch.core import _build, engine
    path = engine.lib()._name
    assert os.path.dirname(path) == _build.BUILD_DIR
    assert os.path.basename(path).startswith("libhvdcore-")
    assert "horovod_tpu_torch" in os.path.relpath(path, REPO).split(os.sep)


def test_frame_roundtrip_through_parse_and_payload_codecs():
    for ftype, name, framed in wire.golden_frames():
        header, payload = wire.parse_frame(framed)
        assert header.type == ftype
        codec = wire.PAYLOAD_CODECS.get(ftype)
        if codec is None:  # HELLO_ACK / HEARTBEAT: empty payloads
            assert payload == b""
            continue
        decoded = codec.decode(payload)
        assert decoded.encode() == payload, f"{name} re-encode drifted"


def test_parse_frame_rejects_corruption():
    _t, _n, framed = wire.golden_frames()[2]  # REQUEST
    flipped = bytearray(framed)
    flipped[-1] ^= 0xFF
    with pytest.raises(wire.WireError, match="CRC"):
        wire.parse_frame(bytes(flipped))
    with pytest.raises(wire.WireError, match="magic"):
        wire.parse_frame(b"\x00" * len(framed))
    with pytest.raises(wire.WireError, match="length mismatch"):
        wire.parse_frame(framed[:-1])


def test_bulk_token_matches_port_native():
    from horovod_tpu_torch.core import engine
    lib = engine.lib()
    lib.hvd_bulk_token.restype = ctypes.c_uint64
    lib.hvd_bulk_token.argtypes = [ctypes.c_longlong, ctypes.c_longlong,
                                   ctypes.c_int, ctypes.c_int]
    for args in ((99, 3, 1, 2), (0, 0, 0, 0), (1 << 40, 7, 5, 11)):
        assert wire.bulk_token(*args) == lib.hvd_bulk_token(*args)


# ---------------------------------------------------------------------------
# Regression traces (tests/golden/traces/)
# ---------------------------------------------------------------------------

def test_trace_lost_completion_fails_on_prefix_model():
    doc = _load_trace("serving_lost_completion.json")
    buggy = ServingDrainModel(**doc["bug_flags"])
    v = replay_trace(buggy, doc["trace"])
    assert getattr(v, "invariant", None) == doc["invariant"], (
        "the reverted model no longer fails this trace — the "
        "counterexample lost its teeth")


def test_trace_lost_completion_passes_on_current_model():
    doc = _load_trace("serving_lost_completion.json")
    final = replay_trace(ServingDrainModel(), doc["trace"])
    assert not hasattr(final, "invariant"), f"fixed model violated: {final}"
    assert all(w.lost == 0 for w in final.workers)


def test_trace_drain_wedge_fails_on_prefix_model():
    doc = _load_trace("serving_drain_wedge.json")
    buggy = ServingDrainModel(**doc["bug_flags"])
    v = replay_trace(buggy, doc["trace"])
    assert getattr(v, "invariant", None) == doc["invariant"]


def test_trace_drain_wedge_passes_on_current_model():
    doc = _load_trace("serving_drain_wedge.json")
    final = replay_trace(ServingDrainModel(), doc["trace"])
    assert not hasattr(final, "invariant"), f"fixed model violated: {final}"


def test_checker_rederives_lost_completion_from_scratch():
    r = check_bfs(ServingDrainModel(deliver_before_tick=False))
    assert r.violation is not None
    assert r.violation.invariant == "no-lost-completion"
    # BFS returns a SHORTEST counterexample; the checked-in trace is one.
    doc = _load_trace("serving_lost_completion.json")
    assert len(r.violation.trace) == len(doc["trace"])


def test_checker_rederives_drain_wedge_from_scratch():
    r = check_bfs(ServingDrainModel(drain_by_protocol=False))
    assert r.violation is not None
    assert r.violation.invariant == "quiescence"
    doc = _load_trace("serving_drain_wedge.json")
    assert len(r.violation.trace) == len(doc["trace"])


def test_replay_rejects_inapplicable_trace():
    with pytest.raises(ValueError, match="not enabled"):
        replay_trace(ServingDrainModel(), [["detect", 0]])


# ---------------------------------------------------------------------------
# Spec sweeps — the fixed models, exhaustively
# ---------------------------------------------------------------------------

def test_serving_fixed_model_exhaustive():
    r = check_bfs(ServingDrainModel())
    assert r.ok, str(r.violation)
    assert r.complete, "frontier not drained: raise max_depth"


def test_serving_fixed_model_at_scale_10k_states():
    r = check_bfs(ServingDrainModel(workers=3, reqs=2, crashes=1))
    assert r.ok, str(r.violation)
    assert r.complete
    assert r.states >= 10_000, f"only {r.states} states: model degenerated?"


def test_elastic_fixed_model_exhaustive():
    r = check_bfs(ElasticModel())
    assert r.ok, str(r.violation)
    assert r.complete


def test_tree_spec_model_exhaustive():
    r = check_bfs(TreeModel(), max_depth=60)
    assert r.ok, str(r.violation)
    assert r.complete


@pytest.mark.parametrize("flags,invariant", [
    ({"promotion_bumps_epoch": False}, "single-coordinator"),
    ({"clamp_join_id": False}, "quiescence"),
    ({"idempotent_reissue": False}, "ticket-single-use"),
])
def test_elastic_bug_knobs_produce_named_violations(flags, invariant):
    r = check_bfs(ElasticModel(**flags))
    assert r.violation is not None, f"{flags}: no counterexample found"
    assert r.violation.invariant == invariant, str(r.violation)


@pytest.mark.parametrize("flag", [
    "replicate_before_fanout",
    "root_replicate_before_send",
    "root_replays_stale",
])
def test_tree_ordering_rules_are_load_bearing(flag):
    r = check_bfs(TreeModel(**{flag: False}), max_depth=60)
    assert r.violation is not None, f"{flag}=False: no counterexample"
    assert r.violation.invariant == "quiescence", str(r.violation)


def test_walk_is_deterministic_for_a_seed():
    a = check_walk(ServingDrainModel(), seed=7, steps=60, walks=20)
    b = check_walk(ServingDrainModel(), seed=7, steps=60, walks=20)
    assert (a.states, a.transitions, a.depth) == \
        (b.states, b.transitions, b.depth)
    c = check_walk(ServingDrainModel(), seed=8, steps=60, walks=20)
    assert (a.states, a.transitions) != (c.states, c.transitions)


# ---------------------------------------------------------------------------
# Model -> wire conformance: traces only speak frames message.cc accepts
# ---------------------------------------------------------------------------

CONFORMANCE = [
    (ServingDrainModel,
     [["step", 0], ["step", 1], ["deliver_req", 0], ["deliver_req", 1],
      ["quit", 0], ["crash", 1], ["detect", 1], ["deliver_resp", 0]]),
    (ElasticModel,
     [["progress", ], ["replicate", ], ["deliver_state", ], ["knock", ],
      ["poll_join", ], ["deliver_ack", ], ["fail_coord", "partition"],
      ["promote", ], ["deliver_reconfig", ]]),
    (TreeModel,
     [["announce", 0, 0], ["announce", 0, 1], ["agg_up", 0],
      ["announce", 1, 0], ["announce", 1, 1], ["agg_up", 1],
      ["root_decide"], ["root_replicate"], ["root_send", 0],
      ["relay_replicate", 0], ["relay_fanout", 0, 0]]),
]


@pytest.mark.parametrize("model_cls,trace", CONFORMANCE,
                         ids=["serving", "elastic", "tree"])
def test_model_frames_encode_through_real_grammar(model_cls, trace):
    frames = frames_in_trace(model_cls(), trace)
    assert frames, "trace sent nothing: conformance hook is dead"
    seen = set()
    for name, payload_struct, epoch in frames:
        ftype = wire.FRAME_TYPES[name]
        framed = wire.frame(ftype, payload_struct.encode(), epoch)
        header, payload = wire.parse_frame(framed)
        assert header.type == ftype
        assert header.flags == epoch & 0xFFFF
        codec = wire.PAYLOAD_CODECS[ftype]
        assert codec.decode(payload).encode() == payload
        seen.add(name)
    assert len(seen) >= 3, f"trace only exercised {seen}"


# ---------------------------------------------------------------------------
# Counterexample -> fault-schedule translation, through the port's parser
# ---------------------------------------------------------------------------

def test_env_schedule_crash_roundtrips_through_faults_parser(monkeypatch):
    from horovod_tpu_torch import faults
    doc = _load_trace("serving_lost_completion.json")
    env = env_schedule(ServingDrainModel(**doc["bug_flags"]), doc["trace"])
    assert env == {"HVD_TPU_FAULT_KILL_RANK": "1",
                   "HVD_TPU_FAULT_KILL_STEP": "0"}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    plan = faults._plan_from_env()
    assert (plan.kill_rank, plan.kill_step) == (1, 0)


def test_env_schedule_partition_emits_wire_grammar(monkeypatch):
    from horovod_tpu_torch import faults
    model = ElasticModel(promotion_bumps_epoch=False)
    r = check_bfs(model)
    env = env_schedule(model, r.violation.trace)
    assert "HVD_TPU_FAULT_WIRE_PARTITION" in env
    monkeypatch.setenv("HVD_TPU_FAULT_WIRE_PARTITION",
                       env["HVD_TPU_FAULT_WIRE_PARTITION"])
    plan = faults._plan_from_env()
    rank, frame, epoch = plan.wire_partition
    assert rank == 0 and frame >= 0 and epoch >= 0


def test_env_schedule_wedge_needs_no_injector():
    model = ElasticModel(clamp_join_id=False)
    r = check_bfs(model)
    assert env_schedule(model, r.violation.trace) == {}
    repro = format_repro(model, r.violation.trace, r.violation)
    assert "no injector needed" in repro
    assert "quiescence" in repro


def test_format_repro_exports_are_pastable():
    doc = _load_trace("serving_lost_completion.json")
    model = ServingDrainModel(**doc["bug_flags"])
    v = replay_trace(model, doc["trace"])
    repro = format_repro(model, doc["trace"], v)
    assert "export HVD_TPU_FAULT_KILL_RANK=1" in repro
    assert "no-lost-completion" in repro


@pytest.mark.parametrize("model", [
    ServingDrainModel(deliver_before_tick=False),
    ElasticModel(promotion_bumps_epoch=False),
    TreeModel(replicate_before_fanout=False),
], ids=["serving", "elastic", "tree"])
def test_repro_exports_are_taken_by_port_injectors(model, monkeypatch):
    """Every ``export`` line of a counterexample's repro parses through the
    port's fault parser (the one its launcher hands to every child and its
    engine arms the native injectors from) into the same plan fields."""
    from horovod_tpu_torch import faults, run
    r = check_bfs(model, max_depth=60)
    repro = format_repro(model, r.violation.trace, r.violation)
    exports = dict(line[len("export "):].split("=", 1)
                   for line in repro.splitlines()
                   if line.startswith("export "))
    assert exports == env_schedule(model, r.violation.trace)
    for k in [k for k in os.environ if k.startswith("HVD_TPU_FAULT_")]:
        monkeypatch.delenv(k)
    for k, v in exports.items():
        monkeypatch.setenv(k, v)
    child = run._child_env(0, 2, 1, 2, 0, None)   # what the launcher hands on
    assert {k: child[k] for k in exports} == exports
    plan = faults._plan_from_env()
    if "HVD_TPU_FAULT_KILL_RANK" in exports:
        assert plan.kill_rank == int(exports["HVD_TPU_FAULT_KILL_RANK"])
        assert plan.kill_step == int(exports["HVD_TPU_FAULT_KILL_STEP"])
    if "HVD_TPU_FAULT_WIRE_PARTITION" in exports:
        rank, frame, epoch = plan.wire_partition
        assert f"{rank}:{frame}@{epoch}" == \
            exports["HVD_TPU_FAULT_WIRE_PARTITION"]


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------

def test_modelcheck_cli_green_and_skippable():
    env = {**os.environ, "PYTHONPATH": REPO, "MODELCHECK_DEPTH": "60"}
    run = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.analysis.protocol"],
        capture_output=True, text=True, env=env, timeout=300)
    assert run.returncode == 0, run.stdout + run.stderr
    assert "all invariants hold" in run.stdout
    skipped = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.analysis.protocol"],
        capture_output=True, text=True,
        env={**env, "MODELCHECK_SKIP": "1"}, timeout=60)
    assert skipped.returncode == 0
    assert "skipped" in skipped.stdout


def test_modelcheck_cli_imports_nothing_of_jax_or_torch():
    code = ("import runpy, sys, os\n"
            "os.environ['MODELCHECK_SKIP'] = '1'\n"
            "try:\n"
            "    runpy.run_module('horovod_tpu_torch.analysis.protocol',"
            " run_name='__main__')\n"
            "except SystemExit:\n"
            "    pass\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'torch', 'numpy', 'horovod_tpu')))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=60,
                         check=True).stdout
    assert out.strip().splitlines()[-1] == "[]"


# ---------------------------------------------------------------------------
# Parity with the JAX package's checker on the same inputs
# ---------------------------------------------------------------------------

def _jax_protocol():
    from horovod_tpu.analysis.protocol import checker, machines, replay
    from horovod_tpu.analysis.protocol import wire as jax_wire
    return checker, machines, replay, jax_wire


# (model class name, constructor flags, BFS depth): every model and bug knob
# the JAX tests and the model-check CLI use.
MODELS = [
    ("ServingDrainModel", {}, 40),
    ("ServingDrainModel", {"workers": 3, "reqs": 2, "crashes": 1}, 60),
    ("ServingDrainModel", {"deliver_before_tick": False}, 40),
    ("ServingDrainModel", {"drain_by_protocol": False}, 40),
    ("ServingDrainModel", {"reqs": 2, "refcount_shared_pages": False}, 60),
    ("ElasticModel", {}, 40),
    ("ElasticModel", {"promotion_bumps_epoch": False}, 40),
    ("ElasticModel", {"clamp_join_id": False}, 40),
    ("ElasticModel", {"idempotent_reissue": False}, 40),
    ("TreeModel", {}, 60),
    ("TreeModel", {"replicate_before_fanout": False}, 60),
    ("TreeModel", {"root_replicate_before_send": False}, 60),
    ("TreeModel", {"root_replays_stale": False}, 60),
]
MODEL_IDS = [f"{c}-{'-'.join(f'{k}={v}' for k, v in f.items()) or 'spec'}"
             for c, f, _d in MODELS]


def _summary(r):
    v = r.violation
    return (r.states, r.transitions, r.depth, r.complete, r.ok,
            None if v is None else (v.invariant, v.detail, v.trace, v.state))


def test_golden_frames_equal_across_packages():
    _c, _m, _r, jax_wire = _jax_protocol()
    port, ref = wire.golden_frames(), jax_wire.golden_frames()
    assert port == ref
    for ftype, name, framed in port:
        with open(os.path.join(FRAMES_DIR, f"{ftype:02d}_{name}.bin"),
                  "rb") as f:
            assert f.read() == framed, name
    assert wire.FRAME_TYPES == jax_wire.FRAME_TYPES


@pytest.mark.parametrize("cls,flags,depth", MODELS, ids=MODEL_IDS)
def test_bfs_equals_jax_checker(cls, flags, depth):
    checker, machines, _r, _w = _jax_protocol()
    port_model = globals()[cls](**flags)
    ref_model = getattr(machines, cls)(**flags)
    assert _summary(check_bfs(port_model, max_depth=depth)) == \
        _summary(checker.check_bfs(ref_model, max_depth=depth))


@pytest.mark.parametrize("seed", [1, 7])
@pytest.mark.parametrize("cls,flags,depth", MODELS, ids=MODEL_IDS)
def test_walk_equals_jax_checker(cls, flags, depth, seed):
    checker, machines, _r, _w = _jax_protocol()
    port = check_walk(globals()[cls](**flags), seed=seed)
    ref = checker.check_walk(getattr(machines, cls)(**flags), seed=seed)
    assert _summary(port) == _summary(ref)


@pytest.mark.parametrize("fname", TRACE_FILES)
def test_replay_schedule_and_repro_equal_jax_on_golden_traces(fname):
    checker, machines, replay, _w = _jax_protocol()
    doc = _load_trace(fname)
    for flags in (doc["bug_flags"], {}):
        port_model = ServingDrainModel(**flags)
        ref_model = machines.ServingDrainModel(**flags)
        port_v = replay_trace(port_model, doc["trace"])
        ref_v = checker.replay_trace(ref_model, doc["trace"])
        assert type(port_v).__name__ == type(ref_v).__name__
        if hasattr(ref_v, "invariant"):
            assert (port_v.invariant, port_v.detail, port_v.trace,
                    port_v.state) == (ref_v.invariant, ref_v.detail,
                                      ref_v.trace, ref_v.state)
        else:
            assert port_v == ref_v
        assert env_schedule(port_model, doc["trace"]) == \
            replay.env_schedule(ref_model, doc["trace"])
        violation = port_v if hasattr(port_v, "invariant") else None
        ref_violation = ref_v if hasattr(ref_v, "invariant") else None
        port_repro = format_repro(port_model, doc["trace"], violation)
        ref_repro = replay.format_repro(ref_model, doc["trace"],
                                        ref_violation)
        assert port_repro.replace("horovod_tpu_torch", "horovod_tpu") == \
            ref_repro
