"""The port's checkpointing (``horovod_tpu_torch/checkpoint.py``,
``utils/manifest.py``) against the JAX package's: the scenarios of
``tests/test_checkpoint.py``, each on the port, and for the manager the
same save / fault / restore schedule run through both managers with the
same values, comparing ``steps()``, ``latest_step()`` and what comes
back.  A checkpoint directory's manifest reads the same through both
``manifest`` modules, whichever package wrote it."""

import json
import os
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

from horovod_tpu import checkpoint as jckpt
from horovod_tpu import faults as jfaults
from horovod_tpu.utils import manifest as jmanifest
from horovod_tpu_torch import checkpoint as tckpt
from horovod_tpu_torch import faults as tfaults
from horovod_tpu_torch.utils import manifest as tmanifest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _clean_faults():
    for mod in (tfaults, jfaults):
        mod.clear()
    yield
    for mod in (tfaults, jfaults):
        mod.clear()


def _t_state(v: float):
    return {"w": torch.full((4,), v), "step_arr": torch.tensor(int(v))}


def _j_state(v: float):
    return {"w": np.full(4, v, np.float32), "step_arr": np.array(int(v))}


def test_save_restore_roundtrip(tmp_path):
    state = {"params": {"w": torch.arange(6.0).reshape(2, 3)},
             "step": torch.tensor(7), "n": np.arange(3), "lr": 0.5}
    p = tmp_path / "ckpt"
    tckpt.save(p, state)
    assert tckpt.exists(p)
    out = tckpt.restore(p)
    assert torch.equal(out["params"]["w"], state["params"]["w"])
    assert int(out["step"]) == 7 and out["lr"] == 0.5
    np.testing.assert_array_equal(out["n"], state["n"])
    # A template puts each tensor where the template's lives and holds
    # the structure.
    out = tckpt.restore(p, template=state)
    assert torch.equal(out["params"]["w"], state["params"]["w"])
    with pytest.raises(KeyError):
        tckpt.restore(p, template={"params": {"v": torch.zeros(1)}})


def test_epoch_resume(tmp_path):
    base = tmp_path / "run"
    assert tckpt.resume_epoch(base) == -1  # fresh start sentinel
    tckpt.save_epoch(base, 0, {"w": torch.zeros(3)})
    assert tckpt.resume_epoch(base) == 0   # epoch 0 is resumable
    tckpt.save_epoch(base, 1, {"w": torch.ones(3)})
    tckpt.save_epoch(base, 3, {"w": torch.ones(3) * 3})
    assert tckpt.resume_epoch(base) == 3
    out = tckpt.restore_epoch(base, 3)
    assert torch.equal(out["w"], torch.ones(3) * 3)


def test_background_save_commits_and_round_trips(tmp_path):
    state = {"w": torch.linspace(0, 1, 8), "step": torch.tensor(3)}
    p = tmp_path / "bg"
    tckpt.save(p, state, background=True)   # returns after the snapshot
    state["w"].add_(1.0)  # the caller's later update cannot tear it
    tckpt.wait_pending()
    assert tckpt.exists(p)
    out = tckpt.restore(p)
    assert torch.equal(out["w"], torch.linspace(0, 1, 8))
    assert int(out["step"]) == 3


def test_background_saves_serialize(tmp_path):
    """A second background save waits for the first to land; all land."""
    for i in range(3):
        tckpt.save_epoch(tmp_path / "bgs", i, {"x": torch.full((4,),
                                                               float(i))},
                         background=True)
    tckpt.wait_pending()
    assert tckpt.resume_epoch(tmp_path / "bgs") == 2
    out = tckpt.restore_epoch(tmp_path / "bgs", 1)
    assert torch.equal(out["x"], torch.full((4,), 1.0))


def test_uninitialized_multiprocess_env_is_loud(tmp_path, monkeypatch):
    """A launcher-spawned worker that forgot ``init()`` carries the job's
    shape in its environment: the rank-0 fallback must not engage, or
    every worker would race-write the same checkpoint directory."""
    from horovod_tpu_torch import basics

    names = ("WORLD_SIZE", "JAX_NUM_PROCESSES", "JAX_COORDINATOR_ADDRESS",
             "HVD_TPU_COORDINATOR_HOST")
    for var, val in [("WORLD_SIZE", "2"), ("JAX_NUM_PROCESSES", "2"),
                     ("JAX_COORDINATOR_ADDRESS", "127.0.0.1:9999"),
                     ("HVD_TPU_COORDINATOR_HOST", "127.0.0.1")]:
        for v in names:
            monkeypatch.delenv(v, raising=False)
        monkeypatch.setenv(var, val)
        assert tckpt._multiprocess_env()
        with pytest.raises(basics.NotInitializedError):
            tckpt.save(tmp_path / "race", {"w": torch.zeros(2)})

    for v in names:
        monkeypatch.delenv(v, raising=False)
    assert not tckpt._multiprocess_env()
    assert tckpt._rank() == 0 and tckpt._size() == 1

    # Explicit -np 1: the launcher sets addresses even for a lone worker.
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("JAX_NUM_PROCESSES", "1")
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "127.0.0.1:9999")
    monkeypatch.setenv("HVD_TPU_COORDINATOR_HOST", "127.0.0.1")
    assert not tckpt._multiprocess_env()
    assert tckpt._rank() == 0 and tckpt._size() == 1


def test_restore_without_init_single_chip(tmp_path):
    """The inference/export contract: a checkpoint of the port's model
    restores and serves in a plain single-process program that never
    calls ``init()``, with the JAX model's logits for the same weights."""
    import jax
    import jax.numpy as jnp

    from horovod_tpu.models import Transformer, TransformerConfig
    from horovod_tpu_torch.models import convert
    from horovod_tpu_torch.models import transformer as ttm

    small = dict(vocab_size=64, num_layers=1, num_heads=2, head_dim=8,
                 embed_dim=16, mlp_dim=32, max_seq_len=8)
    jmodel = Transformer(TransformerConfig(**small, dtype=jnp.float32))
    tokens = np.arange(8, dtype=np.int32)[None, :] % 64
    params = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(tokens))
    want = np.asarray(jmodel.apply(params, jnp.asarray(tokens)), np.float32)
    tcfg = ttm.TransformerConfig(**small, dtype=torch.float32)
    sd = convert.params_from_flax(jax.tree_util.tree_map(np.asarray, params),
                                  tcfg)
    tckpt.save(tmp_path / "export", {"params": sd})

    prog = f"""
import json, sys
import numpy as np, torch
import horovod_tpu_torch as hvd
from horovod_tpu_torch import checkpoint
from horovod_tpu_torch.models import transformer as ttm

assert not hvd.is_initialized()
state = checkpoint.restore({str(tmp_path / "export")!r})
assert not hvd.is_initialized()  # restore must not drag init in
assert "jax" not in sys.modules
cfg = ttm.TransformerConfig(vocab_size=64, num_layers=1, num_heads=2,
                            head_dim=8, embed_dim=16, mlp_dim=32,
                            max_seq_len=8, dtype=torch.float32)
model = ttm.Transformer(cfg, device="cpu")
model.load_state_dict(state["params"])
tokens = torch.arange(8)[None, :] % 64
with torch.no_grad():
    out = model(tokens)
print("RESULT " + json.dumps(out.float().ravel().tolist()))
"""
    env = {k: v for k, v in os.environ.items()
           if k not in ("WORLD_SIZE", "JAX_NUM_PROCESSES",
                        "JAX_COORDINATOR_ADDRESS",
                        "HVD_TPU_COORDINATOR_HOST")}
    proc = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                          text=True, timeout=120, cwd=REPO,
                          env={**env, "PYTHONPATH": REPO})
    assert proc.returncode == 0, proc.stderr[-2000:]
    line = [ln for ln in proc.stdout.splitlines()
            if ln.startswith("RESULT ")][-1]
    got = np.array(json.loads(line[len("RESULT "):]), np.float32)
    np.testing.assert_allclose(got, want.ravel(), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# CheckpointManager: the same schedule through both managers
# ---------------------------------------------------------------------------

def _both(tmp_path, name, max_to_keep=2):
    return (jckpt.CheckpointManager(tmp_path / f"j_{name}",
                                    max_to_keep=max_to_keep, rank=0, size=1),
            tckpt.CheckpointManager(tmp_path / f"t_{name}",
                                    max_to_keep=max_to_keep, rank=0, size=1))


def _same_restore(jck, tck):
    if jck is None or tck is None:
        assert jck is None and tck is None
        return
    assert jck.step == tck.step
    np.testing.assert_array_equal(np.asarray(jck.state["w"]),
                                  tck.state["w"].numpy())
    assert int(np.asarray(jck.state["step_arr"])) == \
        int(tck.state["step_arr"])
    assert jck.metadata == tck.metadata


def _corrupt_newest(directory, step):
    victim, vsize = None, -1
    for root, _d, files in os.walk(os.path.join(directory, f"step_{step}")):
        for f in files:
            fp = os.path.join(root, f)
            if "_COMMIT" not in f and os.path.getsize(fp) > vsize:
                victim, vsize = fp, os.path.getsize(fp)
    with open(victim, "r+b") as f:
        f.write(b"\xff" * min(vsize, 512))


def test_manager_save_restore_and_prune(tmp_path):
    jm, tm = _both(tmp_path, "mgr")
    for s in (0, 1, 2):
        jm.save(s, _j_state(float(s)), metadata={"rng": np.arange(2)})
        tm.save(s, _t_state(float(s)), metadata={"rng": np.arange(2)})
    assert tm.steps() == jm.steps() == [1, 2]
    assert tm.latest_step() == jm.latest_step() == 2
    tck = tm.restore_latest(template=_t_state(0.0))
    _same_restore(jm.restore_latest(template=_j_state(0.0)), tck)
    assert tck.metadata["rng"] == [0, 1]
    assert tmanifest.is_complete(tmanifest.step_dir(tm.directory, 2))


def test_manager_corrupt_newest_falls_back(tmp_path):
    jm, tm = _both(tmp_path, "cr", max_to_keep=3)
    for m, mk in ((jm, _j_state), (tm, _t_state)):
        m.save(1, mk(1.0))
        m.save(2, mk(2.0))
        _corrupt_newest(m.directory, 2)
    with pytest.warns(UserWarning, match="falling back"):
        jck = jm.restore_latest(template=_j_state(0.0))
    with pytest.warns(UserWarning, match="falling back"):
        tck = tm.restore_latest(template=_t_state(0.0))
    assert tck.step == 1
    _same_restore(jck, tck)


def test_manager_fault_injector_corrupts_committed_step(tmp_path):
    jfaults.install(corrupt_step=2)
    tfaults.install(corrupt_step=2)
    jm, tm = _both(tmp_path, "fi", max_to_keep=3)
    for m, mk in ((jm, _j_state), (tm, _t_state)):
        m.save(1, mk(1.0))
        m.save(2, mk(2.0))  # the injector garbles this payload
    assert tm.steps() == jm.steps() == [1, 2]
    with pytest.warns(UserWarning, match="falling back"):
        jck = jm.restore_latest(template=_j_state(0.0))
    with pytest.warns(UserWarning, match="falling back"):
        tck = tm.restore_latest(template=_t_state(0.0))
    assert tck.step == 1
    _same_restore(jck, tck)


def test_manager_background_save_commits_on_drain(tmp_path):
    jm, tm = _both(tmp_path, "bgm")
    jm.save(5, _j_state(5.0), background=True)
    tm.save(5, _t_state(5.0), background=True)
    jm.drain()
    tm.drain()
    assert tm.steps() == jm.steps() == [5]
    assert tmanifest.is_complete(tmanifest.step_dir(tm.directory, 5))
    _same_restore(jm.restore_latest(), tm.restore_latest())


def test_manager_torn_dir_is_invisible_and_cleaned(tmp_path):
    jm, tm = _both(tmp_path, "torn")
    for m in (jm, tm):
        os.makedirs(os.path.join(m.directory, "step_3"))
        assert m.steps() == [] and m.restore_latest() is None
    jm.save(4, _j_state(4.0))
    tm.save(4, _t_state(4.0))
    assert tm.steps() == jm.steps() == [4]
    for m in (jm, tm):
        assert not os.path.isdir(os.path.join(m.directory, "step_3"))


def test_manager_async_save_commits_in_background(tmp_path, monkeypatch):
    monkeypatch.setenv("HVD_TPU_CKPT_ASYNC", "1")
    jm, tm = _both(tmp_path, "am")
    for s in (0, 1, 2):
        jm.save(s, _j_state(float(s)), metadata={"rng": [s]})
        state = _t_state(float(s))
        tm.save(s, state, metadata={"rng": [s]})
        state["w"].add_(100.0)  # after the snapshot: never persisted
    jm.drain()
    tm.drain()
    assert tm.steps() == jm.steps() == [1, 2]
    assert tm.last_committed_step() == jm.last_committed_step() == 2
    assert tm.persist_error() is None
    tck = tm.restore_latest(template=_t_state(0.0))
    assert tck.step == 2 and tck.metadata["rng"] == [2]
    _same_restore(jm.restore_latest(template=_j_state(0.0)), tck)


def test_manager_torn_manifest_is_invisible(tmp_path):
    jfaults.install(torn_manifest_step=2)
    tfaults.install(torn_manifest_step=2)
    jm, tm = _both(tmp_path, "tm", max_to_keep=3)
    for m, mk in ((jm, _j_state), (tm, _t_state)):
        m.save(1, mk(1.0))
        m.save(2, mk(2.0))  # the injector tears this _COMMIT
    for m in (jm, tm):
        step2 = tmanifest.step_dir(m.directory, 2)
        assert os.path.isfile(os.path.join(step2, "_COMMIT"))
        assert not tmanifest.is_complete(step2)
        assert not jmanifest.is_complete(step2)
    assert tm.steps() == jm.steps() == [1]
    _same_restore(jm.restore_latest(template=_j_state(0.0)),
                  tm.restore_latest(template=_t_state(0.0)))


def test_manager_enospc_persist_surfaces_without_crashing(tmp_path,
                                                          monkeypatch):
    import errno

    monkeypatch.setenv("HVD_TPU_CKPT_ASYNC", "1")
    jfaults.install(enospc_step=1)
    tfaults.install(enospc_step=1)
    jm, tm = _both(tmp_path, "nospc", max_to_keep=3)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the persist-failure warning
        for m, mk, fl in ((jm, _j_state, jfaults), (tm, _t_state, tfaults)):
            m.save(1, mk(1.0))  # persist raises ENOSPC
            m.drain()
            fl.clear()
            m.save(2, mk(2.0))  # disk "recovered": commits fine
            m.drain()
    for m in (jm, tm):
        err = m.persist_error()
        assert isinstance(err, OSError) and err.errno == errno.ENOSPC
    assert tm.steps() == jm.steps() == [2]
    _same_restore(jm.restore_latest(template=_j_state(0.0)),
                  tm.restore_latest(template=_t_state(0.0)))


def test_manager_kill_mid_commit_leaves_step_invisible(tmp_path):
    """HVD_TPU_FAULT_PERSIST_KILL_STEP: the process dies after the payload
    is durable but before _COMMIT exists; the step stays invisible and
    restore falls back, through either package's reader."""
    prog = """
import sys
import torch
from horovod_tpu_torch import checkpoint
mgr = checkpoint.CheckpointManager(sys.argv[1], max_to_keep=3,
                                   rank=0, size=1)
mgr.save(1, {"w": torch.full((4,), 1.0)})
mgr.save(2, {"w": torch.full((4,), 2.0)})  # dies mid-commit
print("UNREACHABLE", flush=True)
"""
    root = str(tmp_path / "kc")
    proc = subprocess.run(
        [sys.executable, "-c", prog, root], capture_output=True, text=True,
        timeout=120, cwd=REPO,
        env={**os.environ, "PYTHONPATH": REPO,
             "HVD_TPU_FAULT_PERSIST_KILL_STEP": "2"})
    assert proc.returncode == -9, (proc.returncode, proc.stderr[-2000:])
    assert "UNREACHABLE" not in proc.stdout
    step2 = tmanifest.step_dir(root, 2)
    assert os.path.isdir(step2)  # payload staged...
    assert not tmanifest.is_complete(step2)  # ...but never committed
    assert jmanifest.complete_steps(root) == [1]
    mgr = tckpt.CheckpointManager(root, rank=0, size=1)
    assert mgr.steps() == [1]
    ck = mgr.restore_latest(template={"w": torch.zeros(4)})
    assert ck.step == 1 and torch.equal(ck.state["w"], torch.full((4,), 1.0))


def test_preemption_flag_roundtrip():
    tckpt.clear_preemption()
    assert not tckpt.preemption_requested()
    tckpt.request_checkpoint()
    assert tckpt.preemption_requested()
    tckpt.clear_preemption()
    assert not tckpt.preemption_requested()


# ---------------------------------------------------------------------------
# The manifest format, and what the port adds
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_manifest_reads_the_same_through_both_packages(tmp_path, writer):
    w = jmanifest if writer == "jax" else tmanifest
    root = tmp_path / writer
    for step, md in ((3, {"rng": [1, 2]}), (10, {"data_position": 11}),
                     (7, None)):
        os.makedirs(w.step_dir(root, step))
        w.write_commit(w.step_dir(root, step), step, md)
    os.makedirs(w.step_dir(root, 12))          # torn: no manifest
    with open(os.path.join(w.step_dir(root, 12), "_COMMIT"), "w") as f:
        f.write('{"step": ')
    os.makedirs(root / "not_a_step")
    for m in (jmanifest, tmanifest):
        assert m.complete_steps(root) == [3, 7, 10]
        assert m.latest_complete(root) == (10, w.step_dir(root, 10))
        assert m.read_commit(w.step_dir(root, 3)) == \
            {"step": 3, "metadata": {"rng": [1, 2]}}
        assert m.parse_step("step_12") == 12 and m.parse_step("x") is None
    assert tmanifest.step_dir(root, 4) == jmanifest.step_dir(root, 4)


def test_launcher_resume_dir_names_the_newest_complete_step(tmp_path):
    mgr = tckpt.CheckpointManager(tmp_path / "r", max_to_keep=3, rank=0,
                                  size=1)
    for s in (1, 4):
        mgr.save(s, _t_state(float(s)))
    assert jmanifest.latest_complete(mgr.directory)[1] == \
        tmanifest.latest_complete(mgr.directory)[1] == \
        os.path.join(mgr.directory, "step_4")


def test_template_tolerates_lazy_optimizer_state(tmp_path):
    """A torch optimizer has no state before its first step: a template
    taken then still restores a checkpoint of a trained one."""
    model = torch.nn.Linear(3, 2)
    opt = torch.optim.AdamW(model.parameters(), lr=0.1)
    template = {"model": model.state_dict(), "optim": opt.state_dict()}
    model(torch.ones(1, 3)).sum().backward()
    opt.step()
    mgr = tckpt.CheckpointManager(tmp_path / "lazy", rank=0, size=1)
    mgr.save(0, {"model": model.state_dict(), "optim": opt.state_dict()})
    ck = mgr.restore_latest(template=template)
    fresh = torch.optim.AdamW(torch.nn.Linear(3, 2).parameters(), lr=0.1)
    fresh.load_state_dict(ck.state["optim"])
    for a, b in zip(fresh.state.values(), opt.state.values()):
        assert torch.equal(a["exp_avg"], b["exp_avg"])


@pytest.mark.parametrize("saved_int8", [False, True])
def test_compression_mode_migrates_on_load(saved_int8):
    """The optimizer's ``load_state_dict`` carries a checkpoint across
    compression modes, as the JAX package's restore migrates
    DistributedState <-> DistributedEFState: the residuals zero-start or
    are dropped, with the JAX package's warnings."""
    from horovod_tpu_torch import training
    from horovod_tpu_torch.ops.compression import Compression

    def make(int8):
        model = torch.nn.Linear(3, 2)
        opt = training.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.1),
            compression=Compression.int8 if int8 else Compression.none)
        return opt

    src, dst = make(saved_int8), make(not saved_int8)
    sd = src.state_dict()
    if saved_int8:
        sd["error_feedback"] = [torch.zeros(2, 3), torch.zeros(2)]
    match = "dropped" if saved_int8 else "fresh EF start"
    with pytest.warns(UserWarning, match=match):
        dst.load_state_dict(sd)


def test_snapshot_lands_in_one_flat_buffer_reused_across_saves(
        tmp_path, monkeypatch):
    """The card's tensors of a snapshot are views of one flat host buffer
    at 64-byte aligned offsets (here the CPU's stand in for them); an
    async manager gives that buffer back once the step is persisted and
    takes it again for the next save."""
    monkeypatch.setattr(tckpt, "_on_card", lambda v: True)
    state = {"a": torch.arange(5.0), "b": [torch.tensor(3),
                                          torch.ones(2, 3,
                                                     dtype=torch.bfloat16)],
             "n": np.arange(2), "lr": 1.5}
    bufs = []

    def alloc(nbytes):
        bufs.append(torch.zeros(nbytes, dtype=torch.uint8))
        return bufs[-1]

    state["c"] = torch.full((3,), 7.0)
    snap = tckpt.host_snapshot(state, alloc)
    # One buffer a dtype: f32 (two tensors), int64, bf16.
    assert sorted(b.numel() for b in bufs) == [64, 64, 128]
    for t, want in ((snap["a"], state["a"]), (snap["b"][0], state["b"][0]),
                    (snap["b"][1], state["b"][1]), (snap["c"], state["c"])):
        assert torch.equal(t, want) and t.dtype == want.dtype
        base = t.untyped_storage().data_ptr()
        assert base in {b.data_ptr() for b in bufs}
        assert (t.data_ptr() - base) % 64 == 0
    assert snap["a"].untyped_storage().data_ptr() == \
        snap["c"].untyped_storage().data_ptr()
    state["a"].add_(1.0)
    assert torch.equal(snap["a"], torch.arange(5.0))
    tckpt.save(tmp_path / "flat", state)
    out = tckpt.restore(tmp_path / "flat")
    assert torch.equal(out["b"][1], state["b"][1]) and out["lr"] == 1.5

    monkeypatch.setenv("HVD_TPU_CKPT_ASYNC", "1")
    mgr = tckpt.CheckpointManager(tmp_path / "pool", rank=0, size=1)
    taken = []
    take = mgr._pool.take
    monkeypatch.setattr(mgr._pool, "take",
                        lambda n: taken.append(take(n)) or taken[-1])
    for s in range(3):
        mgr.save(s, _t_state(float(s)))
        mgr.drain()
    # A buffer a dtype (f32, int64), each reused by every save.
    assert len(taken) == 6 and len({t.data_ptr() for t in taken}) == 2
    ck = mgr.restore_latest(template=_t_state(0.0))
    assert ck.step == 2 and torch.equal(ck.state["w"], torch.full((4,), 2.0))
