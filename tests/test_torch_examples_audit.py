"""The port's structural audits (``horovod_tpu_torch.examples.overlap_audit``
and ``longctx_audit``), which read the port's own events, through the
tests of ``tests/test_overlap.py`` that read their JAX twins' compiled
programs, and against the JAX audits' computed outputs: the bucket plans
against the JAX planner's ``plan_overlap`` on the same gradient manifest,
the ring's executed-step counters and the context plans against
``examples/longctx_audit.py``'s ``audit_step_skip`` and
``audit_planner``.  Where a JAX test pins a count in the lowered program
(``is_finite`` gates, surviving all-reduces), the port's count is of the
buckets its optimizer issued and when."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from _timing import scaled

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "horovod_tpu_torch.examples."


def _env(**extra):
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "2",
           **extra}
    for name in ("RANK", "WORLD_SIZE", "JAX_PROCESS_ID", "JAX_NUM_PROCESSES",
                 "JAX_COORDINATOR_ADDRESS", "MASTER_ADDR", "MASTER_PORT",
                 "HOROVOD_OVERLAP_BUCKETS", "HVD_TPU_OVERLAP_BUCKETS",
                 "HVD_TPU_DEVICE_HEADROOM_MB"):
        if name not in extra:
            env.pop(name, None)
    return env


def _launch(np_, module, *args, env=None, timeout=300):
    cmd = [sys.executable, "-m", PKG + module, "--device", "cpu", *args]
    if np_ > 1:
        cmd = [sys.executable, "-m", "horovod_tpu_torch.run", "-np",
               str(np_), "--", *cmd]
    out = subprocess.run(cmd, capture_output=True, text=True,
                         timeout=scaled(timeout), env=_env(**(env or {})),
                         cwd=REPO)
    assert out.returncode == 0, (out.stdout[-3000:], out.stderr[-3000:])
    rows = [json.loads(line[line.index("{"):]) for line in
            out.stdout.splitlines() if line.lstrip("[0]: ").startswith("{")]
    assert rows, out.stdout[-2000:]
    return rows[-1]


# -- overlap_audit ------------------------------------------------------------

@pytest.fixture(scope="module")
def gate():
    """``--assert-planner``: the width-2 gloo job and width 1, once."""
    return _launch(1, "overlap_audit", "--assert-planner")


def test_planner_gate_passes(gate):
    assert gate["failures"] == [], gate["failures"]


def test_buckets_issued_before_combining(gate):
    # The optimizer really does issue several bucket allreduces at width 2.
    assert len(gate["width2"]["buckets_issued"]) >= 3, gate["width2"]


def test_chained_buckets_survive_and_interleave(gate):
    from horovod_tpu_torch.utils import env

    wide = gate["width2"]
    assert len(wide["buckets_issued"]) >= env.DEFAULT_OVERLAP_BUCKETS, wide
    # Issued from the hooks while backward still runs, in plan order, the
    # first well before backward returns.
    assert wide["issued_in_backward"] >= 1, wide
    assert wide["buckets_issued"] == sorted(wide["buckets_issued"]), wide
    assert wide["issue_ms"][0] < wide["backward_end_ms"], wide


def test_chained_buckets_assertion_uses_default(gate):
    from horovod_tpu_torch.utils import env

    assert env.DEFAULT_OVERLAP_BUCKETS == 4
    assert len(gate["width2"]["buckets_issued"]) >= \
        env.DEFAULT_OVERLAP_BUCKETS


def test_adaptive_planner_chains_at_real_width(gate):
    from horovod_tpu_torch.utils import env

    wide = gate["width2"]
    plan = wide["plan"]
    assert plan["planner"] == "adaptive" and plan["chained"], plan
    assert plan["chain_depth"] == env.DEFAULT_OVERLAP_BUCKETS, plan
    assert plan["width"] == 2, plan
    # Every gradient feeds a hook: one a parameter.
    assert wide["optimizer_hooks"] == wide["gradients"] == \
        len(wide["manifest"]), wide


def test_adaptive_planner_width1_bypasses_chain(gate):
    w1 = gate["width1"]
    plan = w1["plan"]
    assert plan["planner"] == "adaptive" and plan["chain_depth"] == 0, plan
    assert not plan["chained"] and plan["width"] == 1, plan
    assert w1["optimizer_hooks"] == 0 and w1["buckets_issued"] == [], w1


def test_disabling_chain_restores_one_fused_pass():
    # HOROVOD_OVERLAP_BUCKETS=0 (deliberate: the escape hatch under test):
    # no hook, no bucket from backward, one fused pass at step().
    row = _launch(2, "overlap_audit",
                  env={"HOROVOD_OVERLAP_BUCKETS": "0"})  # hvd-lint: disable=HVD107
    plan = row["plan"]
    assert plan["planner"] == "static" and not plan["chained"], plan
    assert row["optimizer_hooks"] == 0 and row["buckets_issued"] == [], row


@pytest.mark.parametrize("leg", ["width2", "width1"])
def test_plans_match_the_jax_planner(gate, leg, monkeypatch):
    """The plan each leg recorded is the JAX planner's on the same gradient
    manifest, width and (unknown) headroom."""
    import jax.numpy as jnp

    from horovod_tpu.ops import schedule_plan as jsp

    for name in ("HOROVOD_OVERLAP_BUCKETS", "HVD_TPU_OVERLAP_BUCKETS",
                 "HOROVOD_DEVICE_HEADROOM_MB", "HVD_TPU_DEVICE_HEADROOM_MB"):
        monkeypatch.delenv(name, raising=False)
    row = gate[leg]
    tensors = [np.broadcast_to(np.zeros((), jnp.dtype(d)), s)
               for s, d in row["manifest"]]
    jsp._reset_for_tests()
    want = jsp.plan_overlap(tensors, row["width"]).as_dict()
    assert row["plan"] == want, (row["plan"], want)


# -- longctx_audit ------------------------------------------------------------

@pytest.fixture(scope="module")
def ring8():
    """The audit over eight gloo processes: the JAX audit's ring size on
    the eight-device CPU mesh of ``tests/conftest.py``."""
    return _launch(8, "longctx_audit", "--assert-planner", "--seq-local",
                   "16", timeout=420)


def test_longctx_audit_passes(ring8):
    assert ring8["failures"] == [], ring8["failures"]


def test_ring_posts_the_next_exchange_before_the_kernel(ring8):
    overlap = ring8["overlap"]
    n = overlap["ring_size"]
    assert n == 8
    for name in ("plain_fwd", "plain_grad", "zigzag_fwd", "zigzag_grad"):
        passes = overlap[name]
        assert [p["phase"] for p in passes] == (
            ["fwd"] if name.endswith("fwd") else ["fwd", "bwd"]), passes
        for p in passes:
            assert p["kv_exchanges"] == n - 1, (name, p)
            assert p["prefetched_steps"] == n - 1, (name, p)
            # dk/dv take n rotations home, exempt from the audit.
            assert p["exempt_rotations"] == (n if p["phase"] == "bwd"
                                             else 0), (name, p)


def test_step_skip_counters_match_the_jax_audit(ring8):
    from examples.longctx_audit import audit_step_skip

    want = audit_step_skip()
    got = ring8["step_skip"]
    assert got["ring_size"] == want["ring_size"], (got, want)
    assert got["steps_per_rank"] == want["steps_per_rank"], (got, want)
    assert got["exact"] and want["exact"]


def test_context_plans_match_the_jax_audit(ring8):
    """The decisions (layout, remat, widths, the activation estimate) are
    the JAX planner's; the tiles are the port's kernels' own."""
    from examples.longctx_audit import audit_planner

    want = audit_planner()
    for key in ("s8192", "s32768"):
        got = ring8["planner"][key]
        for field in ("width", "seq_local", "layout", "remat", "causal",
                      "headroom_mb", "est_activation_mb"):
            assert got[field] == want[key][field], (key, field, got, want)
    assert want["checks"]["zigzag_default_for_causal"]
    assert ring8["planner"]["checks"]["zigzag_default_for_causal"]
    assert ring8["planner"]["checks"]["smem_fits_all"]
