"""The port's measurement harnesses (``horovod_tpu_torch.examples``:
``collective_microbench``, ``weak_scaling_benchmark``,
``control_plane_benchmark``, ``int8_convergence``,
``resnet_bn_experiment``) on the CPU: their JSON rows at one and two
processes, the tests of ``tests/test_examples.py`` and
``tests/test_int8_convergence.py`` that run their JAX twins, the int8
simulation held bit for bit against the port's own wire over two gloo
ranks, and the BatchNorm legs' first-step losses against flax.

The harnesses' subprocesses run with two intra-op threads a process: the
suite runs six files at once on this host, and the small tensors here
lose more to a contended thread pool than they gain."""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _timing import scaled
from test_torch_tensor_parallel import run_gloo

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "horovod_tpu_torch.examples."


def _env():
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "2"}
    for name in ("RANK", "WORLD_SIZE", "JAX_PROCESS_ID", "JAX_NUM_PROCESSES",
                 "JAX_COORDINATOR_ADDRESS", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(name, None)
    return env


def _run(module, *args, np_=1, timeout=240):
    cmd = [sys.executable, "-m", PKG + module, *args]
    if np_ > 1:
        cmd = [sys.executable, "-m", "horovod_tpu_torch.run", "-np",
               str(np_), "--", *cmd]
    out = subprocess.run(cmd, capture_output=True, text=True,
                         timeout=scaled(timeout), env=_env(), cwd=REPO)
    assert out.returncode == 0, (out.stdout[-3000:], out.stderr[-3000:])
    return out.stdout


def _rows(out: str) -> list[dict]:
    rows = []
    for line in out.splitlines():
        if "{" in line:
            rows.append(json.loads(line[line.index("{"):]))
    return rows


# -- collective_microbench ----------------------------------------------------

def test_collective_microbench_rows_at_world_1():
    rows = _rows(_run("collective_microbench", "--device", "cpu",
                      "--sizes-mb", "0.5,2", "--iters", "3"))
    sizes = [r for r in rows if "size_mb" in r]
    assert [r["size_mb"] for r in sizes] == [0.5, 2.0], rows
    for r in sizes:
        assert r["workers"] == 1 and r["backend"] == "gloo", r
        assert r["all_reduce_ms"] > 0 and r["all_gather_ms"] > 0, r
        # Nothing crosses a wire at world 1.
        assert r["all_reduce_ring_GBps"] == 0.0, r
        assert "card" in r, r
    (floor,) = [r for r in rows if "dispatch_floor_ms" in r]
    assert floor["dispatch_floor_ms"] > 0 and floor["workers"] == 1, floor


def test_collective_microbench_np2_ring_model():
    rows = _rows(_run("collective_microbench", "--device", "cpu",
                      "--sizes-mb", "1", "--iters", "3", np_=2))
    (row,) = [r for r in rows if "size_mb" in r]
    assert row["workers"] == 2, row
    # The ring model's wire bytes a rank: 2(n-1)/n and (n-1)/n of 1 MB.
    assert row["all_reduce_ring_GBps"] == pytest.approx(
        1e6 / (row["all_reduce_ms"] * 1e-3) / 1e9)
    assert row["all_gather_ring_GBps"] == pytest.approx(
        0.5e6 / (row["all_gather_ms"] * 1e-3) / 1e9)
    assert any("dispatch_floor_ms" in r for r in rows), rows


# -- weak_scaling_benchmark, control_plane_benchmark --------------------------

def test_weak_scaling_benchmark_np2():
    out = _run("weak_scaling_benchmark", "--device", "cpu", "--grad-mb", "1",
               "--compute-reps", "1", "--steps", "3", "--warmup", "1",
               np_=2)
    rows = [r for r in _rows(out) if "steps_per_s_per_rank" in r]
    assert {r["rank"] for r in rows} == {0, 1}
    for r in rows:
        assert r["workers"] == 2
        assert r["wire_model_mb_per_rank_per_step"] == 1.0
        assert r["steps_per_s_per_rank"] > 0


def test_control_plane_benchmark_np2():
    rows = _rows(_run("control_plane_benchmark", "--device", "cpu",
                      "--rounds", "4", "--burst", "20", "--warmup", "2",
                      np_=2))
    (row,) = [r for r in rows if "per_op_ms" in r]
    assert row["np"] == 2, row
    assert row["rendezvous_s"] > 0 and row["per_op_ms"] > 0, row
    assert row["names_per_s"] > 0, row


def test_control_plane_benchmark_star():
    rows = _rows(_run("control_plane_benchmark", "--star", "4,8",
                      "--star-ticks", "20"))
    assert [r["p"] for r in rows] == [4, 8], rows
    assert all(r["tick_us"] > 0 and r["ticks"] == 20 for r in rows), rows


# -- int8_convergence ---------------------------------------------------------

def _int8(*args):
    (row,) = _rows(_run("int8_convergence", "--device", "cpu", *args,
                        timeout=1200))
    return row


def _dev(a, f32):
    return sum(abs(x - y) for x, y in zip(a, f32)) / len(f32)


def test_default_wire_is_the_ports_and_tracks_f32():
    """The default ``--wire`` is the port's own (±127 levels a worker
    whatever the width): at width 16 both int8 runs stay within 0.01 of the
    f32 losses; ``--hierarchical`` has no meaning on it and is refused."""
    from horovod_tpu_torch.examples import int8_convergence as m

    threads = torch.get_num_threads()
    torch.set_num_threads(1)   # as the harness's main does on the CPU
    try:
        r = m.run(m.parse_args(["--device", "cpu", "--width", "16",
                                "--layers", "2", "--steps", "20", "--lr",
                                "1e-3"]))
    finally:
        torch.set_num_threads(threads)
    assert r["wire"] == "qwire" and r["per_worker_levels"] == 127, r
    for mode in ("int8_ef", "int8_noef"):
        assert max(abs(a - b) for a, b in zip(r[mode], r["f32"])) < 0.01, r
    with pytest.raises(SystemExit):
        m.parse_args(["--device", "cpu", "--hierarchical"])


# The JAX harness's properties are stated on its in-mesh grid: these runs
# take ``--wire sumfit``, which simulates it.

def test_width16_nonconvex_ef_tracks_f32_trajectory_fast():
    """Width 16 (±7 levels a worker), two stacked tanh layers: the EF wire
    tracks the f32 trajectory, the stateless wire measurably deviates."""
    r = _int8("--wire", "sumfit", "--width", "16", "--layers", "2",
              "--steps", "50", "--lr", "1e-3", "--record-every", "5")
    assert r["per_worker_levels"] == 7
    assert _dev(r["int8_ef"], r["f32"]) * 2 < _dev(r["int8_noef"], r["f32"]), r


@pytest.mark.slow
def test_width64_hierarchical_tracks_f32():
    r = _int8("--wire", "sumfit", "--width", "64", "--hierarchical",
              "--steps", "200")
    assert r["mesh"] == "8x8" and r["per_worker_levels"] == 15
    f32, ef = r["f32"][-1], r["int8_ef"][-1]
    assert ef < r["f32"][0] * 0.5, "int8+EF failed to train at all"
    assert ef <= f32 * 1.15 + 0.02, r


@pytest.mark.slow
def test_width64_flat_ef_tracks_f32_trajectory():
    r = _int8("--wire", "sumfit", "--width", "64", "--steps", "200")
    assert r["per_worker_levels"] == 1
    f32, ef, noef = r["f32"], r["int8_ef"], r["int8_noef"]
    assert _dev(ef, f32) < _dev(noef, f32), r
    assert ef[-1] <= f32[-1] + 0.05, r


def _wire_tensors(rank: int):
    gen = torch.Generator().manual_seed(100 + rank)
    ts = [torch.randn(37, generator=gen) * 3.0,
          torch.randn(5, 4, generator=gen) * 1e-3,
          torch.zeros(6)]
    errs = [torch.randn(t.shape, generator=gen) * 0.01 for t in ts]
    return ts, errs


def _quantized_allreduce(rank, n):
    from horovod_tpu_torch.ops.collective_ops import \
        quantized_grouped_allreduce

    ts, errs = _wire_tensors(rank)
    return quantized_grouped_allreduce(ts, errs, average=True)


def test_qwire_simulation_is_the_wire_bit_for_bit(tmp_path):
    """The harness's ``--wire qwire`` sum over simulated workers is what
    ``quantized_grouped_allreduce`` computes over two gloo ranks: the
    reduced tensors and each worker's residuals, bit for bit."""
    from horovod_tpu_torch.examples.int8_convergence import qwire_reduce

    outs = run_gloo(_quantized_allreduce, 2, tmp_path)
    workers = []
    for r in range(2):
        ts, errs = _wire_tensors(r)
        workers.append([t + e for t, e in zip(ts, errs)])
    reduced, resids = qwire_reduce(workers)
    for r in range(2):
        got_reduced, got_resid = outs[r]
        for a, b in zip(reduced, got_reduced):
            assert torch.equal(a, b), (a, b)
        for a, b in zip(resids[r], got_resid):
            assert torch.equal(a, b), (a, b)


@pytest.mark.parametrize("mesh_shape", [(8,), (2, 4)],
                         ids=["flat8", "tiers2x4"])
def test_sumfit_reduce_is_the_jax_in_mesh_route(mesh_shape):
    """``--wire sumfit`` against ``quantized_grouped_allreduce`` of the JAX
    package under ``shard_map`` on eight virtual devices, flat and as a
    (dcn, ici) = (2, 4) mesh, with error feedback: the same per-worker
    gradients and errors give the same mean and the same residuals, bit
    for bit."""
    from jax.sharding import Mesh, PartitionSpec as P

    from horovod_tpu.ops import quantized_grouped_allreduce
    from horovod_tpu_torch.examples import int8_convergence as m

    n = 8
    rng = np.random.default_rng(5)
    shapes = ((300,), (16, 10), (10,))
    grads = [(rng.standard_normal((n,) + s) * sc).astype(np.float32)
             for s, sc in zip(shapes, (1.0, 1e-2, 3.0))]
    errors = [(rng.standard_normal(g.shape) * 1e-3).astype(np.float32)
              for g in grads]
    axes = ("hvd",) if len(mesh_shape) == 1 else ("dcn", "ici")
    mesh = Mesh(np.array(jax.devices()[:n]).reshape(mesh_shape), axes)
    spec = P(axes if len(axes) > 1 else axes[0])

    def reduce(gs, es):
        red, res = quantized_grouped_allreduce(
            [g[0] for g in gs], [e[0] for e in es], average=True)
        return red, [r[None] for r in res]

    f = jax.jit(jax.shard_map(
        reduce, mesh=mesh, in_specs=([spec] * 3, [spec] * 3),
        out_specs=([P()] * 3, [spec] * 3), check_vma=False))
    want_red, want_res = f([jnp.asarray(g) for g in grads],
                           [jnp.asarray(e) for e in errors])
    outer, inner = m.tiers(n, len(mesh_shape) > 1)
    assert (outer, inner) == ((1, 8) if len(mesh_shape) == 1 else (2, 4))
    for g, e, wr, ws in zip(grads, errors, want_red, want_res):
        mean, resid = m.sumfit_reduce(torch.from_numpy(g + e), outer, inner)
        np.testing.assert_array_equal(mean.numpy(), np.asarray(wr))
        np.testing.assert_array_equal(resid.numpy(), np.asarray(ws))


def test_sumfit_grid_fits_the_int8_sum():
    """The simulated in-mesh grid: ±127 // n levels a worker (per tier when
    hierarchical), so no partial sum leaves int8: each residual is within
    half a level, and the decoded mean within half a level a worker of the
    exact mean (plus the outer tier's requantization when hierarchical)."""
    from horovod_tpu_torch.examples import int8_convergence as m

    g = torch.randn(16, 300, generator=torch.Generator().manual_seed(0))
    for outer, inner in ((1, 16), (4, 4)):
        mean, resid = m.sumfit_reduce(g, outer, inner)
        qcap = 127 // inner
        scale = g.abs().max() / qcap
        assert resid.abs().max() <= scale * (0.5 + 1e-6)
        bound = 0.5 * scale * (1 if outer == 1 else 2 + inner)
        assert (mean - g.mean(0)).abs().max() <= bound
    assert m.tiers(64, True) == (8, 8) and m.tiers(16, False) == (1, 16)


# -- resnet_bn_experiment -----------------------------------------------------

def test_resnet_bn_experiment_runs_both_legs():
    (row,) = _rows(_run("resnet_bn_experiment", "--device", "cpu", "--batch",
                        "2", "--image-size", "32", "--dtype", "float32",
                        "--warmup", "1", "--iters", "1",
                        "--batches-per-iter", "1", "--steps-per-call", "1"))
    assert row["metric"] == "resnet50_bn_stats_ab", row
    for leg in ("stats", "nostats"):
        assert row[leg]["img_s"] > 0 and row[leg]["step_ms"] > 0, row
        assert all(np.isfinite(row[leg]["losses"])), row
        assert row[leg]["device_ms_by_kind"] == "not measured", row
    # Both legs start from the same weights but normalize differently.
    assert row["stats"]["losses"][0] != row["nostats"]["losses"][0], row


@pytest.fixture()
def world1(monkeypatch):
    import horovod_tpu_torch as hvd

    for name in ("RANK", "WORLD_SIZE", "JAX_PROCESS_ID", "JAX_NUM_PROCESSES",
                 "JAX_COORDINATOR_ADDRESS", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(name, raising=False)
    hvd.init(device="cpu")
    yield
    hvd.shutdown()


def test_bn_legs_first_step_losses_match_flax(world1):
    """The ``stats`` and ``nostats`` first-step losses of ResNet-50 (f32,
    32² images, two of them) against flax's ``ResNet50`` with
    ``train=True`` and ``train=False`` on the same variables (carried by
    ``models/convert.py``): rtol 1e-4."""
    from horovod_tpu.models import ResNet50
    from horovod_tpu_torch.examples import resnet_bn_experiment as m
    from horovod_tpu_torch.models import convert

    x = np.random.default_rng(0).standard_normal((2, 32, 32, 3)) \
        .astype(np.float32)
    y = np.array([3, 917])
    flax_model = ResNet50(num_classes=1000, dtype=jnp.float32)
    model, opt = m.make_trainer("cpu", torch.float32, seed=1)
    start = {k: v.clone() for k, v in model.state_dict().items()}
    variables = jax.tree_util.tree_map(
        jnp.asarray, convert.to_flax(start, model))
    for stats in (True, False):
        model.load_state_dict(start)   # each leg's first step, same start
        if stats:
            logits, _ = flax_model.apply(variables, jnp.asarray(x),
                                         train=True,
                                         mutable=["batch_stats"])
        else:
            logits = flax_model.apply(variables, jnp.asarray(x), train=False)
        want = float(optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(y)).mean())
        got = m.bn_step(model, opt, torch.from_numpy(x), torch.from_numpy(y),
                        stats).item()
        np.testing.assert_allclose(got, want, rtol=1e-4, err_msg=str(stats))
