"""The port's eager engine path against the JAX package's, on the same
seeded numpy inputs.

* One process: the scenarios of ``tests/test_async_ops.py`` (the handle
  API, barriers, alltoall's checks, the wire dtype matrix) on both
  packages, bit for bit; ``_staged_f32_sum`` against the JAX package's for
  fp16 and bf16, bit for bit.
* Two processes, each package's own way: the JAX package's
  ``jax.distributed`` CPU cluster with its ``multihost`` executor (booted
  as ``tests/test_multiprocess.py`` boots it), and the port's two gloo
  processes; each runs the same per-rank inputs through its device route
  and its gather route (``HVD_TPU_EAGER_REDUCE=gather``): f32 / fp16 /
  bf16 / int32 / int64 / f64 sums, averages, ragged allgather, ragged
  alltoall, broadcast, the int8 wire (fused tensors of different scales)
  and its NaN propagation, and ``broadcast_object`` / ``allgather_object``.
  Equal bit for bit, the int8 wire included (which is also held within
  the JAX tests' bound, the sum of the ranks' scales, of the exact sum).
  The port's run also checks a coordinated error (mismatched shapes), a
  collective that fails on every rank (its handle fails everywhere, the
  engine stays usable), the response cache on the live data plane and the
  executor's record of its batches.
* Four gloo processes: the binding's ``DistributedOptimizer`` on both
  routes — every rank's parameters bitwise equal, and equal to one process
  stepping on the averaged gradient; on the int8 wire (error feedback),
  bitwise equal across the ranks, the loss falling.
* Peer death: a rank that dies while its peer is inside the executor's
  collective fails the survivor's handle within the test's limit.

The port's workers import no JAX (the JAX side is imported inside the
tests that use it)."""

import io
import json
import multiprocessing
import os
import queue
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch

from _timing import scaled

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROUTES = ("device", "gather")

# The per-rank inputs, executed by the JAX workers (a script of their own)
# and by this module alike.
INPUTS = textwrap.dedent("""
    import numpy as np

    def inputs(rank):
        rng = np.random.default_rng(10 + rank)
        nan = np.ones(4, np.float32)
        nan[1] = np.nan if rank == 0 else 1.0
        return {
            "f32": rng.standard_normal(37).astype(np.float32),
            "f16": (rng.standard_normal(37) * 100).astype(np.float16),
            "bf16": (rng.standard_normal(37) * 100).astype(np.float32),
            "i32": rng.integers(-1000, 1000, 9).astype(np.int32),
            "i64": np.full(3, 2 ** 40 + 7 + rank, np.int64),
            "f64": rng.standard_normal(5),
            "ragged": (np.arange((rank + 1) * 3, dtype=np.float32)
                       .reshape(rank + 1, 3) + 100 * rank),
            "a2a": np.concatenate([np.full((j + 1, 2), rank * 100 + j,
                                           np.float32) for j in range(2)]),
            "bcast": rng.standard_normal(5).astype(np.float32),
            "q8": [rng.standard_normal(11).astype(np.float32) * (rank + 1),
                   np.full(4, 1e-6, np.float32),
                   rng.standard_normal((2, 5)).astype(np.float32) * 3],
            "nan": nan,
            "obj": {"rank": rank, "items": list(range(rank + 2))},
        }
""")
_ns: dict = {}
exec(INPUTS, _ns)
inputs = _ns["inputs"]

DENSE = ("f32", "f16", "bf16", "i32", "i64", "f64")


def _free_port() -> int:
    # Below the ephemeral range, where no outgoing connection of a busy
    # host can take it between the pick and the coordinator's bind.
    from horovod_tpu_torch.serving.soak import free_port

    return free_port()


def _save(obj) -> bytes:
    buf = io.BytesIO()   # plain bytes: no tensor outlives the process
    torch.save(obj, buf)
    return buf.getvalue()


# -- one process --------------------------------------------------------------

@pytest.fixture()
def both(hvd, monkeypatch):
    import horovod_tpu_torch as thvd

    for name in ("RANK", "WORLD_SIZE", "JAX_PROCESS_ID", "JAX_NUM_PROCESSES",
                 "JAX_COORDINATOR_ADDRESS", "MASTER_ADDR", "MASTER_PORT",
                 "HVD_TPU_EXECUTOR", "HVD_TPU_EAGER_REDUCE"):
        monkeypatch.delenv(name, raising=False)
    thvd.init(device="cpu")
    yield hvd, thvd
    thvd.shutdown()


def _np(t) -> np.ndarray:
    if torch.is_tensor(t):
        return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()
    return np.asarray(t, np.float32) if str(np.asarray(t).dtype) == \
        "bfloat16" else np.asarray(t)


def _same(a, b) -> None:
    a, b = _np(a), _np(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (a, b)
    np.testing.assert_array_equal(a, b)


def test_allreduce_async_roundtrip(both):
    x = np.arange(8, dtype=np.float32)
    outs = [h.synchronize(h.allreduce_async(x, average=True, name="a0"))
            for h in both]
    _same(*outs)
    np.testing.assert_allclose(_np(outs[1]), x)   # size 1: the identity


def test_allreduce_async_fp16_compression(both):
    x = np.linspace(-2, 2, 16, dtype=np.float32)
    outs = [h.synchronize(h.allreduce_async(
        x, average=False, name="a1", compression=h.Compression.fp16))
        for h in both]
    _same(*outs)
    assert outs[1].dtype == torch.float32
    np.testing.assert_allclose(_np(outs[1]), x, atol=1e-2)


def test_allgather_broadcast_async(both):
    x = np.ones((3, 2), np.int32)
    for op in ("allgather", "broadcast"):
        outs = [h.synchronize(
            h.allgather_async(x, name="g0") if op == "allgather"
            else h.broadcast_async(x, root_rank=0, name="b0")) for h in both]
        _same(*outs)
        np.testing.assert_array_equal(_np(outs[1]), x)


def test_poll_eventually_true(both):
    for h in both:
        handle = h.allreduce_async(np.ones(4, np.float32), name="p0")
        deadline = time.monotonic() + 10
        while not h.poll(handle) and time.monotonic() < deadline:
            time.sleep(0.005)
        assert h.poll(handle)
        h.synchronize(handle)


def test_auto_names_unique(both):
    for h in both:
        # Auto names on purpose: they must not collide.
        hs = [h.allreduce_async(  # hvd-lint: disable=HVD102
            np.ones(4, np.float32)) for _ in range(5)]
        for handle in hs:
            h.synchronize(handle)


def test_barriers_reuse_names_and_leak_no_store(both):
    from horovod_tpu.core import engine as jengine
    from horovod_tpu_torch.core import engine as tengine

    for h, em in zip(both, (jengine, tengine)):
        h.barrier()  # hvd-lint: disable=HVD102
        h.barrier(name="sync")
        h.barrier(name="sync")
        for _ in range(5):
            h.barrier()  # hvd-lint: disable=HVD102
        assert not em.get_engine()._store


def test_allreduce_average_int_raises(both):
    for h in both:
        with pytest.raises(ValueError, match="integer"):
            h.allreduce_async(np.ones(4, np.int32), average=True, name="i0")


def _async_ops():
    """Both packages' ``ops/async_ops.py`` (the port's top-level
    ``alltoall`` is ``collective_ops.alltoall``, over torch.distributed)."""
    from horovod_tpu.ops import async_ops as jops
    from horovod_tpu_torch.ops import async_ops as tops

    return jops, tops


def test_alltoall_identity_and_ragged(both):
    x = np.arange(12, dtype=np.float32).reshape(4, 3)
    outs = [ops.alltoall(x) for ops in _async_ops()]
    _same(*outs)
    np.testing.assert_array_equal(_np(outs[1]), x)
    y = np.arange(10, dtype=np.int64)
    outs = [ops.alltoall(y, splits=[10]) for ops in _async_ops()]
    _same(*outs)


def test_alltoall_bad_splits_rejected(both, monkeypatch):
    from horovod_tpu.core import engine as jengine
    from horovod_tpu_torch.core import engine as tengine

    for ops in _async_ops():
        with pytest.raises(ValueError, match="splits"):
            ops.alltoall(np.ones(4, np.float32), splits=[3])
    # Validation runs before any enqueue: size 2 on the live engine is
    # never negotiated.
    for h, em in zip(both, (jengine, tengine)):
        monkeypatch.setattr(em.get_engine(), "size", 2)
        with pytest.raises(ValueError, match="divisible"):
            h.alltoall_async(np.ones(3, np.float32), name="a2a.odd")
        with pytest.raises(ValueError, match="splits"):
            h.alltoall_async(np.ones(4, np.float32), splits=[4],
                             name="a2a.short")


@pytest.mark.parametrize("dtype", ["uint8", "int8", "int32", "int64",
                                   "float16", "float32", "float64", "bool"])
def test_allreduce_wire_dtype_matrix(both, dtype):
    x = np.array([True, False, True, True]) if dtype == "bool" \
        else np.arange(4).astype(dtype)
    outs = [h.synchronize(h.allreduce_async(x, average=False,
                                            name=f"dt.{dtype}"))
            for h in both]
    _same(*outs)
    np.testing.assert_array_equal(_np(outs[1]), x)


def test_port_handle_api_takes_bf16_and_reads_the_engine_reports(both):
    _, thvd = both
    x = torch.linspace(-3, 3, 7, dtype=torch.bfloat16)
    out = thvd.synchronize(thvd.allreduce_async(x, average=False, name="bf"))
    assert out.dtype == torch.bfloat16 and torch.equal(out, x)
    assert thvd.mpi_threads_supported()
    assert thvd.stall_report() == [] and thvd.failure_report() is None
    assert thvd.control_plane_stats()["role"] == "loopback"


@pytest.mark.parametrize("dtype", ["float16", "bfloat16"])
@pytest.mark.parametrize("ranks", [2, 3, 4, 7])
def test_staged_f32_sum_matches_jax_bit_for_bit(dtype, ranks):
    import ml_dtypes

    from horovod_tpu.core.executors import _staged_f32_sum as jsum
    from horovod_tpu_torch.core.executors import _staged_f32_sum as tsum

    rng = np.random.default_rng(ranks)
    f32 = (rng.standard_normal((ranks, 257)) * 300).astype(np.float32)
    f32[:, 0] = [2048.0] + [1.0] * (ranks - 1)   # fp16 accumulation sticks
    if dtype == "float16":
        rows = f32.astype(np.float16)
        trows = torch.from_numpy(rows)
    else:
        rows = f32.astype(ml_dtypes.bfloat16)
        trows = torch.from_numpy(f32).to(torch.bfloat16)
        assert np.array_equal(trows.view(torch.int16).numpy(),
                              rows.view(np.int16))
    want = jsum(rows)
    got = tsum(trows)
    assert got.dtype == trows.dtype
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  want.view(np.int16))


# -- two processes: the JAX package -------------------------------------------

JAX_WORKER = INPUTS + textwrap.dedent("""
    import json, os, sys
    rank = int(sys.argv[1]); jport = int(sys.argv[2]); cport = int(sys.argv[3])
    out_dir = sys.argv[4]
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=1"
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["HVD_TPU_COORDINATOR_HOST"] = "127.0.0.1"
    os.environ["HVD_TPU_COORDINATOR_PORT"] = str(cport)
    os.environ["HVD_TPU_EXECUTOR"] = "multihost"
    import jax
    jax.config.update("jax_platforms", "cpu")
    import ml_dtypes
    import horovod_tpu as hvd
    from horovod_tpu.core.objects import allgather_object, broadcast_object

    hvd.init(coordinator_address=f"127.0.0.1:{jport}", num_processes=2,
             process_id=rank)
    d = inputs(rank)
    out, objs = {}, {}
    for route in ("device", "gather"):
        os.environ["HVD_TPU_EAGER_REDUCE"] = route
        sync = hvd.synchronize
        for key in ("f32", "f16", "bf16", "i32", "i64", "f64"):
            x = d[key].astype(ml_dtypes.bfloat16) if key == "bf16" \\
                else d[key]
            r = sync(hvd.allreduce_async(x, average=False,
                                         name=f"{route}.{key}"))
            out[f"{route}.{key}.sum"] = np.asarray(r, np.float32) \\
                if key == "bf16" else r
        out[f"{route}.f32.avg"] = sync(hvd.allreduce_async(
            d["f32"], average=True, name=f"{route}.f32.avg"))
        out[f"{route}.ragged"] = sync(hvd.allgather_async(
            d["ragged"], name=f"{route}.ragged"))
        out[f"{route}.a2a"] = sync(hvd.alltoall_async(
            d["a2a"], splits=[1, 2], name=f"{route}.a2a"))
        out[f"{route}.bcast"] = sync(hvd.broadcast_async(
            d["bcast"], root_rank=1, name=f"{route}.bcast"))
        hs = [hvd.allreduce_async(q, average=False, name=f"{route}.q8.{i}",
                                  compression=hvd.Compression.int8)
              for i, q in enumerate(d["q8"])]
        for i, h in enumerate(hs):
            out[f"{route}.q8.{i}"] = sync(h)
        out[f"{route}.nan"] = sync(hvd.allreduce_async(
            d["nan"], average=False, name=f"{route}.nan",
            compression=hvd.Compression.int8))
        objs[f"{route}.bobj"] = broadcast_object(d["obj"], 1,
                                                 name=f"{route}.bobj")
        objs[f"{route}.gobj"] = allgather_object(d["obj"],
                                                 name=f"{route}.gobj")
    np.savez(os.path.join(out_dir, f"jax{rank}.npz"), **out)
    with open(os.path.join(out_dir, f"jax{rank}.json"), "w") as f:
        json.dump(objs, f)
    print(f"RANK{rank} OK", flush=True)
    hvd.shutdown()
""")


@pytest.fixture(scope="module")
def jax_two(tmp_path_factory):
    out_dir = tmp_path_factory.mktemp("jax_two")
    jport, cport = _free_port(), _free_port()
    env = {**os.environ, "PYTHONPATH": REPO}
    env.pop("JAX_PLATFORMS", None)
    procs = [subprocess.Popen(
        [sys.executable, "-c", JAX_WORKER, str(r), str(jport), str(cport),
         str(out_dir)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=env, cwd=REPO) for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=scaled(240)))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (out, err) in enumerate(outs):
        assert f"RANK{r} OK" in out, f"JAX rank {r}:\n{err[-3000:]}"
    res = []
    for r in range(2):
        arrays = dict(np.load(out_dir / f"jax{r}.npz"))
        arrays.update(json.loads((out_dir / f"jax{r}.json").read_text()))
        res.append(arrays)
    return res


# -- two processes: the port --------------------------------------------------

def _port_env(cport, route=None):
    os.environ["HVD_TPU_COORDINATOR_PORT"] = str(cport)
    os.environ["HVD_TPU_EXECUTOR"] = "multihost"
    os.environ["HVD_TPU_ABORT_GRACE_MS"] = "-1"
    if route is not None:
        os.environ["HVD_TPU_EAGER_REDUCE"] = route


def _two_worker(rank, store, cport, results):
    _port_env(cport)
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.core import device_reduce, executors
    from horovod_tpu_torch.core.objects import (allgather_object,
                                                broadcast_object)

    hvd.init(device="cpu", init_method=f"file://{store}", rank=rank, size=2)
    try:
        d = inputs(rank)
        out = {}
        for route in ROUTES:
            os.environ["HVD_TPU_EAGER_REDUCE"] = route
            executors.reset_stats()
            sync = hvd.synchronize
            for key in DENSE:
                x = torch.from_numpy(d[key])
                if key == "bf16":
                    x = x.to(torch.bfloat16)
                out[f"{route}.{key}.sum"] = sync(hvd.allreduce_async(
                    x, average=False, name=f"{route}.{key}"))
            out[f"{route}.f32.avg"] = sync(hvd.allreduce_async(
                torch.from_numpy(d["f32"]), name=f"{route}.f32.avg"))
            out[f"{route}.ragged"] = sync(hvd.allgather_async(
                torch.from_numpy(d["ragged"]), name=f"{route}.ragged"))
            out[f"{route}.a2a"] = sync(hvd.alltoall_async(
                torch.from_numpy(d["a2a"]), splits=[1, 2],
                name=f"{route}.a2a"))
            out[f"{route}.bcast"] = sync(hvd.broadcast_async(
                torch.from_numpy(d["bcast"]), root_rank=1,
                name=f"{route}.bcast"))
            hs = [hvd.allreduce_async(torch.from_numpy(q), average=False,
                                      name=f"{route}.q8.{i}",
                                      compression=hvd.Compression.int8)
                  for i, q in enumerate(d["q8"])]
            for i, h in enumerate(hs):
                out[f"{route}.q8.{i}"] = sync(h)
            out[f"{route}.nan"] = sync(hvd.allreduce_async(
                torch.from_numpy(d["nan"]), average=False,
                name=f"{route}.nan", compression=hvd.Compression.int8))
            out[f"{route}.bobj"] = broadcast_object(d["obj"], 1,
                                                    name=f"{route}.bobj")
            out[f"{route}.gobj"] = allgather_object(d["obj"],
                                                    name=f"{route}.gobj")
            # Mismatched shapes: a coordinated error on every rank.
            try:
                sync(hvd.allreduce_async(torch.ones(4 + rank),
                                         name=f"{route}.bad.shape"))
                out[f"{route}.mismatch"] = "no error"
            except hvd.CollectiveError as e:
                out[f"{route}.mismatch"] = str(e)
            # A collective that fails on every rank fails every rank's
            # handle, and the engine goes on.
            real = device_reduce.process_allgather

            def failing(*a, **k):
                raise RuntimeError("injected collective failure")
            device_reduce.process_allgather = failing
            try:
                sync(hvd.allreduce_async(torch.ones(4),
                                         name=f"{route}.fail"))
                out[f"{route}.failed"] = "no error"
            except RuntimeError as e:
                out[f"{route}.failed"] = str(e)
            finally:
                device_reduce.process_allgather = real
            out[f"{route}.after"] = sync(hvd.allreduce_async(
                torch.ones(4), average=False, name=f"{route}.after"))
            before = hvd.cache_stats()["hits"]
            for step in range(3):
                out[f"{route}.cached.{step}"] = sync(hvd.allreduce_async(
                    torch.full((4,), float(rank + 1 + step)), average=False,
                    name=f"{route}.cached"))
            out[f"{route}.cache_hits"] = hvd.cache_stats()["hits"] - before
            out[f"{route}.stats"] = executors.stats()
        results.put((rank, _save(out)))
    finally:
        hvd.shutdown()


def _spawn(worker, n, tmp_path, *extra, timeout=None):
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    cport = _free_port()
    procs = [ctx.Process(target=worker,
                         args=(r, str(tmp_path / "store"), cport, *extra,
                               results))
             for r in range(n)]
    for p in procs:
        p.start()
    outs = {}
    try:
        for _ in procs:
            rank, out = results.get(timeout=timeout or scaled(120))
            outs[rank] = torch.load(io.BytesIO(out), weights_only=False)
    except queue.Empty:
        pytest.fail(f"a gloo worker did not report in time: ranks "
                    f"{sorted(outs)} reported, exit codes "
                    f"{[p.exitcode for p in procs]}")
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
    return outs, [p.exitcode for p in procs]


@pytest.fixture(scope="module")
def port_two(tmp_path_factory):
    outs, codes = _spawn(_two_worker, 2, tmp_path_factory.mktemp("two"))
    assert codes == [0, 0]
    return outs


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("key", DENSE)
def test_sums_match_jax_bit_for_bit(jax_two, port_two, route, key):
    for r in (0, 1):
        got = port_two[r][f"{route}.{key}.sum"]
        assert got.dtype == {"bf16": torch.bfloat16}.get(
            key, torch.from_numpy(inputs(r)[key]).dtype)
        _same(got, jax_two[r][f"{route}.{key}.sum"])


@pytest.mark.parametrize("route", ROUTES)
def test_fp16_sums_in_f32_and_rounds_once(port_two, route):
    a, b = (inputs(r)["f16"] for r in (0, 1))
    want = (a.astype(np.float32) + b.astype(np.float32)).astype(np.float16)
    _same(port_two[0][f"{route}.f16.sum"], want)


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("key", ["f32.avg", "ragged", "a2a", "bcast"])
def test_collectives_match_jax(jax_two, port_two, route, key):
    for r in (0, 1):
        _same(port_two[r][f"{route}.{key}"], jax_two[r][f"{route}.{key}"])
    # The contracts themselves: rank r gets rank r's block from each rank.
    if key == "a2a":
        for r in (0, 1):
            want = np.concatenate([np.full((r + 1, 2), s * 100 + r,
                                           np.float32) for s in (0, 1)])
            _same(port_two[r][f"{route}.a2a"], want)
    if key == "bcast":
        _same(port_two[0][f"{route}.bcast"], inputs(1)["bcast"])


@pytest.mark.parametrize("route", ROUTES)
def test_int8_wire_matches_jax_within_the_scales(jax_two, port_two, route):
    # The JAX tests' bound against the exact sum: per element, the sum of
    # the ranks' scales.
    for i in range(3):
        qs = [inputs(r)["q8"][i] for r in (0, 1)]
        exact = qs[0].astype(np.float64) + qs[1]
        bound = sum(max(np.abs(q).max() / 127.0, 1.2e-38) for q in qs)
        for r in (0, 1):
            got = _np(port_two[r][f"{route}.q8.{i}"])
            want = jax_two[r][f"{route}.q8.{i}"]
            assert got.dtype == np.float32
            assert np.abs(got - exact).max() <= bound + 1e-6
            assert np.abs(want - exact).max() <= bound + 1e-6
            # And bit for bit the JAX package's, on either route.
            np.testing.assert_array_equal(got, want)
    # The tiny tensor kept its own grid next to the larger ones.
    assert np.all(_np(port_two[0][f"{route}.q8.1"]) > 0)


@pytest.mark.parametrize("route", ROUTES)
def test_int8_wire_propagates_nan(jax_two, port_two, route):
    for r in (0, 1):
        got = _np(port_two[r][f"{route}.nan"])
        want = jax_two[r][f"{route}.nan"]
        assert not np.isfinite(got).all() and not np.isfinite(want).all()
        np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))


@pytest.mark.parametrize("route", ROUTES)
def test_objects_match_jax(jax_two, port_two, route):
    for r in (0, 1):
        assert port_two[r][f"{route}.bobj"] == jax_two[r][f"{route}.bobj"] \
            == inputs(1)["obj"]
        assert port_two[r][f"{route}.gobj"] == jax_two[r][f"{route}.gobj"] \
            == [inputs(0)["obj"], inputs(1)["obj"]]


@pytest.mark.parametrize("route", ROUTES)
def test_errors_fail_every_rank_and_the_engine_goes_on(port_two, route):
    for r in (0, 1):
        out = port_two[r]
        assert "Mismatched shapes" in out[f"{route}.mismatch"]
        assert "injected collective failure" in out[f"{route}.failed"]
        _same(out[f"{route}.after"], torch.full((4,), 2.0))
        for step in range(3):
            _same(out[f"{route}.cached.{step}"],
                  torch.full((4,), float(3 + 2 * step)))
        assert out[f"{route}.cache_hits"] >= 2
        # The executor's record: a batch for each collective that ran (at
        # least one a name; fused allreduces share one), a byte count for
        # each, no stream time on the CPU.
        st = out[f"{route}.stats"]
        assert 15 <= st["batches"] == len(st["bytes"]) <= 30, st
        assert st["bytes"][:2] == [37 * 4, 37 * 2] and st["stream_ms"] == 0


# -- four processes: DistributedOptimizer -------------------------------------

OPT_STEPS = 3


def _opt_data(rank):
    g = torch.Generator().manual_seed(1000 + rank)
    return torch.randn(8, 6, generator=g), torch.randn(8, 3, generator=g)


def _opt_model(seed):
    torch.manual_seed(seed)
    return torch.nn.Sequential(torch.nn.Linear(6, 16), torch.nn.Tanh(),
                               torch.nn.Linear(16, 3))


def _opt_worker(rank, store, cport, results):
    _port_env(cport)
    import horovod_tpu_torch as hvd
    import horovod_tpu_torch.torch as hvdt

    hvd.init(device="cpu", init_method=f"file://{store}", rank=rank, size=4)
    try:
        out = {}
        for route in ROUTES:
            os.environ["HVD_TPU_EAGER_REDUCE"] = route
            for comp in ("none", "int8"):
                model = _opt_model(rank)      # per-rank init: broadcast fixes
                opt = hvdt.DistributedOptimizer(
                    torch.optim.SGD(model.parameters(), lr=0.1,
                                    momentum=0.9),
                    named_parameters=[(f"{route}.{comp}.{n}", p)
                                      for n, p in model.named_parameters()],
                    compression=getattr(hvdt.Compression, comp))
                hvdt.broadcast_parameters(model.state_dict(), root_rank=0)
                x, y = _opt_data(rank)
                losses = []
                for _ in range(OPT_STEPS):
                    opt.zero_grad()
                    loss = torch.nn.functional.mse_loss(model(x), y)
                    loss.backward()
                    opt.step()
                    losses.append(float(loss.detach()))
                out[f"{route}.{comp}"] = (
                    [p.detach().clone() for p in model.parameters()], losses)
        results.put((rank, _save(out)))
    finally:
        hvd.shutdown()


def _one_process_reference():
    """One process stepping on the averaged gradient: each rank's gradient
    on its data, summed in rank order in f32 and divided by 4."""
    model = _opt_model(0)
    opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
    data = [_opt_data(r) for r in range(4)]
    for _ in range(OPT_STEPS):
        grads = []
        for x, y in data:
            model.zero_grad()
            torch.nn.functional.mse_loss(model(x), y).backward()
            grads.append([p.grad.clone() for p in model.parameters()])
        for i, p in enumerate(model.parameters()):
            total = grads[0][i].clone()
            for g in grads[1:]:
                total += g[i]
            p.grad = total / torch.full((), 4.0)
        opt.step()
    return [p.detach() for p in model.parameters()]


def test_distributed_optimizer_four_ranks_bit_equal(tmp_path):
    outs, codes = _spawn(_opt_worker, 4, tmp_path)
    assert codes == [0, 0, 0, 0]
    want = _one_process_reference()
    for route in ROUTES:
        for r in range(4):
            for got, ref in zip(outs[r][f"{route}.none"][0], want):
                assert torch.equal(got, ref), (route, r)
            # The int8 wire with error feedback: every rank steps on the
            # same reduced gradient.
            params, losses = outs[r][f"{route}.int8"]
            for got, ref in zip(params, outs[0][f"{route}.int8"][0]):
                assert torch.equal(got, ref), (route, r)
        mean_loss = [sum(outs[r][f"{route}.int8"][1][i] for r in range(4))
                     for i in range(OPT_STEPS)]
        assert mean_loss[-1] < mean_loss[0]


# -- peer death ---------------------------------------------------------------

def _death_worker(rank, store, cport, results):
    _port_env(cport, "device")
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.core import device_reduce

    hvd.init(device="cpu", init_method=f"file://{store}", rank=rank, size=2)
    hvd.synchronize(hvd.allreduce_async(torch.ones(4), name="warm"))
    if rank == 1:
        # Die inside the executor's collective: after the reduce-scatter,
        # before the allgather its peer is now waiting in.
        def die(*a, **k):
            results.put((1, _save("died")))
            results.close()
            results.join_thread()
            os._exit(1)
        device_reduce.process_allgather = die
    from horovod_tpu_torch.core import engine as engine_mod

    eng = engine_mod.get_engine()
    t0 = time.monotonic()
    try:
        hvd.synchronize(hvd.allreduce_async(torch.ones(1000), name="orphan"))
        verdict = "completed"
    except Exception as e:  # noqa: BLE001
        verdict = f"raised after {time.monotonic() - t0:.2f} s: " \
                  f"{type(e).__name__}: {str(e)[:200]}"
    # The executor left the collective: shutting down joins it at once.
    t0 = time.monotonic()
    hvd.shutdown()
    verdict = (verdict, eng._exec_thread.is_alive(), time.monotonic() - t0)
    results.put((rank, _save(verdict)))
    results.close()
    results.join_thread()
    os._exit(0)


def test_peer_death_inside_the_collective_fails_the_survivor(tmp_path):
    outs, codes = _spawn(_death_worker, 2, tmp_path, timeout=scaled(60))
    assert outs[1] == "died" and codes[1] == 1
    verdict, executor_alive, shutdown_s = outs[0]
    assert verdict.startswith("raised after"), verdict
    assert float(verdict.split()[2]) < scaled(30), verdict
    assert not executor_alive and shutdown_s < 10, outs[0]


# -- on the card --------------------------------------------------------------

@pytest.mark.cuda
def test_executor_orders_its_stream_after_the_writer_on_the_card(
        monkeypatch):
    # The executor reads on a stream of its own.  A tensor written by a
    # kernel queued behind ~50 ms of spinning, and gradients whose
    # backward is queued behind it, come back exact: the executor waited
    # for the writers' events, and the caller's stream for the executor's.
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for name in ("RANK", "WORLD_SIZE", "JAX_PROCESS_ID", "JAX_NUM_PROCESSES",
                 "JAX_COORDINATOR_ADDRESS", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("HVD_TPU_EXECUTOR", "multihost")
    import horovod_tpu_torch as hvd
    import horovod_tpu_torch.torch as hvdt

    hvd.init()
    try:
        x = torch.zeros(1 << 22, device="cuda")
        torch.cuda._sleep(100_000_000)
        x.add_(1.0)
        out = hvd.synchronize(hvd.allreduce_async(x, average=False,
                                                  name="late"))
        assert out.is_cuda and torch.equal(out, torch.ones_like(x))

        torch.manual_seed(0)
        model = torch.nn.Sequential(torch.nn.Linear(512, 2048),
                                    torch.nn.GELU(),
                                    torch.nn.Linear(2048, 512)).cuda()
        seen = {}
        for n, p in model.named_parameters():
            p.register_post_accumulate_grad_hook(
                lambda p, n=n: seen.__setitem__(n, p.grad.clone()))
        opt = hvdt.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.1),
            named_parameters=model.named_parameters())
        for _ in range(3):
            opt.zero_grad(set_to_none=True)
            loss = model(torch.randn(256, 512, device="cuda")).square().mean()
            torch.cuda._sleep(100_000_000)
            loss.backward()
            opt.synchronize()
            for n, p in model.named_parameters():
                assert torch.equal(p.grad, seen[n]), n
            opt.step()
    finally:
        hvd.shutdown()
