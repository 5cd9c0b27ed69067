"""The rest of the port's collective surface against the JAX package's, on
the same numpy inputs: ``allreduce(prescale_factor=)``, ``alltoall``,
``allgather_object``, ``allreduce_sparse`` / ``sparse_to_dense``, sparse
gradients and ``average=`` in ``DistributedOptimizer``, the int8 wire with
error feedback (bit for bit the JAX package's eager route), ``init(ranks=)``
on three gloo processes, and ``callbacks``.

The JAX side's multi-worker results come from its in-mesh collectives over
a mesh of two of the suite's virtual CPU devices (one per torch process),
and, for the int8 wire, from its eager route itself, its process gather
handed both ranks' payloads."""

import io
import multiprocessing
import queue

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import optax
import pytest
import torch
from jax.experimental import multihost_utils
from jax.sharding import Mesh, PartitionSpec as P

import horovod_tpu_torch as thvd
from horovod_tpu import basics as jbasics
from horovod_tpu.core import qwire as jqwire
from horovod_tpu.ops import collective_ops as jco
from horovod_tpu_torch import callbacks as tcb


@pytest.fixture()
def world1(monkeypatch):
    for name in ("RANK", "WORLD_SIZE", "JAX_PROCESS_ID", "JAX_NUM_PROCESSES",
                 "JAX_COORDINATOR_ADDRESS", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(name, raising=False)
    thvd.init(device="cpu")
    yield thvd
    thvd.shutdown()


def _mesh2(fn, *stacked):
    """``fn`` on each of two devices, given row r of every ``stacked``
    array; the rows of its output, stacked.  The JAX package's in-mesh
    collectives reduce over the mesh's one axis."""
    mesh = Mesh(np.array(jax.devices()[:2]), ("x",))
    f = jax.shard_map(lambda *a: fn(*[x[0] for x in a])[None], mesh=mesh,
                      in_specs=P("x"), out_specs=P("x"))
    return np.asarray(f(*[jnp.asarray(a) for a in stacked]))


def _jax_eager_int8(monkeypatch, arrs_by_rank, errs_by_rank, rank,
                    average=True):
    """The JAX package's eager int8 route (``_eager_quantized_reduce``, the
    gather transport) as rank ``rank`` of two runs it, its process gather
    handed every rank's payload from the reference codec."""
    payloads = []
    for arrs, errs in zip(arrs_by_rank, errs_by_rank):
        if errs is not None:
            arrs = [a + e.astype(a.dtype) for a, e in zip(arrs, errs)]
        payloads.append(jqwire.pack_int8(arrs)[0])
    monkeypatch.setenv("HVD_TPU_EAGER_REDUCE", "gather")
    monkeypatch.setattr(jbasics, "size", lambda: 2)
    monkeypatch.setattr(multihost_utils, "process_allgather",
                        lambda x, tiled=False: np.stack(payloads))
    reduced, resid = jco._eager_quantized_reduce(
        list(arrs_by_rank[rank]), errs_by_rank[rank], average=average)
    monkeypatch.undo()
    return [np.asarray(r) for r in reduced], [np.asarray(e) for e in resid]


def _np(t):
    """A torch tensor as numpy, bf16 as ml_dtypes' bfloat16."""
    if t.dtype == torch.bfloat16:
        return t.float().numpy().astype(ml_dtypes.bfloat16)
    return t.numpy()


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint16 if a.dtype.itemsize == 2 else np.uint32)


# -- one process --------------------------------------------------------------

def test_quantized_allreduce_is_the_jax_eager_route_bit_for_bit(hvd, world1):
    # tests/test_quantized.py::test_quantized_eager_process_level, bit for
    # bit: one process, f32 and bf16 tensors, a non-finite one, an empty
    # one, and the residuals fed back.
    rng = np.random.default_rng(0)
    arrs = [rng.standard_normal(9).astype(np.float32),
            (rng.standard_normal((3, 4)) * 1e-3).astype(ml_dtypes.bfloat16),
            np.array([1.0, np.inf, 2.0], np.float32),
            np.zeros(0, np.float32)]
    errs = None
    for _ in range(3):
        want_r, want_e = jco.quantized_grouped_allreduce(
            [jnp.asarray(a) for a in arrs],
            None if errs is None else [jnp.asarray(e) for e in errs],
            average=True)
        got_r, got_e = thvd.quantized_grouped_allreduce(
            [torch.from_numpy(a.astype(np.float32)).to(
                torch.bfloat16 if a.dtype == ml_dtypes.bfloat16
                else torch.float32) for a in arrs],
            None if errs is None else [
                torch.from_numpy(np.array(e, np.float32)).to(
                    torch.bfloat16 if e.dtype == ml_dtypes.bfloat16
                    else torch.float32) for e in errs], average=True)
        for g, w in zip(got_r + got_e, list(want_r) + list(want_e)):
            assert _bits(_np(g)).tolist() == _bits(np.asarray(w)).tolist()
        errs = [np.asarray(e) for e in want_e]
    with pytest.raises(ValueError, match="floating"):
        thvd.quantized_grouped_allreduce([torch.ones(3, dtype=torch.int32)])
    with pytest.raises(NotImplementedError, match="quantized"):
        thvd.Compression.int8.compress(torch.ones(3))


def test_single_allreduce_int8_matches_jax(hvd, world1):
    x = np.linspace(-1, 1, 9).astype(np.float32)
    want = jco.allreduce(jnp.asarray(x), compression=hvd.Compression.int8,
                         prescale_factor=0.5)
    got = thvd.allreduce(torch.from_numpy(x),
                         compression=thvd.Compression.int8,
                         prescale_factor=0.5)
    assert _bits(got.numpy()).tolist() == _bits(np.asarray(want)).tolist()


def test_sparse_to_dense_matches_jax():
    rng = np.random.default_rng(1)
    values = rng.standard_normal((6, 3)).astype(np.float32)
    indices = np.array([4, 0, 4, 2, 0, 4], np.int32)
    want = jco.sparse_to_dense(jnp.asarray(values), jnp.asarray(indices), 5)
    got = thvd.sparse_to_dense(torch.from_numpy(values),
                               torch.from_numpy(indices), 5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_world_of_one_surface(hvd, world1):
    assert thvd.allgather_object({"a": 1}) == hvd.allgather_object({"a": 1})
    x = torch.arange(6.0).view(3, 2)
    assert torch.equal(thvd.alltoall(x), x)
    assert torch.equal(thvd.alltoall(x, splits=[3]), x)
    with pytest.raises(ValueError, match="splits"):
        thvd.alltoall(x, splits=[2])
    v, i = thvd.allreduce_sparse(torch.ones(2, 3), torch.tensor([0, 1]))
    assert torch.equal(v, torch.ones(2, 3)) and i.tolist() == [0, 1]


# -- two gloo processes -------------------------------------------------------

def _inputs(rank):
    rng = np.random.default_rng(100 + rank)
    return {
        "x": rng.standard_normal(7).astype(np.float32),
        "a2a": (np.arange(12, dtype=np.float32).reshape(4, 3)
                + 100 * rank),
        "ragged": np.arange((3, 4)[rank] * 2, dtype=np.float32).reshape(
            -1, 2) + 100 * rank,
        "splits": ([1, 2], [3, 1])[rank],
        "sp_values": rng.standard_normal((2, 3)).astype(np.float32),
        "sp_indices": np.array([rank, 3], np.int32),
        "q": [rng.standard_normal(11).astype(np.float32) * (rank + 1),
              rng.standard_normal((2, 5)).astype(ml_dtypes.bfloat16),
              np.array([0.5, -0.25, 1e-3], np.float32)],
        "tokens": np.array([[1, 3, 3], [4, 1, 0]][rank], np.int64),
    }


def _torch(a):
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a))


def _save(obj):
    buf = io.BytesIO()   # plain bytes: no tensor outlives the process
    torch.save(obj, buf)
    return buf.getvalue()


def _two_worker(rank, store, results):
    import horovod_tpu_torch as hvd

    hvd.init(device="cpu", init_method=f"file://{store}", rank=rank, size=2)
    try:
        d = _inputs(rank)
        out = {}
        x = torch.from_numpy(d["x"])
        out["prescale"] = hvd.allreduce(x, prescale_factor=0.5)
        out["prescale_sum"] = hvd.allreduce(x, average=False,
                                            prescale_factor=3.0)
        out["prescale_bf16"] = hvd.allreduce(
            x, prescale_factor=0.5, compression=hvd.Compression.bf16)
        out["a2a"] = hvd.alltoall(torch.from_numpy(d["a2a"]))
        out["ragged"] = hvd.alltoall(torch.from_numpy(d["ragged"]),
                                     splits=d["splits"])
        out["objects"] = hvd.allgather_object({"rank": rank,
                                               "items": list(range(rank + 2))})
        out["sparse"] = hvd.allreduce_sparse(
            torch.from_numpy(d["sp_values"]),
            torch.from_numpy(d["sp_indices"]))
        out["metrics"] = tcb.allreduce_metrics({"loss": rank + 1.0,
                                                "name": "kept"})
        # The int8 wire: two calls, the residuals of the first fed back.
        qs = [_torch(a) for a in d["q"]]
        r1, e1 = hvd.quantized_grouped_allreduce(qs)
        r2, e2 = hvd.quantized_grouped_allreduce(qs, e1, average=False)
        out["int8"] = (r1, e1, r2, e2)

        # DistributedOptimizer: sums with average=False; a sparse embedding
        # gradient by the allgather route and densified; the int8 wire with
        # error feedback, over master weights (bf16 gradients and
        # residuals).
        for mode in ("sum", "sparse", "sparse_as_dense", "dense", "int8"):
            torch.manual_seed(0)
            emb = torch.nn.Embedding(5, 3, sparse=mode.startswith("sparse"))
            opt = torch.optim.SGD(emb.parameters(), lr=0.5)
            if mode == "int8":
                emb = emb.to(torch.bfloat16)
                opt = hvd.master_weights(torch.optim.SGD(emb.parameters(),
                                                         lr=0.5))
            opt = hvd.DistributedOptimizer(
                opt, named_parameters=emb.named_parameters(),
                average=mode != "sum", sparse_as_dense=mode ==
                "sparse_as_dense",
                compression=hvd.Compression.int8 if mode == "int8"
                else hvd.Compression.none)
            record = []
            for step in range(3):
                opt.zero_grad(set_to_none=True)
                toks = torch.from_numpy(d["tokens"]) + step
                emb(toks % 5).float().pow(2).sum().backward()
                raw = emb.weight.grad.clone()
                opt.step()
                g = emb.weight.grad
                record.append((raw.to_dense() if raw.is_sparse else raw,
                               g.is_sparse,
                               g.to_dense() if g.is_sparse else g.clone(),
                               opt.state_dict().get("error_feedback")))
            out[f"opt_{mode}"] = (emb.weight.detach().float().clone(),
                                  record)
        results.put((rank, _save(out)))
    finally:
        hvd.shutdown()


def _run(worker, n, tmp_path, timeout=120):
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=worker,
                         args=(r, str(tmp_path / "store"), results))
             for r in range(n)]
    for p in procs:
        p.start()
    outs = {}
    try:
        for _ in procs:
            rank, out = results.get(timeout=timeout)
            outs[rank] = torch.load(io.BytesIO(out), weights_only=False)
    except queue.Empty:
        pytest.fail(f"a gloo worker did not report within {timeout} s")
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
    assert all(p.exitcode == 0 for p in procs)
    return outs


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    return _run(_two_worker, 2, tmp_path_factory.mktemp("two"))


@pytest.mark.parametrize("key,factor,average", [
    ("prescale", 0.5, True), ("prescale_sum", 3.0, False)])
def test_allreduce_prescale_matches_jax(hvd, two, key, factor, average):
    xs = np.stack([_inputs(r)["x"] for r in (0, 1)])
    want = _mesh2(lambda x: jco.allreduce(x, average=average,
                                          prescale_factor=factor), xs)
    for r in (0, 1):
        np.testing.assert_array_equal(two[r][key].numpy(), want[r])


def test_allreduce_prescale_on_the_bf16_wire_matches_jax(hvd, two):
    xs = np.stack([_inputs(r)["x"] for r in (0, 1)])
    want = _mesh2(lambda x: jco.allreduce(
        x, prescale_factor=0.5, compression=hvd.Compression.bf16), xs)
    for r in (0, 1):
        assert two[r]["prescale_bf16"].dtype == torch.float32
        np.testing.assert_allclose(two[r]["prescale_bf16"].numpy(), want[r],
                                   rtol=2 ** -8)


def test_alltoall_even_matches_jax(hvd, two):
    # The JAX in-mesh alltoall splits a leading axis of the mesh's width:
    # each rank's [4, 3] as [2, 2, 3], two blocks of two rows.
    xs = np.stack([_inputs(r)["a2a"].reshape(2, 2, 3) for r in (0, 1)])
    want = _mesh2(lambda x: jco.alltoall(x), xs)
    for r in (0, 1):
        np.testing.assert_array_equal(two[r]["a2a"].numpy(),
                                      want[r].reshape(4, 3))


def test_alltoall_ragged_follows_the_contract(two):
    # The JAX package's eager contract (ops/async_ops.py:alltoall): rank r
    # receives, in rank order, the block each rank sent to r.
    d = [_inputs(r) for r in (0, 1)]
    for r in (0, 1):
        blocks = []
        for src in (0, 1):
            start = sum(d[src]["splits"][:r])
            blocks.append(d[src]["ragged"][start:start + d[src]["splits"][r]])
        np.testing.assert_array_equal(two[r]["ragged"].numpy(),
                                      np.concatenate(blocks))


def test_allgather_object_and_metric_average(two):
    for r in (0, 1):
        assert two[r]["objects"] == [{"rank": 0, "items": [0, 1]},
                                     {"rank": 1, "items": [0, 1, 2]}]
        assert two[r]["metrics"] == {"loss": 1.5, "name": "kept"}


def test_allreduce_sparse_matches_jax(hvd, two):
    d = [_inputs(r) for r in (0, 1)]
    vals = np.stack([x["sp_values"] for x in d])
    idx = np.stack([x["sp_indices"] for x in d])
    want_v = _mesh2(lambda v: jco.allreduce_sparse(v, v[:, 0])[0], vals)
    want_i = _mesh2(lambda v, i: jco.allreduce_sparse(v, i)[1], vals, idx)
    for r in (0, 1):
        got_v, got_i = two[r]["sparse"]
        np.testing.assert_allclose(got_v.numpy(), want_v[r], rtol=1e-6)
        np.testing.assert_array_equal(got_i.numpy(), want_i[r])


def test_quantized_allreduce_two_processes_bit_exact(monkeypatch, hvd,
                                                     two):
    arrs = [_inputs(r)["q"] for r in (0, 1)]
    for r in (0, 1):
        r1, e1, r2, e2 = two[r]["int8"]
        want_r1, want_e1 = _jax_eager_int8(monkeypatch, arrs, [None, None],
                                           r)
        errs = [[_np(e) for e in two[s]["int8"][1]] for s in (0, 1)]
        want_r2, want_e2 = _jax_eager_int8(monkeypatch, arrs, errs, r,
                                           average=False)
        for got, want in zip(r1 + e1 + r2 + e2,
                             want_r1 + want_e1 + want_r2 + want_e2):
            assert _bits(_np(got)).tolist() == _bits(want).tolist()


def test_distributed_optimizer_sums_without_average(two):
    # average=False: the step applies the sum of both ranks' gradients.
    for r in (0, 1):
        summed = two[r]["opt_sum"][1]
        avg = two[r]["opt_dense"][1]
        for (_, _, g_sum, _), (_, _, g_avg, _) in zip(summed, avg):
            if torch.equal(g_sum, torch.zeros_like(g_sum)):
                continue
        raw = [two[s]["opt_sum"][1][0][0] for s in (0, 1)]
        torch.testing.assert_close(two[r]["opt_sum"][1][0][2],
                                   raw[0] + raw[1], rtol=0, atol=0)
    torch.testing.assert_close(two[0]["opt_sum"][0], two[1]["opt_sum"][0])


@pytest.mark.parametrize("mode", ["sparse", "sparse_as_dense"])
def test_sparse_gradients_match_the_dense_step(two, mode):
    # Embedding(sparse=True): the allgather route leaves the averaged
    # gradient as a sparse tensor, sparse_as_dense a dense one; both step
    # the weights as the dense embedding does.
    for r in (0, 1):
        weights, record = two[r][f"opt_{mode}"]
        dense_w, dense_rec = two[r]["opt_dense"]
        torch.testing.assert_close(weights, dense_w, rtol=1e-6, atol=1e-6)
        for (_, is_sparse, g, _), (_, _, g_dense, _) in zip(record,
                                                            dense_rec):
            assert is_sparse == (mode == "sparse")
            torch.testing.assert_close(g, g_dense, rtol=1e-6, atol=1e-6)


def test_int8_distributed_optimizer_error_feedback_bit_exact(monkeypatch,
                                                             hvd, two):
    # DistributedOptimizer(master_weights(SGD), compression=int8) on two
    # processes: each step's reduced bf16 gradient and carried bf16
    # residual, bit for bit the JAX eager route's on the same raw
    # gradients and residuals (as DistributedEFState carries them).
    recs = [two[r]["opt_int8"][1] for r in (0, 1)]
    errs = [None, None]
    for step in range(3):
        raws = [[_np(recs[r][step][0])] for r in (0, 1)]
        for r in (0, 1):
            want_red, want_err = _jax_eager_int8(monkeypatch, raws, errs, r)
            _, _, got_red, got_err = recs[r][step]
            assert got_err[0].dtype == torch.bfloat16
            assert _bits(_np(got_red)).tolist() == \
                _bits(want_red[0]).tolist()
            assert _bits(_np(got_err[0])).tolist() == \
                _bits(want_err[0]).tolist()
        errs = [[_np(recs[r][step][3][0])] for r in (0, 1)]
    torch.testing.assert_close(two[0]["opt_int8"][0], two[1]["opt_int8"][0],
                               rtol=0, atol=0)


# -- three gloo processes: init(ranks=) ---------------------------------------

def _subset_worker(rank, store, results):
    import horovod_tpu_torch as hvd

    out = {}
    try:
        hvd.init(device="cpu", init_method=f"file://{store}", rank=rank,
                 size=3, ranks=[0, 2])
    except ValueError as e:
        out["error"] = str(e)
        results.put((rank, _save(out)))
        return
    try:
        out["rank"], out["size"] = hvd.rank(), hvd.size()
        out["sum"] = hvd.allreduce(torch.tensor([rank + 1.0]), average=False)
        out["bcast"] = hvd.broadcast(torch.tensor([10.0 * rank]),
                                     root_rank=1)
        out["gather"] = hvd.allgather(torch.tensor([float(rank)]))
        out["objects"] = hvd.allgather_object(rank)
        out["a2a"] = hvd.alltoall(torch.tensor([rank, rank + 0.5]))
        results.put((rank, _save(out)))
    finally:
        hvd.shutdown()


def test_init_ranks_subset_on_three_processes(tmp_path):
    # The JAX package's init(ranks=[0, 2]) contract (basics.py): a member's
    # rank is its place in the list and size the list's length; the
    # collectives span the members; a non-member raises.
    outs = _run(_subset_worker, 3, tmp_path)
    assert "is not in init(ranks=[0, 2])" in outs[1]["error"]
    for launch, rank in ((0, 0), (2, 1)):
        o = outs[launch]
        assert (o["rank"], o["size"]) == (rank, 2)
        assert o["sum"].item() == 4.0                  # 1 + 3
        assert o["bcast"].item() == 20.0               # launch rank 2
        assert o["gather"].tolist() == [0.0, 2.0]
        assert o["objects"] == [0, 2]
    assert outs[0]["a2a"].tolist() == [0.0, 2.0]
    assert outs[2]["a2a"].tolist() == [0.5, 2.5]


def test_init_ranks_validates(world1):
    thvd.shutdown()
    with pytest.raises(ValueError, match="distinct process indices"):
        thvd.init(device="cpu", ranks=[0, 0])
    assert not thvd.is_initialized()


# -- callbacks ----------------------------------------------------------------

class _State:
    def __init__(self, model=None, optimizer=None):
        self.model, self.optimizer = model, optimizer


def test_metric_average_single_process(world1):
    cb = tcb.MetricAverageCallback()
    logs = {"loss": 2.0, "acc": np.float32(0.5), "name": "skip-me",
            "t": torch.tensor(3.0)}
    cb.on_epoch_end(0, None, logs)
    assert logs == {"loss": 2.0, "acc": 0.5, "name": "skip-me", "t": 3.0}


def test_lr_callbacks_publish_the_jax_schedule(hvd, world1, monkeypatch):
    # The same warmup and staircase schedules, driven batch by batch on
    # both packages: the same LR at every point, written into every group.
    # Both jobs of one process (the JAX warmup reads num_chips()).
    monkeypatch.setattr(jbasics, "num_chips", lambda: thvd.size())
    p = torch.nn.Parameter(torch.ones(2))
    opt = torch.optim.SGD([{"params": [p]}, {"params": [], "lr": 9.0}],
                          lr=0.1)
    state = _State(optimizer=opt)
    pairs = [
        (hvd.callbacks.LearningRateWarmupCallback(0.1, warmup_epochs=3,
                                                  steps_per_epoch=4),
         tcb.LearningRateWarmupCallback(0.1, warmup_epochs=3,
                                        steps_per_epoch=4)),
        (hvd.callbacks.LearningRateScheduleCallback(
            1.0, multiplier=lambda e: 0.1 ** (e // 2)),
         tcb.LearningRateScheduleCallback(
             1.0, multiplier=lambda e: 0.1 ** (e // 2))),
        (hvd.callbacks.LearningRateScheduleCallback(
            0.5, multiplier=lambda e: 1 + e, staircase=False,
            steps_per_epoch=2, start_epoch=1, end_epoch=4),
         tcb.LearningRateScheduleCallback(
             0.5, multiplier=lambda e: 1 + e, staircase=False,
             steps_per_epoch=2, start_epoch=1, end_epoch=4))]
    for jcb, cb in pairs:
        for g in opt.param_groups:   # the optimizer starts at initial_lr
            g["lr"] = cb.initial_lr
        for epoch in range(6):
            jcb.on_epoch_begin(epoch, None)
            cb.on_epoch_begin(epoch, state)
            for batch in range(4):
                jcb.on_batch_begin(batch, None)
                cb.on_batch_begin(batch, state)
                assert cb.lr() == pytest.approx(jcb.lr(), rel=1e-12)
                assert [g["lr"] for g in opt.param_groups] == [cb.lr()] * 2
            assert cb.momentum_correction_factor() == pytest.approx(
                jcb.momentum_correction_factor())


def test_schedule_callback_staircase(world1):
    cb = tcb.LearningRateScheduleCallback(
        1.0, multiplier=lambda e: 0.1 ** (e // 2), start_epoch=0)
    cb.on_epoch_begin(0, None)
    assert cb.lr() == pytest.approx(1.0)
    cb.on_epoch_begin(2, None)
    assert cb.lr() == pytest.approx(0.1)
    assert cb.momentum_correction_factor() == pytest.approx(0.1)


def _keras_form_sgd_trajectory(lrs, momentum, grads, w0, corrected):
    """tests/test_callbacks.py's hand-rolled Keras-era SGD (the velocity
    absorbs lr: v = m·v − lr·g), with the reference's momentum correction
    on LR jumps (the jump step uses m·new/old)."""
    w, v, prev_lr = w0, 0.0, lrs[0]
    for lr, g in zip(lrs, grads):
        m_eff = momentum * (lr / prev_lr) if (corrected and lr != prev_lr) \
            else momentum
        v = m_eff * v - lr * g
        w = w + v
        prev_lr = lr
    return w


@pytest.mark.parametrize("corrected", [True, False])
def test_lr_schedule_matches_reference_momentum_semantics(world1, corrected):
    # torch's SGD momentum buffer is LR-free, as optax's trace: the
    # corrected trajectory by construction, the uncorrected one by scaling
    # the buffer by old/new on the jump.
    m = 0.9
    lrs = [1.0, 1.0, 0.1, 0.1]
    grads = [1.0, 0.5, 1.0, 0.25]
    w_ref = _keras_form_sgd_trajectory(lrs, m, grads, 2.0, corrected)
    cb = tcb.LearningRateScheduleCallback(
        1.0, multiplier=lambda e: 0.1 if e >= 2 else 1.0,
        momentum_correction=corrected)
    w = torch.nn.Parameter(torch.tensor(2.0, dtype=torch.float64))
    state = _State(model=None, optimizer=torch.optim.SGD([w], lr=1.0,
                                                         momentum=m))
    for epoch, g in enumerate(grads):
        state = cb.on_epoch_begin(epoch, state)
        w.grad = torch.tensor(g, dtype=torch.float64)
        state.optimizer.step()
    assert w.item() == pytest.approx(w_ref, rel=1e-12)


@pytest.mark.parametrize("corrected", [True, False])
def test_lr_schedule_reaches_master_weights_momentum(world1, corrected):
    # The composition users write: DistributedOptimizer(master_weights(
    # SGD(momentum))), bf16-resident.  The momentum buffers live in the
    # inner optimizer, keyed by the f32 masters; an uncorrected LR jump
    # must scale them there, so the master follows the reference's
    # trajectory either way.
    m = 0.9
    lrs = [1.0, 1.0, 0.1, 0.1]
    grads = [1.0, 0.5, 1.0, 0.25]   # exact in bf16
    w_ref = _keras_form_sgd_trajectory(lrs, m, grads, 2.0, corrected)
    cb = tcb.LearningRateScheduleCallback(
        1.0, multiplier=lambda e: 0.1 if e >= 2 else 1.0,
        momentum_correction=corrected)
    w = torch.nn.Parameter(torch.tensor(2.0, dtype=torch.bfloat16))
    opt = thvd.DistributedOptimizer(thvd.master_weights(
        torch.optim.SGD([w], lr=1.0, momentum=m)))
    state = _State(optimizer=opt)
    for epoch, g in enumerate(grads):
        state = cb.on_epoch_begin(epoch, state)
        w.grad = torch.tensor(g, dtype=torch.bfloat16)
        opt.step()
    (master,) = opt.masters()
    assert master.item() == pytest.approx(w_ref, rel=1e-6)
    assert w.item() == master.to(torch.bfloat16).item()


def test_lr_jump_rescales_momentum_only_when_uncorrected(world1):
    def run(corrected):
        w = torch.nn.Parameter(torch.ones(4))
        opt = torch.optim.SGD([w], lr=0.1, momentum=0.9)
        w.grad = torch.ones(4)
        opt.step()
        cb = tcb.LearningRateScheduleCallback(
            1.0, multiplier=lambda e: 2.0 ** e,
            momentum_correction=corrected)
        st = _State(optimizer=opt)
        st = cb.on_epoch_begin(0, st)   # lr 1.0, no jump
        st = cb.on_epoch_begin(1, st)   # lr 2.0: a jump
        return opt.state[w]["momentum_buffer"]

    torch.testing.assert_close(run(True), torch.ones(4))
    torch.testing.assert_close(run(False), torch.full((4,), 0.5))


def test_broadcast_callback_world_of_one(world1):
    model = torch.nn.Linear(2, 2)
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    before = {n: t.clone() for n, t in model.state_dict().items()}
    state = tcb.run_callbacks([tcb.BroadcastGlobalVariablesCallback(0)],
                              "on_train_begin", _State(model, opt))
    for n, t in state.model.state_dict().items():
        assert torch.equal(t, before[n])
