"""The port's torch binding (``horovod_tpu_torch.torch``) against the JAX
package's (``horovod_tpu.torch``) on the scenarios of
``tests/test_torch_binding.py``: each scenario runs once on each binding,
in one process (a job of one), on the same seeded inputs, and the results
must be equal bit for bit (the JAX tests' own tolerances against the
inputs are checked too): collectives round-trip, in-place forms, async and
fused, autograd of allreduce / allgather / broadcast, sparse gradients and
their compressions, ``DistributedOptimizer`` training (with
``backward_passes_per_step``, sparse embeddings, ``sparse_as_dense``),
``broadcast_parameters``, ``broadcast_optimizer_state`` and the object
helpers; and the response cache's counters over identical steps."""

import time

import pytest
import torch

import horovod_tpu.torch as jhvd
import horovod_tpu_torch
import horovod_tpu_torch.torch as thvd


@pytest.fixture()
def both(hvd, monkeypatch):
    for name in ("RANK", "WORLD_SIZE", "JAX_PROCESS_ID", "JAX_NUM_PROCESSES",
                 "JAX_COORDINATOR_ADDRESS", "MASTER_ADDR", "MASTER_PORT",
                 "HVD_TPU_EXECUTOR", "HVD_TPU_EAGER_REDUCE"):
        monkeypatch.delenv(name, raising=False)
    horovod_tpu_torch.init(device="cpu")
    yield (jhvd, thvd)
    horovod_tpu_torch.shutdown()


def _equal(a, b):
    """Bitwise equality of results: tensors (dense or sparse), lists,
    tuples and dicts of them, and plain values."""
    if torch.is_tensor(a):
        assert torch.is_tensor(b) and a.dtype == b.dtype, (a, b)
        if a.is_sparse:
            assert b.is_sparse
            a, b = a.coalesce().to_dense(), b.coalesce().to_dense()
        assert a.shape == b.shape and torch.equal(a, b), (a, b)
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _equal(a[k], b[k])
    else:
        assert a == b, (a, b)


def _run(both, scenario):
    """``scenario(binding)`` on each binding; the two results, checked
    equal."""
    jax_out, port_out = (scenario(b) for b in both)
    _equal(jax_out, port_out)
    return port_out


def test_allreduce_roundtrip(both):
    x = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    torch.testing.assert_close(_run(both, lambda b: b.allreduce(x)), x)


def test_allreduce_inplace(both):
    def scenario(b):
        x = torch.ones(5)
        out = b.allreduce_(x, average=False)
        assert out is x
        return x
    torch.testing.assert_close(_run(both, scenario), torch.ones(5))


def test_allreduce_bf16(both):
    x = torch.linspace(-2, 2, 8, dtype=torch.bfloat16)
    out = _run(both, lambda b: b.allreduce(x, average=False))
    assert out.dtype == torch.bfloat16
    torch.testing.assert_close(out.float(), x.float())


@pytest.mark.parametrize("comp", ["fp16", "bf16", "int8"])
def test_allreduce_compression(both, comp):
    x = torch.linspace(-1, 1, 8)
    out = _run(both, lambda b: b.allreduce(
        x, average=False, compression=getattr(b.Compression, comp)))
    assert out.dtype == torch.float32
    tol = 0 if comp == "int8" else 1e-2     # int8 is exact at size 1
    torch.testing.assert_close(out, x, atol=tol, rtol=tol)


def test_allreduce_grad(both):
    def scenario(b):
        x = torch.ones(4, requires_grad=True)
        b.allreduce(x, average=True).sum().backward()
        return x.grad
    torch.testing.assert_close(_run(both, scenario), torch.ones(4))


def test_async_fused_many(both):
    def scenario(b):
        hs = [b.allreduce_async(torch.full((10,), float(i)), average=False,
                                name=f"torch.ar{i}") for i in range(8)]
        return [b.synchronize(h) for h in hs]
    for i, out in enumerate(_run(both, scenario)):
        torch.testing.assert_close(out, torch.full((10,), float(i)))


def test_poll_and_synchronize(both):
    def scenario(b):
        h = b.allreduce_async(torch.arange(6.), name="poll.me")
        deadline = time.monotonic() + 30
        while not b.poll(h) and time.monotonic() < deadline:
            time.sleep(0.001)
        assert b.poll(h)
        return b.synchronize(h)
    torch.testing.assert_close(_run(both, scenario), torch.arange(6.))


def test_allgather_broadcast(both):
    x = torch.arange(6).reshape(2, 3)

    def scenario(b):
        y = torch.zeros(3)
        b.broadcast_(y, root_rank=0)
        return b.allgather(x), b.broadcast(x, root_rank=0), y
    gathered, bcast, _ = _run(both, scenario)
    torch.testing.assert_close(gathered, x)
    torch.testing.assert_close(bcast, x)


def _trainer(b, seed=0, **kw):
    torch.manual_seed(seed)
    model = torch.nn.Sequential(torch.nn.Linear(4, 16), torch.nn.ReLU(),
                                torch.nn.Linear(16, 2))
    opt = b.DistributedOptimizer(torch.optim.SGD(model.parameters(), lr=0.1),
                                 named_parameters=model.named_parameters(),
                                 **kw)
    return model, opt


def test_distributed_optimizer_trains(both):
    def scenario(b):
        model, opt = _trainer(b)
        x = torch.randn(32, 4)
        y = (x.sum(dim=1) > 0).long()
        losses = []
        for _ in range(10):
            opt.zero_grad()
            loss = torch.nn.functional.cross_entropy(model(x), y)
            loss.backward()
            opt.step()
            losses.append(float(loss.detach()))
        return losses, [p.detach() for p in model.parameters()]
    losses, _ = _run(both, scenario)
    assert losses[-1] < losses[0]


def test_step_without_backward_no_deadlock(both):
    def scenario(b):
        model = torch.nn.Linear(2, 2)
        opt = b.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.1),
            named_parameters=model.named_parameters())
        opt.step()  # reference test_force_allreduce: must not hang
        return True
    _run(both, scenario)


def test_backward_passes_per_step(both):
    def scenario(b):
        torch.manual_seed(1)
        model = torch.nn.Linear(2, 1)
        opt = b.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.1),
            named_parameters=model.named_parameters(),
            backward_passes_per_step=2)
        x = torch.randn(4, 2)
        for _ in range(2):  # two accumulation passes, then step
            model(x).sum().backward()
        opt.step()
        opt.zero_grad()
        return [p.detach() for p in model.parameters()]
    _run(both, scenario)


def test_double_allreduce_guard(both):
    def scenario(b):
        model = torch.nn.Linear(2, 1)
        opt = b.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.1),
            named_parameters=model.named_parameters())
        model(torch.ones(1, 2)).sum().backward()
        with pytest.raises(AssertionError, match="allreduced twice"):
            model(torch.ones(1, 2)).sum().backward()
        opt.step()
        return True
    _run(both, scenario)


def test_duplicate_named_parameters_rejected(both):
    for b in both:
        model = torch.nn.Linear(2, 2)
        params = list(model.named_parameters())
        with pytest.raises(ValueError, match="duplicate"):
            b.DistributedOptimizer(
                torch.optim.SGD(model.parameters(), lr=0.1),
                named_parameters=params + params)


def test_broadcast_parameters_state_dict(both):
    def scenario(b):
        torch.manual_seed(2)
        model = torch.nn.Linear(3, 3)
        before = {k: v.clone() for k, v in model.state_dict().items()}
        b.broadcast_parameters(model.state_dict(), root_rank=0)
        return before, dict(model.state_dict())
    before, after = _run(both, scenario)
    _equal(before, after)


def test_broadcast_optimizer_state(both):
    def scenario(b):
        torch.manual_seed(3)
        model = torch.nn.Linear(3, 3)
        opt = torch.optim.SGD(model.parameters(), lr=0.25, momentum=0.9)
        model(torch.randn(2, 3)).sum().backward()
        opt.step()
        b.broadcast_optimizer_state(opt, root_rank=0)
        assert opt.param_groups[0]["lr"] == pytest.approx(0.25)
        assert opt.param_groups[0]["momentum"] == pytest.approx(0.9)
        return {k: v["momentum_buffer"]
                for k, v in opt.state_dict()["state"].items()}
    assert _run(both, scenario)


def test_broadcast_optimizer_state_of_a_fresh_adamw(both):
    # Empty state: the reference forces it into being with a zero step.
    # AdamW's 0-d ``step`` comes back from the JAX binding as shape [1]
    # (its engine stages through np.ascontiguousarray, which makes a 0-d
    # array 1-d); the port keeps the 0-d shape, so ``step`` is compared by
    # value.
    def scenario(b):
        torch.manual_seed(4)
        model = torch.nn.Linear(3, 2)
        opt = b.DistributedOptimizer(
            torch.optim.AdamW(model.parameters(), lr=1e-3),
            named_parameters=model.named_parameters())
        b.broadcast_optimizer_state(opt, root_rank=0)
        state = {k: dict(v) for k, v in opt.state_dict()["state"].items()}
        steps = {k: v.pop("step").reshape(()) for k, v in state.items()}
        return [p.detach() for p in model.parameters()], state, steps
    _, _, steps = _run(both, scenario)
    assert all(s.item() == 1 for s in steps.values())


def test_broadcast_and_allgather_object(both):
    obj = {"epoch": 3, "best": 0.91}
    assert _run(both, lambda b: b.broadcast_object(obj, root_rank=0)) == obj
    assert _run(both, lambda b: b.allgather_object({"rank": 0})) == [
        {"rank": 0}]


def test_allgather_grad(both):
    def scenario(b):
        x = torch.arange(6, dtype=torch.float32).reshape(3, 2)
        x.requires_grad_()
        (b.allgather(x) * torch.arange(6.).reshape(3, 2)).sum().backward()
        return x.grad
    torch.testing.assert_close(_run(both, scenario),
                               torch.arange(6.).reshape(3, 2))


def test_broadcast_grad_root(both):
    def scenario(b):
        x = torch.ones(4, requires_grad=True)
        (b.broadcast(x, root_rank=0) * 3.0).sum().backward()
        return x.grad
    torch.testing.assert_close(_run(both, scenario), torch.full((4,), 3.0))


def test_allreduce_sparse_roundtrip(both):
    dense = torch.zeros(6, 3)
    dense[1] = 2.0
    dense[4] = -1.0
    out = _run(both, lambda b: b.allreduce(dense.to_sparse_coo(),
                                           average=True))
    assert out.is_sparse
    torch.testing.assert_close(out.to_dense(), dense)


@pytest.mark.parametrize("comp,vdtype", [
    ("fp16", torch.float32), ("bf16", torch.float32),
    ("int8", torch.float32), ("int8", torch.float16),
    ("int8", torch.bfloat16), ("none", torch.float64),
])
def test_allreduce_sparse_compression_matrix(both, comp, vdtype):
    dense = torch.zeros(8, 4, dtype=vdtype)
    dense[2] = torch.arange(4, dtype=vdtype) * 0.25
    dense[5] = -1.5
    out = _run(both, lambda b: b.allreduce(
        dense.to_sparse_coo(), average=True,
        compression=getattr(b.Compression, comp)))
    tol = 1e-2 if comp in ("fp16", "bf16", "int8") else 1e-6
    torch.testing.assert_close(out.to_dense().float(), dense.float(),
                               atol=tol, rtol=tol)


def test_sparse_int8_nan_propagates(both):
    dense = torch.zeros(4, 2)
    dense[1] = float("nan")
    outs = [b.allreduce(dense.to_sparse_coo(), average=False,
                        compression=b.Compression.int8).to_dense()
            for b in both]
    for out in outs:
        assert not torch.isfinite(out[1]).all()
        assert torch.equal(out[0], torch.zeros(2))


def test_distributed_optimizer_sparse_embedding(both):
    def scenario(b):
        torch.manual_seed(0)
        emb = torch.nn.Embedding(10, 4, sparse=True)
        opt = b.DistributedOptimizer(
            torch.optim.SGD(emb.parameters(), lr=0.5),
            named_parameters=emb.named_parameters())
        ids = torch.tensor([1, 3, 3, 7])
        before = emb.weight.detach().clone()
        loss = emb(ids).pow(2).sum()
        loss.backward()
        assert emb.weight.grad.is_sparse
        opt.step()
        moved = (emb.weight.detach() - before).abs().sum(dim=1) > 0
        opt.zero_grad()
        return moved, float(loss.detach()), float(
            emb(ids).pow(2).sum().detach())
    moved, loss, loss2 = _run(both, scenario)
    assert moved[1] and moved[3] and moved[7]
    assert not moved[0] and not moved[9]
    assert loss2 < loss


@pytest.mark.parametrize("compression", ["none", "int8"])
def test_distributed_optimizer_sparse_as_dense(both, compression):
    def scenario(b):
        torch.manual_seed(0)
        emb = torch.nn.Embedding(8, 4, sparse=True)
        opt = b.DistributedOptimizer(
            torch.optim.SGD(emb.parameters(), lr=0.1),
            named_parameters=emb.named_parameters(), sparse_as_dense=True,
            compression=getattr(b.Compression, compression))
        for step in range(2):
            opt.zero_grad()
            emb(torch.tensor([2, 5 + step])).sum().backward()
            opt.step()  # grad was densified before the allreduce
            assert not emb.weight.grad.is_sparse
        return emb.weight.detach(), emb.weight.grad
    _run(both, scenario)


def test_alltoall_identity(both):
    x = torch.arange(12.).reshape(4, 3)
    out = _run(both, lambda b: (b.alltoall(x),
                                b.alltoall(x, splits=torch.tensor([4]))))
    torch.testing.assert_close(out[0], x)
    torch.testing.assert_close(out[1], x)


def test_cache_stats_after_identical_steps(both):
    # N identical optimizer steps: the first negotiates every gradient,
    # the rest are served from the response cache; both engines count the
    # same hits and misses.  (The JAX engine lives across this worker's
    # tests, so the counters are read as differences, and the parameter
    # names are this test's own.)
    from horovod_tpu.core import engine as jengine
    from horovod_tpu_torch.core import engine as tengine

    deltas = []
    for b, eng in zip(both, (jengine, tengine)):
        torch.manual_seed(5)
        model = torch.nn.Sequential(torch.nn.Linear(4, 8),
                                    torch.nn.Linear(8, 2))
        opt = b.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.1),
            named_parameters=[(f"cache_stats.{n}", p)
                              for n, p in model.named_parameters()])
        before = eng.cache_stats()
        x = torch.randn(3, 4)
        for _ in range(4):
            opt.zero_grad()
            model(x).sum().backward()
            opt.step()
        after = eng.cache_stats()
        deltas.append({k: after[k] - before[k]
                       for k in ("hits", "misses")})
    assert deltas[0] == deltas[1]
    assert deltas[1] == {"hits": 12, "misses": 4}
    assert horovod_tpu_torch.cache_stats()["capacity"] > 0
