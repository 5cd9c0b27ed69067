"""Port's training path against the JAX package's: ``DistributedOptimizer``
over AdamW on the small decoder, the fusion plan, process identity, and
the eager collectives across two gloo processes."""

import io
import multiprocessing
import os
import queue

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import horovod_tpu_torch as thvd
from horovod_tpu.models import transformer as jtm
from horovod_tpu.ops import fusion as jfusion
from horovod_tpu.ops import losses as jlosses
from horovod_tpu_torch import basics, train_transformer
from horovod_tpu_torch.models import convert
from horovod_tpu_torch.models import transformer as ttm
from horovod_tpu_torch.ops import fusion as tfusion

SMALL = dict(vocab_size=64, num_layers=2, num_heads=2, head_dim=8,
             embed_dim=16, mlp_dim=32, max_seq_len=32)


@pytest.fixture()
def world1(monkeypatch):
    """The port initialised as a job of one CPU process (gloo)."""
    for name in ("RANK", "WORLD_SIZE", "JAX_PROCESS_ID", "JAX_NUM_PROCESSES",
                 "JAX_COORDINATOR_ADDRESS", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(name, raising=False)
    thvd.init(device="cpu")
    yield thvd
    thvd.shutdown()


def test_adamw_steps_match_jax_distributed_optimizer(hvd, world1):
    # The optimizer is the point here: both models run their plain
    # attention and norm (the kernels' gradients are pinned in
    # test_torch_transformer.py), so the JAX side needs no interpret mode.
    toks = np.random.default_rng(0).integers(0, 64, (2, 12)).astype(np.int32)
    jcfg = jtm.TransformerConfig(**SMALL, dtype=jnp.float32)
    jmodel = jtm.Transformer(jcfg)
    params = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(toks))
    tcfg = ttm.TransformerConfig(**SMALL, dtype=torch.float32)
    tmodel = ttm.Transformer(tcfg, device="cpu")
    tmodel.load_state_dict(convert.params_from_flax(
        jax.tree_util.tree_map(np.asarray, params), tcfg))
    topt = thvd.DistributedOptimizer(
        torch.optim.AdamW(tmodel.parameters(), lr=3e-4, weight_decay=1e-4),
        named_parameters=tmodel.named_parameters())

    def jax_loss(p):
        logits = jmodel.apply(p, jnp.asarray(toks))
        return jlosses.softmax_cross_entropy(
            logits[:, :-1], jnp.asarray(toks)[:, 1:]).mean()

    jopt = hvd.DistributedOptimizer(optax.adamw(3e-4))   # eager path
    state = jopt.init(params)
    ttoks = torch.from_numpy(toks).long()
    value_and_grad = jax.jit(jax.value_and_grad(jax_loss))
    for _ in range(3):
        jl, grads = value_and_grad(params)
        updates, state = jopt.update(grads, state, params)
        params = optax.apply_updates(params, updates)
        tl = train_transformer.train_step(tmodel, topt, ttoks)
        np.testing.assert_allclose(tl.item(), float(jl), atol=5e-4,
                                   rtol=5e-4)
    want = convert.params_from_flax(jax.tree_util.tree_map(np.asarray,
                                                           params), tcfg)
    # Each AdamW step moves a weight by at most ~lr (3e-4); the gradients
    # agree to 5e-4 relative, and the two apply the decoupled decay in a
    # different order (p·(1 − lr·wd) − lr·u against p − lr·(u + wd·p)),
    # which differs by f32 rounding only.  So after three steps the
    # weights agree well inside one step's size.
    for name, p in tmodel.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), atol=3e-5,
                                   rtol=1e-5, err_msg=name)


@pytest.mark.parametrize("threshold", [None, 1, 64, 1000, 1 << 20])
def test_plan_buckets_match_jax(threshold):
    shapes = [(3, 5), (7,), (2, 2, 2), (130,), (4,), (1,), (64, 3), (9,)]
    dtypes = ["float32", "float32", "bfloat16", "bfloat16", "float16",
              "float32", "int32", "int32"]
    want = jfusion.plan_buckets(
        [(s, jnp.dtype(d)) for s, d in zip(shapes, dtypes)], threshold)
    got = tfusion.plan_buckets(
        [(s, getattr(torch, d)) for s, d in zip(shapes, dtypes)], threshold)
    assert len(got) == len(want) > 1
    for g, w in zip(got, want):
        assert str(g.dtype).removeprefix("torch.") == jnp.dtype(w.dtype).name
        assert g.padded_elems == w.padded_elems
        assert [(s.index, s.offset, s.size, s.shape) for s in g.slots] == \
            [(s.index, s.offset, s.size, s.shape) for s in w.slots]


def test_fused_apply_round_trips_through_buckets():
    ts = [torch.arange(6.0).view(2, 3), torch.ones(5, dtype=torch.bfloat16),
          torch.arange(4, dtype=torch.int32)]
    calls = []

    def collective(flat):
        calls.append((flat.dtype, flat.numel()))
        return flat * 2

    out = tfusion.fused_apply(ts, collective, threshold_bytes=16)
    assert [o.shape for o in out] == [t.shape for t in ts]
    for o, t in zip(out, ts):
        assert o.dtype == t.dtype and torch.equal(o, t * 2)
    # One bucket per dtype run; the 24-byte tensor exceeds the threshold
    # alone and still gets a bucket of its own.
    assert [d for d, _ in calls] == [t.dtype for t in ts]
    assert all(n == 128 for _, n in calls)


def test_world_of_one(world1):
    assert (thvd.rank(), thvd.size(), thvd.local_rank(), thvd.local_size(),
            thvd.cross_rank(), thvd.cross_size(), thvd.num_chips()) == \
        (0, 1, 0, 1, 0, 1, 1)
    assert basics.device() == torch.device("cpu")
    assert torch.distributed.get_backend() == "gloo"
    thvd.init(device="cpu")   # a second call is a no-op
    x = torch.arange(4.0)
    assert torch.equal(thvd.allreduce(x), x)
    assert torch.equal(thvd.allgather(x), x)
    assert torch.equal(thvd.broadcast(x, 0), x)
    assert thvd.broadcast_object({"a": 1}) == {"a": 1}
    assert thvd.scale_learning_rate(0.1, 2) == 0.2
    fp16 = thvd.allreduce(torch.tensor([1.0 + 2 ** -12]),
                          compression=thvd.Compression.fp16)
    assert fp16.dtype == torch.float32 and fp16.item() == 1.0   # cast wire
    store = basics._store_dir
    assert store and os.path.isdir(store)
    thvd.shutdown()
    assert not thvd.is_initialized() and not os.path.exists(store)
    with pytest.raises(thvd.NotInitializedError):
        thvd.size()


def test_init_reads_the_environment_and_needs_an_address(monkeypatch):
    for name in ("RANK", "JAX_COORDINATOR_ADDRESS", "MASTER_ADDR",
                 "MASTER_PORT"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("JAX_PROCESS_ID", "1")
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="rendezvous address"):
        thvd.init(device="cpu")
    monkeypatch.setenv("JAX_PROCESS_ID", "2")
    with pytest.raises(ValueError, match=r"rank 2 is not in \[0, 2\)"):
        thvd.init(device="cpu")
    assert not thvd.is_initialized()


def test_distributed_optimizer_checks_names():
    model = torch.nn.Linear(2, 2)
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    with pytest.raises(ValueError, match="duplicate"):
        thvd.DistributedOptimizer(opt, named_parameters=[
            ("w", model.weight), ("w", model.bias)])
    with pytest.raises(ValueError, match="not named"):
        thvd.DistributedOptimizer(opt, named_parameters=[("w", model.weight)])
    with pytest.raises(ValueError, match="backward_passes_per_step"):
        thvd.DistributedOptimizer(opt, backward_passes_per_step=0)


# -- two gloo processes ------------------------------------------------------

def _data(rank):
    return torch.from_numpy(np.random.default_rng(10 + rank).standard_normal(
        (5, 4)).astype(np.float32))


def _model(seed):
    torch.manual_seed(seed)
    return torch.nn.Sequential(torch.nn.Linear(4, 3), torch.nn.Tanh(),
                               torch.nn.Linear(3, 2))


def _worker(rank, store, results):
    import horovod_tpu_torch as hvd

    hvd.init(device="cpu", init_method=f"file://{store}", rank=rank, size=2)
    try:
        out = {}
        x = torch.full((3,), rank + 1.0)
        out["sum"] = hvd.allreduce(x, average=False)
        out["avg"] = hvd.allreduce(x)
        mixed = [torch.full((5,), rank + 1.0),
                 torch.full((3, 4), rank + 1.0, dtype=torch.bfloat16),
                 torch.full((2,), rank + 1, dtype=torch.int32),
                 torch.full((7,), rank + 1.0, dtype=torch.float16),
                 torch.full((300,), rank + 1.0)]
        out["grouped"] = hvd.grouped_allreduce(mixed, average=False,
                                               threshold_bytes=64)
        out["gather"] = hvd.allgather(
            torch.arange(2 + rank, dtype=torch.float32).view(-1, 1)
            + 10 * rank)
        out["bcast"] = hvd.broadcast(torch.tensor([7.0 * rank]), root_rank=1)
        out["obj"] = hvd.broadcast_object({"from": rank}, root_rank=1)

        model = _model(seed=rank)   # different weights on each rank
        hvd.broadcast_parameters(model, root_rank=0)
        out["init"] = {n: t.clone() for n, t in model.state_dict().items()}
        opt = hvd.DistributedOptimizer(
            torch.optim.AdamW(model.parameters(), lr=0.1),
            named_parameters=model.named_parameters(), threshold_bytes=32)
        model(_data(rank)).pow(2).sum().backward()
        opt.step()
        out["params"] = {n: t.clone() for n, t in model.state_dict().items()}
        if rank == 1:   # diverge, then take the root's optimizer state
            for st in opt.state.values():
                st["exp_avg"].add_(1.0)
        hvd.broadcast_optimizer_state(opt, root_rank=0)
        out["exp_avg"] = [st["exp_avg"].clone() for st in opt.state.values()]
        buf = io.BytesIO()   # plain bytes: no tensor outlives this process
        torch.save(out, buf)
        results.put((rank, buf.getvalue()))
    finally:
        hvd.shutdown()


def test_two_gloo_processes(tmp_path):
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_worker,
                         args=(r, str(tmp_path / "store"), results))
             for r in range(2)]
    for p in procs:
        p.start()
    outs = {}
    try:
        for _ in procs:   # drain before joining
            rank, out = results.get(timeout=60)
            outs[rank] = torch.load(io.BytesIO(out))
    except queue.Empty:
        pytest.fail("a gloo worker did not report within 60 s")
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
    assert all(p.exitcode == 0 for p in procs)

    for r in (0, 1):
        o = outs[r]
        assert torch.equal(o["sum"], torch.full((3,), 3.0))
        assert torch.equal(o["avg"], torch.full((3,), 1.5))
        for t in o["grouped"]:
            assert torch.equal(t, torch.full_like(t, 3))
        assert [t.dtype for t in o["grouped"]] == [
            torch.float32, torch.bfloat16, torch.int32, torch.float16,
            torch.float32]
        assert o["gather"].view(-1).tolist() == [0, 1, 10, 11, 12]
        assert o["bcast"].item() == 7.0 and o["obj"] == {"from": 1}
    root = _model(seed=0).state_dict()
    for n in root:
        assert torch.equal(outs[0]["init"][n], root[n])
        assert torch.equal(outs[1]["init"][n], root[n])
        assert torch.equal(outs[0]["params"][n], outs[1]["params"][n])
    for a, b in zip(outs[0]["exp_avg"], outs[1]["exp_avg"]):
        assert torch.equal(a, b)

    # A single process stepping on the averaged gradient lands on the same
    # parameters.
    ref = _model(seed=0)
    grads = []
    for r in (0, 1):
        ref.zero_grad()
        ref(_data(r)).pow(2).sum().backward()
        grads.append([p.grad.clone() for p in ref.parameters()])
    for p, g0, g1 in zip(ref.parameters(), *grads):
        p.grad = (g0 + g1) / 2
    torch.optim.AdamW(ref.parameters(), lr=0.1).step()
    for n, t in ref.state_dict().items():
        torch.testing.assert_close(outs[0]["params"][n], t, atol=1e-6,
                                   rtol=1e-6)
