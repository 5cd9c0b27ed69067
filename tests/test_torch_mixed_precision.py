"""Port's mixed precision, remat and gradient accumulation against the JAX
package's ``master_weights``, ``TransformerConfig.remat`` and
``accumulate_gradients``, on the same numpy inputs: the master copy
against f32 AdamW, ``params_from_flax`` over a bf16 flax tree, remat
against the plain block (and its hooks under ``DistributedOptimizer`` on
two gloo processes), and microbatches against the full batch."""

import copy
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

import horovod_tpu_torch as thvd
from horovod_tpu.models import transformer as jtm
from horovod_tpu import training as jtraining
from horovod_tpu.ops import losses as jlosses
from horovod_tpu_torch import train_transformer
from horovod_tpu_torch.models import convert
from horovod_tpu_torch.models import transformer as ttm

SMALL = dict(vocab_size=64, num_layers=2, num_heads=2, head_dim=8,
             embed_dim=16, mlp_dim=32, max_seq_len=64)
# The JAX suite's bound for a resident bf16 parameter against
# bf16(master) (tests/test_training.py).
RESIDENT = dict(rtol=0.008, atol=4e-5)


@pytest.fixture()
def world1(monkeypatch):
    for name in ("RANK", "WORLD_SIZE", "JAX_PROCESS_ID", "JAX_NUM_PROCESSES",
                 "JAX_COORDINATOR_ADDRESS", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(name, raising=False)
    thvd.init(device="cpu")
    yield thvd
    thvd.shutdown()


def test_master_weights_tracks_f32_adamw():
    # tests/test_training.py::test_master_weights_tracks_f32_training: the
    # master evolves exactly as f32 AdamW on the same bf16 gradients, and
    # the resident bf16 parameters land on bf16(master).
    rng = np.random.default_rng(0)
    w0 = torch.from_numpy((rng.standard_normal((16, 8)) * 0.1)
                          .astype(np.float32)).to(torch.bfloat16)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (4, 16)).astype(np.float32)).to(torch.bfloat16)
    p16 = torch.nn.Parameter(w0.clone())
    p32 = torch.nn.Parameter(w0.float())
    mw = thvd.master_weights(torch.optim.AdamW([p16], lr=1e-2))
    ref = torch.optim.AdamW([p32], lr=1e-2)
    for _ in range(10):
        mw.zero_grad()
        ((x @ p16) ** 2).sum().float().backward()
        assert p16.grad.dtype == torch.bfloat16
        p32.grad = p16.grad.float()       # the same gradient, upcast
        mw.step()
        ref.step()
        assert p16.dtype == torch.bfloat16
        master = mw.masters()[0]
        assert torch.equal(master, p32.detach())
        np.testing.assert_allclose(
            p16.detach().float().numpy(),
            master.to(torch.bfloat16).float().numpy(), **RESIDENT)


def test_master_weights_matches_jax_on_the_same_gradients():
    # The JAX wrapper over optax.sgd against the port's over torch's SGD,
    # fed the same bf16 gradients: masters within f32 rounding of each
    # other, the residents within the JAX suite's bound of bf16(master).
    rng = np.random.default_rng(2)
    w0 = (rng.standard_normal((8, 4)) * 0.1).astype(np.float32)
    grads = [rng.standard_normal((8, 4)).astype(ml_dtypes.bfloat16)
             for _ in range(5)]
    jopt = jtraining.master_weights(optax.sgd(0.1))
    jparams = {"w": jnp.asarray(w0, jnp.bfloat16)}
    jstate = jopt.init(jparams)
    p = torch.nn.Parameter(torch.from_numpy(w0).to(torch.bfloat16))
    topt = thvd.master_weights(torch.optim.SGD([p], lr=0.1))
    for g in grads:
        u, jstate = jopt.update({"w": jnp.asarray(g)}, jstate, jparams)
        jparams = optax.apply_updates(jparams, u)
        p.grad = torch.from_numpy(g.astype(np.float32)).to(torch.bfloat16)
        topt.step()
        np.testing.assert_allclose(topt.masters()[0].numpy(),
                                   np.asarray(jstate.master["w"]),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(
            p.detach().float().numpy(),
            np.asarray(jparams["w"], np.float32), **RESIDENT)


def test_master_weights_requires_params():
    p = torch.nn.Parameter(torch.ones(3, dtype=torch.bfloat16))
    mw = thvd.master_weights(torch.optim.SGD([p], lr=0.1))
    assert mw.masters()[0].dtype == torch.float32
    with pytest.raises(ValueError, match="master_weights requires params"):
        thvd.master_weights(torch.optim.SGD([{"params": []}], lr=0.1))


def test_master_weights_state_dict_carries_masters():
    # A fresh wrapper loaded from the state_dict steps exactly as the
    # original goes on stepping: masters, moments and step counts carried,
    # and the hyperparameters a schedule wrote into the outer groups.
    def make():
        p = torch.nn.Parameter(torch.arange(6.0).to(torch.bfloat16))
        return p, thvd.master_weights(torch.optim.AdamW([p], lr=0.1))

    p, opt = make()
    for _ in range(3):
        p.grad = torch.full_like(p, 0.5)
        opt.step()
    opt.param_groups[0]["lr"] = 0.05
    q, other = make()
    # A copy, as it arrives from another process (torch's load_state_dict
    # keeps the tensors it is given).
    other.load_state_dict(copy.deepcopy(opt.state_dict()))
    with torch.no_grad():
        q.copy_(p)
    for a, b in ((p, opt), (q, other)):
        a.grad = torch.full_like(a, -0.25)
        b.step()
    assert other.param_groups[0]["lr"] == 0.05
    assert torch.equal(p, q)
    assert torch.equal(opt.masters()[0], other.masters()[0])


def test_master_weights_under_distributed_optimizer_int8(hvd, world1):
    # DistributedOptimizer(master_weights(SGD), compression=int8) against
    # the JAX package's composition on one process: the same bf16
    # gradients ride the int8 wire with error feedback (residuals in bf16,
    # bit for bit the reference's), the masters step on the dequantized
    # gradient.
    rng = np.random.default_rng(3)
    w0 = (rng.standard_normal((6, 5)) * 0.1).astype(np.float32)
    grads = [rng.standard_normal((6, 5)).astype(ml_dtypes.bfloat16)
             for _ in range(4)]
    jopt = hvd.DistributedOptimizer(hvd.master_weights(optax.sgd(0.1)),
                                    compression=hvd.Compression.int8)
    jparams = {"w": jnp.asarray(w0, jnp.bfloat16)}
    jstate = jopt.init(jparams)
    p = torch.nn.Parameter(torch.from_numpy(w0).to(torch.bfloat16))
    topt = thvd.DistributedOptimizer(
        thvd.master_weights(torch.optim.SGD([p], lr=0.1)),
        compression=thvd.Compression.int8)
    for g in grads:
        u, jstate = jopt.update({"w": jnp.asarray(g)}, jstate, jparams)
        jparams = optax.apply_updates(jparams, u)
        p.grad = torch.from_numpy(g.astype(np.float32)).to(torch.bfloat16)
        topt.step()
        err = topt.state_dict()["error_feedback"][0]
        assert err.dtype == torch.bfloat16
        np.testing.assert_array_equal(
            err.float().numpy(), np.asarray(jstate.error["w"], np.float32))
        np.testing.assert_allclose(topt._opt.masters()[0].numpy(),
                                   np.asarray(jstate.inner.master["w"]),
                                   rtol=1e-6, atol=1e-7)


def _linear_problem():
    rng = np.random.RandomState(0)
    x = rng.randn(16, 4).astype(np.float32)
    y = rng.randint(0, 3, 16).astype(np.int32)
    w = rng.randn(4, 3).astype(np.float32)
    return x, y, w


@pytest.mark.parametrize("n_mb", [1, 2, 4])
def test_accumulate_gradients_matches_full_batch(hvd, n_mb):
    # tests/test_training.py::test_accumulate_gradients_matches_full_batch:
    # the mean over microbatches of a mean-reduced loss is the full batch's
    # gradient, against the JAX function.
    x, y, w = _linear_problem()

    def grad_fn(p, batch):
        xb, yb = batch
        return jax.value_and_grad(lambda p: optax.
                                  softmax_cross_entropy_with_integer_labels(
                                      xb @ p["w"], yb).mean())(p)

    full_loss, full_grads = grad_fn({"w": jnp.asarray(w)},
                                    (jnp.asarray(x), jnp.asarray(y)))
    jloss, jgrads = hvd.accumulate_gradients(
        grad_fn, {"w": jnp.asarray(w)}, (jnp.asarray(x), jnp.asarray(y)),
        n_mb)
    tw = torch.nn.Parameter(torch.from_numpy(w))
    loss = thvd.accumulate_gradients(
        lambda mb: torch.nn.functional.cross_entropy(mb[0] @ tw,
                                                     mb[1].long()),
        (torch.from_numpy(x), torch.from_numpy(y)), n_mb)
    for want_loss, want in ((full_loss, full_grads), (jloss, jgrads)):
        np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
        np.testing.assert_allclose(tw.grad.numpy(), np.asarray(want["w"]),
                                   rtol=1e-5)


def test_accumulate_gradients_validates():
    w = torch.nn.Parameter(torch.ones(1))
    with pytest.raises(ValueError, match="divisible"):
        thvd.accumulate_gradients(lambda b: (b * w).sum(),
                                  torch.ones(10, 2), 3)
    with pytest.raises(ValueError, match=">= 1"):
        thvd.accumulate_gradients(lambda b: (b * w).sum(),
                                  torch.ones(10, 2), 0)


def test_accumulate_gradients_splits_dicts_and_lists():
    w = torch.nn.Parameter(torch.ones(2))
    seen = []

    def loss_fn(mb):
        seen.append((mb["x"].shape, mb["y"][0].shape))
        return (mb["x"] @ w).mean() + mb["y"][0].sum()

    batch = {"x": torch.ones(8, 2), "y": [torch.ones(8)]}
    thvd.accumulate_gradients(loss_fn, batch, 4)
    assert seen == [((2, 2), (2,))] * 4
    assert torch.equal(w.grad, torch.ones(2))


def _tokens(b, s, seed=0):
    return np.random.default_rng(seed).integers(0, 64, (b, s)).astype(
        np.int32)


@pytest.fixture(scope="module")
def flax_pair():
    jcfg = jtm.TransformerConfig(**SMALL, dtype=jnp.float32)
    jmodel = jtm.Transformer(jcfg)
    params = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    return jmodel, params


def test_remat_matches_plain_and_jax(flax_pair):
    # tests/test_models.py::test_transformer_remat_matches_plain: remat is
    # the same function and the same gradients; here both held against the
    # JAX model with cfg.remat, at the port's transformer bounds.
    jmodel, params = flax_pair
    toks = _tokens(2, 32)
    jremat = jtm.Transformer(jtm.TransformerConfig(**SMALL,
                                                   dtype=jnp.float32,
                                                   remat=True))

    def jloss(p):
        logits = jremat.apply(p, jnp.asarray(toks))
        return jlosses.softmax_cross_entropy(
            logits[:, :-1], jnp.asarray(toks)[:, 1:]).mean()

    want_loss, jgrads = jax.value_and_grad(jloss)(params)
    tree = jax.tree_util.tree_map(np.asarray, params)
    runs = []
    for remat in (False, True):
        cfg = ttm.TransformerConfig(**SMALL, dtype=torch.float32,
                                    remat=remat)
        model = ttm.Transformer(cfg, device="cpu")
        model.load_state_dict(convert.params_from_flax(tree, cfg))
        loss = train_transformer.loss_fn(model, torch.from_numpy(toks).long())
        loss.backward()
        runs.append((loss.item(), {n: p.grad.clone()
                                   for n, p in model.named_parameters()}))
    (l0, g0), (l1, g1) = runs
    assert l0 == l1
    want = convert.params_from_flax(
        jax.tree_util.tree_map(np.asarray, jgrads), model.cfg)
    np.testing.assert_allclose(l1, float(want_loss), atol=5e-4, rtol=5e-4)
    for name in g0:
        # Recomputing a block runs the same ops on the same inputs.
        assert torch.equal(g0[name], g1[name]), name
        np.testing.assert_allclose(g1[name].numpy(), want[name].numpy(),
                                   atol=1e-3, rtol=1e-3, err_msg=name)


def test_remat_stays_off_the_serving_paths():
    cfg = ttm.TransformerConfig(**SMALL, dtype=torch.float32, remat=True)
    model = ttm.Transformer(cfg, device="cpu")
    toks = torch.from_numpy(_tokens(1, 8)).long()
    calls = []
    real = ttm.checkpoint
    try:
        ttm.checkpoint = lambda *a, **k: calls.append(1) or real(*a, **k)
        model(toks, return_kv=True)
        with torch.no_grad():
            model(toks)
        assert calls == []
        model(toks)
        assert len(calls) == cfg.num_layers
    finally:
        ttm.checkpoint = real


def test_bf16_params_from_flax_match_the_flax_model():
    # A flax model with bf16 parameters (ml_dtypes leaves) through
    # params_from_flax into the port's bf16-param model: the same bf16
    # values, and logits within the JAX suite's bf16 bound of flax's.
    jcfg = jtm.TransformerConfig(**SMALL, dtype=jnp.bfloat16,
                                 param_dtype=jnp.bfloat16)
    jmodel = jtm.Transformer(jcfg)
    params = jmodel.init(jax.random.PRNGKey(1), jnp.zeros((1, 8), jnp.int32))
    tree = jax.tree_util.tree_map(np.asarray, params)
    leaf = tree["params"]["embed"]["embedding"]
    assert leaf.dtype == ml_dtypes.bfloat16
    tcfg = ttm.TransformerConfig(**SMALL, dtype=torch.bfloat16,
                                 param_dtype=torch.bfloat16)
    model = ttm.Transformer(tcfg, device="cpu")
    sd = convert.params_from_flax(tree, tcfg)
    assert all(t.dtype == torch.bfloat16 for t in sd.values())
    np.testing.assert_array_equal(sd["embed.weight"].float().numpy(),
                                  leaf.astype(np.float32))
    model.load_state_dict(sd)
    toks = _tokens(2, 16, seed=3)
    want = np.asarray(jmodel.apply(params, jnp.asarray(toks)), np.float32)
    with torch.no_grad():
        got = model(torch.from_numpy(toks)).float().numpy()
    np.testing.assert_allclose(got, want, atol=0.1, rtol=0.05)


# -- two gloo processes: remat under the chained hooks ------------------------

def _remat_worker(rank, store, results):
    import horovod_tpu_torch as hvd

    hvd.init(device="cpu", init_method=f"file://{store}", rank=rank, size=2)
    try:
        out = {}
        toks = torch.from_numpy(_tokens(2, 16, seed=rank)).long()
        tree = convert.flax_tree(ttm.TransformerConfig(**SMALL), 0)
        for remat, buckets in ((False, 0), (True, 0), (True, 3)):
            cfg = ttm.TransformerConfig(**SMALL, dtype=torch.float32,
                                        remat=remat)
            model = ttm.Transformer(cfg, device="cpu")
            model.load_state_dict(convert.params_from_flax(tree, cfg))
            opt = hvd.DistributedOptimizer(
                torch.optim.SGD(model.parameters(), lr=0.1),
                named_parameters=model.named_parameters(),
                overlap_buckets=buckets)
            fires = []
            for step in range(3):
                opt.zero_grad(set_to_none=True)
                train_transformer.loss_fn(model, toks).backward()
                if opt._plan is not None and opt._plan.chained:
                    # Every hook fired once in this backward: each bucket
                    # was issued during it.
                    fires.append((opt._next, len(opt._buckets)))
                opt.step()
            out[(remat, buckets)] = (
                fires, {n: t.clone() for n, t in model.state_dict().items()})
        buf = io.BytesIO()
        torch.save(out, buf)
        results.put((rank, buf.getvalue()))
    finally:
        hvd.shutdown()


def test_remat_hooks_fire_once_per_backward_on_two_processes(tmp_path):
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_remat_worker,
                         args=(r, str(tmp_path / "store"), results))
             for r in range(2)]
    for p in procs:
        p.start()
    outs = {}
    try:
        for _ in procs:
            rank, out = results.get(timeout=120)
            outs[rank] = torch.load(io.BytesIO(out))
    except queue.Empty:
        pytest.fail("a gloo worker did not report within 120 s")
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
    assert all(p.exitcode == 0 for p in procs)
    for r in (0, 1):
        o = outs[r]
        fires, chained = o[(True, 3)]
        # The first step plans at step(); steps 2 and 3 issue all three
        # buckets inside backward, under the non-reentrant checkpoint.
        assert fires == [(3, 3), (3, 3)]
        plain = o[(False, 0)][1]
        for key in ((True, 0), (True, 3)):
            for name, t in o[key][1].items():
                assert torch.equal(t, plain[name]), (key, name)
        for name, t in plain.items():
            assert torch.equal(t, outs[0][(False, 0)][1][name])
