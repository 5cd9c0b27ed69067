"""The port's FSDP (``parallel/fsdp.py``) against the JAX package's on the
same numpy inputs.

The JAX side runs as ``tests/test_fsdp.py`` runs it: the spec rule, and
the JAX tests' replicated reference steps (to which they hold the JAX
sharded steps, at 1e-5).  The port runs on 2 gloo processes and on 4 as
two hosts of two (``LOCAL_WORLD_SIZE=2``), each with its own rows of the
batch, its parameters sharded by ``fsdp_device_put``: the JAX tests' MLP
as one root unit, and a small decoder with a unit a block, against the
same decoder replicated under ``DistributedOptimizer``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from horovod_tpu.parallel.fsdp import fsdp_spec as jax_spec
from test_torch_tensor_parallel import run_gloo

MIN = 8


def _dim(spec):
    """A JAX PartitionSpec as the port's answer: the sharded dimension."""
    for d, a in enumerate(spec):
        if a is not None:
            return d
    return None


SPEC_CASES = [((8, 3), 8, 1), ((4, 24), 8, 1), ((16, 8), 8, 1),
              ((7,), 8, 1), ((), 8, 1), ((32,), 8, 1024), ((64, 3), 8, 1),
              ((32, 64), 4, 8), ((64, 32), 2, 8), ((64,), 2, 8),
              ((32000, 768), 2, 1024), ((768, 3072), 2, 1024),
              ((768,), 2, 1024), ((6, 10, 10), 5, 1), ((3, 5), 1, 1)]


@pytest.mark.parametrize("shape,n,min_size", SPEC_CASES)
def test_fsdp_spec_selection(shape, n, min_size):
    from horovod_tpu_torch.parallel import fsdp_spec

    want = _dim(jax_spec(shape, n, ("hvd",), min_size=min_size))
    assert fsdp_spec(shape, n, min_size=min_size) == want
    # Hierarchical data axes shard the same dimension over both.
    assert _dim(jax_spec(shape, n, ("dcn", "ici"), min_size=min_size)) == \
        want


def _model_init():
    k = jax.random.PRNGKey(0)
    return {"w1": np.asarray(jax.random.normal(k, (32, 64)) * 0.1),
            "b1": np.zeros((64,), np.float32),
            "w2": np.asarray(jax.random.normal(jax.random.fold_in(k, 1),
                                               (64, 32)) * 0.1),
            "b2": np.zeros((32,), np.float32)}


def _jax_loss(params, batch):
    x, y = batch
    h = jnp.tanh(x @ params["w1"] + params["b1"])
    return jnp.mean((h @ params["w2"] + params["b2"] - y) ** 2)


def _batches():
    k = jax.random.PRNGKey(7)
    return (np.asarray(jax.random.normal(k, (4, 16, 32))),
            np.asarray(jax.random.normal(jax.random.fold_in(k, 1),
                                         (4, 16, 32))))


def _accumulate_batch():
    k = jax.random.PRNGKey(11)
    return (np.asarray(jax.random.normal(k, (16, 32))),
            np.asarray(jax.random.normal(jax.random.fold_in(k, 1),
                                         (16, 32))))


def jax_reference():
    """The JAX tests' replicated steps: 4 adam steps, one full-batch SGD
    step (accumulation's reference) and one SGD step of the (dcn, ici)
    test."""
    params = jax.tree.map(jnp.asarray, _model_init())

    def train(tx, batches):
        p, o = params, tx.init(params)
        for b in batches:
            g = jax.grad(_jax_loss)(p, b)
            u, o = tx.update(g, o, p)
            p = optax.apply_updates(p, u)
        return {k: np.asarray(v) for k, v in p.items()}

    xs, ys = _batches()
    x2 = np.asarray(jax.random.normal(jax.random.PRNGKey(2), (16, 32)))
    return {"adam": train(optax.adam(1e-2), [(xs[t], ys[t])
                                             for t in range(4)]),
            "accumulate": train(optax.sgd(0.1), [_accumulate_batch()]),
            "two_tier": train(optax.sgd(0.1), [(x2, np.ones((16, 32),
                                                            np.float32))]),
            "x2": x2}


class _MLP(torch.nn.Module):
    def __init__(self, arrays, dtype=torch.float32):
        super().__init__()
        for k, a in arrays.items():
            self.register_parameter(k, torch.nn.Parameter(
                torch.tensor(a).to(dtype)))

    def forward(self, x):
        return torch.tanh(x @ self.w1 + self.b1) @ self.w2 + self.b2


def _loss(model, x, y):
    return ((model(x) - y) ** 2).mean()


def _decoder_cfg(dtype):
    from horovod_tpu_torch.models.transformer import TransformerConfig

    return TransformerConfig(vocab_size=64, num_layers=2, num_heads=2,
                             head_dim=8, embed_dim=32, mlp_dim=64,
                             dtype=dtype)


def _decoder_step(rank, n, fsdp, dtype):
    """One AdamW step of the small decoder, sharded or replicated: the
    loss (mean over ranks), the parameters after it (gathered), and the
    FSDP handle's counts."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import parallel as par
    from horovod_tpu_torch.models import convert
    from horovod_tpu_torch.models.transformer import Transformer
    from horovod_tpu_torch.ops.losses import softmax_cross_entropy

    cfg = _decoder_cfg(dtype)
    model = Transformer(cfg, device="cpu")
    model.load_state_dict(convert.init_params(cfg, 0))
    tokens = torch.from_numpy(np.random.RandomState(5).randint(
        0, 64, (2 * n, 16)))[2 * rank:2 * rank + 2]
    info = {}
    if fsdp:
        shardings = par.fsdp_shardings(model, min_size=MIN)
        f = par.fsdp_device_put(model, shardings, units=model.layers)
        opt = torch.optim.AdamW(model.parameters(), lr=1e-2)
    else:
        opt = hvd.DistributedOptimizer(
            torch.optim.AdamW(model.parameters(), lr=1e-2))
    logits = model(tokens)
    if fsdp:
        info["alive_after_forward"] = f.gathered_alive()
        info["gathers"] = f.gathers
    loss = softmax_cross_entropy(logits[:, :-1], tokens[:, 1:]).mean()
    loss.backward()
    opt.step()
    out = {"loss": float(par.common.all_reduce(loss.detach()) / n)}
    if fsdp:
        info["regathers"] = f.regathers
        params = {}
        for name, p in model.named_parameters():
            d = shardings[name]
            params[name] = p.detach() if d is None else \
                par.common.all_gather(p.detach(), None, d)
        out["params"] = params
    else:
        out["params"] = {k: p.detach() for k, p in
                         model.named_parameters()}
    out["info"] = info
    return out


def _worker(rank, n, init, batches, acc_batch, x2):
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import parallel as par
    from horovod_tpu_torch.training import accumulate_gradients

    out = {"tiers": hvd.basics.hierarchy_groups() is not None}
    rows = slice(16 // n * rank, 16 // n * (rank + 1))

    def sharded(dtype=torch.float32):
        m = _MLP(init, dtype)
        shardings = par.fsdp_shardings(m, min_size=MIN)
        f = par.fsdp_device_put(m, shardings)
        return m, shardings, f

    def full(m, shardings):
        return {k: (p.detach() if shardings[k] is None else
                    par.common.all_gather(p.detach(), None, shardings[k]))
                for k, p in m.named_parameters()}

    # Four adam steps.
    m, shardings, f = sharded()
    opt = torch.optim.Adam(m.parameters(), lr=1e-2)
    xs, ys = (torch.tensor(a) for a in batches)
    par.reset_collective_stats()
    for t in range(4):
        opt.zero_grad()
        loss = _loss(m, xs[t, rows], ys[t, rows])
        if t == 0:
            out["alive_after_forward"] = f.gathered_alive()
            out["stats_forward"] = par.collective_stats()
        loss.backward()
        if t == 0:
            out["stats_step"] = par.collective_stats()
        opt.step()
    out["adam"] = full(m, shardings)
    out["shardings"] = shardings
    out["local"] = {k: p.numel() for k, p in m.named_parameters()}
    st = opt.state
    out["state"] = {k: {s: (v.numel(), v.dim()) for s, v in st[p].items()}
                    for k, p in m.named_parameters()}
    out["regathers"] = f.regathers

    # Accumulation: four microbatches of this rank's rows, one SGD step.
    m, shardings, _ = sharded()
    opt = torch.optim.SGD(m.parameters(), lr=0.1)
    x, y = (torch.tensor(a)[rows] for a in acc_batch)
    accumulate_gradients(lambda mb: _loss(m, *mb), (x, y), 4)
    opt.step()
    out["accumulate"] = full(m, shardings)

    # bf16 leaves: shard as f32 ones do, keep their dtype.
    m, shardings, _ = sharded(torch.bfloat16)
    opt = torch.optim.SGD(m.parameters(), lr=0.1)
    xb = torch.ones(16 // n, 32, dtype=torch.bfloat16)
    _loss(m, xb, xb).backward()
    opt.step()
    out["bf16"] = {"shardings": shardings,
                   "dtypes": {k: p.dtype for k, p in m.named_parameters()},
                   "local": {k: p.numel() for k, p in m.named_parameters()}}

    # One SGD step on x2 (the (dcn, ici) test).
    m, shardings, _ = sharded()
    opt = torch.optim.SGD(m.parameters(), lr=0.1)
    _loss(m, torch.tensor(x2)[rows], torch.ones(16 // n, 32)).backward()
    opt.step()
    out["two_tier"] = full(m, shardings)

    # The decoder, a unit a block, against the replicated step.
    for dtype in (torch.float32, torch.bfloat16):
        out[f"decoder_{dtype}"] = [_decoder_step(rank, n, fsdp, dtype)
                                   for fsdp in (True, False)]
    return out


_RUNS: dict = {}


@pytest.fixture(scope="module", params=["2", "2x2"])
def runs(request, tmp_path_factory):
    tag = request.param
    if tag not in _RUNS:
        n = 2 if tag == "2" else 4
        ref = jax_reference()
        got = run_gloo(_worker, n, tmp_path_factory.mktemp(f"fsdp{tag}"),
                       _model_init(), _batches(), _accumulate_batch(),
                       ref["x2"], env={"LOCAL_WORLD_SIZE": "2"})
        _RUNS[tag] = n, ref, got
    return _RUNS[tag]


def _close(got, want, tol=1e-5):
    for k, w in want.items():
        np.testing.assert_allclose(got[k].float().numpy(), w, atol=tol,
                                   rtol=tol, err_msg=k)


def test_fsdp_matches_replicated_training(hvd, runs):
    n, ref, got = runs
    for r in range(n):
        _close(got[r]["adam"], ref["adam"])


def test_fsdp_state_is_sharded(hvd, runs):
    n, _, got = runs
    full = {k: v.size for k, v in _model_init().items()}
    for r in range(n):
        # Every leaf here is >= 8 elements with a dimension n divides.
        assert all(d is not None for d in got[r]["shardings"].values())
        for k, numel in got[r]["local"].items():
            assert numel * n == full[k], (k, numel)
            st = got[r]["state"][k]
            assert st["exp_avg"][0] * n == full[k]
            assert st["exp_avg_sq"][0] * n == full[k]
            assert st["step"][1] == 0       # the step count: a scalar


def test_fsdp_emits_gather_scatter(hvd, runs):
    n, _, got = runs
    for r in range(n):
        fwd, step = got[r]["stats_forward"], got[r]["stats_step"]
        # The forward gathers every leaf just in time, and scatters none.
        assert fwd["all_gather"] == 4 and "reduce_scatter" not in fwd
        # The backward gathers w2 again (saved for dh) and scatters every
        # gradient onto its shard.
        assert step["reduce_scatter"] == 4
        assert step["all_gather"] - fwd["all_gather"] == 1
        # No gathered weight outlives the forward.
        assert got[r]["alive_after_forward"] == 0
        assert got[r]["regathers"] == 4


def test_fsdp_composes_with_accumulate_gradients(hvd, runs):
    n, ref, got = runs
    for r in range(n):
        _close(got[r]["accumulate"], ref["accumulate"])


def test_fsdp_bf16_params(hvd, runs):
    n, _, got = runs
    full = {k: v.size for k, v in _model_init().items()}
    for r in range(n):
        bf = got[r]["bf16"]
        # w1 is (32, 64): the larger divisible dimension (64) is sharded.
        assert bf["shardings"]["w1"] == 1
        assert all(dt == torch.bfloat16 for dt in bf["dtypes"].values())
        assert bf["local"]["w1"] * n == full["w1"]


def test_fsdp_hierarchical_axes(hvd, runs):
    n, ref, got = runs
    assert got[0]["tiers"] == (n == 4)
    for r in range(n):
        np.testing.assert_allclose(got[r]["two_tier"]["w1"].numpy(),
                                   ref["two_tier"]["w1"], atol=1e-5,
                                   rtol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fsdp_decoder_units_match_replicated_step(hvd, runs, dtype):
    n, _, got = runs
    for r in range(n):
        sharded, replicated = got[r][f"decoder_{dtype}"]
        # The forward sees the same weights: the same loss, bit for bit.
        assert sharded["loss"] == replicated["loss"]
        info = sharded["info"]
        assert info["alive_after_forward"] == 0
        # Every leaf (32 elements and more) gathered forward: 7 products
        # and 2 norms a block, the embedding, the final norm and the head;
        # and each that the backward needs gathered again (all but the
        # embedding, whose gradient needs only its shape), none kept
        # between.
        assert info["gathers"] == 2 * 9 + 3
        assert info["regathers"] == 2 * 9 + 2, info
        tol = 1e-5 if dtype == torch.float32 else 2e-2
        for k, p in replicated["params"].items():
            np.testing.assert_allclose(sharded["params"][k].float().numpy(),
                                       p.float().numpy(), atol=tol,
                                       rtol=tol, err_msg=k)
