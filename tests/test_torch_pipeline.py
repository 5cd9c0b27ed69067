"""The port's GPipe pipeline against the JAX package's on the same numpy
inputs.

The JAX side runs as ``tests/test_pipeline.py`` runs it: ``pipeline_apply``
of ``tanh(x @ w + b)`` stages inside ``shard_map`` over a ``pp`` axis of
2 or 4 of the suite's virtual CPU devices, each stage's weights drawn by
``stage_init_rng`` and taken out with ``out_specs=P("pp")``.  Those
weights are carried into the port's stages on as many gloo processes, one
stage a rank, and the port's outputs, stage gradients, ``remat``
gradients and input gradient are held to JAX's at the JAX tests'
tolerances (outputs and the input gradient 1e-5, stage gradients 1e-4,
remat against no remat 1e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from horovod_tpu.parallel import pipeline_apply, stage_init_rng
from test_torch_tensor_parallel import run_gloo

DIM, B = 6, 8


def _stage_jax(params, x):
    w, b = params
    return jnp.tanh(x @ w + b)


def _stage_torch(params, x):
    w, b = params
    return torch.tanh(x @ w + b)


def _x(seed):
    return np.random.default_rng(seed).standard_normal((B, DIM)).astype(
        np.float32)


def jax_runs(n):
    """JAX's stage weights, outputs (M = 4, 8), stage gradients with and
    without remat, and input gradients, over ``n`` stages."""
    mesh = Mesh(np.array(jax.devices()[:n]), ("pp",))

    def init():
        rng = stage_init_rng(jax.random.PRNGKey(0), "pp")
        w = jax.random.normal(rng, (DIM, DIM)) * 0.3
        b = jax.random.normal(jax.random.fold_in(rng, 1), (DIM,)) * 0.1
        return w, b

    def run(x):
        params = init()
        outs = tuple(pipeline_apply(_stage_jax, params, x,
                                    num_microbatches=m)
                     for m in (4, 8))

        def loss(p, x, remat):
            out = pipeline_apply(_stage_jax, p, x, num_microbatches=4,
                                 remat=remat)
            return jax.lax.pmean(jnp.sum(out ** 2), "pp")

        grads = jax.grad(loss)(params, x, False)
        grads_remat = jax.grad(loss)(params, x, True)
        dx = jax.grad(loss, argnums=1)(params, x, False)
        return outs, grads, grads_remat, dx, params

    stage = (P("pp"), P("pp"))
    outs, grads, grads_remat, dx, params = jax.jit(jax.shard_map(
        run, mesh=mesh, in_specs=P(),
        out_specs=((P(), P()), stage, stage, P("pp"), stage),
        check_vma=False))(jnp.asarray(_x(3)))
    split = lambda t: [np.asarray(a) for a in (  # noqa: E731
        np.asarray(t[0]).reshape(n, DIM, DIM),
        np.asarray(t[1]).reshape(n, DIM))]
    return {"outs": [np.asarray(o) for o in outs], "params": split(params),
            "grads": split(grads), "grads_remat": split(grads_remat),
            "dx": np.asarray(dx).reshape(n, B, DIM)}


def _worker(rank, n, w_all, b_all):
    from horovod_tpu_torch.parallel import pipeline_apply as tpa

    def params():
        return (torch.tensor(w_all[rank]).requires_grad_(),
                torch.tensor(b_all[rank]).requires_grad_())

    out = {}
    x = torch.from_numpy(_x(3))
    out["outs"] = [tpa(_stage_torch, params(), x, num_microbatches=m)
                   .detach() for m in (4, 8)]
    for tag, remat in (("grads", False), ("grads_remat", True)):
        p = params()
        xg = x.clone().requires_grad_()
        y = tpa(_stage_torch, p, xg, num_microbatches=4, remat=remat)
        (y ** 2).sum().backward()
        out[tag] = [t.grad for t in p]
        out[f"dx_{tag}"] = xg.grad
    try:
        tpa(_stage_torch, params(), torch.ones(6, DIM),
            num_microbatches=4)
        out["bad"] = None
    except ValueError as e:
        out["bad"] = str(e)
    return out


_RUNS: dict = {}


@pytest.fixture(scope="module", params=[2, 4])
def runs(request, tmp_path_factory):
    n = request.param
    if n not in _RUNS:
        want = jax_runs(n)
        got = run_gloo(_worker, n, tmp_path_factory.mktemp(f"pp{n}"),
                       *want["params"])
        _RUNS[n] = n, want, got
    return _RUNS[n]


def _sequential(w, b, x):
    x = torch.from_numpy(x)
    for s in range(len(w)):
        x = torch.tanh(x @ torch.tensor(w[s]) + torch.tensor(b[s]))
    return x.numpy()


@pytest.mark.parametrize("m_index", [0, 1], ids=["m4", "m8"])
def test_pipeline_matches_jax_and_sequential(hvd, runs, m_index):
    n, want, got = runs
    ref = _sequential(*want["params"], _x(3))
    np.testing.assert_allclose(want["outs"][m_index], ref, atol=1e-5,
                               rtol=1e-5)
    for r in range(n):
        # Every rank returns the whole batch.
        np.testing.assert_allclose(got[r]["outs"][m_index].numpy(),
                                   want["outs"][m_index], atol=1e-5,
                                   rtol=1e-5)
    w = want["params"][0]
    assert not np.allclose(w[0], w[1])


def test_pipeline_backward_matches_jax(hvd, runs):
    n, want, got = runs
    for r in range(n):
        for g, w in zip(got[r]["grads"], want["grads"]):
            np.testing.assert_allclose(g.numpy(), w[r], atol=1e-4,
                                       rtol=1e-4)


def test_pipeline_remat_exact_gradients(hvd, runs):
    n, want, got = runs
    for r in range(n):
        for g0, g1, w in zip(got[r]["grads"], got[r]["grads_remat"],
                             want["grads_remat"]):
            np.testing.assert_allclose(g1.numpy(), g0.numpy(), atol=1e-6,
                                       rtol=1e-6)
            np.testing.assert_allclose(g1.numpy(), w[r], atol=1e-4,
                                       rtol=1e-4)


def test_pipeline_rejects_bad_microbatch(hvd, runs):
    n, _, got = runs
    for r in range(n):
        assert "divisible" in got[r]["bad"]


def test_pipeline_input_grad_lands_on_stage_zero(hvd, runs):
    n, want, got = runs
    np.testing.assert_allclose(got[0]["dx_grads"].numpy(), want["dx"][0],
                               atol=1e-5, rtol=1e-5)
    for r in range(1, n):
        np.testing.assert_array_equal(got[r]["dx_grads"].numpy(),
                                      np.zeros((B, DIM), np.float32))
        np.testing.assert_array_equal(want["dx"][r],
                                      np.zeros((B, DIM), np.float32))
