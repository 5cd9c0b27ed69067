"""The port's ZeRO-1 optimizer (``parallel/zero.py`` and
``DistributedOptimizer(sharded_state=True)``) against the JAX package's on
the same numpy inputs.

The JAX side runs as ``tests/test_zero.py`` runs it: ``zero_optimizer``
inside ``shard_map`` over the data axis (here 2 or 4 of the suite's
virtual CPU devices, and the ``(dcn, ici)`` 2 x 2 mesh), plus the JAX
tests' own reference (plain optax on the mean gradient).  The port runs on
2 gloo processes and on 4 as two hosts of two (``LOCAL_WORLD_SIZE=2``:
two tiers), each with its own rows of the data.  Tolerances are the JAX
tests' (1e-5; momentum 1e-6; the two-tier run 1e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from horovod_tpu.parallel import zero_optimizer
from test_torch_tensor_parallel import run_gloo

LR, STEPS = 1e-2, 4


def _params():
    k = jax.random.PRNGKey(0)
    return {"w": np.asarray(jax.random.normal(k, (5, 3))),
            "b": np.zeros((3,), np.float32),
            "v": np.asarray(jax.random.normal(jax.random.fold_in(k, 1),
                                              (7,)))}


def _xs(n):
    return np.asarray(jax.random.normal(jax.random.PRNGKey(3),
                                        (STEPS, n, 2, 5)))


def _jax_grads(params, x):
    def loss(p):
        return jnp.sum((x @ p["w"] + p["b"]) ** 2) + jnp.sum(p["v"] ** 2)

    return jax.grad(loss)(params)


def jax_adam(n):
    """``zero_optimizer(adam)`` over ``n`` devices, and the JAX test's
    reference: plain adam on the mean gradient."""
    mesh = Mesh(np.array(jax.devices()[:n]), ("hvd",))
    ztx = zero_optimizer(optax.adam(LR), axis_name="hvd")
    params = jax.tree.map(jnp.asarray, _params())

    def steps(params, xs):
        state = ztx.init(params)
        for t in range(STEPS):
            updates, state = ztx.update(_jax_grads(params, xs[t, 0]), state,
                                        params)
            params = optax.apply_updates(params, updates)
        return params

    out = jax.jit(jax.shard_map(steps, mesh=mesh,
                                in_specs=(P(), P(None, "hvd")),
                                out_specs=P(), check_vma=False))(
        params, jnp.asarray(_xs(n)))
    tx = optax.adam(LR)
    p_ref, st = params, tx.init(params)
    xs = _xs(n)
    for t in range(STEPS):
        gs = [_jax_grads(p_ref, xs[t, d]) for d in range(n)]
        g = jax.tree.map(lambda *a: sum(a) / n, *gs)
        u, st = tx.update(g, st, p_ref)
        p_ref = optax.apply_updates(p_ref, u)
    return ({k: np.asarray(v) for k, v in out.items()},
            {k: np.asarray(v) for k, v in p_ref.items()})


def jax_two_tier():
    """``tests/test_zero.py``'s (dcn, ici) program on a 2 x 2 mesh, and its
    replicated reference."""
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("dcn", "ici"))
    params = {"w": jnp.arange(12.0), "b": jnp.ones((5,))}
    ztx = zero_optimizer(optax.adam(LR), axis_name=("dcn", "ici"))

    def steps(params):
        state = ztx.init(params)
        for _ in range(2):
            grads = jax.tree.map(lambda p: p * 0.1, params)
            updates, state = ztx.update(grads, state, params)
            params = optax.apply_updates(params, updates)
        return params

    out = jax.jit(jax.shard_map(steps, mesh=mesh, in_specs=P(),
                                out_specs=P(), check_vma=False))(params)
    tx = optax.adam(LR)
    p, st = params, tx.init(params)
    for _ in range(2):
        u, st = tx.update(jax.tree.map(lambda q: q * 0.1, p), st, p)
        p = optax.apply_updates(p, u)
    return ({k: np.asarray(v) for k, v in out.items()},
            {k: np.asarray(v) for k, v in p.items()})


def _module(arrays):
    m = torch.nn.Module()
    for k, a in arrays.items():
        m.register_parameter(k, torch.nn.Parameter(torch.tensor(a)))
    return m


def _worker(rank, n, params):
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops.compression import Compression
    from horovod_tpu_torch.parallel import zero_optimizer as tzero

    out = {"tiers": hvd.basics.hierarchy_groups() is not None}
    m = _module(params)
    z = tzero(torch.optim.Adam(m.parameters(), lr=LR))
    xs = torch.tensor(_xs(n))
    for t in range(STEPS):
        z.zero_grad()
        x = xs[t, rank]
        ((x @ m.w + m.b) ** 2).sum().add((m.v ** 2).sum()).backward()
        z.step()
    out["adam"] = {k: p.detach().clone() for k, p in m.named_parameters()}
    out["state_numel"] = {k: v.numel() for k, v in
                          z.inner.state[z.shard].items() if v.dim() > 0}

    w = torch.nn.Parameter(torch.arange(10.0))
    z = tzero(torch.optim.SGD([w], lr=0.1, momentum=0.9))
    for _ in range(2):
        w.grad = w.detach() * 0.5
        z.step()
    out["momentum"] = w.detach().clone()

    mixed = [torch.nn.Parameter(torch.ones(6, dtype=torch.bfloat16)),
             torch.nn.Parameter(torch.ones(4))]
    z = tzero(torch.optim.SGD(mixed, lr=0.1))
    for p in mixed:
        p.grad = torch.ones_like(p)
    z.step()
    out["mixed"] = [p.detach().clone() for p in mixed]

    w = torch.nn.Parameter(torch.arange(8.0))
    opt = hvd.DistributedOptimizer(torch.optim.SGD([w], lr=0.1),
                                   sharded_state=True)
    w.grad = torch.ones(8)
    opt.step()
    out["flag"] = w.detach().clone()
    out["refused"] = []
    for kw in (dict(compression=Compression.fp16), dict(threshold_bytes=64),
               dict(overlap_buckets=2), dict(planner=object())):
        try:
            hvd.DistributedOptimizer(torch.optim.SGD([w], lr=0.1),
                                     sharded_state=True, **kw)
        except ValueError as e:
            out["refused"].append(str(e))
    hvd.DistributedOptimizer(torch.optim.SGD([w], lr=0.1),
                             sharded_state=True, overlap_buckets=0)

    two = _module({"w": np.arange(12.0, dtype=np.float32),
                   "b": np.ones(5, np.float32)})
    z = tzero(torch.optim.Adam(two.parameters(), lr=LR))
    for _ in range(2):
        for p in two.parameters():
            p.grad = p.detach() * 0.1
        z.step()
    out["two_tier"] = {k: p.detach().clone()
                       for k, p in two.named_parameters()}
    return out


_RUNS: dict = {}


@pytest.fixture(scope="module", params=["2", "2x2"])
def runs(request, tmp_path_factory):
    tag = request.param
    if tag not in _RUNS:
        n = 2 if tag == "2" else 4
        env = {"LOCAL_WORLD_SIZE": "2"}
        got = run_gloo(_worker, n, tmp_path_factory.mktemp(f"zero{tag}"),
                       _params(), env=env)
        _RUNS[tag] = n, got
    return _RUNS[tag]


def test_zero_matches_replicated_adam(hvd, runs):
    n, got = runs
    zero, ref = jax_adam(n)
    for r in range(n):
        for k, p in got[r]["adam"].items():
            np.testing.assert_allclose(p.numpy(), ref[k], atol=1e-5,
                                       rtol=1e-5)
            np.testing.assert_allclose(p.numpy(), zero[k], atol=1e-5,
                                       rtol=1e-5)
        # Every rank ends with the same bits.
        for k, p in got[r]["adam"].items():
            np.testing.assert_array_equal(p.numpy(),
                                          got[0]["adam"][k].numpy())


def test_zero_state_is_sharded(hvd, runs):
    n, got = runs
    total = 5 * 3 + 3 + 7
    chunk = -(-total // n)
    for r in range(n):
        assert got[r]["state_numel"] == {"exp_avg": chunk,
                                         "exp_avg_sq": chunk}


def test_zero_momentum_semantics(hvd, runs):
    n, got = runs
    tx = optax.sgd(0.1, momentum=0.9)
    p = {"w": jnp.arange(10.0)}
    st = tx.init(p)
    for _ in range(2):
        u, st = tx.update({"w": p["w"] * 0.5}, st, p)
        p = optax.apply_updates(p, u)
    for r in range(n):
        np.testing.assert_allclose(got[r]["momentum"].numpy(),
                                   np.asarray(p["w"]), rtol=1e-6)


def test_zero_mixed_dtypes_round_trip(hvd, runs):
    n, got = runs
    params = {"w": jnp.ones((6,), jnp.bfloat16), "b": jnp.ones((4,))}
    ztx = zero_optimizer(optax.sgd(0.1), axis_name="hvd")
    mesh = Mesh(np.array(jax.devices()[:n]), ("hvd",))

    def step(params):
        grads = jax.tree.map(jnp.ones_like, params)
        updates, _ = ztx.update(grads, ztx.init(params), params)
        return optax.apply_updates(params, updates)

    want = jax.jit(jax.shard_map(step, mesh=mesh, in_specs=P(),
                                 out_specs=P(), check_vma=False))(params)
    for r in range(n):
        w, b = got[r]["mixed"]
        assert w.dtype == torch.bfloat16 and b.dtype == torch.float32
        np.testing.assert_array_equal(w.float().numpy(),
                                      np.asarray(want["w"], np.float32))
        np.testing.assert_array_equal(b.numpy(), np.asarray(want["b"]))


def test_distributed_optimizer_sharded_state_flag(hvd, runs):
    n, got = runs
    for r in range(n):
        # Every rank's gradient is 1: summed n, averaged 1, one step of -0.1.
        np.testing.assert_allclose(got[r]["flag"].numpy(),
                                   np.arange(8.0) - 0.1, rtol=1e-6)
        assert len(got[r]["refused"]) == 4
        assert all("sharded_state=True" in e for e in got[r]["refused"])


def test_zero_hierarchical_axes(hvd, runs):
    n, got = runs
    zero, ref = jax_two_tier()
    assert got[0]["tiers"] == (n == 4)
    for r in range(n):
        for k, p in got[r]["two_tier"].items():
            np.testing.assert_allclose(p.numpy(), ref[k], atol=1e-6)
            np.testing.assert_allclose(p.numpy(), zero[k], atol=1e-6)
