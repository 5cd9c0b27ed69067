"""The port's tensor-parallel layers against the JAX package's on the same
numpy inputs.

The JAX side runs as ``tests/test_tensor_parallel.py`` runs it: the flax
``ParallelMLP`` initialised and applied inside ``shard_map`` over a ``tp``
axis of the suite's virtual CPU devices, its per-shard parameters taken
out with ``out_specs=P("tp")``.  Those shards are carried into the port's
``ParallelMLP`` on 2 and 4 gloo processes, one shard a rank.  The forward
is held to the JAX output at the JAX test's tolerance (1e-5).  The JAX
package pins no tensor-parallel gradient; the port's ``dx`` and every
shard's ``dW`` are held to autograd of the dense MLP on the gathered
weights (float64), at the same tolerance.

:func:`run_gloo` is the gloo process runner the port's parallel tests
share: one set of processes a file and world size (a module-scope
fixture), each returning what its file's tests compare.
"""

import io
import multiprocessing
import os
import queue
import traceback

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from horovod_tpu import parallel as jpar

TOL = 1e-5
IN, HIDDEN, OUT, T = 8, 32, 8, 6


def _save(obj) -> bytes:
    buf = io.BytesIO()
    torch.save(obj, buf)
    return buf.getvalue()


def _entry(fn, rank, n, store, env, args, results):
    os.environ.update(env)
    import horovod_tpu_torch as hvd

    hvd.init(device="cpu", init_method=f"file://{store}", rank=rank, size=n)
    try:
        results.put((rank, _save(fn(rank, n, *args)), None))
    except BaseException:
        results.put((rank, None, traceback.format_exc()))
        raise
    finally:
        hvd.shutdown()


def run_gloo(fn, n, tmp_path, *args, env=None, timeout=240):
    """``{rank: fn(rank, n, *args)}`` from ``n`` spawned gloo processes on
    the CPU, each joined to the job by ``init(device="cpu")`` over a file
    store in ``tmp_path`` (no port), with ``env`` set first."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_entry,
                         args=(fn, r, n, str(tmp_path / "store"), env or {},
                               args, results))
             for r in range(n)]
    for p in procs:
        p.start()
    outs, errors = {}, []
    try:
        for _ in procs:
            rank, out, err = results.get(timeout=timeout)
            if err is not None:
                errors.append(f"rank {rank}:\n{err}")
            else:
                outs[rank] = torch.load(io.BytesIO(out), weights_only=False)
    except queue.Empty:
        pytest.fail(f"a gloo worker did not report within {timeout} s; "
                    f"{sorted(outs)} did")
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
    assert not errors, "\n".join(errors)
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    return outs


def _x():
    return np.random.default_rng(0).standard_normal((T, IN)).astype(
        np.float32)


def _cotangent():
    return np.random.default_rng(1).standard_normal((T, OUT)).astype(
        np.float32)


def jax_mlp(n):
    """The JAX ParallelMLP over ``n`` devices: its output and each
    shard's ``(up kernel, up bias, down kernel, down bias)``."""
    mesh = Mesh(np.array(jax.devices()[:n]), ("tp",))
    model = jpar.ParallelMLP(hidden=HIDDEN, features=OUT, axis_name="tp")

    def init_and_apply(x):
        params = model.init(jax.random.PRNGKey(1), x)
        return model.apply(params, x), params

    out, params = jax.shard_map(
        init_and_apply, mesh=mesh, in_specs=P(), out_specs=(P(), P("tp")),
        check_vma=False)(jnp.asarray(_x()))
    pk = params["params"]
    h = HIDDEN // n
    shards = [tuple(np.asarray(a) for a in (
        pk["up"]["kernel"][r * IN:(r + 1) * IN],
        pk["up"]["bias"][r * h:(r + 1) * h],
        pk["down"]["kernel"][r * h:(r + 1) * h],
        pk["down"]["bias"][r * OUT:(r + 1) * OUT])) for r in range(n)]
    return np.asarray(out), shards


def _load(mlp, shard):
    with torch.no_grad():
        for p, a in zip((mlp.up.kernel, mlp.up.bias, mlp.down.kernel,
                         mlp.down.bias), shard):
            p.copy_(torch.from_numpy(a))


def _worker(rank, n, shards, shards2d, x2d):
    import torch.distributed as dist

    from horovod_tpu_torch import parallel as par

    out = {}
    mlp = par.ParallelMLP(IN, HIDDEN, OUT)
    out["own_up"] = mlp.up.kernel.detach().clone()
    _load(mlp, shards[rank])
    x = torch.from_numpy(_x()).requires_grad_()
    y = mlp(x)
    (y * torch.from_numpy(_cotangent())).sum().backward()
    out["y"] = y.detach()
    out["dx"] = x.grad
    out["dw"] = [p.grad for p in (mlp.up.kernel, mlp.up.bias,
                                  mlp.down.kernel, mlp.down.bias)]
    out["stats"] = par.collective_stats()
    if n == 4:
        # A 2 x 2 mesh: tp groups {0, 1}, {2, 3}; data groups {0, 2},
        # {1, 3}; each tp group's shards are the 2-way JAX shards, and the
        # data-parallel mean runs over the data group.
        tp = [dist.new_group(g) for g in ([0, 1], [2, 3])][rank // 2]
        dp = [dist.new_group(g) for g in ([0, 2], [1, 3])][rank % 2]
        mlp2 = par.ParallelMLP(OUT // 2, HIDDEN // 2, OUT // 2, group=tp)
        _load(mlp2, shards2d[rank % 2])
        rows = torch.from_numpy(x2d)[rank // 2 * 4:(rank // 2 + 1) * 4]
        out["2d"] = par.common.all_reduce(mlp2(rows), dp) / 2
    return out


def jax_2d():
    """``tests/test_tp_with_data_axis``'s (hvd, tp) program, with its
    shards taken out: the output and the two tp shards."""
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("hvd", "tp"))
    model = jpar.ParallelMLP(hidden=HIDDEN // 2, features=OUT // 2,
                             axis_name="tp")
    x = np.random.default_rng(2).standard_normal((8, OUT // 2)).astype(
        np.float32)

    def fwd(x):
        params = model.init(jax.random.PRNGKey(1), x)
        return jax.lax.pmean(model.apply(params, x), "hvd"), params

    out, params = jax.shard_map(
        fwd, mesh=mesh, in_specs=P("hvd"),
        out_specs=(P("hvd"), P(("hvd", "tp"))), check_vma=False)(
            jnp.asarray(x))
    pk = params["params"]
    i, h, o = OUT // 2, HIDDEN // 4, OUT // 2
    shards = [tuple(np.asarray(a) for a in (
        pk["up"]["kernel"][r * i:(r + 1) * i],
        pk["up"]["bias"][r * h:(r + 1) * h],
        pk["down"]["kernel"][r * h:(r + 1) * h],
        pk["down"]["bias"][r * o:(r + 1) * o])) for r in range(2)]
    return np.asarray(out), shards, x


_RUNS: dict = {}


def _run(n, tmp_path_factory):
    if n not in _RUNS:
        want, shards = jax_mlp(n)
        out2d, shards2d, x2d = jax_2d()
        outs = run_gloo(_worker, n, tmp_path_factory.mktemp(f"tp{n}"),
                        shards, shards2d, x2d)
        _RUNS[n] = n, want, shards, (out2d, outs)
    return _RUNS[n]


@pytest.fixture(scope="module", params=[2, 4])
def port(request, tmp_path_factory):
    return _run(request.param, tmp_path_factory)


@pytest.fixture(scope="module")
def port4(tmp_path_factory):
    return _run(4, tmp_path_factory)


def test_parallel_mlp_matches_jax(hvd, port):
    n, want, shards, (_, outs) = port
    for r in range(n):
        np.testing.assert_allclose(outs[r]["y"].numpy(), want, atol=TOL,
                                   rtol=TOL)
    # The port's own shards are distinct (per-rank generators).
    own = [outs[r]["own_up"].numpy() for r in range(n)]
    for r in range(1, n):
        assert not np.allclose(own[0], own[r])
    # One sum forward, one backward.
    assert outs[0]["stats"]["all_reduce"] == 2


def test_parallel_mlp_gradients_are_the_dense_gradients(hvd, port):
    n, _, shards, (_, outs) = port
    up_k = np.concatenate([s[0] for s in shards], axis=1)
    up_b = np.concatenate([s[1] for s in shards])
    down_k = np.concatenate([s[2] for s in shards], axis=0)
    down_b = shards[0][3]
    dense = [torch.tensor(a).double().requires_grad_()
             for a in (up_k, up_b, down_k, down_b)]
    x = torch.from_numpy(_x()).double().requires_grad_()
    h = torch.nn.functional.gelu(x @ dense[0] + dense[1],
                                 approximate="tanh")
    y = h @ dense[2] + dense[3]
    (y * torch.from_numpy(_cotangent()).double()).sum().backward()
    h_local = HIDDEN // n
    for r in range(n):
        got = outs[r]
        np.testing.assert_allclose(got["dx"].numpy(), x.grad.numpy(),
                                   atol=TOL, rtol=TOL)
        want = (dense[0].grad[:, r * h_local:(r + 1) * h_local],
                dense[1].grad[r * h_local:(r + 1) * h_local],
                dense[2].grad[r * h_local:(r + 1) * h_local],
                dense[3].grad)
        for g, w in zip(got["dw"], want):
            np.testing.assert_allclose(g.numpy(), w.numpy(), atol=TOL,
                                       rtol=TOL)


def test_tp_with_data_axis_matches_jax(hvd, port4):
    _, _, _, (out2d, outs) = port4
    got = np.concatenate([outs[r]["2d"].detach().numpy()
                          for r in (0, 2)])
    assert got.shape == (8, OUT // 2) and np.isfinite(got).all()
    np.testing.assert_allclose(got, out2d, atol=TOL, rtol=TOL)
    np.testing.assert_array_equal(outs[0]["2d"].detach().numpy(),
                                  outs[1]["2d"].detach().numpy())
