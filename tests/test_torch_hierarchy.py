"""The port's hierarchical allreduce against the JAX package's, and the
bytes each collective route of the port puts on the wire.

The JAX side runs as ``tests/test_parallel.py``'s hierarchical tests run
it: ``shard_map`` over a ``(dcn, ici)`` 2 x 2 mesh of the suite's virtual
CPU devices, against a flat ``psum``.  The port runs on 4 gloo processes
as two hosts of two (``LOCAL_WORLD_SIZE=2``), where ``init`` forms the
local and cross groups and the fused allreduce goes tier by tier; the JAX
tolerance (1e-5) holds.

Wire bytes are counted per process: the bytes the process wrote to its
sockets (``wchar`` of ``/proc/self/io``) around one call, with 4 MiB a
rank, on 4 processes (P = 4):

* the eager executor's device route (``core/device_reduce.py``): ~2n
  (P - 1)/P; its gather route: (P - 1) n;
* a ZeRO step (reduce-scatter and all-gather of the flat gradients): the
  bytes of the one allreduce it replaces;
* the hierarchical allreduce's cross tier: 1/local_size of a cross-tier
  allreduce of the whole buffer.

Tolerance 5%: the engine's control plane writes a few hundred bytes
beside.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from horovod_tpu.parallel import hierarchical_allreduce
from test_torch_tensor_parallel import run_gloo

N = 4
BYTES = 4 * 2**20


def _x():
    return np.asarray(jax.random.normal(jax.random.PRNGKey(1), (8, 256)))


def _ragged():
    return np.asarray(jax.random.normal(jax.random.PRNGKey(2), (13,)))


def jax_results():
    mesh = Mesh(np.array(jax.devices()[:N]).reshape(2, 2), ("dcn", "ici"))
    flat = jax.shard_map(lambda t: jax.lax.psum(t, ("dcn", "ici")),
                         mesh=mesh, in_specs=P(("dcn", "ici")),
                         out_specs=P())(jnp.asarray(_x()))
    hier = jax.shard_map(
        lambda t: hierarchical_allreduce(t.reshape(-1),
                                         ("dcn", "ici")).reshape(t.shape),
        mesh=mesh, in_specs=P(("dcn", "ici")), out_specs=P(),
        check_vma=False)(jnp.asarray(_x()))
    ragged = jax.shard_map(lambda t: hierarchical_allreduce(t, ("dcn",
                                                                "ici")),
                           mesh=mesh, in_specs=P(), out_specs=P(),
                           check_vma=False)(jnp.asarray(_ragged()))
    return np.asarray(flat), np.asarray(hier), np.asarray(ragged)


def _wchar() -> int:
    with open("/proc/self/io") as f:
        for line in f:
            if line.startswith("wchar"):
                return int(line.split()[1])
    raise RuntimeError("no wchar in /proc/self/io")


def _measured(fn):
    import torch.distributed as dist

    dist.barrier()
    w0 = _wchar()
    out = fn()
    w1 = _wchar()
    dist.barrier()
    return out, w1 - w0


def _worker(rank, n):
    import os

    import torch.distributed as dist

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import basics
    from horovod_tpu_torch import parallel as par
    from horovod_tpu_torch.parallel import hierarchy

    cross, local = basics.hierarchy_groups()
    out = {"local": dist.get_process_group_ranks(local),
           "cross": dist.get_process_group_ranks(cross)}
    x = torch.tensor(_x())
    mine = x[2 * rank:2 * rank + 2]
    out["hier"] = par.hierarchical_allreduce(mine.reshape(-1)).view_as(mine)
    out["ragged"] = par.hierarchical_allreduce(torch.tensor(_ragged()))
    par.reset_collective_stats()
    out["fused"] = hvd.allreduce(mine, average=False)
    out["fused_stats"] = par.collective_stats()

    flat = torch.ones(BYTES // 4) * (rank + 1)
    _, out["allreduce_bytes"] = _measured(
        lambda: dist.all_reduce(flat.clone()))
    # The hierarchical call, its cross tier counted apart.
    cross_bytes = []
    inner = hierarchy.all_reduce

    def counted(t, group):
        w0 = _wchar()
        r = inner(t, group)
        cross_bytes.append(_wchar() - w0)
        return r

    hierarchy.all_reduce = counted
    try:
        _, out["hier_bytes"] = _measured(
            lambda: par.hierarchical_allreduce(flat))
    finally:
        hierarchy.all_reduce = inner
    out["cross_bytes"] = cross_bytes
    # A cross-tier allreduce of the whole buffer, for comparison.
    _, out["cross_full_bytes"] = _measured(
        lambda: dist.all_reduce(flat.clone(), group=cross))

    # A ZeRO step against the allreduce it replaces.
    p = torch.nn.Parameter(torch.zeros(BYTES // 4))
    z = par.zero_optimizer(torch.optim.SGD([p], lr=0.1))
    p.grad = flat.clone()
    _, out["zero_bytes"] = _measured(z.step)

    # The eager executor's two routes.
    for route in ("device", "gather"):
        os.environ["HVD_TPU_EAGER_REDUCE"] = route
        hvd.synchronize(hvd.allreduce_async(flat, average=False,
                                            name=f"warm.{route}"))
        r, out[f"{route}_bytes"] = _measured(
            lambda: hvd.synchronize(hvd.allreduce_async(
                flat, average=False, name=f"wire.{route}")))
        out[f"{route}_ok"] = bool((r == sum(range(1, n + 1))).all())
    return out


_RUNS: dict = {}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    if not _RUNS:
        from horovod_tpu_torch.serving.soak import free_port

        env = {"LOCAL_WORLD_SIZE": "2", "HVD_TPU_EXECUTOR": "multihost",
               "HVD_TPU_COORDINATOR_PORT": str(free_port())}
        _RUNS["got"] = run_gloo(_worker, N, tmp_path_factory.mktemp("hier"),
                                env=env)
        _RUNS["jax"] = jax_results()
    return _RUNS


def test_tier_groups_formed_alike_on_every_rank(hvd, runs):
    got = runs["got"]
    for r in range(N):
        assert got[r]["local"] == [2 * (r // 2), 2 * (r // 2) + 1]
        assert got[r]["cross"] == [r % 2, r % 2 + 2]


def test_hierarchical_allreduce_matches_flat_psum(hvd, runs):
    flat, hier, _ = runs["jax"]
    np.testing.assert_allclose(hier, flat, rtol=1e-5, atol=1e-5)
    for r in range(N):
        np.testing.assert_allclose(runs["got"][r]["hier"].numpy(), flat,
                                   rtol=1e-5, atol=1e-5)


def test_hierarchical_allreduce_ragged_length(hvd, runs):
    _, _, ragged = runs["jax"]
    for r in range(N):
        got = runs["got"][r]["ragged"].numpy()
        assert got.shape == (13,)
        np.testing.assert_allclose(got, ragged, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got, 4 * _ragged(), rtol=1e-5, atol=1e-5)


def test_fused_allreduce_goes_tier_by_tier(hvd, runs):
    flat, _, _ = runs["jax"]
    for r in range(N):
        got = runs["got"][r]
        np.testing.assert_allclose(got["fused"].numpy(), flat, rtol=1e-5,
                                   atol=1e-5)
        stats = got["fused_stats"]
        assert stats["reduce_scatter"] == stats["all_gather"] == 1
        assert stats["all_reduce"] == 1


def _about(got, want):
    assert abs(got - want) <= 0.05 * want, (got, want)


def test_executor_routes_wire_bytes(hvd, runs):
    for r in range(N):
        got = runs["got"][r]
        assert got["device_ok"] and got["gather_ok"]
        _about(got["device_bytes"], 2 * BYTES * (N - 1) / N)
        _about(got["gather_bytes"], (N - 1) * BYTES)


def test_zero_step_carries_the_allreduce_bytes(hvd, runs):
    for r in range(N):
        got = runs["got"][r]
        _about(got["allreduce_bytes"], 2 * BYTES * (N - 1) / N)
        _about(got["zero_bytes"], got["allreduce_bytes"])


def test_hierarchical_cross_tier_carries_one_local_size_share(hvd, runs):
    for r in range(N):
        got = runs["got"][r]
        (cross,) = got["cross_bytes"]
        _about(cross, got["cross_full_bytes"] / 2)
        # The whole call: 1/2 n within the host each way and the cross
        # tier's share.
        _about(got["hier_bytes"], BYTES / 2 + cross + BYTES / 2)
