"""Cross-replica BatchNorm: the port's ``BatchNorm(process_group=...)``
(``models/resnet.py``) on two gloo processes, held two ways on the same
seeded weights and numpy batch (each rank its half):

* against one process on the concatenated batch with local BatchNorm:
  each rank's logits are its rows of the full batch's, the running
  statistics the full batch's on both ranks, and the mean of the ranks'
  gradients the full batch's;
* against the JAX ResNet with ``axis_name`` under ``shard_map`` on two of
  the suite's virtual CPU devices (flax's ``pmean`` of the statistics), as
  the JAX package's ``hvd.shard`` runs it (``check_vma=False``): logits,
  the new ``batch_stats`` and the ``pmean`` of the gradients.

Each BatchNorm makes exactly one ``all_reduce`` in the forward and one in
the backward, counted; with local BatchNorm the two ranks' running
statistics differ, which shows the synced path is the live one.
Tolerances are ``tests/test_torch_resnet.py``'s: float32, max |Δ| ≤
1e-4·max|ref|; bfloat16, relative L2 ≤ 0.02."""

import io
import multiprocessing
import queue

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from _timing import scaled
from horovod_tpu.models import resnet as jres
from horovod_tpu_torch.models import convert
from horovod_tpu_torch.models import resnet as tres
from horovod_tpu_torch.ops.losses import softmax_cross_entropy

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
BATCH, SIZE, CLASSES = 8, 32, 10      # the global batch, two ranks of 4
NORMS = 9                             # BatchNorms of the small ResNet


def _model(dtype, group=None):
    return tres.ResNet(stage_sizes=(1, 1), block_cls=tres.BottleneckBlock,
                       num_classes=CLASSES, num_filters=8,
                       dtype=DTYPES[dtype][1], device="cpu",
                       process_group=group)


def _variables():
    """Seeded weights with every BatchNorm perturbed off its init (as
    ``tests/test_torch_resnet.py`` does), in flax's layout."""
    variables = convert.init_variables(_model("f32"), 0)
    rng = np.random.default_rng(1)

    def walk(tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v)
            elif k == "var":
                tree[k] = rng.uniform(0.5, 2.0, v.shape).astype(np.float32)
            elif k in ("scale", "bias", "mean"):
                tree[k] = (v + rng.normal(0, 0.3, v.shape)).astype(
                    np.float32)

    walk(variables)
    return variables


def _batch():
    rng = np.random.default_rng(2)
    x = (1 + 2 * rng.standard_normal((BATCH, SIZE, SIZE, 3))).astype(
        np.float32)
    return x, rng.integers(0, CLASSES, BATCH)


def _result(model, logits) -> dict:
    """The logits, the raw gradients and the running statistics after a
    backward, in flax's layout."""
    grads = {n: p.grad for n, p in model.named_parameters()}
    tree = convert.to_flax({**model.state_dict(), **grads}, model)
    return {"logits": logits.detach().float().numpy(),
            "grads": tree["params"], "stats": tree["batch_stats"]}


def _step(model, x, y) -> dict:
    """One forward and backward of the mean cross entropy over ``x``."""
    logits = model(torch.from_numpy(x), train=True)
    softmax_cross_entropy(logits, torch.from_numpy(y)).mean().backward()
    return _result(model, logits)


def _worker(rank, store, results):
    import torch.distributed as dist

    import horovod_tpu_torch as hvd

    hvd.init(device="cpu", init_method=f"file://{store}", rank=rank, size=2)
    try:
        x, y = _batch()
        rows = slice(rank * BATCH // 2, (rank + 1) * BATCH // 2)
        out = {}
        real = dist.all_reduce
        phase = ["forward"]
        calls = {"forward": 0, "backward": 0}

        def counting(tensor, *a, **k):
            calls[phase[0]] += 1
            return real(tensor, *a, **k)

        for dtype in DTYPES:
            for sync in (True, False):
                model = _model(dtype, dist.group.WORLD if sync else None)
                model.load_state_dict(convert.from_flax(_variables(), model))
                calls.update(forward=0, backward=0)
                dist.all_reduce = counting
                try:
                    phase[0] = "forward"
                    logits = model(torch.from_numpy(x[rows]), train=True)
                    loss = softmax_cross_entropy(
                        logits, torch.from_numpy(y[rows])).mean()
                    phase[0] = "backward"
                    loss.backward()
                finally:
                    dist.all_reduce = real
                out[(dtype, sync)] = {**_result(model, logits),
                                      "calls": dict(calls)}
        buf = io.BytesIO()
        torch.save(out, buf)
        results.put((rank, buf.getvalue()))
    finally:
        hvd.shutdown()


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    store = str(tmp_path_factory.mktemp("syncbn") / "store")
    procs = [ctx.Process(target=_worker, args=(r, store, results))
             for r in range(2)]
    for p in procs:
        p.start()
    outs = {}
    try:
        for _ in procs:
            rank, blob = results.get(timeout=scaled(180))
            outs[rank] = torch.load(io.BytesIO(blob), weights_only=False)
    except queue.Empty:
        pytest.fail(f"a gloo worker did not report: ranks {sorted(outs)}, "
                    f"exit codes {[p.exitcode for p in procs]}")
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
    assert [p.exitcode for p in procs] == [0, 0]
    return outs


def _close(got, want, dtype, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    assert np.isfinite(got).all(), what
    if dtype == "f32":
        err = np.abs(got - want).max() if got.size else 0.0
        assert err <= 1e-4 * np.abs(want).max(), (what, err)
    else:
        rel = np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)
        assert rel <= 0.02, (what, rel)


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    else:
        yield prefix, np.asarray(tree)


def _mean_grads(outs, key):
    return jax.tree_util.tree_map(lambda a, b: (a + b) / 2,
                                  outs[0][key]["grads"],
                                  outs[1][key]["grads"])


def _held(got_tree, want_tree, dtype, what):
    got = dict(_leaves(got_tree))
    want = dict(_leaves(want_tree))
    assert got.keys() == want.keys()
    for path, w in want.items():
        _close(got[path], w, dtype, f"{what}/{'/'.join(path)}")


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_one_all_reduce_per_batchnorm_each_way(two, dtype):
    for rank in (0, 1):
        assert two[rank][(dtype, True)]["calls"] == {"forward": NORMS,
                                                      "backward": NORMS}
        assert two[rank][(dtype, False)]["calls"] == {"forward": 0,
                                                       "backward": 0}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_running_stats_equal_across_ranks_only_when_synced(two, dtype):
    synced = [dict(_leaves(two[r][(dtype, True)]["stats"])) for r in (0, 1)]
    for path, a in synced[0].items():
        assert np.array_equal(a, synced[1][path]), path   # bit for bit
    local = [dict(_leaves(two[r][(dtype, False)]["stats"])) for r in (0, 1)]
    assert any(not np.array_equal(a, local[1][p])
               for p, a in local[0].items())


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_synced_ranks_match_one_process_on_the_whole_batch(two, dtype):
    x, y = _batch()
    model = _model(dtype)
    model.load_state_dict(convert.from_flax(_variables(), model))
    full = _step(model, x, y)
    for r in (0, 1):
        got = two[r][(dtype, True)]
        _close(got["logits"], full["logits"][r * 4:(r + 1) * 4], dtype,
               f"rank {r} logits")
        _held(got["stats"], full["stats"], dtype, f"rank {r} stats")
    _held(_mean_grads(two, (dtype, True)), full["grads"], dtype, "grads")


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_synced_ranks_match_flax_axis_name_under_shard_map(two, dtype):
    jdt = DTYPES[dtype][0]
    jm = jres.ResNet(stage_sizes=[1, 1], block_cls=jres.BottleneckBlock,
                     num_classes=CLASSES, num_filters=8, dtype=jdt,
                     axis_name="batch")
    variables = jax.tree_util.tree_map(jnp.asarray, _variables())
    x, y = _batch()
    mesh = Mesh(np.array(jax.devices()[:2]), ("batch",))

    def shard(params, stats, x, y):
        def loss_fn(p):
            logits, mutated = jm.apply({"params": p, "batch_stats": stats},
                                       x, train=True,
                                       mutable=["batch_stats"])
            loss = optax.softmax_cross_entropy_with_integer_labels(
                logits, y).mean()
            return loss, (logits, mutated["batch_stats"])

        (_, (logits, new_stats)), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(params)
        return logits, new_stats, jax.lax.pmean(grads, "batch")

    # check_vma=False, as the JAX package's ``hvd.shard`` runs its steps.
    # (With jax's default, True, the gradient of the replicated parameters
    # comes back already summed over the shards, and this pmean leaves it
    # at twice the full batch's.)
    f = jax.jit(jax.shard_map(shard, mesh=mesh,
                              in_specs=(P(), P(), P("batch"), P("batch")),
                              out_specs=(P("batch"), P(), P()),
                              check_vma=False))
    logits, stats, grads = jax.tree_util.tree_map(
        np.asarray, f(variables["params"], variables["batch_stats"],
                      jnp.asarray(x), jnp.asarray(y)))
    for r in (0, 1):
        got = two[r][(dtype, True)]
        _close(got["logits"], logits[r * 4:(r + 1) * 4], dtype,
               f"rank {r} logits")
        _held(got["stats"], stats, dtype, f"rank {r} stats")
    mean = _mean_grads(two, (dtype, True))
    if dtype == "bf16":
        # As tests/test_torch_resnet.py holds bfloat16 training: the
        # parameters after an SGD step (lr 0.01) on the gradients, not the
        # gradients themselves, whose bf16 backward rounds each layer.
        params = _variables()["params"]
        mean, grads = (jax.tree_util.tree_map(
            lambda p, g: p - 0.01 * g, params, t) for t in (mean, grads))
    _held(mean, grads, dtype, "grads")
