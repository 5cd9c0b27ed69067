"""Port's ResNet and MNIST models against the JAX package's flax models,
on the same numpy inputs and converted weights: logits, the new
``batch_stats``, one SGD-momentum step, and the converter.

Tolerances: float32, max |Δ| ≤ 1e-4·max|ref| (the two sum the same
products in another order); bfloat16, relative L2 ≤ 0.02 (each rounds every
activation to bf16, and a value that rounds the other way moves the next
layer's sums by one bf16 ulp, 2**-8 relative)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import horovod_tpu_torch as thvd
from horovod_tpu.models import mnist as jmnist
from horovod_tpu.models import resnet as jres
from horovod_tpu_torch import train_resnet
from horovod_tpu_torch.models import convert
from horovod_tpu_torch.models import mnist as tmnist
from horovod_tpu_torch.models import resnet as tres

BLOCKS = {"bottleneck": (jres.BottleneckBlock, tres.BottleneckBlock),
          "basic": (jres.BasicBlock, tres.BasicBlock)}
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


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


def _small_pair(block, dtype, seed=0):
    """The small ResNet of both packages ([1, 1] stages, 8 filters, 10
    classes) with the same variables: the port's seeded init, with every
    BatchNorm's scale, bias and running statistics perturbed, so that no
    branch is zero and eval mode reads non-trivial statistics."""
    jblock, tblock = BLOCKS[block]
    jdt, tdt = DTYPES[dtype]
    jm = jres.ResNet(stage_sizes=[1, 1], block_cls=jblock, num_classes=10,
                     num_filters=8, dtype=jdt)
    tm = tres.ResNet(stage_sizes=[1, 1], block_cls=tblock, num_classes=10,
                     num_filters=8, dtype=tdt, device="cpu")
    variables = convert.init_variables(tm, seed)
    rng = np.random.default_rng(seed + 1)

    def perturb(tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                perturb(v)
            elif k == "var":
                tree[k] = rng.uniform(0.5, 2.0, v.shape).astype(np.float32)
            elif k in ("scale", "bias", "mean"):
                tree[k] = (v + rng.normal(0, 0.3, v.shape)).astype(np.float32)

    perturb(variables)
    tm.load_state_dict(convert.from_flax(variables, tm))
    return jm, tm, variables


def _images(b=4, size=32, c=3, seed=2):
    return np.random.default_rng(seed).standard_normal(
        (b, size, size, c)).astype(np.float32)


@pytest.mark.parametrize("size,kernel,stride", [
    (224, 7, 2), (32, 7, 2), (112, 3, 2), (56, 3, 2), (16, 3, 2), (7, 3, 2),
    (8, 3, 2), (28, 3, 1), (28, 1, 1), (28, 1, 2), (15, 2, 2)])
def test_same_pads_are_xlas(size, kernel, stride):
    # Asymmetric at stride 2: the stem at 224 pads (2, 3), a 3×3/2 at an
    # even size (0, 1); torch's symmetric padding= gives neither.
    want = jax.lax.padtype_to_pads((size,), (kernel,), (stride,), "SAME")[0]
    assert tres.same_pads(size, kernel, stride) == tuple(want)


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("block", sorted(BLOCKS))
def test_resnet_forward_and_batch_stats_match_flax(block, dtype, train):
    jm, tm, variables = _small_pair(block, dtype)
    x = _images()
    jvars = jax.tree_util.tree_map(jnp.asarray, variables)
    if train:
        jlogits, mutated = jm.apply(jvars, jnp.asarray(x), train=True,
                                    mutable=["batch_stats"])
    else:
        jlogits = jm.apply(jvars, jnp.asarray(x), train=False)
    with torch.no_grad():
        tlogits = tm(torch.from_numpy(x), train=train)
    assert tlogits.dtype == torch.float32 and tlogits.shape == (4, 10)
    _close(tlogits.numpy(), np.asarray(jlogits, np.float32), dtype, "logits")
    got = convert.to_flax(tm.state_dict(), tm)["batch_stats"]
    want = mutated["batch_stats"] if train else variables["batch_stats"]
    got_leaves, want_leaves = dict(_leaves(got)), dict(_leaves(want))
    assert got_leaves.keys() == want_leaves.keys()
    for path, w in want_leaves.items():
        _close(got_leaves[path], w, dtype, "/".join(path))
    if not train:   # eval mode leaves the running statistics alone
        for path, w in want_leaves.items():
            assert np.array_equal(got_leaves[path], w)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_batchnorm_matches_flax(dtype):
    # Statistics in f32; running variance from the biased batch variance;
    # ra = 0.9·ra + 0.1·batch; eps 1e-5; output in the compute dtype.
    import flax.linen as nn

    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(3)
    x = (3 + 2 * rng.standard_normal((4, 5, 5, 6))).astype(np.float32)
    stats = {"mean": rng.normal(size=6).astype(np.float32),
             "var": rng.uniform(0.5, 2, 6).astype(np.float32)}
    params = {"scale": rng.normal(size=6).astype(np.float32),
              "bias": rng.normal(size=6).astype(np.float32)}
    bn = nn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5,
                      dtype=jdt)
    jy, mutated = bn.apply({"params": params, "batch_stats": stats},
                           jnp.asarray(x, jdt), mutable=["batch_stats"])
    tbn = tres.BatchNorm(6, tdt, device="cpu")
    tbn.load_state_dict({k: torch.from_numpy(v) for k, v in
                         {**params, **stats}.items()})
    ty = tbn(torch.from_numpy(x).to(tdt).permute(0, 3, 1, 2), train=True)
    assert ty.dtype == tdt
    _close(ty.permute(0, 2, 3, 1).float().detach().numpy(),
           np.asarray(jy, np.float32), dtype, "y")
    for k in ("mean", "var"):
        _close(getattr(tbn, k).numpy(), mutated["batch_stats"][k], "f32", k)


@pytest.fixture()
def world1(monkeypatch):
    for name in ("RANK", "WORLD_SIZE", "JAX_PROCESS_ID", "JAX_NUM_PROCESSES",
                 "JAX_COORDINATOR_ADDRESS", "MASTER_ADDR", "MASTER_PORT",
                 "HOROVOD_OVERLAP_BUCKETS", "HVD_TPU_OVERLAP_BUCKETS"):
        monkeypatch.delenv(name, raising=False)
    thvd.init(device="cpu")
    yield thvd
    thvd.shutdown()


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("block", sorted(BLOCKS))
def test_sgd_momentum_steps_match_optax(world1, block, dtype):
    # bench.py's step: softmax cross entropy over the logits with the
    # batch's statistics, SGD 0.01 with momentum 0.9; two steps, so the
    # second carries the first's momentum.
    jm, tm, variables = _small_pair(block, dtype)
    x = _images()
    y = np.random.default_rng(4).integers(0, 10, 4)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    stats = jax.tree_util.tree_map(jnp.asarray, variables["batch_stats"])
    opt = optax.sgd(train_resnet.LR, momentum=train_resnet.MOMENTUM)
    state = opt.init(params)

    def loss_fn(p, stats):
        logits, mutated = jm.apply({"params": p, "batch_stats": stats},
                                   jnp.asarray(x), train=True,
                                   mutable=["batch_stats"])
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(y)).mean(), mutated["batch_stats"]

    topt = thvd.DistributedOptimizer(
        torch.optim.SGD(tm.parameters(), lr=train_resnet.LR,
                        momentum=train_resnet.MOMENTUM),
        named_parameters=tm.named_parameters())
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    for _ in range(2):
        (jl, stats), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            params, stats)
        updates, state = opt.update(grads, state, params)
        params = optax.apply_updates(params, updates)
        tl = train_resnet.train_step(tm, topt, tx, ty)
        _close(tl.item(), float(jl), dtype, "loss")
    assert thvd.overlap_plan()["reason"].startswith("width-1 bypass")
    got = convert.to_flax(tm.state_dict(), tm)
    for coll, want in (("params", params), ("batch_stats", stats)):
        got_leaves = dict(_leaves(got[coll]))
        for path, w in _leaves(jax.tree_util.tree_map(np.asarray, want)):
            _close(got_leaves[path], w, dtype, f"{coll}/{'/'.join(path)}")


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_mnist_cnn_matches_flax(dtype):
    jdt, tdt = DTYPES[dtype]
    tm = tmnist.MnistCNN(dtype=tdt, device="cpu")
    variables = convert.init_variables(tm, seed=5)
    tm.load_state_dict(convert.from_flax(variables, tm))
    x = _images(b=3, size=28, c=1, seed=6)
    jlogits = jmnist.MnistCNN(dtype=jdt).apply(
        jax.tree_util.tree_map(jnp.asarray, variables), jnp.asarray(x))
    with torch.no_grad():
        tlogits = tm(torch.from_numpy(x))
    assert tlogits.dtype == torch.float32
    _close(tlogits.numpy(), np.asarray(jlogits, np.float32), dtype, "logits")


def test_mnist_mlp_matches_flax():
    tm = tmnist.MnistMLP(device="cpu")
    variables = convert.init_variables(tm, seed=7)
    tm.load_state_dict(convert.from_flax(variables, tm))
    x = _images(b=3, size=28, c=1, seed=8)
    jlogits = jmnist.MnistMLP().apply(
        jax.tree_util.tree_map(jnp.asarray, variables), jnp.asarray(x))
    with torch.no_grad():
        tlogits = tm(torch.from_numpy(x))
    _close(tlogits.numpy(), np.asarray(jlogits), "f32", "logits")


def _flax_variables(name):
    """Variables made by the JAX package's own init, and the port's model
    of the same architecture."""
    key = jax.random.PRNGKey(0)
    if name == "mnist_cnn":
        jm, tm, x = jmnist.MnistCNN(), tmnist.MnistCNN(device="cpu"), \
            jnp.zeros((1, 28, 28, 1))
    elif name == "mnist_mlp":
        jm, tm, x = jmnist.MnistMLP(hidden=32), \
            tmnist.MnistMLP(hidden=32, device="cpu"), jnp.zeros((1, 28, 28, 1))
    else:
        jblock, tblock = BLOCKS[name]
        jm = jres.ResNet(stage_sizes=[1, 1], block_cls=jblock,
                         num_classes=10, num_filters=8)
        tm = tres.ResNet(stage_sizes=[1, 1], block_cls=tblock,
                         num_classes=10, num_filters=8, device="cpu")
        x = jnp.zeros((1, 32, 32, 3))
    variables = jax.tree_util.tree_map(np.asarray, dict(jm.init(key, x)))
    return tm, variables


@pytest.mark.parametrize("name", ["bottleneck", "basic", "mnist_cnn",
                                  "mnist_mlp"])
def test_converter_round_trips(name):
    tm, variables = _flax_variables(name)
    sd = convert.from_flax(variables, tm)
    assert sd.keys() == tm.state_dict().keys()
    tm.load_state_dict(sd)
    back = convert.to_flax(tm.state_dict(), tm)
    want = dict(_leaves({k: variables[k] for k in back}))
    got = dict(_leaves(back))
    assert got.keys() == want.keys()
    for path, w in want.items():
        assert got[path].shape == w.shape and np.array_equal(got[path], w), \
            path


def test_resnet50_layout_and_seeded_init():
    tm = tres.ResNet50(device="cpu", dtype=torch.float32)
    params = list(tm.parameters())
    assert len(params) == 161 and sum(p.numel() for p in params) == 25557032
    a, b = convert.init_state(tm, 3), convert.init_state(tm, 3)
    assert all(torch.equal(a[k], b[k]) for k in a)
    # The last BatchNorm scale of each block starts at zero.
    for i, block in enumerate(tm.blocks):
        assert torch.all(a[f"blocks.{i}.norms.2.scale"] == 0)
        assert torch.all(a[f"blocks.{i}.norms.0.scale"] == 1)
    assert not torch.equal(a["conv_init.weight"],
                           convert.init_state(tm, 4)["conv_init.weight"])


def test_train_resnet_trains_a_small_resnet_on_one_cpu(world1):
    model, opt = train_resnet.make_trainer(
        "cpu", stage_sizes=(1, 1), num_filters=8, num_classes=10,
        dtype=torch.float32)
    x, y = train_resnet.synthetic_batch(4, "cpu", image=32, num_classes=10)
    losses = [float(train_resnet.train_step(model, opt, x, y))
              for _ in range(4)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    plan = thvd.overlap_plan()
    assert (plan["planner"], plan["chained"], plan["width"]) == \
        ("adaptive", False, 1)
    assert not opt._hooks   # the bypass registers no hook
