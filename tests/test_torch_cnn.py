"""Port's VGG and Inception V3 against the JAX package's flax models, on
the same numpy inputs and converted weights: logits, the new
``batch_stats``, one SGD-momentum step, the converter, parameter counts
and the channel progression of ``tests/test_models.py``.

Tolerances are ``tests/test_torch_resnet.py``'s: float32, max |Δ| ≤
1e-4·max|ref|; bfloat16, relative L2 ≤ 0.02.  One exception, measured and
not assumed: Inception V3 in training mode at its full depth (94
BatchNorms, each normalising by its batch's statistics) is as sensitive to
rounding as it is to its input.  The JAX model's own logits move by ~2e-4
of their size when its input moves by one part in 10⁷, so no second
implementation can agree with it to 1e-4 in float32 there, nor to 2% in
bfloat16; VGG-16 with BatchNorm's step has the same sensitivity.  Their
training-mode comparisons (float32) are held instead against the flax
model run in float64, to a few times the flax float32 model's own error
there (:func:`_as_accurate_as_flax`); every Inception block is held alone
at the standard tolerances, in both dtypes and both modes, and the whole
model in evaluation mode too."""

import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from horovod_tpu.models import inception as jinc
from horovod_tpu.models import vgg as jvgg
from horovod_tpu_torch import train_synthetic
from horovod_tpu_torch.models import convert
from horovod_tpu_torch.models import inception as tinc
from horovod_tpu_torch.models import resnet as tres
from horovod_tpu_torch.models import vgg as tvgg

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
# The training-mode comparisons of the deep BatchNorm models may be this
# many times the flax float32 model's own error against its float64 self.
# PyTorch's float32 CPU arithmetic sits further from the float64 answer
# than XLA's: VGG-16-BN's step is 18× flax's error there (2.65e-4 against
# 1.45e-5 relative L2), while the port run in float64 is within 2e-7 of
# flax in float64, so the two compute the same function.
REF_FACTOR = 32.0


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads for this file's CPU work, as the suite runs it:
    several workers share the host's cores.  The worker's setting is put
    back after the file."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


def _close(got, want, dtype, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.isfinite(got).all(), what
    if dtype == "f32":
        err = np.abs(got - want).max() if got.size else 0.0
        assert err <= 1e-4 * np.abs(want).max(), (what, err)
    else:
        assert _rel_l2(got, want) <= 0.02, (what, _rel_l2(got, want))


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    else:
        yield prefix, np.asarray(tree)


def _perturb(variables, seed):
    """Every BatchNorm's scale, bias and running statistics moved off their
    init, so no branch is trivial and evaluation reads real statistics."""
    rng = np.random.default_rng(seed)

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


def _images(b, size, seed=2):
    return np.random.default_rng(seed).standard_normal(
        (b, size, size, 3)).astype(np.float32)


def _load(tm, variables):
    tm.load_state_dict(convert.from_flax(variables, tm))
    return tm


def _apply(jm, variables, x, train):
    """The flax model's output (and new ``batch_stats`` when it has them
    and trains)."""
    jvars = jax.tree_util.tree_map(jnp.asarray, variables)
    if train and "batch_stats" in variables:
        out, mutated = jm.apply(jvars, jnp.asarray(x), train=True,
                                mutable=["batch_stats"])
        return out, mutated["batch_stats"]
    return jm.apply(jvars, jnp.asarray(x), train=train), \
        variables.get("batch_stats")


# -- VGG ----------------------------------------------------------------------

def _vgg_pair(batch_norm, dtype, seed=0, perturb=None):
    """Both VGG-16s on one seeded init; ``perturb`` (by default with
    BatchNorm) moves every bias, scale and running statistic off it."""
    jdt, tdt = DTYPES[dtype]
    jm = jvgg.VGG16(num_classes=10, dtype=jdt, batch_norm=batch_norm,
                    dropout_rate=0.0)
    tm = tvgg.VGG16(num_classes=10, dtype=tdt, batch_norm=batch_norm,
                    dropout_rate=0.0, image_size=32, device="cpu")
    variables = convert.init_variables(tm, seed)
    if batch_norm if perturb is None else perturb:
        _perturb(variables, seed + 1)
    return jm, _load(tm, variables), variables


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("batch_norm", [False, True])
def test_vgg16_forward_and_batch_stats_match_flax(batch_norm, dtype, train):
    jm, tm, variables = _vgg_pair(batch_norm, dtype)
    x = _images(4, 32)
    jlogits, want_stats = _apply(jm, variables, x, train)
    with torch.no_grad():
        tlogits = tm(torch.from_numpy(x), train=train)
    assert tlogits.dtype == torch.float32 and tlogits.shape == (4, 10)
    _close(tlogits.numpy(), np.asarray(jlogits, np.float32), dtype, "logits")
    got = convert.to_flax(tm.state_dict(), tm)
    assert ("batch_stats" in got) == batch_norm
    if batch_norm:
        got_leaves = dict(_leaves(got["batch_stats"]))
        for path, w in _leaves(want_stats):
            _close(got_leaves[path], w, dtype, "/".join(path))


def _flax_step(jm, variables, x, loss_of):
    """flax's loss, the update of one optax SGD-momentum step (the first:
    ``-lr`` times the gradient) and the new batch statistics, as a dict of
    numpy trees."""
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    stats = jax.tree_util.tree_map(jnp.asarray,
                                   variables.get("batch_stats", {}))

    def loss_fn(p, x):
        if stats:
            out, mutated = jm.apply({"params": p, "batch_stats": stats}, x,
                                    train=True, mutable=["batch_stats"])
            return loss_of(out), mutated["batch_stats"]
        return loss_of(jm.apply({"params": p}, x, train=True)), stats

    (loss, new_stats), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(params, jnp.asarray(x))
    opt = optax.sgd(train_synthetic.LR, momentum=train_synthetic.MOMENTUM)
    updates, _ = opt.update(grads, opt.init(params), params)
    return jax.tree_util.tree_map(np.asarray, {
        "loss": loss, "update": updates, "batch_stats": new_stats})


def _port_step(tm, x, y) -> dict:
    """The same through ``train_synthetic.train_step`` (SGD 0.01, momentum
    0.9, ``DistributedOptimizer`` at world 1), in flax's layout."""
    import horovod_tpu_torch as thvd

    before = convert.to_flax(tm.state_dict(), tm)
    opt = thvd.DistributedOptimizer(
        torch.optim.SGD(tm.parameters(), lr=train_synthetic.LR,
                        momentum=train_synthetic.MOMENTUM),
        named_parameters=tm.named_parameters())
    loss = train_synthetic.train_step(tm, opt, torch.from_numpy(x),
                                      torch.from_numpy(y))
    after = convert.to_flax(tm.state_dict(), tm)
    return {"loss": np.asarray(loss.item()),
            "update": jax.tree_util.tree_map(np.subtract, after["params"],
                                             before["params"]),
            "batch_stats": after.get("batch_stats", {})}


def _in_f64(make_jm, fn, variables, x):
    """``fn(model, variables, x)`` on the flax model in float64 (compute,
    parameters and input), as numpy: the reference's own exact answer."""
    with jax.enable_x64(True):
        v64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                                     variables)
        return jax.tree_util.tree_map(
            np.asarray, fn(make_jm(jnp.float64), v64, x.astype(np.float64)))


def _as_accurate_as_flax(got, want32, want64):
    """Every leaf of the port's float32 answer ``got`` (a dict of trees)
    within REF_FACTOR times the flax float32 answer's own largest error
    against the float64 one, relative L2, and never worse than 1e-4."""
    flat = lambda t: dict(_leaves(t))  # noqa: E731
    g, w32, w64 = flat(got), flat(want32), flat(want64)
    assert g.keys() == w64.keys()
    ref = max(_rel_l2(w32[k], w64[k]) for k in w64)
    bound = max(1e-4, REF_FACTOR * ref)
    for k, w in w64.items():
        assert _rel_l2(g[k], w) <= bound, ("/".join(k), _rel_l2(g[k], w),
                                           ref)
    return ref


def _step_pairs(got, want):
    """``(what, got leaf, want leaf)`` over the loss, every parameter's
    update and every batch statistic."""
    for coll in want:
        got_leaves = dict(_leaves(got[coll]))
        for path, w in _leaves(want[coll]):
            yield "/".join((coll,) + path), got_leaves[path], w


def _ce(y):
    return lambda logits: optax.softmax_cross_entropy_with_integer_labels(
        logits, jnp.asarray(y)).mean()


@pytest.fixture()
def world1(monkeypatch):
    import horovod_tpu_torch as thvd

    for name in ("RANK", "WORLD_SIZE", "JAX_PROCESS_ID", "JAX_NUM_PROCESSES",
                 "JAX_COORDINATOR_ADDRESS", "MASTER_ADDR", "MASTER_PORT",
                 "HOROVOD_OVERLAP_BUCKETS", "HVD_TPU_OVERLAP_BUCKETS"):
        monkeypatch.delenv(name, raising=False)
    thvd.init(device="cpu")
    yield thvd
    thvd.shutdown()


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_vgg16_sgd_step_matches_optax(world1, dtype):
    # One step of the plain VGG-16 at the standard tolerances.  (A second
    # step's gradients move by ~0.5% when the first step's parameters move
    # by 2e-6, as a few ReLU inputs that sit at zero change sides, in
    # either package.)  The biases are perturbed off their zero init, so
    # each parameter, not only its update, is held.
    jm, tm, variables = _vgg_pair(False, dtype, perturb=True)
    x = _images(4, 32)
    y = np.random.default_rng(4).integers(0, 10, 4)
    before = jax.tree_util.tree_map(np.copy, variables["params"])
    want = _flax_step(jm, variables, x, _ce(y))
    got = _port_step(tm, x, y)
    _close(got["loss"], want["loss"], dtype, "loss")
    after = convert.to_flax(tm.state_dict(), tm)["params"]
    for path, w in _leaves(jax.tree_util.tree_map(np.add, before,
                                                  want["update"])):
        _close(dict(_leaves(after))[path], w, dtype, "/".join(path))


def test_vgg16_bn_sgd_step_is_as_accurate_as_flax(world1):
    # With a BatchNorm after every convolution, training-mode gradients
    # carry the sensitivity the module docstring measures: the step is
    # held against flax's float64 step, to REF_FACTOR times flax's own
    # float32 error.
    jm, tm, variables = _vgg_pair(True, "f32")
    x = _images(4, 32)
    y = np.random.default_rng(4).integers(0, 10, 4)

    def step(jm, v, xs):
        return _flax_step(jm, v, xs, _ce(y))

    want64 = _in_f64(lambda dt: jvgg.VGG16(
        num_classes=10, dtype=dt, batch_norm=True, dropout_rate=0.0),
        step, variables, x)
    _as_accurate_as_flax(_port_step(tm, x, y), step(jm, variables, x),
                         want64)


def test_vgg_dropout_draws_from_the_generator_and_only_in_training():
    x = torch.ones(4, 4096)
    gen = lambda: torch.Generator().manual_seed(3)  # noqa: E731
    a = tvgg.dropout(x, 0.5, True, gen())
    b = tvgg.dropout(x, 0.5, True, gen())
    assert torch.equal(a, b)                       # the seed's mask
    kept = a != 0
    assert torch.all(a[kept] == 2.0)               # scaled by 1/(1 - rate)
    assert 0.45 < kept.float().mean().item() < 0.55
    assert torch.equal(tvgg.dropout(x, 0.5, False, None), x)
    assert torch.equal(tvgg.dropout(x, 0.0, True, None), x)
    with pytest.raises(ValueError, match="generator"):
        tvgg.dropout(x, 0.5, True, None)
    # Through the model: two calls with one seed agree, eval is
    # deterministic without a generator.
    tm = tvgg.VGG16(num_classes=10, dtype=torch.float32, image_size=32,
                    device="cpu")
    tm.load_state_dict(convert.init_state(tm, 0))
    xs = torch.from_numpy(_images(2, 32))
    with torch.no_grad():
        assert torch.equal(tm(xs, train=True, generator=gen()),
                           tm(xs, train=True, generator=gen()))
        assert not torch.equal(tm(xs, train=True, generator=gen()),
                               tm(xs, train=False))


# -- Inception V3 -------------------------------------------------------------

def _inception_pair(dtype, aux, size, seed=0, perturb=False):
    jdt, tdt = DTYPES[dtype]
    jm = jinc.InceptionV3(num_classes=10, dtype=jdt, aux_logits=aux)
    tm = tinc.InceptionV3(num_classes=10, dtype=tdt, aux_logits=aux,
                          image_size=size, device="cpu")
    variables = convert.init_variables(tm, seed)
    if perturb:
        _perturb(variables, seed + 1)
    return jm, _load(tm, variables), variables


@pytest.mark.parametrize("aux,dtype", [(False, "f32"), (False, "bf16"),
                                       (True, "f32")])
def test_inception_eval_logits_match_flax(aux, dtype):
    size = 107 if aux else 75
    jm, tm, variables = _inception_pair(dtype, aux, size, perturb=True)
    x = _images(2, size)
    jlogits, _ = _apply(jm, variables, x, train=False)
    with torch.no_grad():
        tlogits = tm(torch.from_numpy(x), train=False)
    # Evaluation returns the bare logits, with the aux head or without.
    assert torch.is_tensor(tlogits) and tlogits.shape == (2, 10)
    _close(tlogits.numpy(), np.asarray(jlogits, np.float32), dtype, "logits")


# (block, index in the port's ``blocks``, NHWC input shape):
# the first block of each kind at the 299 grid's widths, on small grids.
_BLOCKS = [("InceptionA", 0, (2, 9, 9, 192)),
           ("ReductionA", 3, (2, 9, 9, 288)),
           ("InceptionC", 4, (2, 7, 7, 768)),
           ("ReductionB", 8, (2, 7, 7, 768)),
           ("InceptionE", 9, (2, 4, 4, 1280))]


def _flax_block(kind, train, jdt):
    conv = functools.partial(fnn.Conv, use_bias=False, dtype=jdt)
    norm = functools.partial(fnn.BatchNorm, use_running_average=not train,
                             momentum=0.9, epsilon=1e-3, dtype=jdt)
    args = {"InceptionA": (32,), "InceptionC": (128,)}.get(kind, ())
    return getattr(jinc, kind)(*args, conv, norm)


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("kind,index,shape", _BLOCKS,
                         ids=[b[0] for b in _BLOCKS])
def test_inception_block_matches_flax(kind, index, shape, dtype, train):
    jdt, tdt = DTYPES[dtype]
    _, tm, variables = _inception_pair(dtype, False, 75, perturb=True)
    block = tm.blocks[index]
    assert type(block).__name__ == kind
    name = f"{kind}_0"
    bvars = {"params": variables["params"][name],
             "batch_stats": variables["batch_stats"][name]}
    x = np.random.default_rng(7).standard_normal(shape).astype(np.float32)
    jvars = jax.tree_util.tree_map(jnp.asarray, bvars)
    if train:
        jout, mutated = _flax_block(kind, train, jdt).apply(
            jvars, jnp.asarray(x), mutable=["batch_stats"])
        jstats = mutated["batch_stats"]
    else:
        jout = _flax_block(kind, train, jdt).apply(jvars, jnp.asarray(x))
        jstats = bvars["batch_stats"]
    with torch.no_grad():
        tout = block(torch.from_numpy(x).to(tdt).permute(0, 3, 1, 2), train)
    assert tout.dtype == tdt
    _close(tout.permute(0, 2, 3, 1).float().numpy(),
           np.asarray(jout, np.float32), dtype, f"{kind} out")
    got = dict(_leaves(convert.to_flax(tm.state_dict(), tm)[
        "batch_stats"][name]))
    for path, w in _leaves(jstats):
        _close(got[path], w, dtype, f"{kind}/{'/'.join(path)}")


def _forward(jm, variables, x):
    """flax's training-mode logits (and aux) and new batch statistics."""
    out, stats = _apply(jm, variables, x, True)
    outs = {"logits": out[0], "aux": out[1]} if isinstance(out, tuple) \
        else {"logits": out}
    return {**outs, "batch_stats": stats}


@pytest.mark.parametrize("aux", [False, True])
def test_inception_train_logits_and_stats_are_as_accurate_as_flax(aux):
    size = 107 if aux else 75
    jm, tm, variables = _inception_pair("f32", aux, size)
    x = _images(2, size)
    want64 = _in_f64(lambda dt: jinc.InceptionV3(
        num_classes=10, dtype=dt, aux_logits=aux), _forward, variables, x)
    with torch.no_grad():
        out = tm(torch.from_numpy(x), train=True)
    assert isinstance(out, tuple) == aux
    outs = {"logits": out[0], "aux": out[1]} if aux else {"logits": out}
    got = {**{k: v.numpy() for k, v in outs.items()},
           "batch_stats": convert.to_flax(tm.state_dict(), tm)[
               "batch_stats"]}
    assert got["logits"].shape == (2, 10)
    _as_accurate_as_flax(got, _forward(jm, variables, x), want64)
    # The stem's statistics sit before the sensitivity builds up: they
    # meet the standard float32 tolerance.
    for j in range(5):
        for k in ("mean", "var"):
            path = (f"BatchNorm_{j}", k)
            _close(got["batch_stats"][path[0]][k],
                   want64["batch_stats"][path[0]][k], "f32", "/".join(path))


def test_inception_sgd_step_with_the_aux_head_is_as_accurate_as_flax(
        world1):
    # The reference's slim recipe: head + 0.4 · aux, as train_step takes
    # it; held, as the whole model in training mode is, against flax's
    # float64 step to REF_FACTOR times flax's own float32 error.
    jm, tm, variables = _inception_pair("f32", True, 107)
    x = _images(2, 107)
    y = np.random.default_rng(4).integers(0, 10, 2)
    ce = _ce(y)

    def step(jm, v, xs):
        return _flax_step(jm, v, xs, lambda out: ce(out[0])
                          + train_synthetic.AUX_WEIGHT * ce(out[1]))

    want64 = _in_f64(lambda dt: jinc.InceptionV3(
        num_classes=10, dtype=dt, aux_logits=True), step, variables, x)
    _as_accurate_as_flax(_port_step(tm, x, y), step(jm, variables, x),
                         want64)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_avg_pool_same_counts_the_padded_cells_as_flax(dtype):
    jdt, tdt = DTYPES[dtype]
    x = np.random.default_rng(9).standard_normal((2, 5, 6, 3)).astype(
        np.float32)
    want = fnn.avg_pool(jnp.asarray(x, jdt), (3, 3), strides=(1, 1),
                        padding="SAME")
    got = tinc._avg_pool_same(torch.from_numpy(x).to(tdt).permute(0, 3, 1, 2))
    _close(got.permute(0, 2, 3, 1).float().numpy(),
           np.asarray(want, np.float32), dtype, "avg_pool")
    # A corner cell averages 4 real cells over 9.
    ones = torch.ones(1, 1, 4, 4)
    assert tinc._avg_pool_same(ones)[0, 0, 0, 0].item() == pytest.approx(
        4 / 9)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("eps", [1e-5, 1e-3])
def test_batchnorm_eps_matches_flax(dtype, eps):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(3)
    # A small variance (1e-2), where eps weighs.
    x = (0.1 * rng.standard_normal((4, 5, 5, 6))).astype(np.float32)
    stats = {"mean": rng.normal(size=6).astype(np.float32),
             "var": rng.uniform(0.5, 2, 6).astype(np.float32)}
    params = {"scale": rng.normal(size=6).astype(np.float32),
              "bias": rng.normal(size=6).astype(np.float32)}
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=eps,
                       dtype=jdt)
    jy, mutated = bn.apply({"params": params, "batch_stats": stats},
                           jnp.asarray(x, jdt), mutable=["batch_stats"])
    tbn = tres.BatchNorm(6, tdt, device="cpu", eps=eps)
    tbn.load_state_dict({k: torch.from_numpy(v) for k, v in
                         {**params, **stats}.items()})
    ty = tbn(torch.from_numpy(x).to(tdt).permute(0, 3, 1, 2), train=True)
    _close(ty.permute(0, 2, 3, 1).float().detach().numpy(),
           np.asarray(jy, np.float32), dtype, "y")
    for k in ("mean", "var"):
        _close(getattr(tbn, k).numpy(), mutated["batch_stats"][k], "f32", k)
    assert tres.BatchNorm(6, device="cpu").eps == 1e-5
    assert tinc.ConvBNReLU(3, 6, (1, 1), dtype=tdt, process_group=None,
                           device="cpu").norm.eps == 1e-3


# -- sizes, layout, converter -------------------------------------------------

def _jax_count(jm, size, train=False):
    v = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                       jnp.ones((1, size, size, 3)),
                                       train=train))
    return {c: sum(int(np.prod(a.shape)) for a in jax.tree_util.tree_leaves(
        v[c])) for c in v}


@pytest.mark.parametrize("name", ["VGG16", "VGG19", "VGG16_bn", "Inception",
                                  "Inception_aux"])
def test_parameter_counts_match_flax(name):
    if name.startswith("VGG"):
        bn = name.endswith("_bn")
        cls = name.split("_")[0]
        jm = getattr(jvgg, cls)(batch_norm=bn)
        tm = getattr(tvgg, cls)(batch_norm=bn, device="meta")
        want = _jax_count(jm, 224)
    else:
        aux = name.endswith("aux")
        jm = jinc.InceptionV3(aux_logits=aux)
        tm = tinc.InceptionV3(aux_logits=aux, device="meta")
        want = _jax_count(jm, 299, train=True)
    assert sum(p.numel() for p in tm.parameters()) == want["params"]
    assert sum(b.numel() for b in tm.buffers()) == want.get("batch_stats", 0)
    if name == "VGG16":
        assert want["params"] == 138357544
        # 13 convs + 2 FC + head = 16 weight layers: the "16" in VGG-16.
        assert len(convert._flax_layout(tm)) == 2 * 16
    if name == "Inception":
        assert want["params"] == 23834568


def test_inception_channel_progression():
    # The canonical grids: 35×35×256/288, 17×17×768, 8×8×2048 at 299.
    tm = tinc.InceptionV3(num_classes=10, device="meta")
    seen = []
    for block in tm.blocks:
        block.register_forward_hook(
            lambda m, i, o: seen.append((type(m).__name__,
                                         tuple(o.shape[1:]))))
    out = tm(torch.ones(1, 299, 299, 3, device="meta"), train=False)
    assert out.shape == (1, 10)
    assert seen[0] == ("InceptionA", (256, 35, 35))
    assert seen[2] == ("InceptionA", (288, 35, 35))
    assert seen[7] == ("InceptionC", (768, 17, 17))
    assert seen[-1] == ("InceptionE", (2048, 8, 8))
    assert tinc.grid_17(299) == 17
    with pytest.raises(ValueError, match="aux head"):
        tinc.InceptionV3(aux_logits=True, image_size=75, device="meta")


@pytest.mark.parametrize("name", ["vgg16", "vgg16_bn", "inception",
                                  "inception_aux"])
def test_converter_round_trips(name):
    # The converter's flax tree has exactly the paths and shapes of flax's
    # own init; the port's seeded init goes there and back unchanged.
    if name.startswith("vgg"):
        bn = name.endswith("_bn")
        jm = jvgg.VGG16(num_classes=10, batch_norm=bn)
        tm = tvgg.VGG16(num_classes=10, batch_norm=bn, image_size=32,
                        device="cpu")
        size, train = 32, False
    else:
        aux = name.endswith("aux")
        size, train = (107 if aux else 75), True
        jm = jinc.InceptionV3(num_classes=10, aux_logits=aux)
        tm = tinc.InceptionV3(num_classes=10, aux_logits=aux,
                              image_size=size, device="cpu")
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, size, size, 3)), train=train))
    variables = convert.init_variables(tm, 3)
    want = {p: tuple(a.shape) for p, a in _leaves(
        jax.tree_util.tree_map(lambda a: np.empty(a.shape, np.int8),
                               dict(shapes)))}
    assert {p: a.shape for p, a in _leaves(variables)} == want
    sd = convert.from_flax(variables, tm)
    assert sd.keys() == tm.state_dict().keys()
    tm.load_state_dict(sd)
    back = convert.to_flax(tm.state_dict(), tm)
    got = dict(_leaves(back))
    for path, w in _leaves(variables):
        assert np.array_equal(got[path], w), path
    a, b = convert.init_state(tm, 3), convert.init_state(tm, 3)
    assert all(torch.equal(a[k], b[k]) for k in a)
