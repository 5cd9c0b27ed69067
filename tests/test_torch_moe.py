"""The port's expert parallelism and MoE decoder against the JAX package's
on the same numpy inputs.

The JAX side runs as ``tests/test_expert.py`` and ``tests/test_moe_model.py``
run it: ``shard_map`` over an ``ep`` axis of 4 of the suite's virtual CPU
devices, one expert a device, each expert's weights taken out with
``out_specs=P("ep")``.  Those weights are carried into the port on 4 gloo
processes, one expert a rank: the expert layer's tanh experts directly,
the decoder's parameters through ``models/convert.py``.  Outputs are held
to JAX's at the JAX tests' tolerance (1e-5; the decoder's losses and
gradients 1e-4), the routing plan bit for bit, and the port's gradients
to its own finite differences at the JAX tests' tolerances.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from horovod_tpu.models import Transformer as JTransformer
from horovod_tpu.models import TransformerConfig as JConfig
from horovod_tpu.parallel import (expert_init_rng, expert_parallel_moe,
                                  moe_grad_sync, switch_route)
from test_torch_tensor_parallel import run_gloo

E, D, H, T_LOCAL = 4, 8, 16, 6
MODEL = dict(vocab_size=64, num_heads=2, head_dim=8, embed_dim=16,
             mlp_dim=32)


def _mesh():
    return Mesh(np.array(jax.devices()[:E]), ("ep",))


def _expert_jax(params, h):
    w1, w2 = params
    return jnp.tanh(h @ w1) @ w2


def _expert_torch(params, h):
    w1, w2 = params
    return torch.tanh(h @ w1) @ w2


def _layer_inputs():
    router = np.asarray(jax.random.normal(jax.random.PRNGKey(5), (D, E)))
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(6),
                                     (E * T_LOCAL, D)))
    funnel = np.zeros((D, E), np.float32)
    funnel[:, 0] = 1.0
    x_abs = np.abs(np.asarray(jax.random.normal(jax.random.PRNGKey(2),
                                                (E * T_LOCAL, D))))
    return router, x, funnel, x_abs


def jax_layer():
    """The JAX layer's experts and outputs (capacity factor 1.0 and 0.5,
    and the funnelling router at 0.5)."""
    router, x, funnel, x_abs = _layer_inputs()

    def run(x_local, x_abs_local):
        rng = expert_init_rng(jax.random.PRNGKey(0), "ep")
        w1 = jax.random.normal(rng, (D, H)) * 0.3
        w2 = jax.random.normal(jax.random.fold_in(rng, 1), (H, D)) * 0.3
        outs = tuple(expert_parallel_moe(_expert_jax, (w1, w2),
                                         jnp.asarray(router), x_local,
                                         capacity_factor=cf)
                     for cf in (1.0, 0.5))
        drop = expert_parallel_moe(_expert_jax, (w1, w2),
                                   jnp.asarray(funnel), x_abs_local,
                                   capacity_factor=0.5)
        return outs, drop, (w1, w2)

    outs, drop, (w1, w2) = jax.jit(jax.shard_map(
        run, mesh=_mesh(), in_specs=(P("ep"), P("ep")),
        out_specs=((P("ep"), P("ep")), P("ep"), (P("ep"), P("ep"))),
        check_vma=False))(jnp.asarray(x), jnp.asarray(x_abs))
    return ([np.asarray(o) for o in outs], np.asarray(drop),
            np.asarray(w1).reshape(E, D, H), np.asarray(w2).reshape(E, H, D))


def _cfg(**kw):
    return JConfig(**MODEL, num_layers=kw.pop("num_layers", 2),
                   dtype=jnp.float32, moe_axis="ep", moe_capacity_factor=2.0,
                   **kw)


def _tokens(sharded):
    if sharded:
        return np.random.RandomState(0).randint(0, 64, (E * 2, 8))
    return np.ones((2, 8), np.int32)


def jax_model(num_layers, sharded):
    """Each device's initial parameters (numpy trees), the pmean-ed loss,
    each device's gradients after ``moe_grad_sync`` and its parameters
    after one SGD(0.1) step of them."""
    model = JTransformer(_cfg(num_layers=num_layers))
    opt = optax.sgd(0.1)

    def step(tokens):
        params = model.init(jax.random.PRNGKey(0), tokens)

        def loss_fn(p):
            logits = model.apply(p, tokens)
            return jax.lax.pmean(
                optax.softmax_cross_entropy_with_integer_labels(
                    logits[:, :-1], tokens[:, 1:]).mean(), "ep")

        loss, grads = jax.value_and_grad(loss_fn)(params)
        grads = moe_grad_sync(grads, "ep")
        updates, _ = opt.update(grads, opt.init(params), params)
        return loss, params, grads, optax.apply_updates(params, updates)

    spec = P("ep") if sharded else P()
    loss, params, grads, new = jax.jit(jax.shard_map(
        step, mesh=_mesh(), in_specs=spec,
        out_specs=(P(), P("ep"), P("ep"), P("ep")), check_vma=False))(
            jnp.asarray(_tokens(sharded)))

    def per_device(tree):
        return [jax.tree.map(
            lambda a: np.asarray(a).reshape((E, -1) + a.shape[1:])[r],
            tree) for r in range(E)]

    return float(loss), per_device(params), per_device(grads), \
        per_device(new)


def _port_model(num_layers, tree):
    import torch.distributed as dist

    from horovod_tpu_torch.models import convert
    from horovod_tpu_torch.models.transformer import (Transformer,
                                                      TransformerConfig)

    cfg = TransformerConfig(**MODEL, num_layers=num_layers,
                            dtype=torch.float32, moe_axis=dist.group.WORLD,
                            moe_capacity_factor=2.0)
    model = Transformer(cfg, device="cpu")
    model.load_state_dict(convert.params_from_flax(tree, cfg))
    return model


def _local_loss(model, tokens):
    from horovod_tpu_torch.ops.losses import softmax_cross_entropy

    logits = model(tokens)
    return softmax_cross_entropy(logits[:, :-1], tokens[:, 1:]).mean()


def _global_loss(model, tokens):
    from horovod_tpu_torch.parallel.common import all_reduce

    with torch.no_grad():
        return float(all_reduce(_local_loss(model, tokens)) / E)


def _worker(rank, n, w1s, w2s, trees2, trees1, v_router, v_gates):
    from horovod_tpu_torch import parallel as par
    from horovod_tpu_torch.parallel.common import all_reduce

    out = {}
    router, x, funnel, x_abs = _layer_inputs()
    mine = slice(rank * T_LOCAL, (rank + 1) * T_LOCAL)
    xl = torch.tensor(x[mine])
    params = (torch.tensor(w1s[rank]), torch.tensor(w2s[rank]))
    out["outs"] = [par.expert_parallel_moe(
        _expert_torch, params, torch.tensor(router), xl,
        capacity_factor=cf) for cf in (1.0, 0.5)]
    out["route"] = [par.switch_route(xl, torch.tensor(router), E, c)
                    for c in (1, 3)]
    par.reset_moe_stats()
    out["drop"] = par.expert_parallel_moe(
        _expert_torch, params, torch.tensor(funnel),
        torch.tensor(x_abs[mine]), capacity_factor=0.5)
    out["moe_stats"] = par.moe_stats()

    # Directional derivative of sum over ranks of sum(out ** 2) along a
    # shared perturbation v of every expert's w1, against differences.
    v = torch.tensor(np.asarray(jax.random.normal(
        jax.random.PRNGKey(9), (D, H))))

    def total(s, grad=False):
        w1 = (params[0] + s * v).requires_grad_(grad)
        y = par.expert_parallel_moe(_expert_torch, (w1, params[1]),
                                    torch.tensor(router), xl)
        loss = (y ** 2).sum()
        if grad:
            loss.backward()
            return float(all_reduce((w1.grad * v).sum().detach()))
        return float(all_reduce(loss.detach()))

    eps = 1e-3
    out["fd"] = (total(0.0, grad=True),
                 (total(eps) - total(-eps)) / (2 * eps))

    # The decoder: replicated tokens (loss, synced gradients) ...
    model = _port_model(2, trees2[rank])
    tokens = torch.tensor(_tokens(False)).long()
    loss = _local_loss(model, tokens)
    loss.backward()
    par.moe_grad_sync(model.named_parameters())
    out["loss"] = float(all_reduce(loss.detach()) / E)
    out["grads"] = {k: p.grad.clone() for k, p in model.named_parameters()}
    gate = model.layers[0].moe_mlp.gate.detach().clone()
    out["gate"] = gate

    # ... and one SGD step on data-sharded tokens.
    model = _port_model(2, trees2[rank])
    rows = torch.tensor(_tokens(True)[rank * 2:(rank + 1) * 2]).long()
    _local_loss(model, rows).backward()
    par.moe_grad_sync(model.named_parameters())
    with torch.no_grad():
        for p in model.parameters():
            p -= 0.1 * p.grad
    out["stepped"] = {k: p.detach().clone()
                      for k, p in model.state_dict().items()}

    # moe_grad_sync's gradients against finite differences of the mean
    # loss: the router (shared, one v) and an expert's gate (v a rank).
    out["sync_fd"] = {}
    for name, vv, eps, expert in (
            ("layers.0.moe_mlp.router", v_router, 2e-4, False),
            ("layers.0.moe_mlp.gate", v_gates[rank], 1e-2, True)):
        vv = torch.tensor(vv)
        model = _port_model(1, trees1[rank])
        _local_loss(model, rows).backward()
        par.moe_grad_sync(model.named_parameters())
        g = dict(model.named_parameters())[name].grad
        gdot = float((g * vv).sum())
        if expert:
            gdot = float(all_reduce(torch.tensor(gdot)))
        losses = []
        for s in (eps, -eps):
            model = _port_model(1, trees1[rank])
            with torch.no_grad():
                dict(model.named_parameters())[name].add_(s * vv)
            losses.append(_global_loss(model, rows))
        out["sync_fd"][name] = (gdot, (losses[0] - losses[1]) / (2 * eps))
    return out


_RUNS: dict = {}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    if not _RUNS:
        layer = jax_layer()
        model2 = jax_model(2, sharded=False)
        step2 = jax_model(2, sharded=True)
        model1 = jax_model(1, sharded=True)
        rng = np.random.RandomState(1)
        v_router = rng.randn(MODEL["embed_dim"], E).astype(np.float32)
        v_gates = rng.randn(E, MODEL["embed_dim"],
                            MODEL["mlp_dim"]).astype(np.float32)
        got = run_gloo(_worker, E, tmp_path_factory.mktemp("moe"), layer[2],
                       layer[3], model2[1], model1[1], v_router, v_gates)
        _RUNS.update(layer=layer, model2=model2, step2=step2, got=got)
    return _RUNS


def _gathered(got, key, i=None):
    rows = [got[r][key] if i is None else got[r][key][i] for r in range(E)]
    return np.concatenate([t.detach().numpy() for t in rows])


@pytest.mark.parametrize("i,cf", [(0, 1.0), (1, 0.5)])
def test_moe_matches_jax_and_host_reference(hvd, runs, i, cf):
    outs, _, w1s, w2s = runs["layer"]
    got = runs["got"]
    np.testing.assert_allclose(_gathered(got, "outs", i), outs[i],
                               atol=1e-5, rtol=1e-5)
    # The host reference of tests/test_expert.py, on the port's routing.
    router, x, _, _ = _layer_inputs()
    capacity = max(1, int(T_LOCAL * cf / E))
    for r in range(E):
        xr = x[r * T_LOCAL:(r + 1) * T_LOCAL]
        combine, gate = switch_route(jnp.asarray(xr), jnp.asarray(router),
                                     E, capacity)
        ref = np.zeros((T_LOCAL, D), np.float32)
        for t in range(T_LOCAL):
            if float(np.asarray(combine[t]).sum()) == 0:
                continue
            e = int(np.argmax(np.asarray(combine[t]).sum(axis=-1)))
            ref[t] = float(gate[t]) * (np.tanh(xr[t] @ w1s[e]) @ w2s[e])
        np.testing.assert_allclose(got[r]["outs"][i].numpy(), ref,
                                   atol=1e-5, rtol=1e-5)
    assert not np.allclose(w1s[0], w1s[1])


def test_switch_route_matches_jax(hvd, runs):
    # The plan (experts, slots, drops) bit for bit; the gate is an f32
    # softmax, within its rounding.
    router, x, _, _ = _layer_inputs()
    for r in range(E):
        xr = x[r * T_LOCAL:(r + 1) * T_LOCAL]
        for (combine, gate), c in zip(runs["got"][r]["route"], (1, 3)):
            jc, jg = switch_route(jnp.asarray(xr), jnp.asarray(router), E, c)
            np.testing.assert_array_equal(combine.numpy(), np.asarray(jc))
            np.testing.assert_allclose(gate.numpy(), np.asarray(jg),
                                       atol=1e-6, rtol=1e-6)


def test_moe_capacity_drops_tokens(hvd, runs):
    _, drop, _, _ = runs["layer"]
    got = runs["got"]
    out = _gathered(got, "drop").reshape(E, T_LOCAL, D)
    np.testing.assert_allclose(out, drop.reshape(E, T_LOCAL, D), atol=1e-5,
                               rtol=1e-5)
    # capacity = max(1, 6 * 0.5 / 4) = 1: one token kept a rank.
    kept = (np.abs(out).sum(axis=-1) > 0).sum(axis=1)
    np.testing.assert_array_equal(kept, np.ones(E))
    for r in range(E):
        assert got[r]["moe_stats"] == {"tokens": T_LOCAL,
                                       "dropped": T_LOCAL - 1}


def test_moe_grad_finite_difference(hvd, runs):
    for r in range(E):
        directional, fd = runs["got"][r]["fd"]
        assert directional == pytest.approx(fd, rel=2e-2), (directional, fd)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{prefix}{k}/") if isinstance(v, dict)
                   else {f"{prefix}{k}": v})
    return out


def test_moe_transformer_trains(hvd, runs):
    from horovod_tpu_torch.models import convert
    from horovod_tpu_torch.models.transformer import TransformerConfig

    loss, params, grads, _ = runs["model2"]
    got = runs["got"]
    cfg = TransformerConfig(**MODEL, num_layers=2, dtype=torch.float32,
                            moe_axis="ep")
    for r in range(E):
        assert np.isfinite(got[r]["loss"])
        assert got[r]["loss"] == pytest.approx(loss, rel=1e-4)
        want = convert.params_from_flax(grads[r], cfg)
        for k, g in got[r]["grads"].items():
            np.testing.assert_allclose(g.numpy(), want[k].numpy(),
                                       atol=1e-4, rtol=1e-4, err_msg=k)
        assert float(got[r]["grads"]["layers.0.moe_mlp.router"].abs()
                     .sum()) > 0
    # Some expert got tokens, and so gradient (the same token everywhere
    # may route to one expert only).
    assert sum(float(got[r]["grads"]["layers.0.moe_mlp.gate"].abs().sum())
               for r in range(E)) > 0
    assert not np.allclose(got[0]["gate"].numpy(), got[1]["gate"].numpy())


def test_moe_grad_sync_keeps_shared_params_replicated(hvd, runs):
    from horovod_tpu_torch.models import convert
    from horovod_tpu_torch.models.transformer import TransformerConfig

    _, _, _, new = runs["step2"]
    got = runs["got"]
    cfg = TransformerConfig(**MODEL, num_layers=2, dtype=torch.float32,
                            moe_axis="ep")
    for r in range(E):
        want = convert.params_from_flax(new[r], cfg)
        for k, p in got[r]["stepped"].items():
            np.testing.assert_allclose(p.numpy(), want[k].numpy(),
                                       atol=1e-5, rtol=1e-5, err_msg=k)
    for r in range(1, E):
        np.testing.assert_array_equal(got[0]["stepped"]["embed.weight"],
                                      got[r]["stepped"]["embed.weight"])
    assert not np.allclose(got[0]["stepped"]["layers.0.moe_mlp.gate"],
                           got[1]["stepped"]["layers.0.moe_mlp.gate"])


@pytest.mark.parametrize("name,rel", [("layers.0.moe_mlp.router", 0.15),
                                      ("layers.0.moe_mlp.gate", 5e-2)])
def test_moe_grad_sync_finite_difference(hvd, runs, name, rel):
    for r in range(E):
        gdot, fd = runs["got"][r]["sync_fd"][name]
        assert gdot == pytest.approx(fd, rel=rel), (name, r, gdot, fd)
