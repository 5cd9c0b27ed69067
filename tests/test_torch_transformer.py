"""Port's decoder transformer against the JAX package's flax model, with the
same weights carried across by ``params_from_flax``, in an f32 config with
the flash-attention and RMSNorm kernels on (their plain paths here; the
JAX side runs its Pallas kernels in interpret mode): the forward, the
serving paths, and the training loss with every parameter's gradient."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.models import transformer as jtm
from horovod_tpu.ops import losses as jlosses
from horovod_tpu_torch import train_transformer
from horovod_tpu_torch.models import convert
from horovod_tpu_torch.models import transformer as ttm

jfa = importlib.import_module("horovod_tpu.ops.flash_attention")
tfa = importlib.import_module("horovod_tpu_torch.ops.flash_attention")

SMALL = dict(vocab_size=64, num_layers=2, num_heads=2, head_dim=8,
             embed_dim=16, mlp_dim=32, max_seq_len=64)
TOL = dict(atol=2e-5, rtol=2e-5)


@pytest.fixture(scope="module")
def pair():
    jcfg = jtm.TransformerConfig(**SMALL, dtype=jnp.float32,
                                 attention_fn=jfa.make_flash_attention(),
                                 fused_norm=True)
    tcfg = ttm.TransformerConfig(**SMALL, dtype=torch.float32,
                                 attention_fn=tfa.make_flash_attention(),
                                 fused_norm=True)
    jmodel = jtm.Transformer(jcfg)
    params = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    tmodel = ttm.Transformer(tcfg, device="cpu")
    tree = jax.tree_util.tree_map(np.asarray, params)
    tmodel.load_state_dict(convert.params_from_flax(tree, tcfg))
    tmodel.eval()
    return jmodel, params, tmodel


def _tokens(b, s, seed=0):
    return np.random.default_rng(seed).integers(0, 64, (b, s)).astype(
        np.int32)


@pytest.mark.parametrize("b,s", [(1, 8), (2, 13), (1, 33)])
def test_full_forward_matches_jax(pair, b, s):
    jmodel, params, tmodel = pair
    toks = _tokens(b, s)
    want = jmodel.apply(params, jnp.asarray(toks))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(toks))
    assert got.shape == (b, s, 64) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_loss_and_every_gradient_match_jax(pair):
    jmodel, params, tmodel = pair
    toks = _tokens(2, 13, seed=9)   # 13: no multiple of the JAX tiles

    def jax_loss(p):
        logits = jmodel.apply(p, jnp.asarray(toks))
        return jlosses.softmax_cross_entropy(
            logits[:, :-1], jnp.asarray(toks)[:, 1:]).mean()

    want_loss, jgrads = jax.value_and_grad(jax_loss)(params)
    # The gradient tree crosses over as the weights do.
    want = convert.params_from_flax(
        jax.tree_util.tree_map(np.asarray, jgrads), tmodel.cfg)
    tmodel.zero_grad(set_to_none=True)
    loss = train_transformer.loss_fn(tmodel, torch.from_numpy(toks).long())
    loss.backward()
    try:
        # The JAX suite's bound for gradients through the flash kernels.
        np.testing.assert_allclose(loss.item(), float(want_loss),
                                   atol=5e-4, rtol=5e-4)
        assert set(want) == {n for n, _ in tmodel.named_parameters()}
        for name, p in tmodel.named_parameters():
            np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                       atol=5e-4, rtol=5e-4, err_msg=name)
    finally:
        tmodel.zero_grad(set_to_none=True)


def test_prefill_kv_matches_jax(pair):
    jmodel, params, tmodel = pair
    toks = _tokens(2, 12, seed=1)
    _, (jk, jv) = jmodel.apply(params, jnp.asarray(toks), return_kv=True)
    with torch.no_grad():
        _, (tk, tv) = tmodel(torch.from_numpy(toks), return_kv=True)
    assert tk.shape == (2, 2, 12, 2, 8)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), **TOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **TOL)


def test_prefill_then_decode_equals_full_forward(pair):
    _, _, tmodel = pair
    toks = torch.from_numpy(_tokens(2, 20, seed=2)).long()
    n0 = 11
    with torch.no_grad():
        full = tmodel(toks)
        _, (pk, pv) = tmodel(toks[:, :n0], return_kv=True)
        kk, vv = ttm.init_kv_cache(tmodel.cfg, 2, 32, device="cpu")
        kk[:, :, :n0], vv[:, :, :n0] = pk, pv
        for i in range(n0, 20):
            lengths = torch.full((2,), i)
            logits, (kk2, _) = tmodel(toks[:, i:i + 1], kv_cache=(kk, vv),
                                      lengths=lengths)
            assert kk2 is kk   # written in place
            np.testing.assert_allclose(logits.numpy(), full[:, i].numpy(),
                                       **TOL)
        # A multi-token cache call (verify / suffix prefill) too.
        logits, _ = tmodel(toks[:, 15:20], kv_cache=(kk, vv),
                           lengths=torch.full((2,), 15))
    np.testing.assert_allclose(logits.numpy(), full[:, 15:20].numpy(), **TOL)


def test_decode_step_matches_jax(pair):
    jmodel, params, tmodel = pair
    rng = np.random.default_rng(3)
    shape = (2, 2, 24, 2, 8)   # [L, B, S, H, D]
    kk = rng.standard_normal(shape).astype(np.float32)
    vv = rng.standard_normal(shape).astype(np.float32)
    toks = _tokens(2, 1, seed=4)
    lengths = np.array([5, 17], np.int32)
    jl, (jk, _) = jmodel.apply(params, jnp.asarray(toks),
                               kv_cache=(jnp.asarray(kk), jnp.asarray(vv)),
                               lengths=jnp.asarray(lengths))
    tk, tv = torch.from_numpy(kk.copy()), torch.from_numpy(vv.copy())
    with torch.no_grad():
        tl, _ = tmodel(torch.from_numpy(toks), kv_cache=(tk, tv),
                       lengths=torch.from_numpy(lengths))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), **TOL)


def test_building_blocks_match_jax():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 7, 3, 8)).astype(np.float32)
    pos = np.arange(7)[None].repeat(2, 0) + np.array([[0], [40]])
    np.testing.assert_allclose(
        ttm.rope(torch.from_numpy(x), torch.from_numpy(pos), 10000.0).numpy(),
        np.asarray(jtm.rope(jnp.asarray(x), jnp.asarray(pos), 10000.0)),
        **TOL)
    q = rng.standard_normal((2, 5, 3, 8)).astype(np.float32)
    k, v = (rng.standard_normal((2, 9, 3, 8)).astype(np.float32)
            for _ in range(2))
    np.testing.assert_allclose(   # bottom-right causal alignment
        ttm.dense_causal_attention(*map(torch.from_numpy, (q, k, v))).numpy(),
        np.asarray(jtm.dense_causal_attention(*map(jnp.asarray, (q, k, v)))),
        **TOL)
    lengths = np.array([0, 4], np.int32)
    np.testing.assert_allclose(
        ttm.cached_decode_attention(*map(torch.from_numpy,
                                         (q[:, :2], k, v, lengths))).numpy(),
        np.asarray(jtm.cached_decode_attention(
            *map(jnp.asarray, (q[:, :2], k, v, lengths)))), **TOL)


def test_init_params_is_a_flax_layout_tree():
    # The seeded tree init_params converts is one the flax model accepts,
    # and both models give the same logits from it.
    jcfg = jtm.TransformerConfig(**SMALL, dtype=jnp.float32)
    tcfg = ttm.TransformerConfig(**SMALL, dtype=torch.float32)
    tree = convert.flax_tree(tcfg, seed=7)
    ref = jtm.Transformer(jcfg).init(jax.random.PRNGKey(0),
                                     jnp.zeros((1, 4), jnp.int32))
    assert jax.tree_util.tree_structure(ref) == \
        jax.tree_util.tree_structure(tree)
    for a, b in zip(jax.tree_util.tree_leaves(ref),
                    jax.tree_util.tree_leaves(tree)):
        assert a.shape == b.shape
    toks = _tokens(1, 9, seed=8)
    want = jtm.Transformer(jcfg).apply(tree, jnp.asarray(toks))
    tmodel = ttm.Transformer(tcfg, device="cpu")
    tmodel.load_state_dict(convert.init_params(tcfg, seed=7))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_config_162m_is_the_benchmark_decoder():
    cfg = ttm.config_162m()
    assert (cfg.num_layers, cfg.embed_dim, cfg.num_heads, cfg.head_dim,
            cfg.mlp_dim, cfg.vocab_size) == (12, 768, 6, 128, 3072, 32000)
    assert cfg.fused_norm and cfg.attention_fn is not None
    assert cfg.dtype == torch.bfloat16 and cfg.param_dtype == torch.float32
    model = ttm.Transformer(cfg, device="meta")
    assert sum(p.numel() for p in model.parameters()) == 162_417_408
