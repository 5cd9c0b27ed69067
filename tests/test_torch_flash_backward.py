"""Port's flash-attention backward (the plain versions of the dq and dk/dv
kernels on the CPU, through ``_Flash``) against the JAX package's Pallas
backward kernels in interpret mode, on the same numpy inputs."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu_torch.ops import flash_attention as tfa

# The JAX package's ops/__init__ exports a function of the same name.
jfa = importlib.import_module("horovod_tpu.ops.flash_attention")

TOL = dict(atol=5e-4, rtol=5e-4)   # the JAX suite's gradient bound


def _inputs(s_q, s_k, b=2, h=2, d=16, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape, np.float32) for shape in (
        (b, s_q, h, d), (b, s_k, h, d), (b, s_k, h, d), (b, s_q, h, d)))


def _jax_grads(q, k, v, g, causal, q_off, k_off, dtype=jnp.float32):
    def f(q, k, v):
        out = jfa.flash_attention(q, k, v, causal=causal, q_offset=q_off,
                                  k_offset=k_off, block_q=16, block_k=16)
        return jnp.sum(out.astype(jnp.float32) * g)

    args = (jnp.asarray(x, dtype) for x in (q, k, v))
    return jax.grad(f, argnums=(0, 1, 2))(*args)


def _torch_grads(q, k, v, g, causal, q_off, k_off, dtype=torch.float32):
    tq, tk, tv = (torch.from_numpy(x).to(dtype).requires_grad_()
                  for x in (q, k, v))
    out = tfa.flash_attention(tq, tk, tv, causal=causal, q_offset=q_off,
                              k_offset=k_off)
    return torch.autograd.grad(out, (tq, tk, tv),
                               torch.from_numpy(g).to(dtype))


# (S_q, S_k, causal, q_offset, k_offset): aligned causal and non-causal,
# unaligned S=50 (the JAX kernels pad it), a query shard past its keys,
# and key blocks past the queries (early rows attend to nothing).
CASES = [
    (32, 32, True, 0, 0),
    (32, 32, False, 0, 0),
    (50, 50, True, 0, 0),
    (16, 48, True, 32, 0),
    (32, 32, True, 0, 16),
    (40, 24, False, 7, 3),
]


@pytest.mark.parametrize("s_q,s_k,causal,q_off,k_off", CASES)
def test_autograd_matches_jax_grad(s_q, s_k, causal, q_off, k_off):
    q, k, v, g = _inputs(s_q, s_k)
    want = _jax_grads(q, k, v, g, causal, q_off, k_off)
    got = _torch_grads(q, k, v, g, causal, q_off, k_off)
    for a, b in zip(got, want):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def test_rows_that_attend_to_nothing_get_zero_finite_gradients():
    # k_offset 40 > q_offset + S_q - 1: every query precedes every key.
    q, k, v, g = _inputs(32, 32, seed=1)
    dq, dk, dv = _torch_grads(q, k, v, g, True, 0, 40)
    for t in (dq, dk, dv):
        assert torch.isfinite(t).all() and torch.all(t == 0)
    # Half of the rows empty: their dq is zero, the rest is JAX's.
    want = _jax_grads(q, k, v, g, True, 0, 16)
    got = _torch_grads(q, k, v, g, True, 0, 16)
    assert torch.all(got[0][:, :16] == 0)
    for a, b in zip(got, want):
        assert torch.isfinite(a).all()
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def test_bf16_gradients_match_jax():
    q, k, v, g = _inputs(32, 32, seed=2)
    want = _jax_grads(q, k, v, g, True, 0, 0, jnp.bfloat16)
    got = _torch_grads(q, k, v, g, True, 0, 0, torch.bfloat16)
    for a, b in zip(got, want):
        # Same roundings (q fold, ds and the outputs in bf16) in another
        # summation order: the JAX suite's bf16 bound.
        assert a.dtype == torch.bfloat16
        np.testing.assert_allclose(a.float().numpy(),
                                   np.asarray(b, np.float32),
                                   atol=5e-2, rtol=5e-2)


@pytest.mark.parametrize("s_q,s_k,causal,q_off,k_off", [
    (32, 32, True, 0, 0), (50, 50, True, 0, 0), (40, 24, False, 7, 3)])
def test_explicit_backward_matches_jax(s_q, s_k, causal, q_off, k_off):
    # The ring-attention contract: lse and delta passed in explicitly.
    q, k, v, g = _inputs(s_q, s_k, seed=3)
    jq, jk, jv, jg = map(jnp.asarray, (q, k, v, g))
    out, lse = jfa.flash_attention_with_lse(
        jq, jk, jv, causal=causal, q_offset=q_off, k_offset=k_off,
        block_q=16, block_k=16)
    delta = jnp.sum(jg * out, axis=-1)
    want = jfa.flash_attention_backward(
        jq, jk, jv, jg, lse, delta, causal, q_off, k_off, 16, 16,
        interpret=True)
    got = tfa.flash_attention_backward(
        *map(torch.from_numpy, (q, k, v, g, np.array(lse),
                                np.array(delta))),
        causal=causal, q_offset=q_off, k_offset=k_off)
    for a, b, ref in zip(got, want, (q, k, v)):
        assert a.shape == ref.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def test_backward_splits_into_the_two_kernels_plain_versions():
    q, k, v, g = (torch.from_numpy(x) for x in _inputs(24, 40, seed=4))
    out, lse = tfa.flash_attention_with_lse(q, k, v, True, 16, 0)
    delta = (g * out).sum(-1)
    args = (q, k, v, g, lse, delta, True, 16, 0)
    dq, dk, dv = tfa.flash_attention_backward(*args)
    assert torch.equal(dq, tfa.flash_bwd_dq_reference(*args))
    want_dk, want_dv = tfa.flash_bwd_dkv_reference(*args)
    assert torch.equal(dk, want_dk) and torch.equal(dv, want_dv)


@pytest.mark.parametrize("s_q,s_k,causal,q_off,k_off", [
    (40, 40, True, 0, 0), (16, 48, True, 32, 0)])
def test_head_dim_320_gradients_match_jax(s_q, s_k, causal, q_off, k_off):
    # D = 320, which the card runs on the wide route (a 64-column slice of
    # dq, dk and dv a block): the plain path against the JAX kernels.
    q, k, v, g = _inputs(s_q, s_k, b=1, d=320, seed=4)
    want = _jax_grads(q, k, v, g, causal, q_off, k_off)
    got = _torch_grads(q, k, v, g, causal, q_off, k_off)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
