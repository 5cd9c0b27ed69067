"""Port's RMSNorm forward (plain path on the CPU) against the JAX package's
Pallas kernel in interpret mode, on the same numpy inputs."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu_torch.ops import rmsnorm as trn

# The JAX package's ops/__init__ exports a function of the same name.
jrn = importlib.import_module("horovod_tpu.ops.rmsnorm")


def _inputs(n, e, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, e), np.float32),
            (1.0 + 0.1 * rng.standard_normal(e)).astype(np.float32))


# (n, e): rows no multiple of any block, a prefill, and the decode shapes
# (one slot, eight slots).
@pytest.mark.parametrize("n,e", [(300, 384), (1024, 768), (1, 768), (8, 768)])
def test_forward_matches_jax_kernel(n, e):
    x, s = _inputs(n, e)
    want = jrn.rms_norm(jnp.asarray(x), jnp.asarray(s))
    got = trn.rms_norm(torch.from_numpy(x), torch.from_numpy(s))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("n,e", [(64, 256), (1000, 768)])
def test_bf16_output_dtype_and_values(n, e):
    x, s = _inputs(n, e)
    want = jrn.rms_norm(jnp.asarray(x, jnp.bfloat16), jnp.asarray(s))
    got = trn.rms_norm(torch.from_numpy(x).to(torch.bfloat16),
                       torch.from_numpy(s))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=2e-2, rtol=2e-2)


def test_leading_batch_dims():
    x, s = _inputs(24, 64)
    x3 = x.reshape(2, 12, 64)
    want = jrn.rms_norm_reference(jnp.asarray(x3), jnp.asarray(s))
    got = trn.rms_norm(torch.from_numpy(x3), torch.from_numpy(s))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("use_fused", [True, None])
def test_module_matches_flax_module(use_fused):
    x, s = _inputs(10, 32)
    jmod = jrn.FusedRMSNorm(dtype=jnp.float32, use_fused=use_fused)
    init = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))
    tmod = trn.FusedRMSNorm(32, dtype=torch.float32, use_fused=use_fused)
    # Same parameter structure: one `scale` vector, initialised to ones.
    assert list(init["params"]) == [n for n, _ in tmod.named_parameters()]
    np.testing.assert_array_equal(np.asarray(init["params"]["scale"]),
                                  tmod.scale.detach().numpy())
    want = jmod.apply({"params": {"scale": jnp.asarray(s)}}, jnp.asarray(x))
    with torch.no_grad():
        tmod.scale.copy_(torch.from_numpy(s))
        got = tmod(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=1e-5, rtol=1e-5)


def _jax_grads(x, s, dy):
    def f(x, s):
        return jnp.sum(jrn.rms_norm(x, s).astype(jnp.float32) * dy)
    return jax.grad(f, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(s))


def _torch_grads(x, s, dy, dtype=torch.float32):
    tx = torch.from_numpy(x).to(dtype).requires_grad_()
    ts = torch.from_numpy(s).requires_grad_()
    y = trn.rms_norm(tx, ts)
    return torch.autograd.grad(y, (tx, ts), torch.from_numpy(dy).to(dtype))


# (shape): one block, rows that are no multiple of any block (the JAX
# kernel pads 300 rows to 512), and leading batch dims.
@pytest.mark.parametrize("shape", [(64, 256), (300, 384), (2, 50, 96)])
def test_backward_matches_jax_grad(shape):
    x, s = _inputs(int(np.prod(shape[:-1])), shape[-1], seed=3)
    x = x.reshape(shape)
    dy = np.random.default_rng(4).standard_normal(shape).astype(np.float32)
    jdx, jds = _jax_grads(x, s, dy)
    dx, ds = _torch_grads(x, s, dy)
    assert dx.shape == shape and ds.shape == s.shape
    np.testing.assert_allclose(dx.numpy(), np.asarray(jdx),
                               atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(ds.numpy(), np.asarray(jds),
                               atol=2e-4, rtol=2e-4)


def test_backward_keeps_x_and_scale_dtypes():
    x, s = _inputs(40, 64, seed=5)
    dy = np.random.default_rng(6).standard_normal(x.shape).astype(np.float32)
    dx, ds = _torch_grads(x, s, dy, torch.bfloat16)
    assert dx.dtype == torch.bfloat16 and ds.dtype == torch.float32
    jdx, jds = jax.grad(
        lambda x, s: jnp.sum(jrn.rms_norm(x, s).astype(jnp.float32) * dy),
        argnums=(0, 1))(jnp.asarray(x, jnp.bfloat16), jnp.asarray(s))
    np.testing.assert_allclose(dx.float().numpy(),
                               np.asarray(jdx, np.float32),
                               atol=2e-2, rtol=2e-2)
    np.testing.assert_allclose(ds.numpy(), np.asarray(jds),
                               atol=2e-2, rtol=2e-2)


def test_plain_backward_is_the_autograd_of_the_plain_forward():
    x, s = _inputs(33, 48, seed=7)
    dy = torch.from_numpy(
        np.random.default_rng(8).standard_normal(x.shape).astype(np.float32))
    tx = torch.from_numpy(x).requires_grad_()
    ts = torch.from_numpy(s).requires_grad_()
    want = torch.autograd.grad(trn.rms_norm_reference(tx, ts), (tx, ts), dy)
    got = trn.rms_norm_backward_reference(tx.detach(), ts.detach(), dy)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)
