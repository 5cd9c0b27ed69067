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


@pytest.mark.parametrize("n,e", [(300, 384), (1024, 768)])
def test_forward_matches_jax_kernel(n, e):
    x, s = _inputs(n, e)
    want = jrn.rms_norm(jnp.asarray(x), jnp.asarray(s))
    got = trn.rms_norm(torch.from_numpy(x), torch.from_numpy(s))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=1e-5, rtol=1e-5)


def test_bf16_output_dtype_and_values():
    x, s = _inputs(64, 256)
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
