"""Port's ``softmax_cross_entropy`` against the JAX package's, on the same
numpy inputs: value and gradient, f32 numerics inside, a logits-dtype
cotangent."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.ops import losses as jlosses
from horovod_tpu_torch.ops.losses import softmax_cross_entropy


def _data(shape=(4, 8), v=64, scale=5.0, seed=0):
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal(shape + (v,)) * scale).astype(np.float32)
    labels = rng.integers(0, v, shape).astype(np.int32)
    g = rng.standard_normal(shape).astype(np.float32)
    return logits, labels, g


def _jax(logits, labels, g, dtype):
    def f(l):
        return jnp.sum(jlosses.softmax_cross_entropy(l, labels) * g)
    x = jnp.asarray(logits, dtype)
    return jlosses.softmax_cross_entropy(x, labels), jax.grad(f)(x)


def _torch(logits, labels, g, dtype):
    x = torch.from_numpy(logits).to(dtype).requires_grad_()
    loss = softmax_cross_entropy(x, torch.from_numpy(labels).long())
    (dx,) = torch.autograd.grad(loss, x, torch.from_numpy(g))
    return loss.detach(), dx


def test_value_and_gradient_match_jax_f32():
    logits, labels, g = _data()
    jl, jg = _jax(logits, labels, g, jnp.float32)
    tl, tg = _torch(logits, labels, g, torch.float32)
    assert tl.dtype == torch.float32 and tl.shape == (4, 8)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-6,
                               rtol=1e-6)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=1e-6,
                               rtol=1e-6)


@pytest.mark.parametrize("scale", [5.0, 80.0])
def test_bf16_logits_give_f32_loss_and_bf16_cotangent(scale):
    logits, labels, g = _data(scale=scale, seed=1)
    jl, jg = _jax(logits, labels, g, jnp.bfloat16)
    tl, tg = _torch(logits, labels, g, torch.bfloat16)
    assert tl.dtype == torch.float32 and tg.dtype == torch.bfloat16
    assert torch.isfinite(tl).all() and torch.isfinite(tg.float()).all()
    # Both widen the same bf16 logits to f32: the loss agrees to f32
    # rounding; the cotangent rounds to bf16 once on each side.
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5,
                               rtol=1e-6)
    np.testing.assert_allclose(tg.float().numpy(),
                               np.asarray(jg, np.float32), atol=8e-3)


def test_gradient_rows_sum_to_zero():
    logits, labels, _ = _data(seed=2)
    x = torch.from_numpy(logits).requires_grad_()
    softmax_cross_entropy(x, torch.from_numpy(labels)).sum().backward()
    np.testing.assert_allclose(x.grad.sum(-1).numpy(), 0.0, atol=1e-5)
