"""Port's forward flash attention (plain path on the CPU) against the JAX
package's Pallas kernel in interpret mode, on the same numpy inputs."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu_torch.models import transformer as tm
from horovod_tpu_torch.ops import flash_attention as tfa

# The JAX package's ops/__init__ exports a function of the same name.
jfa = importlib.import_module("horovod_tpu.ops.flash_attention")


def _qkv(b=2, s_q=64, s_k=None, h=2, d=16, seed=0):
    rng = np.random.default_rng(seed)
    s_k = s_q if s_k is None else s_k
    return (rng.standard_normal((b, s_q, h, d), np.float32),
            rng.standard_normal((b, s_k, h, d), np.float32),
            rng.standard_normal((b, s_k, h, d), np.float32))


# (S_q, S_k, causal, q_offset, k_offset): aligned, unaligned (S=50 pads
# the JAX kernel's tiles), a query block past the keys, and key blocks past
# the queries (early rows attend to nothing: out 0, lse NEG_INF).
CASES = [
    (64, 64, True, 0, 0),
    (64, 64, False, 0, 0),
    (50, 50, True, 0, 0),
    (32, 32, True, 32, 0),
    (16, 48, True, 32, 0),
    (32, 32, True, 0, 16),
    (40, 24, False, 7, 3),
]


@pytest.mark.parametrize("s_q,s_k,causal,q_off,k_off", CASES)
def test_out_and_lse_match_jax_kernel(s_q, s_k, causal, q_off, k_off):
    q, k, v = _qkv(s_q=s_q, s_k=s_k)
    j_out, j_lse = jfa.flash_attention_with_lse(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        q_offset=q_off, k_offset=k_off, block_q=16, block_k=16)
    t_out, t_lse = tfa.flash_attention_with_lse(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal, q_offset=q_off, k_offset=k_off)
    assert t_out.dtype == torch.float32 and t_lse.shape == (2, s_q, 2)
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out),
                               atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(t_lse.numpy(), np.asarray(j_lse),
                               atol=2e-5, rtol=2e-5)


def test_rows_that_attend_to_nothing():
    q, k, v = _qkv(s_q=32)
    out, lse = tfa.flash_attention_with_lse(
        *map(torch.from_numpy, (q, k, v)), causal=True, k_offset=16)
    assert torch.all(out[:, :16] == 0)
    assert torch.all(lse[:, :16] == tfa.NEG_INF)
    assert torch.all(lse[:, 16:] > tfa.NEG_INF)


def test_bf16_keeps_dtype_and_matches_jax():
    q, k, v = _qkv()
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    j_out = jfa.flash_attention(jq, jk, jv, block_q=16, block_k=16)
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    t_out = tfa.flash_attention(tq, tk, tv)
    assert t_out.dtype == torch.bfloat16
    # Both fold the scale into q with one bf16 rounding and accumulate in
    # f32; the outputs round to bf16 once (the JAX suite's bf16 bound).
    np.testing.assert_allclose(t_out.float().numpy(),
                               np.asarray(j_out, np.float32),
                               atol=3e-2, rtol=3e-2)


@pytest.mark.parametrize("causal", [True, False])
def test_adapter_matches_dense_attention(causal):
    q, k, v = (torch.from_numpy(x) for x in _qkv(s_q=24))
    attn = tfa.make_flash_attention(block_q=16, block_k=16, sub=8)
    np.testing.assert_allclose(
        attn(q, k, v, causal=causal).numpy(),
        tm.dense_causal_attention(q, k, v, causal=causal).numpy(),
        atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("d", [320, 384])
@pytest.mark.parametrize("causal", [True, False])
def test_head_dims_past_256_match_jax_kernel(d, causal):
    # The head dims the card runs on the wide route: the plain path here
    # against the JAX kernel, which takes any head dim.
    q, k, v = _qkv(b=1, s_q=40, h=2, d=d, seed=5)
    j_out, j_lse = jfa.flash_attention_with_lse(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        block_q=16, block_k=16)
    t_out, t_lse = tfa.flash_attention_with_lse(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal)
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out),
                               atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(t_lse.numpy(), np.asarray(j_lse),
                               atol=2e-5, rtol=2e-5)
