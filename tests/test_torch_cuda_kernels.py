"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips on a machine without a CUDA device.  On
one with a card, ``python -m pytest tests/test_torch_cuda_kernels.py``
builds the kernels from ``horovod_tpu_torch/csrc`` and runs them.
"""

import pytest
import torch

from horovod_tpu_torch.ops import _build
from horovod_tpu_torch.ops import flash_attention as tfa
from horovod_tpu_torch.ops import rmsnorm as trn

pytestmark = pytest.mark.cuda


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    for k in _build.KERNELS.values():
        k.load()
    return torch.device("cuda")


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-5),
                                        (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("s_q,s_k,causal,q_off,k_off,d", [
    (64, 64, True, 0, 0, 64), (200, 200, True, 0, 0, 128),
    (100, 300, True, 200, 0, 128), (130, 70, False, 0, 0, 64),
    (64, 64, True, 0, 100, 128)])
def test_flash_kernel_matches_plain(cuda, dtype, atol, s_q, s_k, causal,
                                    q_off, k_off, d):
    g = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn(2, s_q, 3, d, generator=g, device=cuda, dtype=dtype)
    k, v = (torch.randn(2, s_k, 3, d, generator=g, device=cuda, dtype=dtype)
            for _ in range(2))
    before = tfa.KERNEL.launches
    out, lse = tfa.flash_attention_with_lse(q, k, v, causal, q_off, k_off)
    ref_out, ref_lse = tfa.flash_attention_reference(q, k, v, causal, q_off,
                                                     k_off)
    torch.cuda.synchronize()
    assert tfa.KERNEL.launches == before + 1
    assert out.dtype == dtype
    torch.testing.assert_close(out.float(), ref_out.float(), atol=atol,
                               rtol=atol)
    torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,e", [(1, 768), (1000, 768), (37, 384)])
def test_rmsnorm_kernel_matches_plain(cuda, dtype, n, e):
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn(n, e, generator=g, device=cuda, dtype=dtype)
    scale = 1 + 0.1 * torch.randn(e, generator=g, device=cuda)
    y = trn.rms_norm(x, scale)
    torch.cuda.synchronize()
    tol = 1e-5 if dtype == torch.float32 else 1.6e-2
    torch.testing.assert_close(y.float(), trn.rms_norm_reference(
        x, scale).float(), atol=1e-5, rtol=tol)
