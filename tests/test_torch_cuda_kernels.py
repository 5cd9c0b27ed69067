"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips on a machine without a CUDA device.  On
one with a card, ``python -m pytest --noconftest
tests/test_torch_cuda_kernels.py`` builds the kernels from
``horovod_tpu_torch/csrc`` and runs them.
"""

import pytest
import torch

from horovod_tpu_torch.ops import _build
from horovod_tpu_torch.ops import flash_attention as tfa
from horovod_tpu_torch.ops import rmsnorm as trn
from horovod_tpu_torch.utils import trace

pytestmark = pytest.mark.cuda

FLASH_CASES = [   # (S_q, S_k, causal, q_offset, k_offset, head_dim)
    (64, 64, True, 0, 0, 64), (200, 200, True, 0, 0, 128),
    (100, 300, True, 200, 0, 128), (130, 70, False, 0, 0, 64),
    (64, 64, True, 0, 100, 128)] + [
    # The edges of the tensor-core kernels' tiles (64-key K tiles, 64- or
    # 128-row q tiles), at both head dims: S not a multiple of 128; one and
    # 37 queries at the end of their keys; fewer keys than one K tile; and
    # k_offset > q_offset, where the first rows see no key.
    case for d in (64, 128) for case in (
        (1000, 1000, True, 0, 0, d), (1, 300, True, 299, 0, d),
        (37, 300, True, 263, 0, d), (50, 30, True, 20, 0, d),
        (100, 40, False, 0, 0, d), (100, 80, True, 0, 37, d),
        # No keys at all; and 128-row q tiles (S_q large enough that they
        # fill the card at B*H = 6) with a ragged last tile, whose second
        # warpgroup is partly past S_q, over fewer keys than one K tile.
        (130, 0, True, 0, 0, d), (2900, 40, True, 0, 0, d))] + [
    # Head dims the wrappers zero-pad (32 -> 64, 96 -> 128, 160 -> 256)
    # and 256, which runs on the CUDA cores in both dtypes with 32-row dq
    # and 32-key dk/dv tiles: causal, with the query block past its keys,
    # non-causal over more keys than one tile, and a ragged q tile.
    case for d in (32, 96, 160, 256) for case in (
        (200, 200, True, 0, 0, d), (100, 300, True, 200, 0, d),
        (130, 70, False, 0, 0, d), (37, 300, True, 263, 0, d))] + [
    # Head dims past 256, the wide route in both dtypes (each block one
    # 64-column slice of the output, the D sums in 64-wide chunks): 320 and
    # 384 as they are, 500 zero-padded to 512, and 512.
    case for d in (320, 384, 500, 512) for case in (
        (200, 200, True, 0, 0, d), (100, 300, True, 200, 0, d),
        (130, 70, False, 0, 0, d), (37, 300, True, 263, 0, d))]


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    for k in _build.KERNELS.values():
        k.load()
    return torch.device("cuda")


def _close(got, want, dtype):
    """f32: the kernels and the plain versions differ in summation order
    only.  bf16: each rounds its f32 sums to bf16 once (ulp 2**-8 relative),
    and ds, rounded to bf16 before its products, can round the other way
    where the two f32 values straddle a rounding boundary; a gradient sums
    up to S such terms, so the bound scales with its magnitude."""
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all()
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    else:
        scale = want.abs().max().item() if want.numel() else 0.0
        torch.testing.assert_close(got, want, atol=2e-2 * scale, rtol=1.6e-2)


def _qkv(cuda, dtype, s_q, s_k, d, seed=0):
    g = torch.Generator(device=cuda).manual_seed(seed)
    q = torch.randn(2, s_q, 3, d, generator=g, device=cuda, dtype=dtype)
    k, v = (torch.randn(2, s_k, 3, d, generator=g, device=cuda, dtype=dtype)
            for _ in range(2))
    return q, k, v, torch.randn(2, s_q, 3, d, generator=g, device=cuda,
                                dtype=dtype)


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-5),
                                        (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("s_q,s_k,causal,q_off,k_off,d", FLASH_CASES)
def test_flash_kernel_matches_plain(cuda, dtype, atol, s_q, s_k, causal,
                                    q_off, k_off, d):
    q, k, v, _ = _qkv(cuda, dtype, s_q, s_k, d)
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
@pytest.mark.parametrize("s_q,s_k,causal,q_off,k_off,d", FLASH_CASES)
def test_flash_backward_kernels_match_plain(cuda, dtype, s_q, s_k, causal,
                                            q_off, k_off, d):
    q, k, v, dout = _qkv(cuda, dtype, s_q, s_k, d, seed=1)
    out, lse = tfa.flash_attention_with_lse(q, k, v, causal, q_off, k_off)
    delta = (dout.float() * out.float()).sum(-1)
    before = (tfa.DQ_KERNEL.launches, tfa.DKV_KERNEL.launches)
    got = tfa.flash_attention_backward(q, k, v, dout, lse, delta, causal,
                                       q_off, k_off)
    want = tfa.flash_attention_backward_reference(q, k, v, dout, lse, delta,
                                                  causal, q_off, k_off)
    torch.cuda.synchronize()
    # With no keys there is no dk or dv to compute, and no dk/dv launch.
    assert (tfa.DQ_KERNEL.launches, tfa.DKV_KERNEL.launches) == \
        (before[0] + 1, before[1] + (1 if s_k else 0))
    for g, w, t in zip(got, want, (q, k, v)):
        assert g.dtype == dtype and g.shape == t.shape
        _close(g, w, dtype)
    if causal and k_off > q_off:   # rows that saw no key: zero gradient
        empty = k_off - q_off
        assert torch.all(got[0][:, :empty] == 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kernel", ["dq", "dkv"])
def test_flash_dkv_kernel_is_deterministic(cuda, kernel, dtype):
    # dq, and dk and dv, accumulate in registers and are written once (no
    # atomics): two launches on the same inputs agree bit for bit.  S = 2900
    # takes the dq kernel's 128-row q tiles.
    fn = {"dq": tfa.flash_bwd_dq, "dkv": tfa.flash_bwd_dkv}[kernel]
    q, k, v, dout = _qkv(cuda, dtype, 2900, 2900, 128, seed=3)
    out, lse = tfa.flash_attention_with_lse(q, k, v)
    delta = (dout.float() * out.float()).sum(-1)
    first = fn(q, k, v, dout, lse, delta)
    second = fn(q, k, v, dout, lse, delta)
    torch.cuda.synchronize()
    if kernel == "dq":
        first, second = (first,), (second,)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernels_take_batch_heads_past_65535(cuda, dtype):
    # B*H = 65540 blocks on the grid's x axis (y and z stop at 65535): bf16
    # on the tensor cores, f32 on the CUDA cores; every row of the batch
    # against the plain versions.
    g = torch.Generator(device=cuda).manual_seed(6)
    q, k, v, dout = (torch.randn(16385, 64, 4, 64, generator=g, device=cuda,
                                 dtype=dtype) for _ in range(4))
    before = [t.launches for t in (tfa.KERNEL, tfa.DQ_KERNEL,
                                   tfa.DKV_KERNEL)]
    out, lse = tfa.flash_attention_with_lse(q, k, v)
    delta = (dout.float() * out.float()).sum(-1)
    got = tfa.flash_attention_backward(q, k, v, dout, lse, delta)
    torch.cuda.synchronize()
    assert [t.launches for t in (tfa.KERNEL, tfa.DQ_KERNEL,
                                 tfa.DKV_KERNEL)] == [b + 1 for b in before]
    ref_out, ref_lse = tfa.flash_attention_reference(q, k, v)
    atol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(out.float(), ref_out.float(), atol=atol,
                               rtol=atol)
    torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=0)
    del ref_out, ref_lse
    want = tfa.flash_attention_backward_reference(q, k, v, dout, lse, delta)
    for gr, w in zip(got, want):
        _close(gr, w, dtype)


def test_flash_autograd_runs_the_kernels(cuda):
    q, k, v, dout = _qkv(cuda, torch.bfloat16, 128, 128, 128, seed=2)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    before = [t.launches for t in (tfa.KERNEL, tfa.DQ_KERNEL,
                                   tfa.DKV_KERNEL)]
    out = tfa.flash_attention(q, k, v)
    grads = torch.autograd.grad(out, (q, k, v), dout)
    torch.cuda.synchronize()
    assert [t.launches for t in (tfa.KERNEL, tfa.DQ_KERNEL,
                                 tfa.DKV_KERNEL)] == [b + 1 for b in before]
    lse = tfa.flash_attention_with_lse(q.detach(), k.detach(),
                                       v.detach())[1]
    delta = (dout.float() * out.detach().float()).sum(-1)
    want = tfa.flash_attention_backward_reference(
        q.detach(), k.detach(), v.detach(), dout, lse, delta)
    for g, w in zip(grads, want):
        _close(g, w, torch.bfloat16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 96, 128, 256])
def test_flash_kernels_take_strided_views(cuda, dtype, d):
    # q, k, v and dO as transposed views of [B, H, S, D] tensors, as ring
    # attention's chunks come: the wrappers copy them into the kernels'
    # layout, and the results match the plain versions on the same views.
    g = torch.Generator(device=cuda).manual_seed(4)
    q, k, v, dout = (torch.randn(2, 3, 150, d, generator=g, device=cuda,
                                 dtype=dtype).transpose(1, 2)
                     for _ in range(4))
    assert not q.is_contiguous()
    out, lse = tfa.flash_attention_with_lse(q, k, v)
    ref_out, ref_lse = tfa.flash_attention_reference(q, k, v)
    delta = (dout.float() * out.float()).sum(-1)
    got = tfa.flash_attention_backward(q, k, v, dout, lse, delta)
    want = tfa.flash_attention_backward_reference(q, k, v, dout, lse, delta)
    torch.cuda.synchronize()
    atol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(out.float(), ref_out.float(), atol=atol,
                               rtol=atol)
    torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=0)
    for gr, w in zip(got, want):
        assert gr.shape == q.shape and gr.dtype == dtype
        _close(gr, w, dtype)


def _rms_inputs(cuda, dtype, n, e, seed=1, unaligned=False):
    """x [n, e] and an f32 scale; ``unaligned`` puts x one element past a
    16-byte boundary (a contiguous view), which the register form refuses."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn(n * e + unaligned, generator=g, device=cuda, dtype=dtype)
    x = x[1:] if unaligned else x
    return x.view(n, e), 1 + 0.1 * torch.randn(e, generator=g, device=cuda)


# Widths each form of the forward kernel takes: rows of at most 2 KB whose
# width is a multiple of the 16-byte vector (8 values in bf16, 4 in f32) in
# registers (bf16 768, 384 and 1024; f32 384 and 100), the rest in the
# loop form (f32 768 and 4096; bf16 100 and 4096; an unaligned x).  A
# block takes ceil(N / SMs) rows, up to 8, so N = 301 (3 a block) and 1001
# (8 a block) leave warps past N in the last block, and N = 37 gives each
# row a block of its own.  N = 8192 is more rows than the grid's warps, so
# each warp takes several.
RMS_FWD_FORMS = [   # (dtype, E, unaligned, form)
    (torch.bfloat16, 768, False, "regs"), (torch.bfloat16, 384, False, "regs"),
    (torch.bfloat16, 1024, False, "regs"), (torch.float32, 384, False, "regs"),
    (torch.float32, 100, False, "regs"), (torch.float32, 768, False, "loop"),
    (torch.bfloat16, 100, False, "loop"), (torch.float32, 4096, False, "loop"),
    (torch.bfloat16, 4096, False, "loop"), (torch.bfloat16, 768, True, "loop")]


@pytest.mark.parametrize("n", [1, 8, 37, 301, 1000, 1001, 8192])
@pytest.mark.parametrize("dtype,e,unaligned,form", RMS_FWD_FORMS)
def test_rmsnorm_kernel_matches_plain(cuda, dtype, e, unaligned, form, n):
    x, scale = _rms_inputs(cuda, dtype, n, e, unaligned=unaligned)
    before = trn.KERNEL.launches
    y = trn.rms_norm(x, scale)
    torch.cuda.synchronize()
    assert trn.KERNEL.launches == before + 1
    assert y.dtype == dtype and y.shape == x.shape
    tol = 1e-5 if dtype == torch.float32 else 1.6e-2
    torch.testing.assert_close(y.float(), trn.rms_norm_reference(
        x, scale).float(), atol=1e-5, rtol=tol)


@pytest.mark.parametrize("dtype,e,unaligned,form", RMS_FWD_FORMS)
def test_rmsnorm_forward_is_one_launch_of_its_form(cuda, dtype, e, unaligned,
                                                   form):
    # One call is one kernel on the card, and the shape and alignment pick
    # the form.
    x, scale = _rms_inputs(cuda, dtype, 2048, e, unaligned=unaligned)
    names = trace.kernels_in_one_call(lambda: trn.rms_norm(x, scale))
    assert len(names) == 1 and trace.kind_of(names[0]) == "rmsnorm_fwd", names
    assert ("rmsnorm_fwd_regs_kernel" in names[0]) == (form == "regs"), names


@pytest.mark.parametrize("dtype,e", [
    (torch.bfloat16, 768), (torch.float32, 384),     # register form
    (torch.bfloat16, 100), (torch.float32, 768)])    # loop form
def test_rmsnorm_forward_rows_do_not_depend_on_n(cuda, dtype, e):
    # A row has the same bits whatever the call's N: alone (decode of one),
    # within 8 rows (a decode batch) and within 1024 (a prefill).
    x, scale = _rms_inputs(cuda, dtype, 1024, e, seed=5)
    full = trn.rms_norm(x, scale)
    for i in (0, 7, 8, 517, 1023):
        alone = trn.rms_norm(x[i:i + 1], scale)
        first = min(i - i % 8, 1016)
        batch = trn.rms_norm(x[first:first + 8], scale)
        torch.cuda.synchronize()
        assert torch.equal(alone[0], full[i])
        assert torch.equal(batch[i - first], full[i])


# Widths each form of the backward kernel takes: rows of at most 2 KB whose
# width is a multiple of 8 in registers (bf16 768, 384, 1024; f32 384), the
# loop form up to WIDE_BWD_WIDTH (f32 768, 1024; 100, 4096 and 7168 in both
# dtypes), the wide form past it, a block a row, with its row of dscale
# partials in shared memory (8192, 12288, 57856) or, past 57856, in device
# memory (57857, 65536).  N above 8 * MAX_BWD_BLOCKS rows makes each warp
# take several rows, and above MAX_BWD_BLOCKS each wide block; N up to 128
# runs one group of blocks, whose sum is dscale itself.
RMS_BWD_CASES = [(1, 768), (1000, 768), (8192, 768), (37, 384),
                 (3000, 1024), (300, 100), (2500, 4096), (500, 7168),
                 (1, 8192), (1000, 8192), (300, 12288), (37, 57856),
                 (37, 57857), (300, 65536)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,e", RMS_BWD_CASES)
def test_rmsnorm_backward_kernel_matches_plain(cuda, dtype, n, e):
    g = torch.Generator(device=cuda).manual_seed(2)
    x = torch.randn(n, e, generator=g, device=cuda, dtype=dtype)
    dy = torch.randn(n, e, generator=g, device=cuda, dtype=dtype)
    scale = 1 + 0.1 * torch.randn(e, generator=g, device=cuda)
    before = trn.BWD_KERNEL.launches
    dx, dscale = trn.rms_norm_backward(x, scale, dy)
    want_dx, want_dscale = trn.rms_norm_backward_reference(x, scale, dy)
    torch.cuda.synchronize()
    assert trn.BWD_KERNEL.launches == before + 1
    assert dx.dtype == dtype and dscale.dtype == torch.float32
    tol = 1e-5 if dtype == torch.float32 else 1.6e-2
    torch.testing.assert_close(dx.float(), want_dx.float(), atol=1e-4,
                               rtol=tol)
    # dscale sums N f32 terms in another order: relative to sqrt(N).
    torch.testing.assert_close(dscale, want_dscale, atol=1e-4 * n ** 0.5,
                               rtol=1e-5)


def _rms_bwd_inputs(cuda, dtype, n, e, seed=2):
    g = torch.Generator(device=cuda).manual_seed(seed)
    x, dy = (torch.randn(n, e, generator=g, device=cuda, dtype=dtype)
             for _ in range(2))
    return x, 1 + 0.1 * torch.randn(e, generator=g, device=cuda), dy


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,e", [(8192, 768), (2500, 100)])
def test_rmsnorm_backward_kernel_is_deterministic(cuda, dtype, n, e):
    # Every sum runs in an order fixed by block index: two launches give
    # bit-equal dscale (and dx).
    x, scale, dy = _rms_bwd_inputs(cuda, dtype, n, e, seed=4)
    first = trn.rms_norm_backward(x, scale, dy)
    second = trn.rms_norm_backward(x, scale, dy)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype,e,form", [
    (torch.bfloat16, 768, "regs"), (torch.bfloat16, 100, "loop"),
    (torch.float32, 384, "regs"), (torch.float32, 768, "loop"),
    (torch.bfloat16, 7168, "loop"), (torch.bfloat16, 8192, "wide"),
    (torch.float32, 65536, "wide")])
def test_rmsnorm_backward_is_one_launch_of_its_form(cuda, dtype, e, form):
    # One call is one kernel on the card (the cross-block dscale sum
    # included), and the width picks the form.
    x, scale, dy = _rms_bwd_inputs(cuda, dtype, 2048, e)
    names = trace.kernels_in_one_call(
        lambda: trn.rms_norm_backward(x, scale, dy))
    assert len(names) == 1, names
    assert trace.kind_of(names[0]) == "rmsnorm_bwd", names
    assert ("rmsnorm_bwd_regs_kernel" in names[0]) == (form == "regs"), names
    assert ("rmsnorm_bwd_wide_kernel" in names[0]) == (form == "wide"), names


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("e", [8192, 12288, 65536])
def test_rmsnorm_backward_wide_rows_do_not_depend_on_n(cuda, dtype, e):
    # The wide form's rows: a row's dx has the same bits alone, among 8
    # and among 1024 rows, whatever the grid; and dscale is deterministic.
    x, scale, dy = _rms_bwd_inputs(cuda, dtype, 1024, e, seed=6)
    full, full_ds = trn.rms_norm_backward(x, scale, dy)
    again, again_ds = trn.rms_norm_backward(x, scale, dy)
    want, want_ds = trn.rms_norm_backward_reference(x, scale, dy)
    for i in (0, 7, 8, 517, 1023):
        alone = trn.rms_norm_backward(x[i:i + 1], scale, dy[i:i + 1])[0]
        first = min(i - i % 8, 1016)
        batch = trn.rms_norm_backward(x[first:first + 8], scale,
                                      dy[first:first + 8])[0]
        torch.cuda.synchronize()
        assert torch.equal(alone[0], full[i])
        assert torch.equal(batch[i - first], full[i])
    assert torch.equal(full, again) and torch.equal(full_ds, again_ds)
    tol = 1e-5 if dtype == torch.float32 else 1.6e-2
    torch.testing.assert_close(full.float(), want.float(), atol=1e-4,
                               rtol=tol)
    torch.testing.assert_close(full_ds, want_ds, atol=1e-4 * 1024 ** 0.5,
                               rtol=1e-5)
