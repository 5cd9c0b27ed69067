"""The decode attention of the model's cache path: its plain version and
routing on the CPU, and the CUDA kernel against the plain version on the
card.

On the CPU: the plain version is the cache path's einsum arithmetic bit
for bit, the CPU path never touches the kernel, the wrapper's checks
raise, and the serving backend's ``kv_read_share`` counts the positions
its cache steps read.  The ``cuda``-marked tests skip without a card; on
one, ``python -m pytest --noconftest tests/test_torch_decode_attention.py``
builds ``csrc/decode_attention.cu`` and holds it against the f32 plain
version at ragged lengths, its slots independent of the batch, and a
``TransformerBackend`` decode through it.  This file imports no JAX.
"""

import types

import numpy as np
import pytest
import torch

from horovod_tpu_torch.models import transformer as ttm
from horovod_tpu_torch.ops import _build
from horovod_tpu_torch.ops import decode_attention as da
from horovod_tpu_torch.serving.engine import (ServingConfig, ServingEngine,
                                              StubBackend,
                                              TransformerBackend)
from horovod_tpu_torch.utils import trace


def _todays_arithmetic(q, k_cache, v_cache, lengths):
    """The cache path's attention as the model computed it before the
    kernel: bf16 einsums, an f32 softmax with a -1e30 mask."""
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k_cache).float() * scale
    s, s_q = k_cache.shape[1], q.shape[1]
    qpos = lengths[:, None] + torch.arange(s_q, device=q.device)[None, :]
    mask = (torch.arange(s, device=q.device)[None, None, :]
            <= qpos[:, :, None])[:, None, :, :]
    logits = logits.masked_fill(~mask, -1e30)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v_cache)


def _inputs(b, s_q, s, h, d, dtype, device="cpu", seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    q = torch.randn(b, s_q, h, d, generator=g, device=device, dtype=dtype)
    k, v = (torch.randn(b, s, h, d, generator=g, device=device, dtype=dtype)
            for _ in range(2))
    return q, k, v


# -- CPU ---------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s_q", [1, 3])
def test_plain_version_is_todays_arithmetic_bit_for_bit(dtype, s_q):
    q, k, v = _inputs(3, s_q, 40, 2, 16, dtype)
    lengths = torch.tensor([0, 17, 40 - s_q])
    want = _todays_arithmetic(q, k, v, lengths)
    for fn in (da.decode_attention_reference, da.decode_attention,
               ttm.cached_decode_attention):
        got = fn(q, k, v, lengths)
        assert got.dtype == dtype and torch.equal(got, want), fn.__name__


def _small_cfg(**kw):
    return ttm.TransformerConfig(**{
        **dict(vocab_size=64, num_layers=2, num_heads=2, head_dim=64,
               embed_dim=32, mlp_dim=64, max_seq_len=128,
               dtype=torch.float32), **kw})


def test_cpu_path_never_touches_the_kernel(monkeypatch):
    def refuse():
        raise AssertionError("the CPU path loaded the CUDA kernel")

    monkeypatch.setattr(da.KERNEL, "load", refuse)
    before = da.KERNEL.launches
    # A block the kernel would take on the card: 1 row, head dim 64.
    q, k, v = _inputs(2, 1, 50, 2, 64, torch.float32)
    lengths = torch.tensor([3, 49])
    assert not da.kernel_takes(q)
    torch.testing.assert_close(ttm.cached_decode_attention(q, k, v, lengths),
                               _todays_arithmetic(q, k, v, lengths),
                               atol=0, rtol=0)
    torch.manual_seed(0)
    backend = TransformerBackend(ttm.Transformer(_small_cfg(), "cpu"), 2,
                                 128)
    backend.decode(np.array([5, 6]), np.array([4, 9]))
    assert da.KERNEL.launches == before


@pytest.mark.parametrize("shape,takes", [
    ((32, 1, 32, 128), True), ((8, 16, 6, 128), True), ((4, 5, 8, 64), True),
    ((1, 17, 2, 64), False), ((2, 1, 4, 96), False), ((2, 1, 4, 8), False)])
def test_kernel_takes_decode_and_verify_blocks(shape, takes):
    # The route the model's cache path takes on a CUDA tensor, by shape.
    assert da.kernel_takes(types.SimpleNamespace(is_cuda=True,
                                                 shape=shape)) is takes


@pytest.mark.parametrize("heads,head_dim,elem_bytes,group", [
    (32, 128, 2, 4), (6, 128, 2, 3), (32, 64, 2, 8), (32, 128, 4, 2),
    (1, 128, 2, 1), (6, 64, 4, 3), (7, 128, 2, 1)])
def test_head_group_is_the_largest_divisor_that_fits(heads, head_dim,
                                                     elem_bytes, group):
    assert da.head_group(heads, head_dim, elem_bytes) == group
    assert group * head_dim * elem_bytes <= da.ROW_BYTES


@pytest.mark.parametrize("name", [
    "void (anonymous namespace)::decode_attention_split_kernel<"
    "__nv_bfloat16, 128>(__nv_bfloat16 const*, __nv_bfloat16 const*",
    "void (anonymous namespace)::decode_attention_merge_kernel<float, 64>("
    "float const*, float const*, long const*, float*, int"])
def test_traces_name_the_pair_by_its_kind(name):
    assert trace.kind_of(name) == "decode_attention"


def _bad_inputs(case):
    q, k, v = _inputs(2, 1, 32, 2, 64, torch.float32)
    lengths = torch.tensor([0, 5])
    if case == "dtype":
        q, k, v = (t.half() for t in (q, k, v))
    elif case == "rows":
        q = torch.zeros(2, 17, 2, 64)
    elif case == "head_dim":
        q, k, v = _inputs(2, 1, 32, 2, 96, torch.float32)
    elif case == "cache_shape":
        k = k[:, :, :1].contiguous()
    elif case == "cache_dtype":
        v = v.double()
    elif case == "lengths":
        lengths = torch.tensor([0, 5, 7])
    elif case == "strided":
        k = k.transpose(0, 1).contiguous().transpose(0, 1)
    return q, k, v, lengths


@pytest.mark.parametrize("case", ["dtype", "rows", "head_dim", "cache_shape",
                                  "cache_dtype", "lengths", "strided"])
def test_wrapper_checks_raise_on_what_the_kernel_does_not_take(case):
    with pytest.raises(ValueError, match="decode_attention"):
        da._check(*_bad_inputs(case))


def test_kv_read_share_counts_the_positions_of_each_cache_step():
    torch.manual_seed(0)
    backend = TransformerBackend(ttm.Transformer(_small_cfg(), "cpu"), 3,
                                 128)
    assert backend.kv_read_stats()["kv_read_share"] == 0.0
    # The engine's lengths count the pending token: w = max(len - 1, 0).
    backend.decode(np.array([1, 2, 3]), np.array([0, 10, 100]))
    backend.verify(np.zeros((3, 4), np.int64), np.array([5, 1, 60]))
    read = (0 + 9 + 99 + 3 * 1) + (4 + 0 + 59 + 3 * 4)
    assert backend.kv_positions_read == read
    assert backend.kv_positions_dense == 2 * 3 * 128
    st = backend.kv_read_stats()
    assert st["kv_read_share"] == read / (2 * 3 * 128)
    assert st["decode_attention_launches"] == da.KERNEL.launches
    eng = ServingEngine(backend, ServingConfig(num_slots=3, buckets=(8,),
                                               max_seq_len=128))
    eng.submit([1, 2, 3], 4)
    eng.run_until_idle()
    assert 0.0 < eng.stats()["kv_read_share"] < 1.0
    # The stub engine's counters stay the JAX engine's.
    assert "kv_read_share" not in ServingEngine(
        StubBackend(2), ServingConfig(num_slots=2, buckets=(8,))).stats()


# -- the card ----------------------------------------------------------------

@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    da.KERNEL.load()
    return torch.device("cuda")


def _lengths(b, s, s_q, device):
    """Ragged lengths: 0, 1, a chunk boundary and each side of it, the
    last position, the rest spread over the slot."""
    c = da.CHUNK
    edges = [0, 1, c - 1, c, c + 1, s - 1, 2 * c - 1, s - s_q]
    rest = torch.randint(0, s, (b,), generator=torch.Generator().manual_seed(
        b + s + s_q)).tolist()
    return torch.tensor([min(x, s - 1) for x in edges + rest][:b],
                        device=device)


def _close(got, want, dtype):
    """f32: the kernel and the plain version differ in summation order and
    in exp2 against exp.  bf16: the kernel rounds an f32 result once, half
    a bf16 ulp (2**-9 relative), against the plain version in f32 on the
    same bf16 inputs; 2**-8 leaves room for the f32 differences at a
    rounding boundary, and atol for outputs near zero."""
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all()
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    else:
        torch.testing.assert_close(got, want, atol=1e-4, rtol=2**-8)


CARD_SHAPES = [   # (B, S, H, D, dtype)
    (32, 4096, 32, 128, torch.bfloat16),   # the serving cell's decode
    (8, 2048, 6, 128, torch.bfloat16),     # the 162M decoder (3 heads a block)
    (5, 600, 8, 64, torch.bfloat16),       # D = 64, S no multiple of a chunk
    (4, 700, 4, 128, torch.float32),
    (3, 300, 6, 64, torch.float32)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CARD_SHAPES,
                         ids=lambda s: "x".join(map(str, s[:4])) + str(s[4]))
@pytest.mark.parametrize("s_q", [1, 5, 16])
def test_kernel_matches_f32_plain_version(cuda, shape, s_q):
    b, s, h, d, dtype = shape
    q, k, v = _inputs(b, s_q, s, h, d, dtype, cuda, seed=s_q)
    lengths = _lengths(b, s, s_q, cuda)
    before = da.KERNEL.launches
    got = da.decode_attention(q, k, v, lengths)
    assert da.KERNEL.launches == before + 1
    assert got.shape == q.shape and got.dtype == dtype
    want = da.decode_attention_reference(q.float(), k.float(), v.float(),
                                         lengths)
    torch.cuda.synchronize()
    _close(got, want, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("s_q", [1, 5])
def test_slot_alone_matches_slot_in_a_batch_of_32(cuda, s_q):
    b, s, h, d = 32, 4096, 32, 128
    q, k, v = _inputs(b, s_q, s, h, d, torch.bfloat16, cuda, seed=7)
    lengths = _lengths(b, s, s_q, cuda)
    batch = da.decode_attention(q, k, v, lengths)
    for slot in (0, 3, 5, 17, 31):
        alone = da.decode_attention(q[slot:slot + 1], k[slot:slot + 1],
                                    v[slot:slot + 1],
                                    lengths[slot:slot + 1])
        assert torch.equal(alone[0], batch[slot]), slot


@pytest.mark.cuda
def test_backend_decode_runs_the_kernel_once_a_layer(cuda):
    cfg = _small_cfg(num_layers=3, num_heads=4, embed_dim=256, mlp_dim=512,
                     max_seq_len=512, dtype=torch.bfloat16)
    torch.manual_seed(0)
    backend = TransformerBackend(ttm.Transformer(cfg, cuda), 4, 512)
    _build.reset_launches()
    lengths = np.array([1, 5, 300, 0])
    backend.decode(np.array([1, 2, 3, 4]), lengths)
    torch.cuda.synchronize()
    assert da.KERNEL.launches == cfg.num_layers
    backend.verify(np.ones((4, 3), np.int64), lengths)
    assert da.KERNEL.launches == 2 * cfg.num_layers
    w = np.maximum(lengths - 1, 0)
    read = (w.sum() + 4 * 1) + (w.sum() + 4 * 3)
    st = backend.kv_read_stats()
    assert st["kv_read_share"] == read / (2 * 4 * 512)
    assert st["decode_attention_launches"] == 2 * cfg.num_layers
