"""Flash attention: the CUDA kernels ``csrc/flash_fwd.cu``,
``csrc/flash_bwd_dq.cu`` and ``csrc/flash_bwd_dkv.cu``, each beside its
plain PyTorch version, and the ``torch.autograd.Function`` that joins them.

Counterpart of ``horovod_tpu/ops/flash_attention.py``.  The contract is the
JAX package's public one, over ``[B, S, H, D]`` tensors:

* ``scale * log2(e)`` is folded into q, which is rounded to the input dtype
  once; scores live in the log2 domain and the softmax runs on ``exp2``;
* a key at global position ``k_offset + j`` is visible to the query at
  ``q_offset + i`` iff ``not causal or q_offset + i >= k_offset + j``;
* the output is the f32 accumulator divided by ``max(l, 1e-30)`` and cast to
  the input dtype, and ``lse[b, s, h]`` is the natural-log log-sum-exp in
  f32, :data:`NEG_INF` for a row that attended to nothing;
* the backward recomputes ``p = exp2(s - lse * log2(e))`` from the saved
  lse (0 on rows that attended to nothing), rounds ``ds = p * (dp - Δ)`` to
  the input dtype before both of its products, keeps p in f32 for dv (the
  bf16 kernels: below), and applies ``scale`` to dq and ``ln 2`` to dk
  once, at the end.

A CUDA tensor launches the kernels (float32 or bfloat16, any layout, any
``head_dim``, any batch·heads) or raises; a CPU tensor takes the plain
versions.  The wrappers hand the kernels contiguous ``[B, S, H, D]``
copies of strided inputs, and zero-pad the head dim up to the next of 64,
128 and 256, or past 256 to the next multiple of 64 (:func:`kernel_head_dim`);
the outputs and gradients are sliced back.  That is exact: zero columns
add nothing to ``q·kᵀ``, and the padded columns of the output, dq, dk and
dv are zero.  The scale is the unpadded head dim's, passed from the host.
Every kernel puts batch·heads on the grid's x axis, so it is not capped
at 65535.  On the card the route follows the dtype and the (padded) head
dim:

* float32 at 64, 128 and 256, and bfloat16 at 256, run every product on
  the CUDA cores in f32, with p in f32 as in the plain versions (the
  f32 tiles of 256 wide rows fill a block's shared memory, so those
  kernels take 32-row q tiles for dq and 32-key tiles for dk/dv);
* both dtypes past 256 run the CUDA-core route's arithmetic with each
  block owning one 64-column slice of the output (or of dq, dk and dv) on
  the grid's third axis: the products that sum over D (``q·kᵀ``, and
  ``dO·vᵀ`` in the backward) loop over D in 64-wide chunks, and every
  slice recomputes the same scores and row statistics;
* bfloat16 at 64 and 128 runs all three kernels on the tensor cores,
  whose operands are bf16, so p is carried there as follows (the plain
  versions keep f32 p, the JAX contract; ``l`` sums the f32 p in both):

* forward ``p·V``: p enters as two bf16 terms, ``bf16(p)`` and
  ``bf16(p - bf16(p))`` (~16 significant bits), so the output agrees with
  the f32-p product to f32 rounding;
* dk/dv ``pᵀ·dO``: p is rounded to bf16 once, the single bf16 MXU pass
  that the TPU kernel's f32 ``p·dO`` product takes
  (``horovod_tpu/ops/flash_attention.py:142-146``, ``:560-564``); ds is
  formed from the f32 p;
* dq ``ds·K``: ds is formed from the f32 p and rounded to bf16, as the
  contract already rounds it, so dq adds no rounding of its own: its
  operands (q̃, K, V, dO, ds) are all bf16 values already.

:func:`flash_attention` is differentiable on every device through
:class:`_Flash`; :func:`flash_attention_with_lse` is forward-only, as in
the JAX package, and :func:`flash_attention_backward` takes lse and Δ
explicitly, so ring attention can drive both per step with merged
statistics.  The TPU tiling knobs (``block_q``, ``block_k``, ``sub``) are
accepted so call sites match, and ignored: the kernels' tiles are their own.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from horovod_tpu_torch.ops import _build
from horovod_tpu_torch.utils import profiling

NEG_INF = -1e30
LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
KERNEL = _build.register(
    "flash_fwd", "hvd_flash_fwd",
    [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _P])
DQ_KERNEL = _build.register(
    "flash_bwd_dq", "hvd_flash_bwd_dq",
    [_P] * 7 + [_I] * 9 + [_F, _F, _P])
DKV_KERNEL = _build.register(
    "flash_bwd_dkv", "hvd_flash_bwd_dkv",
    [_P] * 8 + [_I] * 9 + [_F, _P])
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# The head dims the tiled kernels are built for; others up to 256 are
# zero-padded up, and past 256 to a multiple of _WIDE_CHUNK (the wide route).
_HEAD_DIMS = (64, 128, 256)
_WIDE_CHUNK = 64


def _on_cuda(t: torch.Tensor) -> bool:
    return t.is_cuda


def _fold_q(q):
    """q times ``scale * log2(e)``, rounded to q's dtype once, as f32."""
    return (q.float() * (q.shape[-1] ** -0.5 * LOG2E)).to(q.dtype).float()


def _visible(s_q, s_k, causal, q_offset, k_offset, device):
    """``[S_q, S_k]`` mask of the (query, key) pairs that attend."""
    if not causal:
        return torch.ones(s_q, s_k, dtype=torch.bool, device=device)
    qpos = int(q_offset) + torch.arange(s_q, device=device)
    kpos = int(k_offset) + torch.arange(s_k, device=device)
    return qpos[:, None] >= kpos[None, :]


# f32 scores the plain versions hold at once: longer rows of queries are
# taken in chunks, so that a long sequence's [B, H, S_q, S_k] scores never
# exist whole (at S = 32768 and 16 heads they would take 68.7 GB).
PLAIN_CHUNK_ELEMS = 1 << 28


def _q_chunks(q, s_k):
    """``(start, stop)`` of the chunks of query rows the plain versions
    take in turn; one chunk unless the scores pass
    :data:`PLAIN_CHUNK_ELEMS`."""
    b, s_q, h = q.shape[:3]
    rows = max(1, PLAIN_CHUNK_ELEMS // max(b * h * s_k, 1))
    return [(i, min(i + rows, s_q)) for i in range(0, s_q, rows)] or [(0, 0)]


def flash_attention_reference(q, k, v, causal: bool = True, q_offset=0,
                              k_offset=0):
    """Plain PyTorch version of the forward kernel's arithmetic, dense over
    all (q, k) pairs: same q fold and rounding, same exp2-domain softmax,
    same output and lse contract.  Returns ``(out, lse)``."""
    chunks = _q_chunks(q, k.shape[1])
    if len(chunks) > 1:
        parts = [_flash_reference(q[:, i:j], k, v, causal, q_offset + i,
                                  k_offset) for i, j in chunks]
        return (torch.cat([o for o, _ in parts], dim=1),
                torch.cat([lse for _, lse in parts], dim=1))
    return _flash_reference(q, k, v, causal, q_offset, k_offset)


def _flash_reference(q, k, v, causal, q_offset, k_offset):
    mask = _visible(q.shape[1], k.shape[1], causal, q_offset, k_offset,
                    q.device)
    s = torch.einsum("bqhd,bkhd->bhqk", _fold_q(q), k.float())
    s = s.masked_fill(~mask, NEG_INF)
    m = s.amax(dim=-1, keepdim=True) if k.shape[1] else \
        s.new_full(s.shape[:-1] + (1,), NEG_INF)   # no keys: nothing seen
    p = torch.where(mask, torch.exp2(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)                        # [b, h, q, 1]
    denom = l.clamp_min(1e-30)
    o = torch.einsum("bhqk,bkhd->bhqd", p, v.float()) / denom
    lse = torch.where(l > 0, m * LN2 + torch.log(denom),
                      torch.full_like(l, NEG_INF))
    return (o.permute(0, 2, 1, 3).to(q.dtype),
            lse[..., 0].permute(0, 2, 1).contiguous())


def _bwd_p_ds(q, k, v, dout, lse, delta, causal, q_offset, k_offset):
    """The backward's recomputed ``p`` (f32) and ``ds`` (rounded to the
    input dtype), ``[B, H, S_q, S_k]``, and the folded q."""
    mask = _visible(q.shape[1], k.shape[1], causal, q_offset, k_offset,
                    q.device)
    qs = _fold_q(q)
    s = torch.einsum("bqhd,bkhd->bhqk", qs, k.float())
    lse_t = lse.float().permute(0, 2, 1)[..., None]         # [b, h, q, 1]
    attended = lse_t > NEG_INF / 2
    p = torch.where(mask & attended, torch.exp2(s - lse_t * LOG2E), 0.0)
    dp = torch.einsum("bqhd,bkhd->bhqk", dout.to(q.dtype).float(), v.float())
    ds = p * (dp - delta.float().permute(0, 2, 1)[..., None])
    return p, ds.to(q.dtype).float(), qs


def flash_bwd_dq_reference(q, k, v, dout, lse, delta, causal: bool = True,
                           q_offset=0, k_offset=0):
    """Plain PyTorch version of the dq kernel: ``scale * Σ_k ds·K``, in
    q's dtype."""
    parts = []
    for i, j in _q_chunks(q, k.shape[1]):
        _, ds, _ = _bwd_p_ds(q[:, i:j], k, v, dout[:, i:j], lse[:, i:j],
                             delta[:, i:j], causal, q_offset + i, k_offset)
        parts.append(torch.einsum("bhqk,bkhd->bqhd", ds, k.float())
                     * q.shape[-1] ** -0.5)
    return torch.cat(parts, dim=1).to(q.dtype)


def flash_bwd_dkv_reference(q, k, v, dout, lse, delta, causal: bool = True,
                            q_offset=0, k_offset=0):
    """Plain PyTorch version of the dk/dv kernel: ``dk = ln 2 · Σ_q dsᵀ·q̃``
    and ``dv = Σ_q pᵀ·dO``, in k's and v's dtypes (summed over the chunks
    of query rows in turn)."""
    dk = dv = 0.0
    for i, j in _q_chunks(q, k.shape[1]):
        p, ds, qs = _bwd_p_ds(q[:, i:j], k, v, dout[:, i:j], lse[:, i:j],
                              delta[:, i:j], causal, q_offset + i, k_offset)
        dk = dk + torch.einsum("bhqk,bqhd->bkhd", ds, qs) * LN2
        dv = dv + torch.einsum("bhqk,bqhd->bkhd", p,
                               dout[:, i:j].to(q.dtype).float())
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_backward_reference(q, k, v, dout, lse, delta,
                                       causal: bool = True, q_offset=0,
                                       k_offset=0):
    """Plain PyTorch version of :func:`flash_attention_backward`."""
    dq = flash_bwd_dq_reference(q, k, v, dout, lse, delta, causal, q_offset,
                                k_offset)
    dk, dv = flash_bwd_dkv_reference(q, k, v, dout, lse, delta, causal,
                                     q_offset, k_offset)
    return dq, dk, dv


def kernel_head_dim(d: int) -> int:
    """The head dim the kernels run ``d`` at: the least of
    :data:`_HEAD_DIMS` that is at least ``d``, or past 256 the least
    multiple of 64 that is (the wide route, which takes any such D)."""
    for kd in _HEAD_DIMS:
        if d <= kd:
            return kd
    return -(-d // _WIDE_CHUNK) * _WIDE_CHUNK


# Streaming multiprocessors of the card the kernels are built for (H100
# SXM), where no card is present: the tensor-core forward and dq take
# 128-row q tiles when those give every SM a block, as their launchers
# decide from the card's own count.
H100_SMS = 132


def _card_sms() -> int:
    if torch.cuda.is_available():
        return torch.cuda.get_device_properties(
            torch.cuda.current_device()).multi_processor_count
    return H100_SMS


def kernel_tiles(head_dim: int, dtype_bytes: int = 2, s_q: int = 1,
                 batch_heads: int = 1, sms: int | None = None) -> dict:
    """``{kernel: (block_q, block_k, shared-memory bytes a block)}`` of the
    three flash kernels at one call's shape, as their launchers in
    ``csrc/flash_*.cu`` choose them: on the tensor cores (bf16, padded D of
    64 or 128) 64-key tiles in a two-stage TMA ring, with 128-row q tiles
    for the forward and dq when ``ceil(s_q / 128) · batch_heads`` reaches
    ``sms`` (default: the card's count, or :data:`H100_SMS` without one),
    else 64, and 64-key dk/dv blocks over 64-row q tiles; on the CUDA
    cores (f32, or D = 256) 64 × 64 f32 tiles, with 32-row dq and 32-key
    dk/dv tiles at D = 256; past 256 the wide route's 64 × 64 tiles of
    64-column chunks.  This needs no card, so a plan can be made anywhere;
    :func:`launcher_tiles` asks the built launchers themselves, and
    ``chip_smoke.py`` holds the two equal."""
    if sms is None:
        sms = _card_sms()
    d = kernel_head_dim(head_dim)
    if dtype_bytes == 2 and d in (64, 128):
        tile = (d // 64) * 64 * 128          # 64 rows of d bf16, in chunks
        bars = 8 * 5 + 1024                  # barriers, alignment slack
        nwg = 2 if -(-s_q // 128) * batch_heads >= sms else 1
        return {"flash_fwd": (64 * nwg, 64, (nwg + 4) * tile + bars),
                "flash_bwd_dq": (64 * nwg, 64, (2 * nwg + 4) * tile + bars),
                "flash_bwd_dkv": (64, 64, 6 * tile + 2 * 2 * 64 * 4 + bars)}
    f32 = 4
    if d > 256:                              # the wide route, 64-col chunks
        c = _WIDE_CHUNK
        return {"flash_fwd": (64, 64, f32 * (64 * c + 64 * (c + 1) + 64 * c
                                             + 8 * 4 * 64)),
                "flash_bwd_dq": (64, 64, f32 * (2 * 64 * c + 2 * 64 * (c + 1)
                                                + 64 * c + 8 * 4 * 64
                                                + 3 * 64)),
                "flash_bwd_dkv": (64, 64, f32 * (2 * 64 * c
                                                 + 2 * 64 * (c + 1)
                                                 + 2 * 64 * c
                                                 + 2 * 8 * 4 * 64 + 3 * 64))}
    bq_dq = bk_dkv = 32 if d > 128 else 64
    return {"flash_fwd": (64, 64, f32 * (64 * d + 64 * (d + 1) + 64 * d
                                         + 8 * 4 * 64)),
            "flash_bwd_dq": (bq_dq, 64, f32 * (2 * bq_dq * d + 2 * 64 * (d + 1)
                                               + 8 * 4 * 64 + 3 * bq_dq)),
            "flash_bwd_dkv": (64, bk_dkv, f32 * (2 * bk_dkv * d
                                                 + 2 * 64 * (d + 1)
                                                 + 2 * 8 * 4 * 64 + 3 * 64))}


def launcher_tiles(head_dim: int, dtype_bytes: int = 2, s_q: int = 1,
                   batch_heads: int = 1, device=None) -> dict:
    """:func:`kernel_tiles`'s answer from the built launchers on the card:
    each kernel's library reports the tiles and shared memory its launch
    at this shape would take (``hvd_flash_*_tiles``).  Builds the kernels
    if needed; launches nothing."""
    d = kernel_head_dim(head_dim)
    dtype = {2: _DTYPES[torch.bfloat16], 4: _DTYPES[torch.float32]}[
        dtype_bytes]
    tiles = {}
    for kernel in (KERNEL, DQ_KERNEL, DKV_KERNEL):
        query = kernel.entry(kernel.symbol + "_tiles",
                             [_I] * 5 + [ctypes.POINTER(ctypes.c_int)])
        got = (ctypes.c_int * 3)()
        with torch.cuda.device(device):
            rc = query(dtype, 1, batch_heads, s_q, d, got)
        if rc:
            raise RuntimeError(f"{kernel.name}: no launch at dtype_bytes="
                               f"{dtype_bytes}, head dim {d}")
        tiles[kernel.name] = tuple(got)
    return tiles


def _kernel_layout(d_kernel, *ts):
    """Each of ``ts`` contiguous, its last axis zero-padded to
    ``d_kernel``."""
    return [t.contiguous() if t.shape[-1] == d_kernel
            else F.pad(t, (0, d_kernel - t.shape[-1])) for t in ts]


def _unpad(t, d):
    return t if t.shape[-1] == d else t[..., :d].contiguous()


def _check_cuda_inputs(q, k, v):
    if q.dtype not in _DTYPES or not q.dtype == k.dtype == v.dtype:
        raise ValueError(f"flash_attention: CUDA kernel takes float32 or "
                         f"bfloat16 q/k/v of one dtype, got {q.dtype}, "
                         f"{k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4 or \
            q.shape[0] != k.shape[0] or q.shape[2:] != k.shape[2:]:
        raise ValueError(f"flash_attention: expected q [B,Sq,H,D] and k, v "
                         f"[B,Sk,H,D], got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if not (k.is_cuda and v.is_cuda and q.device == k.device == v.device):
        raise ValueError("flash_attention: q, k, v must be on one CUDA device")


def _check_cuda_grad_inputs(q, dout, lse, delta):
    if dout.shape != q.shape or dout.device != q.device:
        raise ValueError(f"flash_attention_backward: dout must be "
                         f"{tuple(q.shape)} on {q.device}, got "
                         f"{tuple(dout.shape)} on {dout.device}")
    stats = q.shape[:3]
    for name, t in (("lse", lse), ("delta", delta)):
        if t.shape != stats or t.dtype != torch.float32 or \
                t.device != q.device or not t.is_contiguous():
            raise ValueError(f"flash_attention_backward: {name} must be "
                             f"contiguous float32 {tuple(stats)} on "
                             f"{q.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")


def _flash_cuda(q, k, v, causal, q_offset, k_offset):
    _check_cuda_inputs(q, k, v)
    b, s_q, h, d = q.shape
    d_kernel = kernel_head_dim(d)
    q, k, v = _kernel_layout(d_kernel, q, k, v)
    out = torch.empty_like(q)
    lse = torch.empty((b, s_q, h), dtype=torch.float32, device=q.device)
    if s_q:
        with torch.cuda.device(q.device):
            KERNEL(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                   lse.data_ptr(), _DTYPES[q.dtype], b, h, s_q, k.shape[1],
                   d_kernel, int(bool(causal)), int(q_offset), int(k_offset),
                   d ** -0.5 * LOG2E, _build.stream_of(q))
    return _unpad(out, d), lse


def _bwd_cuda_args(q, k, v, dout, lse, delta, causal, q_offset, k_offset):
    """Checked inputs of a backward kernel: q, k, v and ``dout`` (in q's
    dtype) in the kernels' layout, the shared arguments after the pointers,
    and the unpadded head dim."""
    _check_cuda_inputs(q, k, v)
    dout = dout.to(q.dtype)
    _check_cuda_grad_inputs(q, dout, lse, delta)
    b, s_q, h, d = q.shape
    d_kernel = kernel_head_dim(d)
    return _kernel_layout(d_kernel, q, k, v, dout), (
        _DTYPES[q.dtype], b, h, s_q, k.shape[1], d_kernel,
        int(bool(causal)), int(q_offset), int(k_offset),
        d ** -0.5 * LOG2E), d


def flash_bwd_dq(q, k, v, dout, lse, delta, causal: bool = True,
                 q_offset=0, k_offset=0):
    """dq of flash attention (the dq kernel on CUDA, else
    :func:`flash_bwd_dq_reference`)."""
    if not _on_cuda(q):
        return flash_bwd_dq_reference(q, k, v, dout, lse, delta, causal,
                                      q_offset, k_offset)
    (q, k, v, dout), args, d = _bwd_cuda_args(q, k, v, dout, lse, delta,
                                              causal, q_offset, k_offset)
    dq = torch.empty_like(q)
    if q.shape[1]:
        with torch.cuda.device(q.device):
            DQ_KERNEL(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                      dq.data_ptr(), *args, d ** -0.5, _build.stream_of(q))
    return _unpad(dq, d)


def flash_bwd_dkv(q, k, v, dout, lse, delta, causal: bool = True,
                  q_offset=0, k_offset=0):
    """``(dk, dv)`` of flash attention (the dk/dv kernel on CUDA, else
    :func:`flash_bwd_dkv_reference`)."""
    if not _on_cuda(q):
        return flash_bwd_dkv_reference(q, k, v, dout, lse, delta, causal,
                                       q_offset, k_offset)
    (q, k, v, dout), args, d = _bwd_cuda_args(q, k, v, dout, lse, delta,
                                              causal, q_offset, k_offset)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if k.shape[1]:
        with torch.cuda.device(q.device):
            DKV_KERNEL(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                       dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                       dk.data_ptr(), dv.data_ptr(), *args,
                       _build.stream_of(q))
    return _unpad(dk, d), _unpad(dv, d)


def flash_attention_with_lse(q, k, v, causal: bool = True, q_offset=0,
                             k_offset=0, block_q=None, block_k=None,
                             sub=None):
    """Forward attention over ``[B, S, H, D]`` returning ``(out, lse)``,
    ``lse`` as ``[B, Sq, H]`` float32.  Forward-only: the caller handles
    differentiation, through :func:`flash_attention_backward`."""
    if _on_cuda(q):
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or v.requires_grad):
            raise RuntimeError(
                "flash_attention_with_lse is forward-only; use "
                "flash_attention for autograd, or drive "
                "flash_attention_backward with the saved lse")
        return _flash_cuda(q, k, v, causal, q_offset, k_offset)
    return flash_attention_reference(q, k, v, causal, q_offset, k_offset)


def flash_attention_backward(q, k, v, dout, lse, delta, causal: bool = True,
                             q_offset=0, k_offset=0):
    """``(dq, dk, dv)`` from the forward's inputs, the output's gradient
    ``dout``, and the saved ``lse`` and ``delta = Σ_D dout·out`` (both
    ``[B, Sq, H]`` float32), in the dtypes of q, k and v: the dq pass,
    then the dk/dv pass."""
    dq = flash_bwd_dq(q, k, v, dout, lse, delta, causal, q_offset, k_offset)
    dk, dv = flash_bwd_dkv(q, k, v, dout, lse, delta, causal, q_offset,
                           k_offset)
    return dq, dk, dv


class _Flash(torch.autograd.Function):
    """Flash attention with its fused backward, as the JAX package's
    ``_flash`` custom VJP: the forward saves ``(q, k, v, out, lse)``; the
    backward forms ``Δ = Σ_D dO·O`` in f32 and runs both backward passes.
    The offsets are not differentiable."""

    @staticmethod
    def forward(ctx, q, k, v, causal, q_offset, k_offset):
        with profiling.span("attention.flash"):
            out, lse = flash_attention_with_lse(q, k, v, causal, q_offset,
                                                k_offset)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, q_offset, k_offset)
        return out

    @staticmethod
    def backward(ctx, g):
        # On the card the autograd engine's device thread runs this, so
        # the span opens on the thread that launches its kernels.
        with profiling.span("attention.flash"):
            q, k, v, out, lse = ctx.saved_tensors
            g = g.contiguous()
            delta = (g.float() * out.float()).sum(dim=-1)
            dq, dk, dv = flash_attention_backward(q, k, v, g, lse, delta,
                                                  *ctx.args)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, causal: bool = True, q_offset=0, k_offset=0,
                    block_q=None, block_k=None, sub=None):
    """Attention over ``[B, S, H, D]`` tensors; ``q_offset`` and ``k_offset``
    are the global positions of the first row and column.  Differentiable
    in q, k and v."""
    return _Flash.apply(q, k, v, causal, q_offset, k_offset)


def make_flash_attention(block_q=None, block_k=None, sub=None):
    """Adapter producing a ``TransformerConfig.attention_fn``."""
    def attn(q, k, v, causal=True):
        return flash_attention(q, k, v, causal=causal)
    return attn
