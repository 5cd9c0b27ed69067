"""Forward flash attention: the CUDA kernel ``csrc/flash_fwd.cu`` and its
plain PyTorch version.

Counterpart of ``horovod_tpu/ops/flash_attention.py`` (forward only).  The
contract is the JAX package's public one, over ``[B, S, H, D]`` tensors:

* ``scale * log2(e)`` is folded into q, which is rounded to the input dtype
  once; scores live in the log2 domain and the softmax runs on ``exp2``;
* a key at global position ``k_offset + j`` is visible to the query at
  ``q_offset + i`` iff ``not causal or q_offset + i >= k_offset + j``;
* the output is the f32 accumulator divided by ``max(l, 1e-30)`` and cast to
  the input dtype, and ``lse[b, s, h]`` is the natural-log log-sum-exp in
  f32, :data:`NEG_INF` for a row that attended to nothing.

A CUDA tensor launches the kernel (float32 or bfloat16, ``head_dim`` 64 or
128) or raises; a CPU tensor takes :func:`flash_attention_reference`.  The
backward is not ported yet, so the CUDA path raises when autograd would
record it.  The TPU tiling knobs (``block_q``, ``block_k``, ``sub``) are
accepted so call sites match, and ignored: the kernel's tiles are its own.
"""

from __future__ import annotations

import ctypes

import torch

from horovod_tpu_torch.ops import _build

NEG_INF = -1e30
LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = _build.register(
    "flash_fwd", "hvd_flash_fwd",
    [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, ctypes.c_float,
     _P])
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)


def _on_cuda(t: torch.Tensor) -> bool:
    return t.is_cuda


def flash_attention_reference(q, k, v, causal: bool = True, q_offset=0,
                              k_offset=0):
    """Plain PyTorch version of the kernel's arithmetic, dense over all
    (q, k) pairs: same q fold and rounding, same exp2-domain softmax, same
    output and lse contract.  Returns ``(out, lse)``."""
    b, s_q, h, d = q.shape
    s_k = k.shape[1]
    qs = (q.float() * (d ** -0.5 * LOG2E)).to(q.dtype).float()
    s = torch.einsum("bqhd,bkhd->bhqk", qs, k.float())
    if causal:
        qpos = int(q_offset) + torch.arange(s_q, device=q.device)
        kpos = int(k_offset) + torch.arange(s_k, device=q.device)
        mask = qpos[:, None] >= kpos[None, :]
    else:
        mask = torch.ones(s_q, s_k, dtype=torch.bool, device=q.device)
    s = s.masked_fill(~mask, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp2(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)                        # [b, h, q, 1]
    denom = l.clamp_min(1e-30)
    o = torch.einsum("bhqk,bkhd->bhqd", p, v.float()) / denom
    lse = torch.where(l > 0, m * LN2 + torch.log(denom),
                      torch.full_like(l, NEG_INF))
    return (o.permute(0, 2, 1, 3).to(q.dtype),
            lse[..., 0].permute(0, 2, 1).contiguous())


def _check_cuda_inputs(q, k, v):
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise RuntimeError("flash_attention: the backward kernels are not "
                           "ported yet; call under torch.no_grad() or "
                           "torch.inference_mode()")
    if q.dtype not in _DTYPES or not q.dtype == k.dtype == v.dtype:
        raise ValueError(f"flash_attention: CUDA kernel takes float32 or "
                         f"bfloat16 q/k/v of one dtype, got {q.dtype}, "
                         f"{k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4 or \
            q.shape[0] != k.shape[0] or q.shape[2:] != k.shape[2:]:
        raise ValueError(f"flash_attention: expected q [B,Sq,H,D] and k, v "
                         f"[B,Sk,H,D], got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if q.shape[-1] not in _HEAD_DIMS:
        raise ValueError(f"flash_attention: CUDA kernel takes head_dim in "
                         f"{_HEAD_DIMS}, got {q.shape[-1]}")
    if q.shape[0] * q.shape[2] > 65535:
        raise ValueError("flash_attention: batch * heads must be <= 65535")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: q, k, v must be contiguous")
    if not (k.is_cuda and v.is_cuda and q.device == k.device == v.device):
        raise ValueError("flash_attention: q, k, v must be on one CUDA device")


def _flash_cuda(q, k, v, causal, q_offset, k_offset):
    _check_cuda_inputs(q, k, v)
    b, s_q, h, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, s_q, h), dtype=torch.float32, device=q.device)
    if s_q == 0:
        return out, lse
    with torch.cuda.device(q.device):
        KERNEL(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
               lse.data_ptr(), _DTYPES[q.dtype], b, h, s_q, k.shape[1], d,
               int(bool(causal)), int(q_offset), int(k_offset),
               d ** -0.5 * LOG2E, _build.stream_of(q))
    return out, lse


def flash_attention_with_lse(q, k, v, causal: bool = True, q_offset=0,
                             k_offset=0, block_q=None, block_k=None,
                             sub=None):
    """Forward attention over ``[B, S, H, D]`` returning ``(out, lse)``,
    ``lse`` as ``[B, Sq, H]`` float32."""
    if _on_cuda(q):
        return _flash_cuda(q, k, v, causal, q_offset, k_offset)
    return flash_attention_reference(q, k, v, causal, q_offset, k_offset)


def flash_attention(q, k, v, causal: bool = True, q_offset=0, k_offset=0,
                    block_q=None, block_k=None, sub=None):
    """Forward attention over ``[B, S, H, D]`` tensors; ``q_offset`` and
    ``k_offset`` are the global positions of the first row and column."""
    return flash_attention_with_lse(q, k, v, causal, q_offset, k_offset)[0]


def make_flash_attention(block_q=None, block_k=None, sub=None):
    """Adapter producing a ``TransformerConfig.attention_fn``."""
    def attn(q, k, v, causal=True):
        return flash_attention(q, k, v, causal=causal)
    return attn
