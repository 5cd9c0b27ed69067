"""Decode attention over a per-slot KV cache: the CUDA kernel
``csrc/decode_attention.cu`` beside its plain PyTorch version.

``decode_attention(q, k_cache, v_cache, lengths)``: ``q`` ``[B, S_q, H,
D]``, query row ``i`` of slot ``b`` at position ``lengths[b] + i``;
``k_cache`` / ``v_cache`` ``[B, S, H, D]``; key ``p`` is visible to that row
iff ``p <= lengths[b] + i``.  Returns ``[B, S_q, H, D]`` in q's dtype.

A CUDA tensor launches the kernel pair (split-KV, then a log-sum-exp merge;
one counted launch) or raises; a CPU tensor takes
:func:`decode_attention_reference`, the arithmetic the model's cache path
has always used: bf16 einsums, an f32 softmax with a ``-1e30`` mask.  The
kernel reads only each slot's visible positions, each byte once, and keeps
every sum in f32, rounding the output once: on bf16 inputs it is the more
exact of the two.  It takes float32 or bfloat16, ``S_q`` from 1 to
:data:`MAX_QUERY_ROWS`, head dims :data:`HEAD_DIMS`, contiguous
16-byte-aligned tensors, and ``lengths`` in ``[0, S)``.

The JAX package has no kernel here (``horovod_tpu/models/transformer.py``
``cached_decode_attention`` is an einsum that XLA fuses); the port adds
one because eager PyTorch's einsums copy the whole cache into another
layout at every call.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from horovod_tpu_torch.ops import _build

# Positions a phase-1 block streams; a slot's partition follows from its
# own length and S, so its output does not depend on the batch.
CHUNK = 256
MAX_QUERY_ROWS = 16
HEAD_DIMS = (64, 128)
# One position's K (or V) of a block's head group: the group is the
# largest divisor of H whose row fits.
ROW_BYTES = 1024

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = _build.register("decode_attention", "hvd_decode_attention",
                         [_P] * 7 + [_I] * 8 + [_P])
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def decode_attention_reference(q, k_cache, v_cache, lengths):
    """Plain PyTorch version: softmax(q Kᵀ · D^-1/2) V over the visible
    positions, the logits of the einsum in q's dtype, the softmax in f32,
    every masked position at ``-1e30``."""
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k_cache).float() * scale
    s, s_q = k_cache.shape[1], q.shape[1]
    qpos = lengths[:, None] + torch.arange(s_q, device=q.device)[None, :]
    mask = (torch.arange(s, device=q.device)[None, None, :]
            <= qpos[:, :, None])[:, None, :, :]            # [B,1,S_q,S]
    logits = logits.masked_fill(~mask, -1e30)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v_cache)


def kernel_takes(q) -> bool:
    """Whether the kernel takes a query block of this shape on this device:
    a CUDA tensor of at most :data:`MAX_QUERY_ROWS` rows with a head dim in
    :data:`HEAD_DIMS`."""
    return q.is_cuda and q.shape[1] <= MAX_QUERY_ROWS and \
        q.shape[-1] in HEAD_DIMS


@functools.lru_cache(maxsize=None)
def head_group(heads: int, head_dim: int, elem_bytes: int) -> int:
    """Heads a phase-1 block takes: the largest divisor of ``heads`` whose
    row of ``head_dim`` elements a head fits :data:`ROW_BYTES`."""
    return max(g for g in range(1, heads + 1)
               if heads % g == 0 and g * head_dim * elem_bytes <= ROW_BYTES)


def _check(q, k_cache, v_cache, lengths):
    """Raise on what the kernel does not take.  Few tensor calls: it runs
    once a layer of every decode, on a host that sets the decode's pace."""
    if q.dtype not in _DTYPES or q.dim() != 4 or \
            not 1 <= q.shape[1] <= MAX_QUERY_ROWS or \
            q.shape[3] not in HEAD_DIMS:
        raise ValueError(
            f"decode_attention: the kernel takes float32 or bfloat16 q of "
            f"[B, 1..{MAX_QUERY_ROWS}, H, D] with D in {HEAD_DIMS}, got "
            f"{q.dtype} {tuple(q.shape)}")
    b, _, h, d = q.shape
    dev, ks = q.device, tuple(k_cache.shape)
    if len(ks) != 4 or (ks[0], ks[2], ks[3]) != (b, h, d) or \
            tuple(v_cache.shape) != ks or k_cache.dtype != q.dtype or \
            v_cache.dtype != q.dtype or k_cache.device != dev or \
            v_cache.device != dev:
        raise ValueError(
            f"decode_attention: k_cache and v_cache must be [{b}, S, {h}, "
            f"{d}] {q.dtype} on {dev}, got {ks} {k_cache.dtype} on "
            f"{k_cache.device} and {tuple(v_cache.shape)} {v_cache.dtype} "
            f"on {v_cache.device}")
    if tuple(lengths.shape) != (b,) or lengths.device != dev or \
            lengths.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"decode_attention: lengths must be [{b}] integers "
                         f"on {dev}")
    if not (q.is_contiguous() and k_cache.is_contiguous()
            and v_cache.is_contiguous()) or \
            (q.data_ptr() | k_cache.data_ptr() | v_cache.data_ptr()) % 16:
        raise ValueError("decode_attention: q, k_cache and v_cache must be "
                         "contiguous and 16-byte aligned")


def decode_attention(q, k_cache, v_cache, lengths):
    """The kernel on CUDA tensors (raises on what it does not take), the
    plain version on CPU tensors."""
    if not q.is_cuda:
        return decode_attention_reference(q, k_cache, v_cache, lengths)
    _check(q, k_cache, v_cache, lengths)
    b, s_q, h, d = q.shape
    s = k_cache.shape[1]
    if lengths.dtype != torch.int64 or not lengths.is_contiguous():
        lengths = lengths.to(torch.int64).contiguous()
    out = torch.empty_like(q)
    # One f32 scratch: each chunk's accumulators [B, chunks, S_q, H, D],
    # then its (max, sum) pairs [B, chunks, S_q, H, 2].
    n_acc = b * -(-s // CHUNK) * s_q * h * d
    scratch = torch.empty(n_acc + 2 * n_acc // d, dtype=torch.float32,
                          device=q.device)
    with torch.cuda.device(q.device):
        ptr = scratch.data_ptr()
        KERNEL(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
               lengths.data_ptr(), out.data_ptr(), ptr, ptr + 4 * n_acc,
               _DTYPES[q.dtype], b, s_q, s, h, d,
               head_group(h, d, q.element_size()), CHUNK,
               _build.stream_of(q))
    return out
