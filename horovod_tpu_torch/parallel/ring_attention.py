"""Ring attention: exact attention over a sequence sharded across the
processes of a group — counterpart of
``horovod_tpu/parallel/ring_attention.py``.

Each rank keeps its query shard and K/V shards rotate around the ring of
the group's ranks (rank ``r`` sends to ``r + 1`` and receives from
``r - 1``) while an online softmax, or the flash kernels' lse merge,
accumulates the exact result.  Where the JAX package takes a mesh axis
name and rotates with ``lax.ppermute``, the port takes a
``torch.distributed`` process group (``None``: the world) and rotates with
``dist.batch_isend_irecv`` to the ring neighbours:

* on NCCL the device tensors go on the wire as they are;
* on gloo, which sends no CUDA tensor, a CUDA tensor is staged through
  host memory: copied to the host before the send, and the received copy
  moved back to the device when the exchange is waited for.  Two ranks on
  one card take this route (NCCL refuses two ranks on one device), and the
  CPU tests too.  The route follows the group's backend.

The flash ring passes are double-buffered as in the JAX package: each step
posts the next K/V exchange before it launches its own kernels, and the
last step posts none.  On the plain causal layout, steps whose whole K/V
shard lies above the diagonal are skipped (``steps_run == rank + 1``); the
zigzag layout (shard ``r`` holds chunks ``r`` and ``2n - 1 - r``) instead
runs all four half-pairs every step, and the kernels' diagonal bound makes
the wholly masked ones write zeros and lse ``NEG_INF`` at almost no cost.
The backward drives :func:`~horovod_tpu_torch.ops.flash_attention.flash_attention_backward`
with the globally merged lse and ``Δ = Σ dO·out``; dq accumulates at home
while dk/dv ride the ring with their K/V and take their n-th rotation
home (K/V rotate n − 1 times).

:func:`exchange_stats` counts the ring's exchanges, their bytes a rank and
the host milliseconds spent posting and waiting for them.
"""

from __future__ import annotations

import functools
import time

import numpy as np
import torch
import torch.distributed as dist

from horovod_tpu_torch.ops.flash_attention import (NEG_INF,
                                                   flash_attention_backward,
                                                   flash_attention_with_lse)
from horovod_tpu_torch.parallel.common import global_rank, on_wire, staged

_stats = {"exchanges": 0, "bytes": 0, "host_ms": 0.0}


def exchange_stats() -> dict:
    """``{"exchanges", "bytes", "host_ms"}`` since the last
    :func:`reset_exchange_stats`: ring rotations posted, bytes this rank
    sent in them, and host ms spent posting and waiting (on the staged
    route this includes the copies to and from the host)."""
    return dict(_stats)


def reset_exchange_stats() -> None:
    _stats.update(exchanges=0, bytes=0, host_ms=0.0)


def _size_rank(group):
    return dist.get_world_size(group), dist.get_rank(group)


class _Rotation:
    """One ring exchange in flight: ``tensors`` posted to the next rank,
    as many received from the previous one (``shift=-1``: the other way
    round).  :meth:`wait` returns the received tensors on the device the
    sent ones came from."""

    def __init__(self, tensors, group, shift: int = 1):
        t0 = time.perf_counter()
        n, r = _size_rank(group)
        dst, src = global_rank(group, (r + shift) % n), \
            global_rank(group, (r - shift) % n)
        self._device = tensors[0].device
        self._staged = staged(tensors[0], group)
        self._send = [on_wire(t, group) for t in tensors]
        self._recv = [torch.empty_like(t) for t in self._send]
        ops = [op for s, rv in zip(self._send, self._recv) for op in (
            dist.P2POp(dist.isend, s, dst, group),
            dist.P2POp(dist.irecv, rv, src, group))]
        self._reqs = dist.batch_isend_irecv(ops)
        _stats["exchanges"] += 1
        _stats["bytes"] += sum(t.numel() * t.element_size()
                               for t in self._send)
        _stats["host_ms"] += (time.perf_counter() - t0) * 1e3

    def wait(self) -> list:
        t0 = time.perf_counter()
        for req in self._reqs:
            req.wait()
        out = [t.to(self._device) for t in self._recv] if self._staged \
            else self._recv
        _stats["host_ms"] += (time.perf_counter() - t0) * 1e3
        return out


def _rotate(tensors, group) -> list:
    """``tensors`` from the previous rank of the ring (one exchange)."""
    return _Rotation(tensors, group).wait()


class _Rotate(torch.autograd.Function):
    """A differentiable ring rotation: forward from the previous rank, the
    gradient back to it."""

    @staticmethod
    def forward(ctx, group, x):
        ctx.group = group
        return _Rotation([x], group).wait()[0]

    @staticmethod
    def backward(ctx, g):
        return None, _Rotation([g], ctx.group, shift=-1).wait()[0]


def _block_attend(q, k, v, q_pos, k_pos, causal, m, l, acc):
    """One online-softmax accumulation step: q [B, Sq, H, D]; k, v
    [B, Sk, H, D]; global positions [Sq] / [Sk]; m, l [B, H, Sq]; acc
    [B, H, Sq, D] (f32).  Masked probabilities are zeroed, so a row that
    sees nothing never divides by zero."""
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        mask = q_pos[:, None] >= k_pos[None, :]
        logits = torch.where(mask, logits, NEG_INF)
    m_new = torch.maximum(m, logits.amax(dim=-1))
    p = torch.exp(logits - m_new[..., None])
    if causal:
        p = torch.where(mask, p, 0.0)
    correction = torch.exp(m - m_new)
    l_new = l * correction + p.sum(dim=-1)
    pv = torch.einsum("bhqk,bkhd->bhqd", p.to(v.dtype).float(), v.float())
    return m_new, l_new, acc * correction[..., None] + pv


def ring_attention(q, k, v, group=None, causal: bool = True):
    """Exact attention over a sequence sharded on ``group``, by einsum
    blocks (differentiable through autograd: each rotation's gradient goes
    back round the ring).  Shapes ``[B, S_local, H, D]`` a rank, shard
    ``i`` holding positions ``[i·S_local, (i+1)·S_local)``; returns the
    local output shard in q's dtype."""
    n, my = _size_rank(group)
    b, s_local, h, d = q.shape
    q_pos = my * s_local + torch.arange(s_local, device=q.device)
    m = torch.full((b, h, s_local), NEG_INF, device=q.device)
    l = torch.zeros((b, h, s_local), device=q.device)
    acc = torch.zeros((b, h, s_local, d), device=q.device)
    for i in range(n):
        owner = (my - i) % n
        k_pos = owner * s_local + torch.arange(s_local, device=q.device)
        m, l, acc = _block_attend(q, k, v, q_pos, k_pos, causal, m, l, acc)
        if i < n - 1:
            k, v = _Rotate.apply(group, k), _Rotate.apply(group, v)
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.permute(0, 2, 1, 3).to(q.dtype)


def make_ring_attention(group=None):
    """Adapter producing a ``TransformerConfig.attention_fn``."""
    return functools.partial(ring_attention, group=group)


# -- ring + flash ------------------------------------------------------------

def _merge_partial(out, lse, o_i, lse_i):
    """Exact merge of two normalised partial attentions through their lse,
    at the shifted max: out [B, S, H, D] f32, lse [B, S, H].  A partial
    that attended nothing (lse ``NEG_INF``) leaves ``out`` and ``lse``
    exactly as they were."""
    m = torch.maximum(lse, lse_i)
    w_old = torch.exp(lse - m)[..., None]
    w_new = torch.exp(lse_i - m)[..., None]
    denom = (w_old + w_new).clamp_min(1e-30)
    out = (out * w_old + o_i.float() * w_new) / denom
    return out, m + torch.log(denom[..., 0])


def _attends(causal: bool, owner: int, my: int) -> bool:
    """Whether the K/V shard of ``owner`` reaches rank ``my``'s queries on
    the plain layout (a later shard lies wholly above the diagonal)."""
    return not causal or owner <= my


def _ring_flash_forward(q, k, v, group, causal):
    """Forward ring pass: ``(out f32, merged lse, steps_run)``."""
    n, my = _size_rank(group)
    b, s_local, h, d = q.shape
    out = torch.zeros((b, s_local, h, d), dtype=torch.float32,
                      device=q.device)
    lse = torch.full((b, s_local, h), NEG_INF, dtype=torch.float32,
                     device=q.device)
    steps = 0
    for i in range(n):
        # Post the next shard's exchange before this step's kernel.
        nxt = _Rotation((k, v), group) if i < n - 1 else None
        owner = (my - i) % n
        if _attends(causal, owner, my):
            o_i, lse_i = flash_attention_with_lse(
                q, k, v, causal, my * s_local, owner * s_local)
            out, lse = _merge_partial(out, lse, o_i, lse_i)
            steps += 1
        if nxt is not None:
            k, v = nxt.wait()
    return out, lse, steps


class _RingFlash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, group, causal):
        out, lse, _ = _ring_flash_forward(q, k, v, group, causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (group, causal)
        return out.to(q.dtype)

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        group, causal = ctx.args
        n, my = _size_rank(group)
        s_local = q.shape[1]
        g = g.contiguous()
        # Δ with the globally merged output: valid for every block, since
        # p is recomputed against the merged lse.
        delta = (g.float() * out).sum(dim=-1)
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dk = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
        dv = torch.zeros(v.shape, dtype=torch.float32, device=q.device)
        for i in range(n):
            nxt = _Rotation((k, v), group) if i < n - 1 else None
            owner = (my - i) % n
            if _attends(causal, owner, my):
                dq_i, dk_i, dv_i = flash_attention_backward(
                    q, k, v, g, lse, delta, causal, my * s_local,
                    owner * s_local)
                dq += dq_i.float()
                dk += dk_i.float()
                dv += dv_i.float()
            if nxt is not None:
                k, v = nxt.wait()
            # dk/dv travel with their K/V; the n-th rotation takes them
            # home.
            if n > 1:
                dk, dv = _rotate((dk, dv), group)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None)


def ring_flash_attention(q, k, v, group=None, causal: bool = True):
    """Ring attention whose block attention is the flash kernel, merged
    across steps through the lse; differentiable in q, k and v.  The JAX
    package's tiling arguments have no counterpart: the kernels choose
    their own tiles."""
    return _RingFlash.apply(q, k, v, group, causal)


def ring_flash_attention_stats(q, k, v, group=None, causal: bool = True):
    """Forward only: ``(out, steps_run)``, the flash kernels this rank ran
    (``rank + 1`` of ``n`` when causal)."""
    with torch.no_grad():
        out, _, steps = _ring_flash_forward(q, k, v, group, causal)
    return out.to(q.dtype), steps


def make_ring_flash_attention(group=None):
    """Adapter producing a ``TransformerConfig.attention_fn``."""
    return functools.partial(ring_flash_attention, group=group)


# -- zigzag ring attention ---------------------------------------------------
# Plain causal ring attention idles early ranks: shard r's queries see only
# the first r + 1 shards.  The zigzag layout splits the sequence into 2n
# chunks and gives rank r chunks (r, 2n - 1 - r), one early and one late,
# so every rank does the same work.

def zigzag_permutation(seq_len: int, n: int):
    """Global index order that makes contiguous shard r hold zigzag chunks
    (r, 2n - 1 - r).  Apply as ``x[:, perm]`` before sharding."""
    c, rem = divmod(seq_len, 2 * n)
    if rem or c == 0:
        raise ValueError(
            f"zigzag needs seq_len divisible by 2·n ({seq_len} vs n={n})")
    idx = []
    for r in range(n):
        idx.extend(range(r * c, (r + 1) * c))
        idx.extend(range((2 * n - 1 - r) * c, (2 * n - r) * c))
    return np.asarray(idx)


def zigzag_inverse_permutation(seq_len: int, n: int):
    """Inverse of :func:`zigzag_permutation` (restores natural order)."""
    perm = zigzag_permutation(seq_len, n)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(seq_len)
    return inv


def zigzag_positions(s_local: int, group=None, device=None):
    """Global sequence positions of this rank's zigzag shard ([s_local]),
    for ``Transformer(..., positions=...)``."""
    n, r = _size_rank(group)
    c = s_local // 2
    lo = r * c + torch.arange(c, device=device)
    hi = (2 * n - 1 - r) * c + torch.arange(c, device=device)
    return torch.cat([lo, hi])


def _halves(x, c):
    return x[:, :c], x[:, c:]


def _zigzag_offsets(r: int, n: int, c: int):
    return r * c, (2 * n - 1 - r) * c


def _zigzag_flash_forward(q, k, v, group, causal):
    """Forward zigzag ring pass: ``(out f32, merged lse)`` in the local
    order [chunk_lo ∥ chunk_hi]."""
    n, r = _size_rank(group)
    b, s_local, h, d = q.shape
    if s_local % 2:
        raise ValueError(f"zigzag shard length must be even, got {s_local}")
    c = s_local // 2
    acc = [[torch.zeros((b, c, h, d), dtype=torch.float32, device=q.device),
            torch.full((b, c, h), NEG_INF, dtype=torch.float32,
                       device=q.device)] for _ in range(2)]
    q_halves, q_offs = _halves(q, c), _zigzag_offsets(r, n, c)
    for i in range(n):
        nxt = _Rotation((k, v), group) if i < n - 1 else None
        k_offs = _zigzag_offsets((r - i) % n, n, c)
        k_halves, v_halves = _halves(k, c), _halves(v, c)
        for qi in range(2):
            for ki in range(2):
                o_p, lse_p = flash_attention_with_lse(
                    q_halves[qi], k_halves[ki], v_halves[ki], causal,
                    q_offs[qi], k_offs[ki])
                acc[qi] = list(_merge_partial(*acc[qi], o_p, lse_p))
        if nxt is not None:
            k, v = nxt.wait()
    return (torch.cat([acc[0][0], acc[1][0]], dim=1),
            torch.cat([acc[0][1], acc[1][1]], dim=1))


class _ZigzagFlash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, group, causal):
        out, lse = _zigzag_flash_forward(q, k, v, group, causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (group, causal)
        return out.to(q.dtype)

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        group, causal = ctx.args
        n, r = _size_rank(group)
        c = q.shape[1] // 2
        g = g.contiguous()
        delta = (g.float() * out).sum(dim=-1)              # [B, 2c, H]
        half = (q.shape[0], c) + tuple(q.shape[2:])
        zeros = lambda: torch.zeros(half, dtype=torch.float32,  # noqa: E731
                                    device=q.device)
        dq, dk, dv = ([zeros(), zeros()] for _ in range(3))
        q_halves, g_halves = _halves(q, c), _halves(g, c)
        lse_halves = tuple(t.contiguous() for t in _halves(lse, c))
        delta_halves = tuple(t.contiguous() for t in _halves(delta, c))
        q_offs = _zigzag_offsets(r, n, c)
        for i in range(n):
            nxt = _Rotation((k, v), group) if i < n - 1 else None
            k_offs = _zigzag_offsets((r - i) % n, n, c)
            k_halves, v_halves = _halves(k, c), _halves(v, c)
            for qi in range(2):
                for ki in range(2):
                    dq_p, dk_p, dv_p = flash_attention_backward(
                        q_halves[qi], k_halves[ki], v_halves[ki],
                        g_halves[qi], lse_halves[qi], delta_halves[qi],
                        causal, q_offs[qi], k_offs[ki])
                    dq[qi] += dq_p.float()
                    dk[ki] += dk_p.float()
                    dv[ki] += dv_p.float()
            if nxt is not None:
                k, v = nxt.wait()
            # dk/dv ride the ring with their K/V; the n-th rotation takes
            # them home.
            if n > 1:
                dk[0], dk[1], dv[0], dv[1] = _rotate(dk + dv, group)
        cat = functools.partial(torch.cat, dim=1)
        return (cat(dq).to(q.dtype), cat(dk).to(k.dtype),
                cat(dv).to(v.dtype), None, None)


def zigzag_ring_flash_attention(q, k, v, group=None, causal: bool = True):
    """Load-balanced causal ring attention over zigzag-sharded sequences:
    inputs are this rank's shard ``[B, 2c, H, D]`` (chunks ``r`` and
    ``2n - 1 - r``, see :func:`zigzag_permutation`), the output the
    matching shard of the exact attention.  Differentiable in q, k and v;
    no tiling arguments, as in :func:`ring_flash_attention`."""
    return _ZigzagFlash.apply(q, k, v, group, causal)


def make_zigzag_ring_flash_attention(group=None):
    """Adapter producing a ``TransformerConfig.attention_fn`` (pair with
    ``positions=zigzag_positions(...)`` so RoPE matches the layout)."""
    return functools.partial(zigzag_ring_flash_attention, group=group)
