"""Decoder-only Transformer in PyTorch — counterpart of
``horovod_tpu/models/transformer.py``.

Same arithmetic as the flax model: RMSNorm (optionally the kernel,
``fused_norm=True``), rotary embeddings computed in f32 and split in halves,
a GLU MLP, projections and the head as matrix products in the compute dtype
with f32 parameters cast per use, logits cast to ``logits_dtype``.
Attention is pluggable through ``attention_fn(q, k, v, causal)`` over
``[B, S, H, D]`` (``make_flash_attention()`` for the kernel); ``None`` is the
plain :func:`dense_causal_attention`.

Serving paths, as in the JAX package: ``return_kv=True`` for a prefill that
also returns the per-layer K/V as ``[L, B, S, H, D]``, and ``kv_cache=(k, v)``
with ``lengths`` for a decode, verify or suffix step over a preallocated
per-slot cache.  Unlike the JAX package, which returns updated copies, the
port writes the new K/V into the cache tensors in place and returns them.

Mixture-of-experts, context parallelism, rematerialisation and the paged KV
pool are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch
import torch.nn.functional as F
from torch import nn

from horovod_tpu_torch.ops.flash_attention import make_flash_attention
from horovod_tpu_torch.ops.rmsnorm import FusedRMSNorm
from horovod_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32000
    num_layers: int = 12
    num_heads: int = 8
    head_dim: int = 64
    embed_dim: int = 512
    mlp_dim: int = 2048
    max_seq_len: int = 2048
    dtype: Any = torch.bfloat16
    param_dtype: Any = torch.float32
    # attention_fn(q, k, v, causal) -> out over [B, S, H, D]; None = dense.
    attention_fn: Callable | None = None
    rope_theta: float = 10000.0
    logits_dtype: Any = torch.float32
    # True runs every norm through the RMSNorm kernel.
    fused_norm: bool | None = None


def config_162m(**overrides) -> TransformerConfig:
    """The 162M decoder of ``examples/jax_transformer_benchmark.py`` at its
    defaults: 12 layers, width 768, 6 heads of 128, GLU width 3072, vocab
    32000, bf16 compute over f32 parameters, with the flash-attention and
    RMSNorm kernels on.  Logits stay f32 (the serving engine samples from
    them)."""
    base = dict(vocab_size=32000, num_layers=12, num_heads=6, head_dim=128,
                embed_dim=768, mlp_dim=3072, dtype=torch.bfloat16,
                param_dtype=torch.float32,
                attention_fn=make_flash_attention(), fused_norm=True)
    base.update(overrides)
    return TransformerConfig(**base)


def rope(x, positions, theta: float):
    """Rotary embeddings; x: [B, S, H, D], positions: [B, S] (f32 math)."""
    d = x.shape[-1]
    freq = theta ** (-torch.arange(0, d, 2, dtype=torch.float32,
                                   device=x.device) / d)
    angles = positions[..., None].to(torch.float32) * freq    # [B, S, d/2]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def dense_causal_attention(q, k, v, causal: bool = True):
    """Reference attention: one softmax(QKᵀ)V over [B, S, H, D], the causal
    mask aligned bottom-right (``tril(k=s_k - s_q)``)."""
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    if causal:
        s_q, s_k = logits.shape[-2], logits.shape[-1]
        mask = torch.ones(s_q, s_k, dtype=torch.bool,
                          device=q.device).tril(s_k - s_q)
        logits = logits.masked_fill(~mask, -1e30)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def init_kv_cache(cfg: TransformerConfig, num_slots: int,
                  max_len: int | None = None, device=None):
    """Preallocated per-slot K/V cache: two ``[L, slots, S, H, D]`` zero
    tensors in the compute dtype, on ``cuda`` unless ``device`` says
    otherwise."""
    s = max_len or cfg.max_seq_len
    shape = (cfg.num_layers, num_slots, s, cfg.num_heads, cfg.head_dim)
    device = resolve_device(device)
    return (torch.zeros(shape, dtype=cfg.dtype, device=device),
            torch.zeros(shape, dtype=cfg.dtype, device=device))


def cached_decode_attention(q, k_cache, v_cache, lengths):
    """Block attention over a per-slot KV cache.

    ``q``: [B, S_q, H, D], query row ``i`` at position ``lengths[b] + i``;
    ``k_cache``/``v_cache``: [B, S, H, D], everything past each row's own
    position masked.  Same f32-softmax/-1e30-mask arithmetic as
    :func:`dense_causal_attention`."""
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k_cache).float() * scale
    s, s_q = k_cache.shape[1], q.shape[1]
    qpos = lengths[:, None] + torch.arange(s_q, device=q.device)[None, :]
    mask = (torch.arange(s, device=q.device)[None, None, :]
            <= qpos[:, :, None])[:, None, :, :]                # [B,1,S_q,S]
    logits = logits.masked_fill(~mask, -1e30)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v_cache)


def write_cache(cache, new, start) -> None:
    """Write ``new`` [B, S_q, H, D] into ``cache`` [B, S, H, D] at rows
    ``start[b] .. start[b] + S_q`` of each batch row, in place.

    ``jax.lax.dynamic_update_slice`` clamps a start that would overflow;
    this write does not, so the caller keeps ``start + S_q <= S``.  The
    serving backend checks it on the host before every call."""
    b, s_q = new.shape[:2]
    rows = torch.arange(b, device=cache.device)[:, None]
    cols = start[:, None] + torch.arange(s_q, device=cache.device)[None, :]
    cache[rows, cols] = new


def _linear(x, layer: nn.Linear, dtype):
    """Flax ``Dense(dtype=...)``: both operands cast to the compute dtype."""
    return F.linear(x.to(dtype), layer.weight.to(dtype))


class Attention(nn.Module):
    def __init__(self, cfg: TransformerConfig, device=None):
        super().__init__()
        self.cfg = cfg
        hd = cfg.num_heads * cfg.head_dim
        mk = lambda i, o: nn.Linear(i, o, bias=False,  # noqa: E731
                                    dtype=cfg.param_dtype, device=device)
        self.q, self.k, self.v = mk(cfg.embed_dim, hd), \
            mk(cfg.embed_dim, hd), mk(cfg.embed_dim, hd)
        self.o = mk(hd, cfg.embed_dim)

    def forward(self, x, positions, cache=None, return_kv=False):
        cfg = self.cfg
        b, s, _ = x.shape
        heads = lambda t: t.view(b, s, cfg.num_heads, cfg.head_dim)  # noqa
        q = rope(heads(_linear(x, self.q, cfg.dtype)), positions,
                 cfg.rope_theta)
        k = rope(heads(_linear(x, self.k, cfg.dtype)), positions,
                 cfg.rope_theta)
        v = heads(_linear(x, self.v, cfg.dtype))
        if cache is not None:
            # Decode / verify / suffix prefill: write this block's K/V at
            # each slot's position, then attend over the cache.  K/V at a
            # position depend only on its token and rotary phase, so cached
            # entries match what a full forward would compute there.
            k_cache, v_cache, lengths = cache
            write_cache(k_cache, k, lengths)
            write_cache(v_cache, v, lengths)
            out = cached_decode_attention(q, k_cache, v_cache, lengths)
            return _linear(out.reshape(b, s, -1), self.o, cfg.dtype), \
                (k_cache, v_cache)
        attn = cfg.attention_fn or dense_causal_attention
        out = _linear(attn(q, k, v, causal=True).reshape(b, s, -1), self.o,
                      cfg.dtype)
        if return_kv:
            return out, (k, v)
        return out


class MLP(nn.Module):
    def __init__(self, cfg: TransformerConfig, device=None):
        super().__init__()
        self.cfg = cfg
        mk = lambda i, o: nn.Linear(i, o, bias=False,  # noqa: E731
                                    dtype=cfg.param_dtype, device=device)
        self.gate = mk(cfg.embed_dim, cfg.mlp_dim)
        self.up = mk(cfg.embed_dim, cfg.mlp_dim)
        self.down = mk(cfg.mlp_dim, cfg.embed_dim)

    def forward(self, x):
        dt = self.cfg.dtype
        return _linear(F.silu(_linear(x, self.gate, dt))
                       * _linear(x, self.up, dt), self.down, dt)


class Block(nn.Module):
    def __init__(self, cfg: TransformerConfig, device=None):
        super().__init__()
        self.cfg = cfg
        norm = lambda: FusedRMSNorm(  # noqa: E731
            cfg.embed_dim, dtype=cfg.dtype, param_dtype=cfg.param_dtype,
            use_fused=cfg.fused_norm, device=device)
        self.attn_norm, self.mlp_norm = norm(), norm()
        self.attn = Attention(cfg, device)
        self.mlp = MLP(cfg, device)

    def forward(self, x, positions, cache=None, return_kv=False):
        kv = None
        y = self.attn_norm(x)
        if cache is not None or return_kv:
            attn_out, kv = self.attn(y, positions, cache=cache,
                                     return_kv=return_kv)
        else:
            attn_out = self.attn(y, positions)
        x = x + attn_out
        x = x + self.mlp(self.mlp_norm(x))
        if cache is not None or return_kv:
            return x, kv
        return x


class Transformer(nn.Module):
    """Token ids [B, S] → logits [B, S, vocab].

    * ``return_kv=True`` — a prefill: also return the per-layer
      rotary-embedded K and raw V as two stacked ``[L, B, S, H, D]`` tensors.
    * ``kv_cache=(k, v)`` + ``lengths`` — one cache step: ``tokens`` is
      ``[B, S_q]`` at positions ``lengths[b] + i``; returns ``(logits, (k,
      v))`` with the caches written in place, logits ``[B, vocab]`` when
      ``S_q == 1`` and ``[B, S_q, vocab]`` otherwise.

    The parameters live on ``cuda`` unless ``device`` says otherwise.
    """

    def __init__(self, cfg: TransformerConfig, device=None):
        super().__init__()
        self.cfg = cfg
        device = resolve_device(device)
        self.embed = nn.Embedding(cfg.vocab_size, cfg.embed_dim,
                                  dtype=cfg.param_dtype, device=device)
        self.layers = nn.ModuleList(Block(cfg, device)
                                    for _ in range(cfg.num_layers))
        self.final_norm = FusedRMSNorm(
            cfg.embed_dim, dtype=cfg.dtype, param_dtype=cfg.param_dtype,
            use_fused=cfg.fused_norm, device=device)
        self.lm_head = nn.Linear(cfg.embed_dim, cfg.vocab_size, bias=False,
                                 dtype=cfg.param_dtype, device=device)

    def forward(self, tokens, kv_cache=None, lengths=None, return_kv=False):
        cfg = self.cfg
        decode = kv_cache is not None
        tokens = tokens.long()
        x = self.embed(tokens).to(cfg.dtype)
        positions = torch.arange(tokens.shape[1], device=tokens.device)[None]
        if decode:
            lengths = lengths.long()
            positions = lengths[:, None] + positions
        positions = positions.expand(tokens.shape)
        kvs = []
        for i, block in enumerate(self.layers):
            if decode:
                x, kv = block(x, positions,
                              cache=(kv_cache[0][i], kv_cache[1][i], lengths))
            elif return_kv:
                x, kv = block(x, positions, return_kv=True)
                kvs.append(kv)
            else:
                x = block(x, positions)
        x = self.final_norm(x)
        logits = _linear(x, self.lm_head, cfg.dtype).to(cfg.logits_dtype)
        if decode:
            if tokens.shape[1] == 1:
                return logits[:, 0], kv_cache
            return logits, kv_cache
        if return_kv:
            return logits, (torch.stack([kv[0] for kv in kvs]),
                            torch.stack([kv[1] for kv in kvs]))
        return logits
