"""Plain reference of the decoder family, DeepSeek LLM's architecture:
float32 PyTorch with TF32 off, no kernels, no cache, no batching.

From DeepSeek LLM (arXiv:2401.02954, §2.2, "the micro design largely
follows LLaMA") and the ``config.json`` of deepseek-ai/deepseek-llm-7b-base:
pre-norm blocks with RMSNorm (eps from the configuration), multi-head
attention with rotary embeddings (theta from the configuration, the two
halves of each head rotated as LLaMA's ``rotate_half``), a SiLU-gated
MLP, no biases, a final RMSNorm and an untied head; the loss is the mean
next-token cross entropy.  AdamW is ``torch.optim.AdamW``.

Departures, each for the check and none for the model's mathematics:
every block is recomputed in the backward pass (``torch.utils.checkpoint``)
and a batch's rows run one after the other with their gradients added,
so that the reference fits beside nothing else on one card; the loss of
a row is divided by the batch's token count before its backward, which
gives the batch's mean.

``quant="fp8"`` is the check's control: every matrix product takes its
two operands through float8 e4m3 (per-tensor scale to the format's
largest value, straight-through in the backward), the step below the
configuration's bf16.

Imports nothing of the program."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

FP8_MAX = 448.0


def strict_f32() -> None:
    """Float32 products in float32: TF32 off for cuBLAS and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def fp8(t):
    """``t`` rounded through float8 e4m3 at a per-tensor scale, with the
    identity as its gradient."""
    with torch.no_grad():
        scale = t.detach().abs().amax().clamp_min(1e-30) / FP8_MAX
        q = (t.detach() / scale).to(torch.float8_e4m3fn).float() * scale
    return t + (q - t).detach()


def _operands(quant):
    if quant is None:
        return lambda t: t
    if quant == "fp8":
        return fp8
    raise ValueError(f"quant {quant!r}")


def rms_norm(x, scale, eps: float):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale


def rope(x, positions, theta: float):
    """``x``: [S, H, D]; the first and second halves of D rotate as pairs
    at frequencies ``theta^(-2i/D)``."""
    d = x.shape[-1]
    freq = theta ** (-torch.arange(0, d, 2, dtype=torch.float32,
                                   device=x.device) / d)
    ang = positions[:, None].float() * freq[None]              # [S, D/2]
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


class Decoder:
    """The forward pass over one sequence at a time, from weights
    ``w`` (``{name: f32 tensor}``, names and ``[out, in]`` layout as in
    ``perfbench.models.decoder.leaves``)."""

    def __init__(self, cfg: dict, w: dict, quant=None):
        self.cfg, self.w = cfg, w
        self.q = _operands(quant)
        self.heads = cfg["num_attention_heads"]
        self.eps = float(cfg["rms_norm_eps"])
        self.theta = float(cfg["rope_theta"])

    def linear(self, x, name):
        return self.q(x) @ self.q(self.w[name]).t()

    def attention(self, x, i, positions):
        s, e = x.shape
        p = f"layers.{i}.attn."
        split = lambda t: t.view(s, self.heads, -1)  # noqa: E731
        q = rope(split(self.linear(x, p + "q.weight")), positions,
                 self.theta)
        k = rope(split(self.linear(x, p + "k.weight")), positions,
                 self.theta)
        v = split(self.linear(x, p + "v.weight"))
        d = q.shape[-1]
        scores = torch.einsum("qhd,khd->hqk", self.q(q), self.q(k)) \
            / math.sqrt(d)
        mask = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
        probs = torch.softmax(scores.masked_fill(~mask, float("-inf")),
                              dim=-1)
        out = torch.einsum("hqk,khd->qhd", self.q(probs), self.q(v))
        return self.linear(out.reshape(s, -1), p + "o.weight")

    def block(self, x, i, positions):
        p = f"layers.{i}."
        x = x + self.attention(
            rms_norm(x, self.w[p + "attn_norm.scale"], self.eps), i,
            positions)
        h = rms_norm(x, self.w[p + "mlp_norm.scale"], self.eps)
        mlp = F.silu(self.linear(h, p + "mlp.gate.weight")) * \
            self.linear(h, p + "mlp.up.weight")
        return x + self.linear(mlp, p + "mlp.down.weight")

    def hidden(self, tokens, recompute: bool = False):
        """Final-normed hidden states of one sequence ``tokens`` [S]."""
        positions = torch.arange(tokens.shape[0], device=tokens.device)
        x = self.w["embed.weight"][tokens]
        for i in range(self.cfg["num_hidden_layers"]):
            if recompute:
                x = checkpoint(self.block, x, i, positions,
                               use_reentrant=False)
            else:
                x = self.block(x, i, positions)
        return rms_norm(x, self.w["final_norm.scale"], self.eps)

    def logits(self, h):
        return self.linear(h, "lm_head.weight")


def batch_loss_backward(cfg, w, tokens, quant=None, world: int = 1) -> float:
    """Mean next-token cross entropy over the batch ``tokens`` [B, S]
    (over ``world`` times its rows where ranks each hold a share), its
    gradient added into the leaves' ``.grad``; returns this share's part
    of the loss."""
    model = Decoder(cfg, w, quant)
    b, s = tokens.shape
    count = world * b * (s - 1)
    total = 0.0
    for r in range(b):
        h = model.hidden(tokens[r], recompute=True)
        logits = model.logits(h[:-1])
        loss = F.cross_entropy(logits, tokens[r, 1:], reduction="sum") \
            / count
        loss.backward()
        total += float(loss.detach())
        del h, logits, loss
    return total


def train(cfg: dict, hp: dict, make_weights, batches, quant=None,
          rows=None, world: int = 1, allreduce=None) -> dict:
    """Follow the program's first ``len(batches)`` steps: AdamW on f32
    weights from ``make_weights()`` (``{name: f32 tensor}``, made anew
    each call), one batch a step.  ``rows`` keeps only the first rows of
    each batch (a planted fault: part of the batch left out).  Where
    ``world`` ranks each hold a share of every batch, ``allreduce`` (an
    in-place sum over the ranks) adds up the shares' gradients and
    losses.

    Returns the losses, the first step's gradient norm of every leaf, and
    every leaf's norm of change over the steps."""
    w = {n: t.requires_grad_(True) for n, t in make_weights().items()}
    opt = torch.optim.AdamW(list(w.values()), lr=hp["lr"],
                            betas=tuple(hp["betas"]), eps=hp["eps"],
                            weight_decay=hp["weight_decay"], foreach=False)
    losses, grad_norms = [], {}
    for step, tokens in enumerate(batches):
        opt.zero_grad(set_to_none=True)
        loss = batch_loss_backward(
            cfg, w, tokens if rows is None else tokens[:rows], quant, world)
        if allreduce is not None:
            for t in w.values():
                allreduce(t.grad)
            total = torch.tensor([loss], dtype=torch.float64,
                                 device=tokens.device)
            allreduce(total)
            loss = float(total)
        losses.append(loss)
        if step == 0:
            grad_norms = {n: float(t.grad.norm()) for n, t in w.items()}
        opt.step()
    del opt
    for t in w.values():
        t.grad = None
    w0 = make_weights()
    change = {}
    with torch.no_grad():
        for n, t in w.items():
            change[n] = float((t - w0[n]).norm())
            del w0[n]
    return {"losses": losses, "grad_norms": grad_norms,
            "change_norms": change}


@torch.no_grad()
def served_logits(cfg: dict, w: dict, tokens, positions, quant=None):
    """Logits [len(positions), vocab] of the sequence ``tokens`` [S] at
    ``positions``."""
    model = Decoder(cfg, w, quant)
    h = model.hidden(tokens)
    return model.logits(h[positions])
