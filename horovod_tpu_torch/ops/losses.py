"""Softmax cross entropy with f32 numerics and a logits-dtype cotangent.

Counterpart of ``horovod_tpu/ops/losses.py``: the forward takes the
logsumexp and the true-class logit in f32 (bf16 logits are widened inside);
the backward returns ``(softmax - onehot) * g`` cast to the logits' dtype,
so a bf16 head gets a half-width gradient.  Plain PyTorch: the JAX package
has no kernel here.
"""

from __future__ import annotations

import torch


class _SoftmaxCrossEntropy(torch.autograd.Function):

    @staticmethod
    def forward(ctx, logits, labels):
        lf = logits.float()
        lse = torch.logsumexp(lf, dim=-1)
        true_logit = lf.gather(-1, labels[..., None].long())[..., 0]
        ctx.save_for_backward(logits, lse, labels)
        return lse - true_logit

    @staticmethod
    def backward(ctx, g):
        logits, lse, labels = ctx.saved_tensors
        d = torch.exp(logits.float() - lse[..., None])
        # Subtract the one-hot in place rather than building it: at a 32k
        # vocabulary a dense one-hot is as large as the f32 logits.
        d.scatter_add_(-1, labels[..., None].long(),
                       torch.full_like(lse[..., None], -1.0))
        return (d * g[..., None]).to(logits.dtype), None


def softmax_cross_entropy(logits, labels):
    """Per-example cross entropy: f32 softmax numerics, logits-dtype
    cotangent.  ``logits``: ``[..., V]`` (any float dtype), ``labels``:
    ``[...]`` int.  Returns f32 ``[...]`` losses (reduce them yourself)."""
    return _SoftmaxCrossEntropy.apply(logits, labels)
