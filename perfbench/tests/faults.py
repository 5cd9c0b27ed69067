"""Faults planted under the timed path, as ``"module:function"`` patches
that a test hands ``run.execute`` (which applies them in every rank)."""

from __future__ import annotations

import torch

from perfbench.kinds import train_cnn, train_decoder

KINDS = (train_decoder, train_cnn)


def _each_kind(make):
    for kind in KINDS:
        broken = make(kind, kind.program_step())
        kind.program_step = lambda broken=broken: broken


def unchanged() -> None:
    """A step that computes its loss and leaves the state as it was."""
    def make(kind, real):
        if kind is train_decoder:
            from horovod_tpu_torch.train_transformer import loss_fn

            def step(model, opt, tokens):
                with torch.no_grad():
                    return loss_fn(model, tokens)
            return step

        from horovod_tpu_torch.ops.losses import softmax_cross_entropy

        def step(model, opt, x, y):
            with torch.no_grad():
                return softmax_cross_entropy(model(x, train=True),
                                             y).mean()
        return step
    _each_kind(make)


def half_batch() -> None:
    """Half of each batch left out, the mean taken over the rest."""
    def make(kind, real):
        def step(model, opt, *batch):
            return real(model, opt, *(t[:t.shape[0] // 2] for t in batch))
        return step
    _each_kind(make)


def no_exchange() -> None:
    """The distributed optimizer steps on each rank's own gradients: the
    exchange between chips left out."""
    from horovod_tpu_torch import training

    training._DistributedOptimizer.synchronize = lambda self: None


def altered_token() -> None:
    """Every decoded token replaced, where the backend produces it, by
    the one the program's own logits rank last."""
    from horovod_tpu_torch.serving import engine

    real = engine._ModelBackend._cache_step

    def altered(self, tok_block, lengths):
        preds, logits = real(self, tok_block, lengths)
        return logits.argmin(-1).astype(preds.dtype).reshape(
            preds.shape), logits

    engine._ModelBackend._cache_step = altered


# A middle block of the third stage (of a shorter net, its last block).
BRANCH_BLOCK = 8


def branch_conv_zero() -> None:
    """One block's 3x3 convolution hands on zeros (its result is never
    written), inside a branch that gets no first gradient while the
    block's last BatchNorm scale is 0."""
    from horovod_tpu_torch.models import resnet

    real = resnet.ResNet.__init__

    def init(self, *args, **kwargs):
        real(self, *args, **kwargs)
        conv = self.blocks[min(BRANCH_BLOCK, len(self.blocks) - 1)].convs[1]
        forward = conv.forward
        conv.forward = lambda x: torch.zeros_like(forward(x))

    resnet.ResNet.__init__ = init
