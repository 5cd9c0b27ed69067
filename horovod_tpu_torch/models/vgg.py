"""VGG — counterpart of ``horovod_tpu/models/vgg.py``, the bandwidth-heavy
model of the reference Horovod's benchmark table (~138 M parameters at
1000 classes: ~553 MB of f32 gradients a step).

The layout is the JAX package's: NHWC images in, f32 logits out, bf16
compute over f32 parameters (activations are NCHW tensors in
``torch.channels_last`` memory inside, as in :mod:`.resnet`):

* configs D and E (:data:`CFG_16`, :data:`CFG_19`) of 3×3 "SAME"
  convolutions with bias and ReLU, or, with ``batch_norm=True``, without
  bias and with a BatchNorm (eps 1e-5, synced across ``process_group``'s
  ranks when one is given); "M" is a 2×2/2 max pool;
* the features flattened in NHWC order, so the first Dense's rows are
  flax's ``[7·7·512, 4096]`` kernel's (transposed);
* two Dense(4096) + ReLU + dropout, in ``dtype``;
* an f32 ``head``.

Dropout (``dropout_rate``) is active only when ``train=True`` and then
draws its mask from the ``generator`` the caller passes, as flax's needs a
``"dropout"`` key; a rate of 0 is the identity.  The first Dense's width
follows from ``image_size`` (224: 7·7·512), as flax's follows from the
input at ``init``.
"""

from __future__ import annotations

import functools
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from horovod_tpu_torch.models.resnet import BatchNorm, Conv, dense
from horovod_tpu_torch.utils.device import resolve_device

CFG_16: tuple = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
                 512, 512, 512, "M", 512, 512, 512, "M")
CFG_19: tuple = (64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
                 512, 512, 512, 512, "M", 512, 512, 512, 512, "M")
FC_WIDTH = 4096


def dropout(x, rate: float, train: bool, generator):
    """flax ``nn.Dropout``: keep each value with probability ``1 - rate``
    and scale it by ``1 / (1 - rate)``; the identity when not training or
    at rate 0.  The mask comes from ``generator``."""
    if not train or rate == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout is active (train=True, rate "
                         f"{rate}): pass generator=")
    keep = torch.rand(x.shape, generator=generator, device=x.device) \
        >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


class VGG(nn.Module):
    """VGG over NHWC inputs: ``forward(x, train=True, generator=None)`` ->
    f32 logits."""

    def __init__(self, cfg: Sequence = CFG_16, num_classes: int = 1000,
                 dtype=torch.bfloat16, batch_norm: bool = False,
                 dropout_rate: float = 0.5, image_size: int = 224,
                 process_group=None, device=None):
        super().__init__()
        device = resolve_device(device)
        self.cfg, self.dtype = tuple(cfg), dtype
        self.batch_norm, self.dropout_rate = batch_norm, dropout_rate
        convs, norms, ch, side = [], [], 3, image_size
        for width in self.cfg:
            if width == "M":
                side //= 2
                continue
            convs.append(Conv(ch, width, (3, 3), bias=not batch_norm,
                              dtype=dtype, device=device))
            if batch_norm:
                norms.append(BatchNorm(width, dtype, device,
                                       process_group=process_group))
            ch = width
        self.convs = nn.ModuleList(convs)
        self.norms = nn.ModuleList(norms)
        self.dense = nn.ModuleList([
            nn.Linear(side * side * ch, FC_WIDTH, device=device),
            nn.Linear(FC_WIDTH, FC_WIDTH, device=device)])
        self.head = nn.Linear(FC_WIDTH, num_classes, device=device)

    def forward(self, x, train: bool = True, generator=None):
        x = x.to(self.dtype).permute(0, 3, 1, 2)   # NHWC -> channels_last
        i = 0
        for width in self.cfg:
            if width == "M":
                x = F.max_pool2d(x, 2, 2)
                continue
            x = self.convs[i](x)
            if self.batch_norm:
                x = self.norms[i](x, train)
            x = F.relu(x)
            i += 1
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)   # NHWC order
        for layer in self.dense:
            x = F.relu(dense(x, layer, self.dtype))
            x = dropout(x, self.dropout_rate, train, generator)
        return self.head(x.float())


VGG16 = functools.partial(VGG, cfg=CFG_16)
VGG19 = functools.partial(VGG, cfg=CFG_19)
