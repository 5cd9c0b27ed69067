"""MNIST models — counterpart of ``horovod_tpu/models/mnist.py``.

``MnistCNN`` is the conv-conv-fc net of the reference Horovod's MNIST
examples and ``MnistMLP`` the 2×2000-unit MLP, with the JAX package's
layout: NHWC images in, f32 logits out.  ``MnistCNN`` flattens its pooled
features in NHWC order, so its first Dense keeps flax's ``[H·W·C, out]``
row order (``convert.mnist_from_flax`` only transposes it).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from horovod_tpu_torch.models.resnet import Conv, dense
from horovod_tpu_torch.utils.device import resolve_device


class MnistCNN(nn.Module):
    """Conv(32, 3×3) → relu → Conv(64, 3×3) → relu → 2×2 max pool →
    Dense(128) → relu → Dense(num_classes, f32), over ``[B, 28, 28, 1]``."""

    def __init__(self, num_classes: int = 10, dtype=torch.float32,
                 in_channels: int = 1, image_size: int = 28, device=None):
        super().__init__()
        device = resolve_device(device)
        self.dtype = dtype
        self.convs = nn.ModuleList([
            Conv(in_channels, 32, (3, 3), bias=True, dtype=dtype,
                 device=device),
            Conv(32, 64, (3, 3), bias=True, dtype=dtype, device=device)])
        pooled = (image_size // 2) ** 2 * 64
        self.dense = nn.ModuleList([nn.Linear(pooled, 128, device=device),
                                    nn.Linear(128, num_classes,
                                              device=device)])

    def forward(self, x, train: bool = True):
        x = x.to(self.dtype).permute(0, 3, 1, 2)   # NHWC -> channels_last
        for conv in self.convs:
            x = F.relu(conv(x))
        x = F.max_pool2d(x, 2, 2)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)   # NHWC order
        x = F.relu(dense(x, self.dense[0], self.dtype))
        return dense(x.float(), self.dense[1], torch.float32)


class MnistMLP(nn.Module):
    """Two hidden layers of ``hidden`` units with relu, f32 throughout."""

    def __init__(self, num_classes: int = 10, hidden: int = 2000,
                 in_features: int = 28 * 28, device=None):
        super().__init__()
        device = resolve_device(device)
        self.dense = nn.ModuleList([
            nn.Linear(in_features, hidden, device=device),
            nn.Linear(hidden, hidden, device=device),
            nn.Linear(hidden, num_classes, device=device)])

    def forward(self, x, train: bool = True):
        x = x.reshape(x.shape[0], -1).float()
        x = F.relu(self.dense[0](x))
        x = F.relu(self.dense[1](x))
        return self.dense[2](x)
