"""ResNet v1.5 — counterpart of ``horovod_tpu/models/resnet.py``, the
model of the ``BASELINE.json`` metric (ResNet-50 on synthetic data).

The public layout is the JAX package's: the model takes NHWC images and
returns f32 logits.  Inside, activations are NCHW tensors in
``torch.channels_last`` memory, which is NHWC in memory, so the NHWC
input's permuted view is already in that layout.  Parameters are f32 and
cast to the compute ``dtype`` (bf16 by default) at each use, as flax's
``Conv(dtype=...)`` casts them.

What follows flax, not PyTorch's defaults, each pinned by a parity test:

* **"SAME" padding** is flax's, asymmetric at stride 2 (the 7×7/2 stem
  pads (2, 3) at 224; a 3×3/2 conv pads (0, 1) at an even size), so it is
  an explicit ``F.pad`` before a convolution with ``padding=0``; the
  3×3/2 max pool pads the same way with −inf;
* **BatchNorm** is flax's ``BatchNorm(momentum=0.9, epsilon=1e-5)``:
  statistics in f32, the output in ``dtype``, and the running statistics
  ``ra = 0.9·ra + 0.1·batch`` with the *biased* batch variance (PyTorch's
  own running update uses the unbiased one; :class:`BatchNorm` undoes
  that);
* the last BN scale of each block starts at zero (:mod:`.convert`);
* the head is an f32 Dense over the mean of the pooled features, taken in
  ``dtype`` as ``jnp.mean`` takes it, then widened to f32.

Cross-replica BatchNorm (the JAX model's ``axis_name``) is not ported:
``bench.py``'s protocol keeps each replica's statistics local.
"""

from __future__ import annotations

import functools
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from horovod_tpu_torch.utils.device import resolve_device

BN_MOMENTUM = 0.9
BN_EPS = 1e-5


def same_pads(size: int, kernel: int, stride: int) -> tuple[int, int]:
    """flax/XLA "SAME" padding ``(low, high)`` of one spatial axis: the
    output has ``ceil(size / stride)`` positions, and the odd pixel of the
    total pad goes to the high side."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def _pad_same(x, kernel, stride, value=0.0):
    """``x`` (NCHW) padded for a "SAME" window of ``kernel`` / ``stride``."""
    h_lo, h_hi = same_pads(x.shape[2], kernel[0], stride[0])
    w_lo, w_hi = same_pads(x.shape[3], kernel[1], stride[1])
    if not (h_lo or h_hi or w_lo or w_hi):
        return x
    return F.pad(x, (w_lo, w_hi, h_lo, h_hi), value=value)


class Conv(nn.Module):
    """flax ``nn.Conv(padding="SAME")``: an OIHW f32 ``weight`` (and
    ``bias``), both operands cast to ``dtype`` at use."""

    def __init__(self, in_ch: int, out_ch: int, kernel: tuple[int, int],
                 stride: tuple[int, int] = (1, 1), bias: bool = False,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.kernel, self.stride, self.dtype = kernel, stride, dtype
        self.weight = nn.Parameter(torch.zeros(out_ch, in_ch, *kernel,
                                               device=device))
        self.bias = (nn.Parameter(torch.zeros(out_ch, device=device))
                     if bias else None)

    def forward(self, x):
        x = _pad_same(x.to(self.dtype), self.kernel, self.stride)
        b = None if self.bias is None else self.bias.to(self.dtype)
        return F.conv2d(x, self.weight.to(self.dtype), b, self.stride)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` over the channels of NCHW activations:
    ``scale``, ``bias`` (f32 parameters) and the running ``mean``, ``var``
    (f32 buffers, flax's ``batch_stats``)."""

    def __init__(self, ch: int, dtype=torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.scale = nn.Parameter(torch.ones(ch, device=device))
        self.bias = nn.Parameter(torch.zeros(ch, device=device))
        self.register_buffer("mean", torch.zeros(ch, device=device))
        self.register_buffer("var", torch.ones(ch, device=device))

    def forward(self, x, train: bool):
        x = x.to(self.dtype)
        if not train:
            return F.batch_norm(x, self.mean, self.var, self.scale,
                                self.bias, False, 0.0, BN_EPS)
        # One fused pass normalises with the batch's biased variance in f32.
        # With momentum 1 it also hands back the batch mean and PyTorch's
        # unbiased variance, whose factor n / (n - 1) is undone for flax's
        # running update.
        mean = torch.zeros_like(self.mean)
        var = torch.zeros_like(self.var)
        y = F.batch_norm(x, mean, var, self.scale, self.bias, True, 1.0,
                         BN_EPS)
        n = x.numel() // x.shape[1]
        with torch.no_grad():
            biased = var * ((n - 1) / n)
            self.mean.copy_(BN_MOMENTUM * self.mean + (1 - BN_MOMENTUM) * mean)
            self.var.copy_(BN_MOMENTUM * self.var + (1 - BN_MOMENTUM) * biased)
        return y


class BottleneckBlock(nn.Module):
    """1×1 → 3×3(stride) → 1×1(×4) bottleneck with projection shortcut."""

    expansion = 4

    def __init__(self, in_ch: int, filters: int, stride: int, dtype,
                 device=None):
        super().__init__()
        s, out = (stride, stride), filters * 4
        mk = functools.partial(Conv, dtype=dtype, device=device)
        self.convs = nn.ModuleList([mk(in_ch, filters, (1, 1)),
                                    mk(filters, filters, (3, 3), s),
                                    mk(filters, out, (1, 1))])
        self.norms = nn.ModuleList([BatchNorm(c, dtype, device)
                                    for c in (filters, filters, out)])
        self.conv_proj = self.norm_proj = None
        if in_ch != out or stride != 1:
            self.conv_proj = mk(in_ch, out, (1, 1), s)
            self.norm_proj = BatchNorm(out, dtype, device)

    def forward(self, x, train: bool):
        y = x
        for i, (conv, norm) in enumerate(zip(self.convs, self.norms)):
            y = norm(conv(y), train)
            if i < 2:
                y = F.relu(y)
        residual = x
        if self.conv_proj is not None:
            residual = self.norm_proj(self.conv_proj(x), train)
        return F.relu(residual + y)


class BasicBlock(nn.Module):
    """3×3 → 3×3 block for ResNet-18/34."""

    expansion = 1

    def __init__(self, in_ch: int, filters: int, stride: int, dtype,
                 device=None):
        super().__init__()
        s = (stride, stride)
        mk = functools.partial(Conv, dtype=dtype, device=device)
        self.convs = nn.ModuleList([mk(in_ch, filters, (3, 3), s),
                                    mk(filters, filters, (3, 3))])
        self.norms = nn.ModuleList([BatchNorm(filters, dtype, device)
                                    for _ in range(2)])
        self.conv_proj = self.norm_proj = None
        if in_ch != filters or stride != 1:
            self.conv_proj = mk(in_ch, filters, (1, 1), s)
            self.norm_proj = BatchNorm(filters, dtype, device)

    def forward(self, x, train: bool):
        y = F.relu(self.norms[0](self.convs[0](x), train))
        y = self.norms[1](self.convs[1](y), train)
        residual = x
        if self.conv_proj is not None:
            residual = self.norm_proj(self.conv_proj(x), train)
        return F.relu(residual + y)


class ResNet(nn.Module):
    """ResNet v1.5 over NHWC inputs: ``forward(x, train=True)`` -> f32
    logits.  ``dtype`` is the compute dtype; parameters are f32.
    ``train=False`` uses the running batch-norm statistics."""

    def __init__(self, stage_sizes: Sequence[int], block_cls,
                 num_classes: int = 1000, num_filters: int = 64,
                 dtype=torch.bfloat16, in_channels: int = 3, device=None):
        super().__init__()
        device = resolve_device(device)
        self.stage_sizes, self.block_cls = tuple(stage_sizes), block_cls
        self.dtype = dtype
        nf = num_filters
        self.conv_init = Conv(in_channels, nf, (7, 7), (2, 2), dtype=dtype,
                              device=device)
        self.bn_init = BatchNorm(nf, dtype, device)
        blocks, in_ch = [], nf
        for i, count in enumerate(self.stage_sizes):
            for j in range(count):
                stride = 2 if i > 0 and j == 0 else 1
                blocks.append(block_cls(in_ch, nf * 2 ** i, stride, dtype,
                                        device))
                in_ch = nf * 2 ** i * block_cls.expansion
        self.blocks = nn.ModuleList(blocks)
        self.head = nn.Linear(in_ch, num_classes, device=device)

    def forward(self, x, train: bool = True):
        x = x.to(self.dtype).permute(0, 3, 1, 2)   # NHWC -> channels_last
        x = F.relu(self.bn_init(self.conv_init(x), train))
        x = F.max_pool2d(_pad_same(x, (3, 3), (2, 2), float("-inf")), 3, 2)
        for block in self.blocks:
            x = block(x, train)
        return self.head(x.mean(dim=(2, 3)).float())


ResNet18 = functools.partial(ResNet, stage_sizes=(2, 2, 2, 2),
                             block_cls=BasicBlock)
ResNet34 = functools.partial(ResNet, stage_sizes=(3, 4, 6, 3),
                             block_cls=BasicBlock)
ResNet50 = functools.partial(ResNet, stage_sizes=(3, 4, 6, 3),
                             block_cls=BottleneckBlock)
ResNet101 = functools.partial(ResNet, stage_sizes=(3, 4, 23, 3),
                              block_cls=BottleneckBlock)
ResNet152 = functools.partial(ResNet, stage_sizes=(3, 8, 36, 3),
                              block_cls=BottleneckBlock)
