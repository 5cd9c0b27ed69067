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
  that); ``eps`` is the module's (Inception's is 1e-3);
* the last BN scale of each block starts at zero (:mod:`.convert`);
* the head is an f32 Dense over the mean of the pooled features, taken in
  ``dtype`` as ``jnp.mean`` takes it, then widened to f32.

Cross-replica BatchNorm is the JAX model's ``axis_name``: pass
``process_group`` (a ``torch.distributed`` group; ``dist.group.WORLD`` for
the job) and every BatchNorm takes its statistics over the whole batch of
the group's ranks, one ``all_reduce`` a BatchNorm forward and one backward
(:class:`BatchNorm`).  ``None``, the default and ``bench.py``'s protocol,
keeps each replica's statistics local.
"""

from __future__ import annotations

import functools
from typing import Sequence

import torch
import torch.distributed as dist
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
    """flax ``nn.Conv``: an OIHW f32 ``weight`` (and ``bias``), both
    operands cast to ``dtype`` at use; ``padding`` is flax's ``"SAME"`` or
    ``"VALID"``."""

    def __init__(self, in_ch: int, out_ch: int, kernel: tuple[int, int],
                 stride: tuple[int, int] = (1, 1), bias: bool = False,
                 dtype=torch.float32, device=None, padding: str = "SAME"):
        super().__init__()
        if padding not in ("SAME", "VALID"):
            raise ValueError(f"padding {padding!r}: SAME or VALID")
        self.kernel, self.stride, self.dtype = kernel, stride, dtype
        self.padding = padding
        self.weight = nn.Parameter(torch.zeros(out_ch, in_ch, *kernel,
                                               device=device))
        self.bias = (nn.Parameter(torch.zeros(out_ch, device=device))
                     if bias else None)

    def forward(self, x):
        x = x.to(self.dtype)
        if self.padding == "SAME":
            x = _pad_same(x, self.kernel, self.stride)
        b = None if self.bias is None else self.bias.to(self.dtype)
        return F.conv2d(x, self.weight.to(self.dtype), b, self.stride)


def dense(x, layer: nn.Linear, dtype):
    """flax ``Dense(dtype=...)``: both operands cast to ``dtype``."""
    return F.linear(x.to(dtype), layer.weight.to(dtype),
                    layer.bias.to(dtype))


class _SyncStats(torch.autograd.Function):
    """Batch normalisation over the batch of every rank of ``group``:
    flax's ``BatchNorm(axis_name=...)`` with its fast variance.

    Forward: this rank's per-channel f32 ``[mean, mean of squares]``,
    stacked, summed over the group by one ``all_reduce`` and divided by its
    size (flax's ``pmean``: every rank holds the same batch size), the
    variance ``max(E[x²] − E[x]², 0)``, and ``y = (x − mean)·rsqrt(var +
    eps)·scale + bias`` in f32, returned in ``x``'s dtype with the batch's
    mean and variance.  Backward: the transpose of that ``pmean``, one
    ``all_reduce`` of the stacked per-channel sums ``[Σdy, Σdy·x̂]``; the
    scale and bias gradients are this rank's own sums, which the
    optimizer's allreduce averages as it does every other gradient."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps: float, group):
        dims, shape = (0, 2, 3), (1, -1, 1, 1)
        xf = x.float()
        stats = torch.stack([xf.mean(dims), (xf * xf).mean(dims)])
        world = dist.get_world_size(group)
        dist.all_reduce(stats, group=group)
        stats /= world
        mean = stats[0]
        var = torch.clamp(stats[1] - mean * mean, min=0.0)
        invstd = torch.rsqrt(var + eps)
        y = (xf - mean.view(shape)) * (invstd * scale).view(shape) \
            + bias.view(shape)
        ctx.save_for_backward(x, mean, invstd, scale)
        ctx.group = group
        ctx.count = world * (x.numel() // x.shape[1])
        ctx.mark_non_differentiable(mean, var)
        return y.to(x.dtype), mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, mean, invstd, scale = ctx.saved_tensors
        dims, shape = (0, 2, 3), (1, -1, 1, 1)
        dyf = dy.float()
        xhat = (x.float() - mean.view(shape)) * invstd.view(shape)
        sums = torch.stack([dyf.sum(dims), (dyf * xhat).sum(dims)])
        dbias, dscale = sums[0].clone(), sums[1].clone()
        dist.all_reduce(sums, group=ctx.group)
        sums /= ctx.count
        dx = (dyf - sums[0].view(shape) - xhat * sums[1].view(shape)) \
            * (scale * invstd).view(shape)
        return dx.to(x.dtype), dscale, dbias, None, None


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` over the channels of NCHW activations:
    ``scale``, ``bias`` (f32 parameters) and the running ``mean``, ``var``
    (f32 buffers, flax's ``batch_stats``).

    ``process_group`` (a ``torch.distributed`` group) is flax's
    ``axis_name``: training takes the statistics over every rank's batch
    (:class:`_SyncStats`), so the running statistics are the same on every
    rank.  ``None`` keeps them local."""

    def __init__(self, ch: int, dtype=torch.float32, device=None,
                 eps: float = BN_EPS, process_group=None):
        super().__init__()
        self.dtype, self.eps = dtype, eps
        self.process_group = process_group
        self.scale = nn.Parameter(torch.ones(ch, device=device))
        self.bias = nn.Parameter(torch.zeros(ch, device=device))
        self.register_buffer("mean", torch.zeros(ch, device=device))
        self.register_buffer("var", torch.ones(ch, device=device))

    def forward(self, x, train: bool):
        x = x.to(self.dtype)
        if not train:
            return F.batch_norm(x, self.mean, self.var, self.scale,
                                self.bias, False, 0.0, self.eps)
        if self.process_group is not None:
            y, mean, var = _SyncStats.apply(x, self.scale, self.bias,
                                            self.eps, self.process_group)
            with torch.no_grad():
                self.mean.copy_(BN_MOMENTUM * self.mean
                                + (1 - BN_MOMENTUM) * mean)
                self.var.copy_(BN_MOMENTUM * self.var
                               + (1 - BN_MOMENTUM) * var)
            return y
        # One fused pass normalises with the batch's biased variance in f32.
        # With momentum 1 it also hands back the batch mean and PyTorch's
        # unbiased variance, whose factor n / (n - 1) is undone for flax's
        # running update.
        mean = torch.zeros_like(self.mean)
        var = torch.zeros_like(self.var)
        y = F.batch_norm(x, mean, var, self.scale, self.bias, True, 1.0,
                         self.eps)
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
                 device=None, process_group=None):
        super().__init__()
        s, out = (stride, stride), filters * 4
        mk = functools.partial(Conv, dtype=dtype, device=device)
        norm = functools.partial(BatchNorm, dtype=dtype, device=device,
                                 process_group=process_group)
        self.convs = nn.ModuleList([mk(in_ch, filters, (1, 1)),
                                    mk(filters, filters, (3, 3), s),
                                    mk(filters, out, (1, 1))])
        self.norms = nn.ModuleList([norm(c) for c in (filters, filters, out)])
        self.conv_proj = self.norm_proj = None
        if in_ch != out or stride != 1:
            self.conv_proj = mk(in_ch, out, (1, 1), s)
            self.norm_proj = norm(out)

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
                 device=None, process_group=None):
        super().__init__()
        s = (stride, stride)
        mk = functools.partial(Conv, dtype=dtype, device=device)
        norm = functools.partial(BatchNorm, dtype=dtype, device=device,
                                 process_group=process_group)
        self.convs = nn.ModuleList([mk(in_ch, filters, (3, 3), s),
                                    mk(filters, filters, (3, 3))])
        self.norms = nn.ModuleList([norm(filters) for _ in range(2)])
        self.conv_proj = self.norm_proj = None
        if in_ch != filters or stride != 1:
            self.conv_proj = mk(in_ch, filters, (1, 1), s)
            self.norm_proj = norm(filters)

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
    ``train=False`` uses the running batch-norm statistics;
    ``process_group`` syncs them across its ranks (the JAX model's
    ``axis_name``)."""

    def __init__(self, stage_sizes: Sequence[int], block_cls,
                 num_classes: int = 1000, num_filters: int = 64,
                 dtype=torch.bfloat16, in_channels: int = 3, device=None,
                 process_group=None):
        super().__init__()
        device = resolve_device(device)
        self.stage_sizes, self.block_cls = tuple(stage_sizes), block_cls
        self.dtype = dtype
        nf = num_filters
        self.conv_init = Conv(in_channels, nf, (7, 7), (2, 2), dtype=dtype,
                              device=device)
        self.bn_init = BatchNorm(nf, dtype, device,
                                 process_group=process_group)
        blocks, in_ch = [], nf
        for i, count in enumerate(self.stage_sizes):
            for j in range(count):
                stride = 2 if i > 0 and j == 0 else 1
                blocks.append(block_cls(in_ch, nf * 2 ** i, stride, dtype,
                                        device, process_group))
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
