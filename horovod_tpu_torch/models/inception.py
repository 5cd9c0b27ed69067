"""Inception V3 — counterpart of ``horovod_tpu/models/inception.py``, the
model that leads the reference Horovod's benchmark table.

The layout is the JAX package's: NHWC images in (canonically 299×299),
f32 logits out, bf16 compute over f32 parameters, NCHW activations in
``torch.channels_last`` memory inside (:mod:`.resnet`):

* every unit is conv → BatchNorm (eps 1e-3, synced across
  ``process_group``'s ranks when one is given) → ReLU (:class:`ConvBNReLU`,
  flax's ``_cbr``), convolutions without bias;
* the stem and the grid reductions are "VALID" (299² → 35² → 17² → 8²),
  the branches inside a block "SAME", with the factorised 1×7 / 7×1 and
  1×3 / 3×1 convolutions;
* the pooled branch's 3×3 "SAME" average pool counts the padded cells, as
  flax's ``avg_pool`` does (``count_include_pad=True``);
* ``aux_logits=True`` adds the auxiliary head on the 17×17 grid (a 5×5/3
  "VALID" average pool, a 1×1 unit, a unit whose kernel covers the pooled
  grid, the spatial mean and an f32 ``aux_head``); ``forward`` returns
  ``(logits, aux)`` only when ``train=True``.  The kernel's size follows
  from ``image_size`` (299: 5×5), as flax's follows from the input at
  ``init``;
* the head's spatial mean is taken in ``dtype`` and widened to f32 before
  the f32 ``head``.

Each block's units are held in flax's creation order (``units.i`` is the
block's ``Conv_i`` / ``BatchNorm_i``), which is what
:func:`~.convert.from_flax` relies on.  The smallest input is 75×75, or
107×107 with the auxiliary head.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch import nn

from horovod_tpu_torch.models.resnet import BatchNorm, Conv
from horovod_tpu_torch.models.vgg import dropout
from horovod_tpu_torch.utils.device import resolve_device

BN_EPS = 1e-3
AUX_POOL, AUX_STRIDE = 5, 3


class ConvBNReLU(nn.Module):
    """flax's ``_cbr``: conv → BatchNorm → ReLU."""

    def __init__(self, in_ch: int, out_ch: int, kernel, stride=(1, 1),
                 padding: str = "SAME", *, dtype, process_group, device):
        super().__init__()
        self.conv = Conv(in_ch, out_ch, tuple(kernel), tuple(stride),
                         dtype=dtype, device=device, padding=padding)
        self.norm = BatchNorm(out_ch, dtype, device, eps=BN_EPS,
                              process_group=process_group)

    def forward(self, x, train: bool):
        return F.relu(self.norm(self.conv(x), train))


def _avg_pool_same(x):
    """flax ``avg_pool(x, (3, 3), strides=(1, 1), padding="SAME")``: the
    padded cells count in the mean."""
    return F.avg_pool2d(x, 3, 1, padding=1, count_include_pad=True)


class _Block(nn.Module):
    """A mixed block: its :class:`ConvBNReLU` ``units``, made by ``mk`` from
    ``specs`` in flax's creation order; ``forward(x, t)`` with ``t`` the
    ``train`` flag; ``out_ch`` its output channels."""

    def __init__(self, specs, mk):
        super().__init__()
        self.units = nn.ModuleList([mk(*s) for s in specs])


class InceptionA(_Block):
    """35×35 block: 1×1 / 5×5 / double-3×3 / pooled branches."""

    def __init__(self, in_ch: int, pool_features: int, mk):
        super().__init__([(in_ch, 64, (1, 1)), (in_ch, 48, (1, 1)),
                          (48, 64, (5, 5)), (in_ch, 64, (1, 1)),
                          (64, 96, (3, 3)), (96, 96, (3, 3)),
                          (in_ch, pool_features, (1, 1))], mk)
        self.out_ch = 64 + 64 + 96 + pool_features

    def forward(self, x, t: bool):
        u = self.units
        return torch.cat([u[0](x, t), u[2](u[1](x, t), t),
                          u[5](u[4](u[3](x, t), t), t),
                          u[6](_avg_pool_same(x), t)], dim=1)


class ReductionA(_Block):
    """35×35 → 17×17: stride-2 "VALID" branches and a max pool."""

    def __init__(self, in_ch: int, mk):
        super().__init__([(in_ch, 384, (3, 3), (2, 2), "VALID"),
                          (in_ch, 64, (1, 1)), (64, 96, (3, 3)),
                          (96, 96, (3, 3), (2, 2), "VALID")], mk)
        self.out_ch = 384 + 96 + in_ch

    def forward(self, x, t: bool):
        u = self.units
        return torch.cat([u[0](x, t), u[3](u[2](u[1](x, t), t), t),
                          F.max_pool2d(x, 3, 2)], dim=1)


class InceptionC(_Block):
    """17×17 block with the factorised 1×7 / 7×1 convolutions."""

    def __init__(self, in_ch: int, channels_7x7: int, mk):
        c7 = channels_7x7
        super().__init__([(in_ch, 192, (1, 1)), (in_ch, c7, (1, 1)),
                          (c7, c7, (1, 7)), (c7, 192, (7, 1)),
                          (in_ch, c7, (1, 1)), (c7, c7, (7, 1)),
                          (c7, c7, (1, 7)), (c7, c7, (7, 1)),
                          (c7, 192, (1, 7)), (in_ch, 192, (1, 1))], mk)
        self.out_ch = 4 * 192

    def forward(self, x, t: bool):
        u = self.units
        bd = x
        for i in (4, 5, 6, 7, 8):
            bd = u[i](bd, t)
        return torch.cat([u[0](x, t), u[3](u[2](u[1](x, t), t), t), bd,
                          u[9](_avg_pool_same(x), t)], dim=1)


class ReductionB(_Block):
    """17×17 → 8×8 grid reduction."""

    def __init__(self, in_ch: int, mk):
        super().__init__([(in_ch, 192, (1, 1)),
                          (192, 320, (3, 3), (2, 2), "VALID"),
                          (in_ch, 192, (1, 1)), (192, 192, (1, 7)),
                          (192, 192, (7, 1)),
                          (192, 192, (3, 3), (2, 2), "VALID")], mk)
        self.out_ch = 320 + 192 + in_ch

    def forward(self, x, t: bool):
        u = self.units
        b7 = x
        for i in (2, 3, 4, 5):
            b7 = u[i](b7, t)
        return torch.cat([u[1](u[0](x, t), t), b7, F.max_pool2d(x, 3, 2)],
                         dim=1)


class InceptionE(_Block):
    """8×8 block with the 1×3 / 3×1 fan-out branches (→ 2048 channels)."""

    def __init__(self, in_ch: int, mk):
        super().__init__([(in_ch, 320, (1, 1)), (in_ch, 384, (1, 1)),
                          (384, 384, (1, 3)), (384, 384, (3, 1)),
                          (in_ch, 448, (1, 1)), (448, 384, (3, 3)),
                          (384, 384, (1, 3)), (384, 384, (3, 1)),
                          (in_ch, 192, (1, 1))], mk)
        self.out_ch = 320 + 2 * 384 + 2 * 384 + 192

    def forward(self, x, t: bool):
        u = self.units
        b3 = u[1](x, t)
        bd = u[5](u[4](x, t), t)
        return torch.cat([u[0](x, t), u[2](b3, t), u[3](b3, t), u[6](bd, t),
                          u[7](bd, t), u[8](_avg_pool_same(x), t)], dim=1)


def grid_17(image_size: int) -> int:
    """Side of the 17×17-level grid (17 at 299) for an input side."""
    s = (image_size - 3) // 2 + 1      # 3×3/2 VALID
    s = s - 2                          # 3×3 VALID; then a 3×3 SAME
    s = (s - 3) // 2 + 1               # 3×3/2 max pool
    s = s - 2                          # 1×1 VALID, 3×3 VALID
    s = (s - 3) // 2 + 1               # 3×3/2 max pool; the 35×35 blocks
    return (s - 3) // 2 + 1            # ReductionA


class InceptionV3(nn.Module):
    """Inception V3 over NHWC inputs: ``forward(x, train=True,
    generator=None)`` -> f32 logits, or ``(logits, aux)`` with
    ``aux_logits`` when training.  ``dropout_rate`` (0 by default) drops
    the pooled features before the head, its mask from ``generator``."""

    def __init__(self, num_classes: int = 1000, dtype=torch.bfloat16,
                 aux_logits: bool = False, dropout_rate: float = 0.0,
                 image_size: int = 299, process_group=None, device=None):
        super().__init__()
        device = resolve_device(device)
        self.dtype, self.dropout_rate = dtype, dropout_rate
        mk = functools.partial(ConvBNReLU, dtype=dtype,
                               process_group=process_group, device=device)
        self.stem = nn.ModuleList([
            mk(3, 32, (3, 3), (2, 2), "VALID"), mk(32, 32, (3, 3),
                                                   padding="VALID"),
            mk(32, 64, (3, 3)), mk(64, 80, (1, 1), padding="VALID"),
            mk(80, 192, (3, 3), padding="VALID")])
        blocks, ch = [], 192
        for pool_features in (32, 64, 64):
            blocks.append(InceptionA(ch, pool_features, mk))
            ch = blocks[-1].out_ch
        blocks.append(ReductionA(ch, mk))
        ch = blocks[-1].out_ch
        for c7 in (128, 160, 160, 192):
            blocks.append(InceptionC(ch, c7, mk))
            ch = blocks[-1].out_ch
        self.aux_at = len(blocks)    # the aux head reads this grid
        self.aux = self.aux_head = None
        if aux_logits:
            g = grid_17(image_size)
            if g < AUX_POOL:
                raise ValueError(f"image_size {image_size}: the 17x17 grid "
                                 f"is {g}x{g}, below the aux head's "
                                 f"{AUX_POOL}x{AUX_POOL} pool")
            k = (g - AUX_POOL) // AUX_STRIDE + 1
            self.aux = nn.ModuleList([mk(ch, 128, (1, 1)),
                                      mk(128, 768, (k, k), padding="VALID")])
            self.aux_head = nn.Linear(768, num_classes, device=device)
        blocks.append(ReductionB(ch, mk))
        ch = blocks[-1].out_ch
        for _ in range(2):
            blocks.append(InceptionE(ch, mk))
            ch = blocks[-1].out_ch
        self.blocks = nn.ModuleList(blocks)
        self.head = nn.Linear(ch, num_classes, device=device)

    def forward(self, x, train: bool = True, generator=None):
        x = x.to(self.dtype).permute(0, 3, 1, 2)   # NHWC -> channels_last
        for i, unit in enumerate(self.stem):
            x = unit(x, train)
            if i in (2, 4):
                x = F.max_pool2d(x, 3, 2)
        aux = None
        for i, block in enumerate(self.blocks):
            if i == self.aux_at and self.aux is not None and train:
                a = F.avg_pool2d(x, AUX_POOL, AUX_STRIDE)
                for unit in self.aux:
                    a = unit(a, train)
                aux = self.aux_head(a.mean(dim=(2, 3)).float())
            x = block(x, train)
        x = dropout(x.mean(dim=(2, 3)), self.dropout_rate, train, generator)
        x = self.head(x.float())
        return (x, aux) if aux is not None else x
