"""Plain reference of the bottleneck ResNet family (ResNet-50 v1.5):
float32 PyTorch with TF32 off.

From He et al. (arXiv:1512.03385, Table 1, the 50-layer column) with
v1.5's change as NVIDIA's DeepLearningExamples describe it: the stride
of a down-sampling bottleneck is on its 3x3 convolution, not the first
1x1.  The stem is a 7x7/2 convolution, BatchNorm, ReLU and a 3x3/2 max
pool; each bottleneck is 1x1, 3x3, 1x1 convolutions each followed by
BatchNorm (ReLU after the first two), a projection (1x1 convolution and
BatchNorm) where the shape changes, the residual added and a ReLU; then
the spatial mean and a fully connected head with a bias.  BatchNorm in
training takes each channel's mean and biased variance over the batch.
The loss is the mean softmax cross entropy; the optimizer is
``torch.optim.SGD``.

Departures: convolutions and the max pool pad as XLA's "SAME" does, as
the configuration states (the odd pixel of a stride-2 window's pad on the
high side), where torchvision pads symmetrically; every block is
recomputed in the backward pass (``torch.utils.checkpoint``) so that the
reference fits on the card at the cell's batch, which changes no number.

``quant="fp8"`` is the check's control: every tensor that the program
holds in bf16 goes through float8 e4m3 instead (``reference/decoder.
fp8``, straight-through in the backward): the operands of every
convolution and of the head, and every BatchNorm's output and residual
sum; the step below the configuration's bf16.

Imports nothing of the program."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from perfbench.reference.decoder import _operands, strict_f32  # noqa: F401


def same_pads(size: int, kernel: int, stride: int) -> tuple[int, int]:
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def pad_same(x, kernel: int, stride: int, value: float = 0.0):
    h = same_pads(x.shape[2], kernel, stride)
    w = same_pads(x.shape[3], kernel, stride)
    return F.pad(x, (w[0], w[1], h[0], h[1]), value=value)


class ResNet:
    """The forward pass from weights ``w`` (``{name: f32 tensor}``, named
    as ``perfbench.models.resnet.leaves`` names them)."""

    def __init__(self, cfg: dict, w: dict, quant=None):
        from perfbench.models.resnet import blocks

        self.cfg, self.w, self.q = cfg, w, _operands(quant)
        self.blocks = blocks(cfg)
        self.eps = float(cfg["batchnorm_eps"])

    def conv(self, x, name, stride: int = 1):
        wt = self.w[name]
        return F.conv2d(self.q(pad_same(x, wt.shape[2], stride)),
                        self.q(wt), stride=stride)

    def bn(self, x, name):
        mean = x.mean(dim=(0, 2, 3), keepdim=True)
        var = ((x - mean) ** 2).mean(dim=(0, 2, 3), keepdim=True)
        scale = self.w[name + ".scale"].view(1, -1, 1, 1)
        bias = self.w[name + ".bias"].view(1, -1, 1, 1)
        return self.q((x - mean) * torch.rsqrt(var + self.eps) * scale
                      + bias)

    def block(self, x, b: int):
        stride, proj = self.blocks[b]
        p = f"blocks.{b}."
        y = F.relu(self.bn(self.conv(x, p + "convs.0.weight"),
                           p + "norms.0"))
        y = F.relu(self.bn(self.conv(y, p + "convs.1.weight", stride),
                           p + "norms.1"))
        y = self.bn(self.conv(y, p + "convs.2.weight"), p + "norms.2")
        if proj:
            x = self.bn(self.conv(x, p + "conv_proj.weight", stride),
                        p + "norm_proj")
        return F.relu(self.q(x + y))

    def __call__(self, images, recompute: bool = False):
        """Logits of NHWC ``images``."""
        x = images.permute(0, 3, 1, 2).contiguous()
        x = F.relu(self.bn(self.conv(x, "conv_init.weight", 2), "bn_init"))
        x = F.max_pool2d(pad_same(x, 3, 2, float("-inf")), 3, 2)
        for b in range(len(self.blocks)):
            if recompute:
                x = checkpoint(self.block, x, b, use_reentrant=False)
            else:
                x = self.block(x, b)
        feats = x.mean(dim=(2, 3))
        return self.q(feats) @ self.q(self.w["head.weight"]).t() + \
            self.w["head.bias"]


def train(cfg: dict, hp: dict, make_weights, batches, quant=None,
          rows=None) -> dict:
    """Follow the program's first ``len(batches)`` steps (``(images,
    labels)`` each) with SGD on f32 weights from ``make_weights()``;
    ``rows`` keeps only the first rows of each batch (a planted fault).
    Returns the losses, the first step's gradient norm of every leaf and
    every leaf's norm of change."""
    w = {n: t.requires_grad_(True) for n, t in make_weights().items()}
    opt = torch.optim.SGD(list(w.values()), lr=hp["lr"],
                          momentum=hp["momentum"],
                          weight_decay=hp["weight_decay"],
                          nesterov=hp["nesterov"], foreach=False)
    losses, grad_norms = [], {}
    for step, (x, y) in enumerate(batches):
        if rows is not None:
            x, y = x[:rows], y[:rows]
        opt.zero_grad(set_to_none=True)
        logits = ResNet(cfg, w, quant)(x, recompute=True)
        loss = F.cross_entropy(logits, y)
        loss.backward()
        losses.append(float(loss.detach()))
        del logits, loss
        if step == 0:
            grad_norms = {n: float(t.grad.norm()) for n, t in w.items()}
        opt.step()
    del opt
    w0 = make_weights()
    with torch.no_grad():
        change = {n: float((t - w0[n]).norm()) for n, t in w.items()}
    return {"losses": losses, "grad_norms": grad_norms,
            "change_norms": change}
