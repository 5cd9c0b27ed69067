"""The bottleneck ResNet family (ResNet-50 v1.5): its leaves, its weights
made from a seed, and the program's model built from a configuration.

:func:`init_flat` draws every convolution and the head in one call of a
``torch.Generator`` on the device and scales each leaf by its own
standard deviation in one more; BatchNorm scales are one, biases zero,
and with the configuration's ``zero_init_residual`` each block's last
BatchNorm scale is zero (Goyal et al., arXiv:1706.02677, §5.1), so that
every block starts as the identity.  The program and the plain reference
take the same numbers."""

from __future__ import annotations

import math

import torch

CONV = "conv"
HEAD = "head"
ONES = "ones"
ZEROS = "zeros"
LAST = "last"       # a block's last BatchNorm scale


def leaves(cfg: dict) -> list[tuple[str, tuple[int, ...], str]]:
    """``(name, shape, kind)`` of every parameter, named as the program's
    ``ResNet`` names them; convolutions ``[out, in, kh, kw]``."""
    stem = cfg["stem_filters"]
    out = [("conv_init.weight", (stem, cfg["in_channels"], 7, 7), CONV),
           ("bn_init.scale", (stem,), ONES), ("bn_init.bias", (stem,), ZEROS)]
    in_ch, b = stem, 0
    for i, count in enumerate(cfg["stage_sizes"]):
        filters = stem * 2 ** i
        width = filters * cfg["expansion"]
        for j in range(count):
            stride = 2 if i > 0 and j == 0 else 1
            p = f"blocks.{b}."
            shapes = [(filters, in_ch, 1, 1), (filters, filters, 3, 3),
                      (width, filters, 1, 1)]
            for k, shape in enumerate(shapes):
                out.append((f"{p}convs.{k}.weight", shape, CONV))
            for k, shape in enumerate(shapes):
                out += [(f"{p}norms.{k}.scale", (shape[0],),
                         LAST if k == 2 else ONES),
                        (f"{p}norms.{k}.bias", (shape[0],), ZEROS)]
            if in_ch != width or stride != 1:
                out += [(f"{p}conv_proj.weight", (width, in_ch, 1, 1), CONV),
                        (f"{p}norm_proj.scale", (width,), ONES),
                        (f"{p}norm_proj.bias", (width,), ZEROS)]
            in_ch, b = width, b + 1
    out += [("head.weight", (cfg["num_classes"], in_ch), HEAD),
            ("head.bias", (cfg["num_classes"],), ZEROS)]
    return out


def blocks(cfg: dict) -> list[tuple[int, bool]]:
    """``(stride, has projection)`` of every block, in order."""
    out, in_ch = [], cfg["stem_filters"]
    for i, count in enumerate(cfg["stage_sizes"]):
        width = cfg["stem_filters"] * 2 ** i * cfg["expansion"]
        for j in range(count):
            stride = 2 if i > 0 and j == 0 else 1
            out.append((stride, in_ch != width or stride != 1))
            in_ch = width
    return out


def _std(shape, kind) -> float:
    if kind == CONV:        # He et al.'s normal, fan out
        return math.sqrt(2.0 / (shape[0] * shape[2] * shape[3]))
    return 0.01             # the head


def init_flat(cfg: dict, seed: int, device):
    """Every convolution and the head's weight, end to end in
    :func:`leaves`' order, as one flat f32 tensor from the seed."""
    drawn = [(s, k) for _, s, k in leaves(cfg) if k in (CONV, HEAD)]
    sizes = [math.prod(s) for s, _ in drawn]
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    std = torch.tensor([_std(s, k) for s, k in drawn], device=device)
    return flat.mul_(torch.repeat_interleave(
        std, torch.tensor(sizes, device=device)))


def iter_weights(cfg: dict, flat):
    off = 0
    for name, shape, kind in leaves(cfg):
        if kind in (CONV, HEAD):
            n = math.prod(shape)
            yield name, flat[off:off + n].view(shape)
            off += n
        elif kind == ONES or kind == LAST and not cfg["zero_init_residual"]:
            yield name, torch.ones(shape, device=flat.device)
        else:
            yield name, torch.zeros(shape, device=flat.device)


def build(cfg: dict, seed: int, device):
    """The program's ResNet (bf16 compute over f32 parameters) with the
    seed's weights, in channels-last memory."""
    from horovod_tpu_torch.models import resnet

    if cfg["block"] != "bottleneck" or cfg["stride_on"] != "3x3" or \
            cfg["batchnorm_eps"] != resnet.BN_EPS:
        raise ValueError("the program's ResNet is v1.5's bottleneck with "
                         f"BatchNorm eps {resnet.BN_EPS}")
    model = resnet.ResNet(stage_sizes=cfg["stage_sizes"],
                          block_cls=resnet.BottleneckBlock,
                          num_classes=cfg["num_classes"],
                          num_filters=cfg["stem_filters"],
                          dtype=torch.bfloat16,
                          in_channels=cfg["in_channels"], device=device)
    params = dict(model.named_parameters())
    names = [n for n, _, _ in leaves(cfg)]
    if sorted(names) != sorted(params):
        raise ValueError("the program's ResNet has other parameters than "
                         "the configuration's leaves")
    flat = init_flat(cfg, seed, device)
    with torch.no_grad():
        for name, w in iter_weights(cfg, flat):
            params[name].copy_(w)
    del flat
    return model.to(memory_format=torch.channels_last)
