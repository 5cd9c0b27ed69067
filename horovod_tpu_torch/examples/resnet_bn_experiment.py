"""``python -m horovod_tpu_torch.examples.resnet_bn_experiment`` — what do
BatchNorm's statistics cost the ResNet-50 step?  Counterpart of
``examples/resnet_bn_experiment.py``.

The same full training step (forward, backward, ``DistributedOptimizer``
SGD with momentum) runs twice from the same seeded start:

* ``stats``: training BatchNorm (``train=True``): each batch's mean and
  variance, the running averages' update, and the statistics' terms in
  the backward;
* ``nostats``: BatchNorm normalizing with the running averages inside the
  gradient step (``train=False``): the same convolutions, activations,
  residuals and optimizer, only the statistics are gone.

Each leg reports its step ms and img/s (``--iters`` windows of
``--batches-per-iter`` × ``--steps-per-call`` steps, each window ending in
a synchronize; the JAX twin's ``lax.scan`` of ``--steps-per-call`` steps a
dispatch has no counterpart, the steps run one by one) and, on the card,
its device ms by kind of kernel from ``utils/trace.measure`` (batch norm,
convolution, matmul, other) with the busy ms and idle share.  One JSON
line, with the card's ``nvidia-smi`` name and power limit.

Run:  python -m horovod_tpu_torch.examples.resnet_bn_experiment
"""

from __future__ import annotations

import argparse
import json
import tempfile
import time

import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch import basics
from horovod_tpu_torch.examples._common import add_device
from horovod_tpu_torch.models.convert import init_state
from horovod_tpu_torch.ops.losses import softmax_cross_entropy
from horovod_tpu_torch.train_synthetic import build_model, card

LR, MOMENTUM = 0.01, 0.9


def make_trainer(device, dtype=torch.bfloat16, seed: int = 0, state=None):
    """ResNet-50 (1000 classes, channels last) with ``state`` or seeded
    weights, and its distributed SGD; both legs start from this."""
    model = build_model("ResNet50", device, dtype)
    model.load_state_dict(init_state(model, seed) if state is None
                          else state)
    model = model.to(memory_format=torch.channels_last)
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=LR, momentum=MOMENTUM),
        named_parameters=model.named_parameters())
    return model, opt


def bn_step(model, opt, x, y, stats: bool) -> torch.Tensor:
    """One step; ``stats=False`` normalizes with the running averages."""
    opt.zero_grad(set_to_none=True)
    loss = softmax_cross_entropy(model(x, train=stats), y).mean()
    loss.backward()
    opt.step()
    return loss.detach()


def leg(stats: bool, x, y, args, trace_dir: str, start) -> dict:
    dev = x.device
    model, opt = make_trainer(dev, getattr(torch, args.dtype), state=start)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def step():
        return bn_step(model, opt, x, y, stats)

    losses = [float(step()) for _ in range(args.warmup)]
    steps = args.batches_per_iter * args.steps_per_call
    rates = []
    for _ in range(args.iters):
        t0 = time.perf_counter()
        for _ in range(steps):
            loss = step()
        sync()
        rates.append(args.batch * steps / (time.perf_counter() - t0))
        losses.append(float(loss))
    img_s = sum(rates) / len(rates)
    out = {"img_s": img_s, "step_ms": args.batch / img_s * 1e3,
           "losses": losses}
    if dev.type == "cuda":
        from horovod_tpu_torch.utils import trace

        m = trace.measure("stats" if stats else "nostats", step, 3,
                          trace_dir)
        out.update({k: m[k] for k in ("device_busy_ms", "device_idle_share",
                                      "device_ms_by_kind",
                                      "kernels_per_call")})
    else:
        out["device_ms_by_kind"] = "not measured"
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m horovod_tpu_torch.examples"
                                 ".resnet_bn_experiment")
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--warmup", type=int, default=5)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--batches-per-iter", type=int, default=5)
    ap.add_argument("--steps-per-call", type=int, default=8)
    ap.add_argument("--image-size", type=int, default=224)
    ap.add_argument("--dtype", choices=("bfloat16", "float32"),
                    default="bfloat16", help="compute dtype")
    add_device(ap)
    args = ap.parse_args(argv)

    hvd.init(device=args.device)
    dev = basics.device()
    if dev.type == "cuda":
        torch.backends.cudnn.benchmark = True
    gen = torch.Generator(device=dev).manual_seed(basics.rank())
    x = torch.randn(args.batch, args.image_size, args.image_size, 3,
                    generator=gen, device=dev)
    y = torch.randint(0, 1000, (args.batch,), generator=gen, device=dev)
    # The seeded weights once, on the host: both legs load them.
    start = init_state(build_model("ResNet50", "cpu", torch.float32))
    with tempfile.TemporaryDirectory(prefix="hvd_bn_") as trace_dir:
        with_stats = leg(True, x, y, args, trace_dir, start)
        no_stats = leg(False, x, y, args, trace_dir, start)
    if hvd.rank() == 0:
        print(json.dumps({
            "metric": "resnet50_bn_stats_ab", "batch": args.batch,
            "image_size": args.image_size, "dtype": args.dtype,
            "stats": with_stats,
            "nostats": no_stats,
            "speedup": no_stats["img_s"] / with_stats["img_s"],
            "card": card()}), flush=True)
    hvd.shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
