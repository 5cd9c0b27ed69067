"""``python -m horovod_tpu_torch.train_resnet`` — ResNet-50 on synthetic
data, the ``BASELINE.json`` metric, one process per card.

Counterpart of the ResNet phase of ``bench.py`` (``resnet50_synthetic_
train_throughput``), under its protocol: ``init()`` → ResNet-50 v1.5
(1000 classes, bf16 compute over f32 parameters, seeded random weights,
``broadcast_parameters`` from rank 0) → one fixed synthetic batch of
``BENCH_BATCH`` (128) NHWC 224×224×3 images and labels per card, from a
seeded generator → softmax cross entropy → backward →
``DistributedOptimizer(SGD(lr=0.01, momentum=0.9))`` (PyTorch's SGD with
no dampening keeps optax's ``sgd(momentum=0.9)`` trace: the first buffer is
the gradient itself).  ``BENCH_WARMUP`` steps, then ``BENCH_ITERS`` timed
windows of ``BENCH_BATCHES_PER_ITER`` steps, each ending in a host fetch
of the loss.  The defaults (3, 3, 5) fit a smoke run; ``bench.py``'s are
10, 10, 10.  ``bench.py``'s ``lax.scan`` of several steps per dispatch has
no counterpart here.

``torch.backends.cudnn.benchmark`` is on: the batch never changes shape, so
cuDNN's choice of convolution algorithm is made once, in the warm-up.

It prints one JSON line: img/s per card and ``vs_baseline`` against the
reference Horovod's figure, the step time, peak device memory, the
schedule planner's ``overlap_plan()`` for the step just timed (a
throughput figure cannot be read without the plan behind it), and the
card's name and power limit.
"""

from __future__ import annotations

import json
import os
import subprocess
import time

import numpy as np
import torch

from horovod_tpu_torch import basics
from horovod_tpu_torch.models.convert import init_state
from horovod_tpu_torch.models.resnet import ResNet50
from horovod_tpu_torch.ops.losses import softmax_cross_entropy
from horovod_tpu_torch.ops.schedule_plan import overlap_plan
from horovod_tpu_torch.training import (DistributedOptimizer,
                                        broadcast_parameters)

BASELINE_IMG_PER_SEC_PER_DEVICE = 1656.82 / 16  # reference docs/benchmarks.md:34-38
IMAGE = 224
NUM_CLASSES = 1000
LR = 0.01
MOMENTUM = 0.9
SEED = 0


def knob(name: str, default: int) -> int:
    return int(os.environ.get(name, default))


def make_trainer(device, seed: int = SEED, dtype=torch.bfloat16, **model_kw):
    """ResNet-50 (or the ResNet ``model_kw`` names) with seeded weights,
    broadcast from rank 0, in channels-last memory, and its distributed
    SGD.  Needs :func:`basics.init`."""
    kw = {"num_classes": NUM_CLASSES, **model_kw}
    model = ResNet50(dtype=dtype, device=device, **kw)
    model.load_state_dict(init_state(model, seed))
    model = model.to(memory_format=torch.channels_last)
    broadcast_parameters(model, root_rank=0)
    opt = DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=LR, momentum=MOMENTUM),
        named_parameters=model.named_parameters())
    return model, opt


def synthetic_batch(batch: int, device, image: int = IMAGE,
                    num_classes: int = NUM_CLASSES, seed: int = SEED):
    """This card's fixed batch: ``[batch, image, image, 3]`` f32 images
    N(0, 1) and integer labels, from a generator seeded by ``seed`` and the
    rank."""
    gen = torch.Generator(device=device).manual_seed(seed + basics.rank())
    x = torch.randn(batch, image, image, 3, generator=gen, device=device)
    y = torch.randint(0, num_classes, (batch,), generator=gen, device=device)
    return x, y


def train_step(model, opt, x, y) -> torch.Tensor:
    """One step: forward (batch statistics, running averages updated),
    backward, averaged gradients, SGD update.  Returns the loss (on the
    device; reading it waits for the step)."""
    opt.zero_grad(set_to_none=True)
    loss = softmax_cross_entropy(model(x, train=True), y).mean()
    loss.backward()
    opt.step()
    return loss.detach()


def card() -> str | None:
    """``nvidia-smi``'s name and power limit of this process's card."""
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--id={basics.local_rank()}",
             "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    return out.strip() or None


def run(batch: int, warmup: int, iters: int, batches_per_iter: int) -> dict:
    """Train and time as ``bench.py`` does; the metric line's fields.
    Needs :func:`basics.init` on the card."""
    torch.backends.cudnn.benchmark = True
    dev = basics.device()
    model, opt = make_trainer(dev)
    x, y = synthetic_batch(batch, dev)
    torch.cuda.reset_peak_memory_stats(dev)
    losses = [float(train_step(model, opt, x, y)) for _ in range(warmup)]
    rates = []
    for _ in range(iters):
        t0 = time.perf_counter()
        for _ in range(batches_per_iter):
            loss = train_step(model, opt, x, y)
        losses.append(float(loss))   # the host fetch ends the window
        dt = time.perf_counter() - t0
        rates.append(batch * basics.size() * batches_per_iter / dt)
    per_card = float(np.mean(rates)) / basics.num_chips()
    return {
        "metric": "resnet50_synthetic_train_throughput",
        "value": per_card, "unit": "img/s/gpu",
        "vs_baseline": per_card / BASELINE_IMG_PER_SEC_PER_DEVICE,
        "overlap_plan": overlap_plan(),
        "step_ms": batch / per_card * 1e3, "batch_per_card": batch,
        "processes": basics.size(), "losses": losses,
        "max_memory_allocated": torch.cuda.max_memory_allocated(dev),
        "device": torch.cuda.get_device_name(dev), "nvidia_smi": card()}


def main() -> int:
    basics.init()
    try:
        out = run(knob("BENCH_BATCH", 128), knob("BENCH_WARMUP", 3),
                  knob("BENCH_ITERS", 3), knob("BENCH_BATCHES_PER_ITER", 5))
        if basics.rank() == 0:
            print(json.dumps(out), flush=True)
    finally:
        basics.shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
