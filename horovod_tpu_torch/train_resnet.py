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

import functools
import json
import os
import time

import numpy as np
import torch

from horovod_tpu_torch import basics, train_synthetic
from horovod_tpu_torch.ops.schedule_plan import overlap_plan
from horovod_tpu_torch.train_synthetic import (  # noqa: F401
    IMAGE, LR, MOMENTUM, NUM_CLASSES, SEED, card, synthetic_batch,
    train_step)

BASELINE_IMG_PER_SEC_PER_DEVICE = 1656.82 / 16  # reference docs/benchmarks.md:34-38

# ResNet-50 (or the ResNet ``model_kw`` names) with seeded weights,
# broadcast from rank 0, in channels-last memory, and its distributed SGD
# (``train_synthetic.make_trainer``).  Needs :func:`basics.init`.
make_trainer = functools.partial(train_synthetic.make_trainer,
                                 model="ResNet50")


def knob(name: str, default: int) -> int:
    return int(os.environ.get(name, default))


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
