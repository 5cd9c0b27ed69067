"""``python -m horovod_tpu_torch.examples.mnist_advanced`` — MNIST with the
full callback stack; counterpart of ``examples/jax_mnist_advanced.py``.

``horovod_tpu_torch.callbacks`` drives the loop as Keras would: broadcast
on train begin, the epoch-end metrics averaged over every rank, a gradual
learning-rate warmup from 1× to ``num_chips()``× over two epochs, then a
staircase decay (×0.1 every two epochs).  4 epochs of 8 steps at 32 images
a card, from the rolling window of the synthetic MNIST stand-in.

Run:  python -m horovod_tpu_torch.examples.mnist_advanced [--device cpu]
"""

from __future__ import annotations

import argparse
import types

import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch import basics, callbacks
from horovod_tpu_torch.examples._common import add_device, synthetic_mnist
from horovod_tpu_torch.examples.mnist import make_model, train_step

BASE_LR = 0.001
EPOCHS, STEPS_PER_EPOCH, BATCH = 4, 8, 32


def make_callbacks(base_lr: float = BASE_LR,
                   steps_per_epoch: int = STEPS_PER_EPOCH) -> list:
    return [
        callbacks.BroadcastGlobalVariablesCallback(0),
        callbacks.MetricAverageCallback(),
        callbacks.LearningRateWarmupCallback(
            base_lr, warmup_epochs=2, steps_per_epoch=steps_per_epoch,
            verbose=True),
        callbacks.LearningRateScheduleCallback(
            base_lr * hvd.num_chips(),
            multiplier=lambda e: 0.1 ** ((e - 2) // 2), start_epoch=2),
    ]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m horovod_tpu_torch.examples"
                                 ".mnist_advanced")
    add_device(ap)
    args = ap.parse_args(argv)

    hvd.init(device=args.device)
    dev = basics.device()
    model = make_model(dev, seed=0)
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=BASE_LR, momentum=0.9),
        named_parameters=model.named_parameters())
    state = types.SimpleNamespace(model=model, optimizer=opt)

    cbs = make_callbacks()
    lr_cbs = [c for c in cbs
              if isinstance(c, callbacks.LearningRateScheduleCallback)]
    gb = BATCH * hvd.num_chips()
    x_all, y_all = synthetic_mnist(max(2048, 4 * gb))
    x_all = torch.as_tensor(x_all, device=dev)
    y_all = torch.as_tensor(y_all, device=dev)
    # This card's rows of the global batch, as the JAX example's mesh
    # shards it.
    mine = slice(hvd.rank() * BATCH, (hvd.rank() + 1) * BATCH)

    state = callbacks.run_callbacks(cbs, "on_train_begin", state)
    loss, lr = None, BASE_LR
    for epoch in range(EPOCHS):
        for cb in cbs:
            state = cb.on_epoch_begin(epoch, state)
        for s in range(STEPS_PER_EPOCH):
            for cb in cbs:
                state = cb.on_batch_begin(s, state)
            lr = max((c.lr() for c in lr_cbs), default=BASE_LR)
            for group in opt.param_groups:
                group["lr"] = lr
            lo = (s * gb) % (len(x_all) - gb)
            xb, yb = x_all[lo:lo + gb][mine], y_all[lo:lo + gb][mine]
            loss = train_step(model, opt, xb, yb)
        logs = {"loss": float(loss)}
        for cb in cbs:
            state = cb.on_epoch_end(epoch, state, logs=logs)
        if hvd.rank() == 0:
            print(f"epoch {epoch}: {logs} lr={lr:.5f}", flush=True)

    final = float(hvd.allreduce(torch.tensor(float(loss), device=dev),
                                average=True))
    print(f"[rank {hvd.rank()}/{hvd.size()}] final loss={final:.6f}",
          flush=True)
    hvd.shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
