"""``python -m horovod_tpu_torch.examples.imagenet_resnet50`` — the ImageNet
ResNet-50 recipe on synthetic data; counterpart of
``examples/jax_imagenet_resnet50.py``.

ResNet-50 at 224², bf16 compute over f32 parameters, seeded weights;
per-process synthetic batches (a ``RandomState`` seeded by the rank, made
on the loader thread, copied to the card under the step); SGD with
Nesterov momentum 0.9 and weight decay; LR = base × ``num_chips()``,
reached by a linear warmup over ``--warmup-epochs`` and cut ×0.1 at epochs
30, 60 and 80 (the reference recipe's ``adjust_learning_rate``; the JAX
twin's ``floor(epoch / 30)`` cuts at 90 instead of 80); gradients averaged
on a bf16 wire (``Compression.bf16``).  Checkpoints follow the
reference's contract: rank 0 writes ``epoch_<N>`` in the background
(``checkpoint.save_epoch``), and a restart broadcasts rank 0's resume
epoch (``resume_epoch``), restores it (``restore_epoch``) and broadcasts
the weights.

Run:  python -m horovod_tpu_torch.examples.imagenet_resnet50 [--device cpu]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch import basics, checkpoint, data
from horovod_tpu_torch.examples._common import add_device, scratch_dir
from horovod_tpu_torch.models.convert import init_state
from horovod_tpu_torch.train_synthetic import build_model, train_step

DECAY_EPOCHS = (30, 60, 80)


def learning_rate(step: int, steps_per_epoch: int, base_lr: float,
                  warmup_epochs: float, size: int) -> float:
    """Linear scaling, gradual warmup and the staircase decay."""
    epoch = step / steps_per_epoch
    if epoch < warmup_epochs:
        warm = base_lr * (1.0 + epoch / warmup_epochs * (size - 1))
        return min(warm, base_lr * size)
    return base_lr * size * 0.1 ** sum(epoch >= e for e in DECAY_EPOCHS)


def make_trainer(device, base_lr: float, wd: float, seed: int = 0):
    """ResNet-50 (bf16 compute, f32 parameters, seeded weights, channels
    last) and its distributed SGD on the bf16 wire."""
    model = build_model("ResNet50", device)
    model.load_state_dict(init_state(model, seed))
    model = model.to(memory_format=torch.channels_last)
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=base_lr, momentum=0.9,
                        nesterov=True, weight_decay=wd),
        named_parameters=model.named_parameters(),
        compression=hvd.Compression.bf16)
    return model, opt


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m horovod_tpu_torch.examples"
                                 ".imagenet_resnet50")
    ap.add_argument("--epochs", type=int, default=90)
    ap.add_argument("--steps-per-epoch", type=int, default=10)
    ap.add_argument("--batch-size", type=int, default=32,
                    help="per-card batch size")
    ap.add_argument("--base-lr", type=float, default=0.0125)
    ap.add_argument("--warmup-epochs", type=float, default=5)
    ap.add_argument("--wd", type=float, default=5e-5)
    ap.add_argument("--ckpt-dir", default=scratch_dir("hvd_torch_resnet50"))
    ap.add_argument("--synthetic", action="store_true", default=True)
    add_device(ap)
    args = ap.parse_args(argv)

    hvd.init(device=args.device)
    dev = basics.device()
    if dev.type == "cuda":
        torch.backends.cudnn.benchmark = True
    model, opt = make_trainer(dev, args.base_lr, args.wd)

    # Resume: rank 0 lists the checkpoints, every rank takes its verdict
    # (-1 when fresh) and restores that epoch; the weights are broadcast
    # below either way.
    resume = checkpoint.resume_epoch(args.ckpt_dir)
    if resume >= 0:
        model.load_state_dict(checkpoint.restore_epoch(args.ckpt_dir,
                                                       resume))
        if hvd.rank() == 0:
            print(f"resumed from epoch {resume}", flush=True)
    hvd.broadcast_parameters(model, root_rank=0)

    size, spe, batch = hvd.num_chips(), args.steps_per_epoch, \
        args.batch_size
    rng = np.random.RandomState(hvd.rank())

    def synthetic_batches():
        # Stand-in for a decode/augment pipeline: made on the loader
        # thread, copied to the card under the step.
        for _ in range(spe):
            yield (rng.rand(batch, 224, 224, 3).astype(np.float32),
                   rng.randint(0, 1000, batch).astype(np.int64))

    loss = None
    for epoch in range(resume + 1, args.epochs):
        t0 = time.time()
        for i, (x, y) in enumerate(data.prefetch_to_device(
                data.BackgroundLoader(synthetic_batches()), device=dev)):
            lr = learning_rate(epoch * spe + i, spe, args.base_lr,
                               args.warmup_epochs, size)
            for group in opt.param_groups:
                group["lr"] = lr
            loss = train_step(model, opt, x, y)
        loss_value = float(loss)   # waits for the epoch's last step
        dt = time.time() - t0
        if hvd.rank() == 0:
            print(f"epoch {epoch}: loss={loss_value:.3f} "
                  f"{spe * batch * size / dt:.1f} img/s", flush=True)
        # In the background: the next epoch's steps overlap the write.
        checkpoint.save_epoch(args.ckpt_dir, epoch, model.state_dict(),
                              background=True)
    checkpoint.wait_pending()

    if loss is not None:
        final = float(hvd.allreduce(loss.float(), average=True))
        print(f"[rank {hvd.rank()}/{hvd.size()}] final loss={final:.6f}",
              flush=True)
    hvd.shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
