"""``python -m horovod_tpu_torch.examples.torch_mnist`` — MNIST through the
eager binding; counterpart of ``examples/torch_mnist.py``.

``import horovod_tpu_torch.torch as hvd``: the reference's
``pytorch_mnist.py`` model, the LR scaled by the size,
``DistributedOptimizer`` with gradient hooks on the native engine,
parameters and optimizer state broadcast before training, the data
sharded by rank.  With ``--ckpt-dir`` it also keeps the reference's
checkpoint contract: rank 0 writes ``epoch_<N>`` atomically each epoch,
and a restart agrees on the resume epoch through ``broadcast_object``
before rank 0's weights and momentum are broadcast.

Run:  python -m horovod_tpu_torch.examples.torch_mnist [--device cpu]
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch
import torch.nn.functional as F

import horovod_tpu_torch.torch as hvd
from horovod_tpu_torch import basics
from horovod_tpu_torch.examples._common import add_device


class Net(torch.nn.Module):
    """The reference ``pytorch_mnist.py`` model (NCHW)."""

    def __init__(self):
        super().__init__()
        self.conv1 = torch.nn.Conv2d(1, 10, kernel_size=5)
        self.conv2 = torch.nn.Conv2d(10, 20, kernel_size=5)
        self.conv2_drop = torch.nn.Dropout2d()
        self.fc1 = torch.nn.Linear(320, 50)
        self.fc2 = torch.nn.Linear(50, 10)

    def forward(self, x):
        x = F.relu(F.max_pool2d(self.conv1(x), 2))
        x = F.relu(F.max_pool2d(self.conv2_drop(self.conv2(x)), 2))
        x = x.view(-1, 320)
        x = F.relu(self.fc1(x))
        x = F.dropout(x, training=self.training)
        return F.log_softmax(self.fc2(x), dim=1)


def train_step(model, optimizer, x, y) -> torch.Tensor:
    optimizer.zero_grad()
    loss = F.nll_loss(model(x), y)
    loss.backward()
    optimizer.step()
    return loss.detach()


def latest_epoch(ckpt_dir: str) -> int:
    """The newest ``epoch_<N>`` under ``ckpt_dir``, or -1."""
    epoch = -1
    if os.path.isdir(ckpt_dir):
        for entry in os.listdir(ckpt_dir):
            if entry.startswith("epoch_"):
                try:
                    epoch = max(epoch, int(entry.split("_", 1)[1]))
                except ValueError:
                    pass   # a stray or partial file does not stop startup
    return epoch


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m horovod_tpu_torch.examples"
                                 ".torch_mnist")
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--lr", type=float, default=0.01)
    ap.add_argument("--ckpt-dir", default=None,
                    help="enable per-epoch checkpoint + resume")
    add_device(ap)
    args = ap.parse_args(argv)

    hvd.init(device=args.device)
    dev = basics.device()
    torch.manual_seed(42 + hvd.rank())

    model = Net().to(dev)
    optimizer = torch.optim.SGD(model.parameters(),
                                lr=args.lr * hvd.size(), momentum=0.5)
    optimizer = hvd.DistributedOptimizer(
        optimizer, named_parameters=model.named_parameters())

    resume_epoch = -1
    if args.ckpt_dir:
        if hvd.rank() == 0:
            resume_epoch = latest_epoch(args.ckpt_dir)
        # Rank 0 reads the filesystem; the epoch travels by broadcast so
        # every worker agrees, then the weights are broadcast below.
        resume_epoch = hvd.broadcast_object(resume_epoch, root_rank=0)
        if resume_epoch >= 0 and hvd.rank() == 0:
            ck = torch.load(os.path.join(args.ckpt_dir,
                                         f"epoch_{resume_epoch}"),
                            map_location=dev, weights_only=True)
            model.load_state_dict(ck["model"])
            optimizer.load_state_dict(ck["optimizer"])
            print(f"resumed from epoch {resume_epoch}", flush=True)

    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    # Momentum resumes too, or the trajectory leaves the uninterrupted one.
    hvd.broadcast_optimizer_state(optimizer, root_rank=0)

    # Synthetic MNIST-shaped data, sharded by rank.
    rng = np.random.RandomState(0)
    x = torch.tensor(rng.rand(2048, 1, 28, 28), dtype=torch.float32)
    y = torch.tensor((rng.rand(2048) * 10).astype(np.int64))
    x = x[hvd.rank()::hvd.size()].to(dev)
    y = y[hvd.rank()::hvd.size()].to(dev)

    model.train()
    loss = None
    for epoch in range(resume_epoch + 1, args.epochs):
        perm = torch.randperm(len(x)).to(dev)
        loss = None
        for lo in range(0, len(x) - args.batch_size, args.batch_size):
            idx = perm[lo:lo + args.batch_size]
            loss = train_step(model, optimizer, x[idx], y[idx])
        if args.ckpt_dir and hvd.rank() == 0:
            # Rank 0 writes, atomically: a crash mid-save leaves no
            # truncated file for the resume scan to pick up.
            os.makedirs(args.ckpt_dir, exist_ok=True)
            final = os.path.join(args.ckpt_dir, f"epoch_{epoch}")
            torch.save({"model": model.state_dict(),
                        "optimizer": optimizer.state_dict(),
                        "epoch": epoch}, final + ".tmp")
            os.replace(final + ".tmp", final)
        if hvd.rank() == 0:
            print(f"epoch {epoch}: loss={float(loss):.4f}", flush=True)

    final = hvd.allreduce(loss if loss is not None
                          else torch.zeros((), device=dev), average=True,
                          name="final_loss")
    print(f"[rank {hvd.rank()}/{hvd.size()}] final loss={float(final):.6f}",
          flush=True)
    hvd.shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
