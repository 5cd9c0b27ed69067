"""``python -m horovod_tpu_torch.examples.mnist`` — MNIST data-parallel
training, the hello-world recipe; counterpart of ``examples/jax_mnist.py``.

The flow, in order: ``init`` → the data sharded by rank
(``data.ShardedBatches`` → ``BackgroundLoader`` → ``prefetch_to_device``)
→ ``DistributedOptimizer(SGD(scale_learning_rate(lr), momentum=0.9))`` →
``broadcast_parameters`` → every step ``faults.step(gstep)`` (so the
``HVD_TPU_FAULT_*`` scenarios replay) → a manifest-committed
``CheckpointManager`` each epoch, written by rank 0, with a SIGTERM drain
(``install_preemption_handler``) and resume from the newest complete
epoch → the accuracy summed over every rank → ``[rank r/n] final ...`` on
every rank.  The weights are seeded (``models/convert.init_state``), and
the data is the JAX example's synthetic stand-in.

Run:  python -m horovod_tpu_torch.examples.mnist [--device cpu]
"""

from __future__ import annotations

import argparse
import time

import torch
import torch.nn.functional as F

import horovod_tpu_torch as hvd
from horovod_tpu_torch import basics, checkpoint, data, faults
from horovod_tpu_torch.examples._common import (add_device, scratch_dir,
                                                synthetic_mnist)
from horovod_tpu_torch.models.convert import init_state
from horovod_tpu_torch.models.mnist import MnistCNN

SEED = 42


def make_model(device, seed: int = SEED) -> MnistCNN:
    """``MnistCNN`` with seeded weights (the same on every rank)."""
    model = MnistCNN(device=device)
    model.load_state_dict(init_state(model, seed))
    return model


def make_optimizer(model, lr: float):
    """The recipe's optimizer: SGD at the linearly scaled rate with
    momentum 0.9 (PyTorch's first momentum buffer is the gradient itself,
    as optax's ``sgd(momentum=0.9)`` trace is)."""
    return hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=hvd.scale_learning_rate(lr),
                        momentum=0.9),
        named_parameters=model.named_parameters())


def train_step(model, opt, x, y) -> torch.Tensor:
    """One step: softmax cross entropy, backward, averaged update."""
    opt.zero_grad(set_to_none=True)
    loss = F.cross_entropy(model(x), y.long())
    loss.backward()
    opt.step()
    return loss.detach()


@torch.no_grad()
def correct(model, x, y) -> torch.Tensor:
    return (model(x, train=False).argmax(-1) == y.long()).sum()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m horovod_tpu_torch.examples"
                                 ".mnist")
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--batch-size", type=int, default=64,
                    help="per-card batch size")
    ap.add_argument("--lr", type=float, default=0.001)
    ap.add_argument("--ckpt-dir", default=scratch_dir("hvd_torch_mnist"))
    ap.add_argument("--num-samples", type=int, default=4096,
                    help="rows of the synthetic dataset (the JAX twin's "
                    "4096)")
    add_device(ap)
    args = ap.parse_args(argv)

    hvd.init(device=args.device)
    dev = basics.device()
    model = make_model(dev)
    opt = make_optimizer(model, args.lr)
    hvd.broadcast_parameters(model, root_rank=0)
    global_batch = args.batch_size * hvd.num_chips()

    x_all, y_all = synthetic_mnist(args.num_samples)
    batches = data.ShardedBatches(x_all, y_all,
                                  batch_per_chip=args.batch_size,
                                  shuffle=True)
    if len(batches) == 0:
        raise SystemExit(
            f"per-process shard is smaller than the global batch "
            f"({global_batch}); lower --batch-size or add data.")

    manager = checkpoint.CheckpointManager(args.ckpt_dir)
    checkpoint.install_preemption_handler()
    start_epoch, gstep = 0, 0
    ckpt = manager.restore_latest()
    if ckpt is not None:
        model.load_state_dict(ckpt.state["model"])
        opt.load_state_dict(ckpt.state["opt"])
        start_epoch = int(ckpt.metadata.get("completed_epoch", -1)) + 1
        gstep = ckpt.step + 1
        if hvd.rank() == 0:
            print(f"resumed from epoch {start_epoch - 1}", flush=True)

    def state():
        return {"model": model.state_dict(), "opt": opt.state_dict()}

    loss, acc = None, float("nan")
    for epoch in range(start_epoch, args.epochs):
        t0 = time.time()
        loss = None
        for xb, yb in data.prefetch_to_device(
                data.BackgroundLoader(batches), device=dev):
            faults.step(gstep)
            if checkpoint.preemption_requested():
                # Drain: one complete checkpoint, then a clean exit the
                # launcher recognizes (the epoch in progress is repeated).
                manager.save(gstep, state(),
                             metadata={"completed_epoch": epoch - 1})
                manager.drain()
                raise SystemExit(0)
            loss = train_step(model, opt, xb, yb)
            gstep += 1
        manager.save(gstep, state(), metadata={"completed_epoch": epoch})
        hits = sum(correct(model, torch.as_tensor(xb, device=dev),
                           torch.as_tensor(yb, device=dev))
                   for xb, yb in batches)
        hits = hvd.allreduce(torch.as_tensor(hits, device=dev).float(),
                             average=False)
        acc = float(hits) / (len(batches) * global_batch)
        if hvd.rank() == 0:
            print(f"epoch {epoch}: loss={float(loss):.4f} acc={acc:.3f} "
                  f"({time.time() - t0:.1f}s)", flush=True)

    # Every rank reports the globally averaged final metric (identical by
    # construction; the launcher tests compare them).
    final_loss = float(hvd.allreduce(torch.tensor(
        0.0 if loss is None else float(loss), device=dev)))
    print(f"[rank {hvd.rank()}/{hvd.size()}] final loss={final_loss:.6f} "
          f"acc={acc:.4f}", flush=True)
    manager.drain()
    if hvd.rank() == 0:
        print("done; checkpoint written to", args.ckpt_dir, flush=True)
    hvd.shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
