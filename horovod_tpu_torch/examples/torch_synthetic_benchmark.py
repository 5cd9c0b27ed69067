"""``python -m horovod_tpu_torch.examples.torch_synthetic_benchmark`` — the
reference's synthetic throughput protocol over the eager binding;
counterpart of ``examples/torch_synthetic_benchmark.py``.

Fixed fake data, a timed ``benchmark_step`` (forward, backward, optimizer
step under ``horovod_tpu_torch.torch.DistributedOptimizer``), warm-up
batches, then ``--num-iters`` windows of ``--num-batches-per-iter`` steps
with img/s per window, the mean ± 1.96σ per worker and the total over the
workers (reference ``pytorch_synthetic_benchmark.py``).  On the card each
window ends in ``torch.cuda.synchronize``, so it times the work, not its
launch.  ``--model convnet|mlp`` (the small in-file models of the JAX
twin; no torchvision), ``--fp16-allreduce`` sends the gradients on the
bf16 wire.

Run:  python -m horovod_tpu_torch.examples.torch_synthetic_benchmark
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch
import torch.nn.functional as F

import horovod_tpu_torch.torch as hvd
from horovod_tpu_torch import basics
from horovod_tpu_torch.examples._common import add_device


class ConvNet(torch.nn.Module):
    """Three strided convolutions and two dense layers: gradients of many
    shapes (the case fusion is for), cheap enough for the CPU."""

    def __init__(self, hidden: int = 64):
        super().__init__()
        self.conv1 = torch.nn.Conv2d(3, hidden, 3, stride=2, padding=1)
        self.conv2 = torch.nn.Conv2d(hidden, hidden, 3, stride=2, padding=1)
        self.conv3 = torch.nn.Conv2d(hidden, hidden, 3, stride=2, padding=1)
        self.fc1 = torch.nn.Linear(hidden * 4 * 4, 512)
        self.fc2 = torch.nn.Linear(512, 1000)

    def forward(self, x):
        x = F.relu(self.conv1(x))
        x = F.relu(self.conv2(x))
        x = F.relu(F.adaptive_avg_pool2d(self.conv3(x), 4))
        x = x.flatten(1)
        return self.fc2(F.relu(self.fc1(x)))


class MLP(torch.nn.Module):
    def __init__(self, hidden: int = 1024):
        super().__init__()
        self.net = torch.nn.Sequential(
            torch.nn.Flatten(),
            torch.nn.Linear(3 * 32 * 32, hidden), torch.nn.ReLU(),
            torch.nn.Linear(hidden, hidden), torch.nn.ReLU(),
            torch.nn.Linear(hidden, 1000))

    def forward(self, x):
        return self.net(x)


def benchmark_step(model, optimizer, data, target) -> None:
    optimizer.zero_grad()
    loss = F.cross_entropy(model(data), target)
    loss.backward()
    optimizer.step()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m horovod_tpu_torch.examples"
                                 ".torch_synthetic_benchmark")
    ap.add_argument("--model", choices=["convnet", "mlp"], default="convnet")
    ap.add_argument("--hidden", type=int, default=64)
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--image-size", type=int, default=32,
                    help="input H=W (the reference used 224)")
    ap.add_argument("--num-warmup-batches", type=int, default=4)
    ap.add_argument("--num-batches-per-iter", type=int, default=4)
    ap.add_argument("--num-iters", type=int, default=8)
    ap.add_argument("--fp16-allreduce", action="store_true",
                    help="bf16 wire (the reference's --fp16-allreduce)")
    add_device(ap)
    args = ap.parse_args(argv)

    hvd.init(device=args.device)
    dev = basics.device()
    torch.manual_seed(42)
    if dev.type == "cpu":
        torch.set_num_threads(max(torch.get_num_threads() // hvd.size(), 1))

    model = (ConvNet(args.hidden) if args.model == "convnet"
             else MLP(args.hidden)).to(dev)
    optimizer = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.01),
        named_parameters=model.named_parameters(),
        compression=(hvd.Compression.bf16 if args.fp16_allreduce
                     else hvd.Compression.none))
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    hvd.broadcast_optimizer_state(optimizer, root_rank=0)

    data = torch.randn(args.batch_size, 3, args.image_size, args.image_size,
                       device=dev)
    target = torch.randint(0, 1000, (args.batch_size,), device=dev)

    def window(steps: int) -> float:
        t0 = time.perf_counter()
        for _ in range(steps):
            benchmark_step(model, optimizer, data, target)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return time.perf_counter() - t0

    def log(s):
        if hvd.rank() == 0:
            print(s, flush=True)

    nparam = sum(p.numel() for p in model.parameters())
    log(f"Model: {args.model} ({nparam / 1e6:.1f}M params)")
    log(f"Batch size: {args.batch_size}  (image {args.image_size}px)")
    log(f"Number of workers: {hvd.size()}")
    log("Running warmup...")
    window(args.num_warmup_batches)
    log("Running benchmark...")
    img_secs = []
    for i in range(args.num_iters):
        img_sec = args.batch_size * args.num_batches_per_iter \
            / window(args.num_batches_per_iter)
        log(f"Iter #{i}: {img_sec:.1f} img/sec per worker")
        img_secs.append(img_sec)
    mean, conf = np.mean(img_secs), 1.96 * np.std(img_secs)
    log(f"Img/sec per worker: {mean:.1f} +-{conf:.1f}")
    log(f"Total img/sec on {hvd.size()} worker(s): "
        f"{hvd.size() * mean:.1f} +-{hvd.size() * conf:.1f}")
    hvd.shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
