"""``python -m horovod_tpu_torch.train_synthetic`` — img/s of the
reference's benchmark CNNs on synthetic data, with a fusion-threshold
sweep; one process per card.

Counterpart of ``examples/jax_synthetic_benchmark.py`` (itself the analog
of the reference's ``pytorch_synthetic_benchmark.py``): ``init()`` → the
``--model`` (ResNet50/101/152, VGG16/19 or InceptionV3; 1000 classes, bf16
compute over f32 parameters, seeded random weights broadcast from rank 0,
dropout 0, channels-last memory) at its canonical resolution (299 for
Inception V3, else 224; ``--image-size``) → one fixed synthetic batch of
``--batch-size`` images and labels a card → softmax cross entropy →
backward → ``DistributedOptimizer(SGD(0.01, momentum=0.9),
compression=--compression)``.  ``--num-warmup-batches`` steps, then
``--num-iters`` timed windows of ``--num-batches-per-iter`` steps, each
ending in a host fetch of the loss; img/s mean ± 1.96σ a card and in
total.  ``--sweep`` runs it again at each ``HOROVOD_FUSION_THRESHOLD`` of
1, 8, 64 and 256 MiB, a fresh model and optimizer each.  ``--profile DIR``
traces one more step after the warm-up (``horovod_tpu_torch.profiling``,
rank 0).  ``--device cpu`` runs it on the CPU (gloo).  The JAX example's
``--steps-per-call`` (its ``lax.scan`` of several steps in one dispatched
program) has no counterpart.

Each run prints the JAX example's two img/s lines and one JSON line:
the rates, step time, the losses, ``overlap_plan()``, the fusion buckets
a step's allreduce packs at the run's threshold, peak device memory, and
the card's name and power limit.

A model whose ``forward`` returns ``(logits, aux)`` (Inception V3 with
``aux_logits=True``) trains on ``CE(logits) + 0.4·CE(aux)``, the slim
recipe the reference's Inception numbers come from.  The helpers here are
shared with ``train_resnet``, the ResNet-50 protocol of ``bench.py``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

import numpy as np
import torch

from horovod_tpu_torch import basics
from horovod_tpu_torch.models import inception, resnet, vgg
from horovod_tpu_torch.models.convert import init_state
from horovod_tpu_torch.ops.compression import Compression
from horovod_tpu_torch.ops.losses import softmax_cross_entropy
from horovod_tpu_torch.ops.schedule_plan import overlap_plan
from horovod_tpu_torch.training import (DistributedOptimizer,
                                        broadcast_parameters)
from horovod_tpu_torch.utils import env, profiling

MODELS = {"ResNet50": resnet.ResNet50, "ResNet101": resnet.ResNet101,
          "ResNet152": resnet.ResNet152, "VGG16": vgg.VGG16,
          "VGG19": vgg.VGG19, "InceptionV3": inception.InceptionV3}
IMAGE = 224
IMAGE_SIZE = {"InceptionV3": 299}   # tf_cnn_benchmarks' resolutions
NUM_CLASSES = 1000
LR = 0.01
MOMENTUM = 0.9
SEED = 0
AUX_WEIGHT = 0.4
SWEEP_MIB = (1, 8, 64, 256)
COMPRESSIONS = ("none", "fp16", "bf16", "int8")


def image_size(model: str, size: int | None = None) -> int:
    """``size``, or the model's canonical resolution."""
    return size or IMAGE_SIZE.get(model, IMAGE)


def build_model(name: str, device, dtype=torch.bfloat16,
                size: int | None = None, **model_kw):
    """The ``MODELS[name]`` of 1000 classes (unless ``model_kw`` says) in
    ``dtype``; VGG and Inception sized for ``size`` and without dropout
    (the JAX example's synthetic runs)."""
    kw = {"num_classes": NUM_CLASSES, **model_kw}
    if not name.startswith("ResNet"):
        kw.setdefault("image_size", image_size(name, size))
        kw.setdefault("dropout_rate", 0.0)
    return MODELS[name](dtype=dtype, device=device, **kw)


def make_trainer(device, seed: int = SEED, dtype=torch.bfloat16,
                 model: str = "ResNet50", compression=Compression.none,
                 size: int | None = None, **model_kw):
    """The model (:func:`build_model`) with seeded weights, broadcast from
    rank 0, in channels-last memory, and its distributed SGD.  Needs
    :func:`basics.init`."""
    net = build_model(model, device, dtype, size, **model_kw)
    net.load_state_dict(init_state(net, seed))
    net = net.to(memory_format=torch.channels_last)
    broadcast_parameters(net, root_rank=0)
    opt = DistributedOptimizer(
        torch.optim.SGD(net.parameters(), lr=LR, momentum=MOMENTUM),
        named_parameters=net.named_parameters(), compression=compression)
    return net, opt


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
    with profiling.span("train.forward"):
        out = model(x, train=True)
        if isinstance(out, tuple):
            logits, aux = out
            loss = softmax_cross_entropy(logits, y).mean() \
                + AUX_WEIGHT * softmax_cross_entropy(aux, y).mean()
        else:
            loss = softmax_cross_entropy(out, y).mean()
    with profiling.span("train.backward"):
        loss.backward()
    with profiling.span("train.optimizer"):
        opt.step()
    return loss.detach()


def card(device=None) -> str | None:
    """``nvidia-smi``'s name and power limit of ``device`` (default: this
    process's card, after :func:`basics.init`); None off the card."""
    if device is None:
        index = basics.local_rank()
    elif torch.device(device).type != "cuda":
        return None
    else:
        index = torch.device(device).index or 0
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--id={index}",
             "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    return out.strip() or None


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m horovod_tpu_torch.train_synthetic",
        description="img/s of a benchmark CNN on synthetic data.")
    ap.add_argument("--model", default="ResNet50", choices=sorted(MODELS))
    ap.add_argument("--image-size", type=int, default=None,
                    help="input resolution (default: canonical per model)")
    ap.add_argument("--batch-size", type=int, default=32,
                    help="images a card a step")
    ap.add_argument("--num-warmup-batches", type=int, default=10)
    ap.add_argument("--num-iters", type=int, default=10)
    ap.add_argument("--num-batches-per-iter", type=int, default=10)
    ap.add_argument("--sweep", action="store_true",
                    help="run at each HOROVOD_FUSION_THRESHOLD of "
                         f"{'/'.join(map(str, SWEEP_MIB))} MiB")
    ap.add_argument("--compression", default="none", choices=COMPRESSIONS,
                    help="gradient wire compression")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="trace one step after the warm-up into DIR "
                         "(rank 0; horovod_tpu_torch.profiling.trace)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    return ap.parse_args(argv)


def run(args, threshold: int | None = None, **model_kw) -> dict:
    """Train and time as the JAX example does, at fusion threshold
    ``threshold`` (bytes; None keeps the environment's); prints its img/s
    lines on rank 0 and returns the JSON line's fields.  ``model_kw``
    reaches the model's constructor.  Needs :func:`basics.init`."""
    if threshold is not None:
        os.environ["HOROVOD_FUSION_THRESHOLD"] = str(threshold)
    dev = basics.device()
    cuda = dev.type == "cuda"
    if cuda:
        torch.backends.cudnn.benchmark = True
    size = image_size(args.model, args.image_size)
    model, opt = make_trainer(dev, model=args.model, size=size,
                              compression=getattr(Compression,
                                                  args.compression),
                              **model_kw)
    x, y = synthetic_batch(args.batch_size, dev, size,
                           model_kw.get("num_classes", NUM_CLASSES))
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    losses = [float(train_step(model, opt, x, y))
              for _ in range(args.num_warmup_batches)]
    if args.profile:
        with profiling.trace(args.profile):
            with profiling.span("train_step"):
                losses.append(float(train_step(model, opt, x, y)))
    rates = []
    for _ in range(args.num_iters):
        t0 = time.perf_counter()
        for _ in range(args.num_batches_per_iter):
            loss = train_step(model, opt, x, y)
        losses.append(float(loss))   # the host fetch ends the window
        rates.append(args.batch_size * basics.size()
                     * args.num_batches_per_iter / (time.perf_counter() - t0))
    mean, conf = float(np.mean(rates)), 1.96 * float(np.std(rates))
    n = basics.num_chips()
    if basics.rank() == 0:
        print(f"Img/sec per card: {mean / n:.1f} +-{conf / n:.1f}")
        print(f"Total img/sec on {n} card(s): {mean:.1f} +-{conf:.1f}",
              flush=True)
    return {
        "metric": "synthetic_train_throughput", "model": args.model,
        "image_size": size, "batch_per_card": args.batch_size,
        "processes": basics.size(),
        "params": sum(p.numel() for p in model.parameters()),
        "img_per_s_per_card": mean / n, "img_per_s_per_card_conf": conf / n,
        "img_per_s": mean, "img_per_s_conf": conf,
        "step_ms": args.batch_size * n / mean * 1e3, "losses": losses,
        "compression": args.compression,
        "fusion_threshold_bytes": env.fusion_threshold_bytes(),
        "fusion_buckets": opt.fusion_buckets(),
        "overlap_plan": overlap_plan(),
        "max_memory_allocated": torch.cuda.max_memory_allocated(dev)
        if cuda else None,
        "device": torch.cuda.get_device_name(dev) if cuda else str(dev),
        "nvidia_smi": card() if cuda else None}


def main(argv=None) -> int:
    args = parse_args(argv)
    basics.init(device=args.device)
    try:
        for mib in SWEEP_MIB if args.sweep else (None,):
            out = run(args, None if mib is None else mib * 2**20)
            if basics.rank() == 0:
                if mib is not None:
                    print(f"fusion_threshold={mib}MiB -> "
                          f"{out['img_per_s']:.1f} img/s")
                print(json.dumps(out), flush=True)
    finally:
        basics.shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
