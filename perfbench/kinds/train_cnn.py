"""Kind ``train_cnn``: a CNN's synchronous training step on synthetic
images.

Set-up turns cuDNN's autotuning on (as the program's benchmarks do) and
builds one trainer: the program's ResNet with the seed's weights, in
channels-last memory, and ``DistributedOptimizer(SGD)``.  It draws a
pool of distinct batches of NHWC f32 images, N(0, 1), and labels from
the seed on the device, and drives the trainer through its first
``check_steps`` steps through the window's own call, the program's
``train_synthetic.train_step``; those steps tune and warm every shape.
The program's readings: each step's loss, each leaf's first gradient as
SGD's momentum buffer holds it after one step (less the weight decay's
part, ``weight_decay · w0``), and each leaf's change over the steps.
The same trainer then runs the window, cycling the pool.

``train_images_per_s`` is every image of every step over the window's
wall.  With ``--trace 1`` the same window runs untraced first, for the
images a second that ``mfu.cnn`` reads, and then a traced window of
``trace_seconds``; the model carries no hooks, and BatchNorm's work is
told from the trace by the op that launched it.  After the windows the
trainer is freed and the plain reference follows the checked steps.

Traffic parameters: ``batch``, ``pool``, ``check_steps``,
``trace_seconds``."""

from __future__ import annotations

import time

import torch

from perfbench import compare, counts, loop
from perfbench.harness import log
from perfbench.models import resnet

IMAGE_STREAM = 0x2545F491


def program_step():
    """The window's entry: the program's training step."""
    from horovod_tpu_torch.train_synthetic import train_step

    return train_step


def hparams(cfg: dict) -> dict:
    return cfg["optimizer"]


def make_trainer(cfg: dict, seed: int, device):
    from horovod_tpu_torch.training import DistributedOptimizer

    model = resnet.build(cfg, seed, device)
    hp = hparams(cfg)
    opt = DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=hp["lr"],
                        momentum=hp["momentum"],
                        weight_decay=hp["weight_decay"],
                        nesterov=hp["nesterov"]),
        named_parameters=model.named_parameters())
    return model, opt


def image_pool(cfg: dict, traffic: dict, seed: int, device, rank: int = 0):
    """``(images [pool, batch, H, W, C], labels [pool, batch])`` from the
    seed (and the rank), drawn on the device."""
    gen = torch.Generator(device=device).manual_seed(
        (seed * 4 + rank + IMAGE_STREAM) % 2 ** 63)
    size = cfg["image_size"]
    x = torch.randn(traffic["pool"], traffic["batch"], size, size,
                    cfg["in_channels"], generator=gen, device=device)
    y = torch.randint(0, cfg["num_classes"],
                      (traffic["pool"], traffic["batch"]), generator=gen,
                      device=device)
    return x, y


def weights(cfg, seed, device):
    def make():
        flat = resnet.init_flat(cfg, seed, device)
        return {n: t.clone() for n, t in resnet.iter_weights(cfg, flat)}
    return make


def program_readings(run, model, opt, images, labels, step) -> dict:
    cfg, traffic = run.cfg, run.traffic
    wd = hparams(cfg)["weight_decay"]
    names = [n for n, _ in model.named_parameters()]
    w0 = weights(cfg, run.seed, run.device)()
    sgd = opt._opt
    losses, grads = [], {}
    for i in range(traffic["check_steps"]):
        losses.append(float(step(model, opt, images[i], labels[i])))
        if i == 0:
            with torch.no_grad():
                for n, p in zip(names, model.parameters()):
                    buf = sgd.state.get(p, {}).get("momentum_buffer")
                    grads[n] = 0.0 if buf is None else \
                        float((buf - wd * w0[n]).norm())
    with torch.no_grad():
        change = {n: float((p - w0[n]).norm())
                  for n, p in zip(names, model.parameters())}
    return {"losses": losses, "grad_norms": grads, "change_norms": change}


def reference_readings(run, batches, quant=None, rows=None) -> dict:
    from perfbench.reference import resnet as ref

    ref.strict_f32()
    torch.backends.cudnn.benchmark = False
    return ref.train(run.cfg, hparams(run.cfg),
                     weights(run.cfg, run.seed, run.device), batches,
                     quant=quant, rows=rows)


def run(run) -> dict:
    from horovod_tpu_torch import basics

    basics.init(device=str(run.device))
    try:
        return _run(run, basics)
    finally:
        basics.shutdown()


def _run(run, basics) -> dict:
    cfg, traffic, dev = run.cfg, run.traffic, run.device
    if dev.type == "cuda":
        torch.backends.cudnn.benchmark = True
    step = program_step()
    model, opt = make_trainer(cfg, run.seed, dev)
    images, labels = image_pool(cfg, traffic, run.seed, dev, basics.rank())
    log("trainer built")
    prog = program_readings(run, model, opt, images, labels, step)
    log(f"checked steps: losses {prog['losses']}")
    k = traffic["check_steps"]
    checked = [(images[i].clone(), labels[i].clone()) for i in range(k)]
    per_step = traffic["batch"] * basics.size()
    size = traffic["pool"]
    loop.sync(dev)
    setup_s = time.perf_counter() - run.t0

    def steps_from(first):
        return lambda i: step(model, opt, images[(first + i) % size],
                              labels[(first + i) % size])

    n, wall, failed, _ = loop.window(steps_from(k), run.seconds, dev, False)
    log(f"window: {n} steps in {wall:.3f} s, {1e3 * wall / n:.2f} ms a step")
    attempted, window = n, None
    if run.trace:
        tn, _, tfailed, window = loop.window(
            steps_from(k + n), traffic["trace_seconds"], dev, True)
        attempted, failed = n + tn, failed + tfailed
        log(f"traced window: {tn} steps in {window.window_s:.3f} s, "
            f"{1e3 * window.window_s / tn:.2f} ms a step")
    peak = loop.peak_bytes(dev)
    del model, opt, images, labels
    loop.free(dev)
    ref = reference_readings(run, checked)
    log(f"reference: losses {ref['losses']}")
    result = {
        "attempted": attempted, "failed": failed, "peak_bytes": peak,
        "numbers": compare.training_numbers(prog, ref),
        "e2e": {"train_images_per_s": n * per_step / wall,
                "setup_s": setup_s},
        "window": window,
    }
    if window is not None:
        result["trace"] = {
            "family": "resnet", "phase": "train", "steps": tn,
            "window_s": window.window_s, "busy_s": window.busy_s,
            "events": window.events, "chips": basics.size(),
            "images_per_s": n * per_step / wall,
            "flops_per_image": counts.resnet_train_flops_per_image(
                cfg, cfg["image_size"])}
    return result
