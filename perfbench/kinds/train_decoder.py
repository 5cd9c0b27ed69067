"""Kind ``train_decoder``: the decoder's synchronous training step.

Set-up builds one trainer, the program's ``Transformer`` with the seed's
weights and ``DistributedOptimizer(master_weights(AdamW))``, draws a pool
of distinct token batches from the seed on the device, and drives the
trainer through its first ``check_steps`` steps on the first batches of
the pool through the window's own call, the program's
``train_transformer.train_step``.  Those steps warm every shape.  The
program's readings for the check are taken from them: each step's loss,
the first gradient of each leaf as AdamW holds it after one step
(``exp_avg / (1 - beta1)``), and each leaf's change of its f32 master
copy over the steps.  The same trainer then runs the window, cycling
the pool.

``train_tokens_per_s`` is every token of every step over the window's
wall, from a synchronisation before the first step to one after the
last.  After the window the trainer is freed and the plain reference
follows the checked steps from the same weights and batches.

Traffic parameters: ``batch`` (rows a chip a step), ``seq_len``,
``pool`` (batches in the pool), ``check_steps``, ``trace_seconds`` (the
traced window's length, at most ``--seconds``)."""

from __future__ import annotations

import time

import torch

from perfbench import compare, counts, loop
from perfbench.harness import log
from perfbench.models import decoder

ATTENTION_SPAN = "perfbench.attention"
OPTIMIZER_SPAN = "perfbench.optimizer"
TOKEN_STREAM = 0x5DEECE66D


def program_step():
    """The window's entry: the program's training step."""
    from horovod_tpu_torch.train_transformer import train_step

    return train_step


def hparams(cfg: dict) -> dict:
    return cfg["training"]


def make_trainer(cfg: dict, seed: int, device, traced: bool):
    from horovod_tpu_torch.training import (DistributedOptimizer,
                                            master_weights)

    attn = None
    if traced:
        from horovod_tpu_torch.ops.flash_attention import \
            make_flash_attention

        attn = loop.spanned(make_flash_attention(), ATTENTION_SPAN)
    model = decoder.build(cfg, seed, device, train=True, attention_fn=attn)
    hp = hparams(cfg)
    inner = torch.optim.AdamW(model.parameters(), lr=hp["lr"],
                              betas=tuple(hp["betas"]), eps=hp["eps"],
                              weight_decay=hp["weight_decay"])
    opt = DistributedOptimizer(master_weights(inner),
                               named_parameters=model.named_parameters())
    if traced:
        opt.step = loop.spanned(opt.step, OPTIMIZER_SPAN)
    return model, opt


def token_pool(cfg: dict, traffic: dict, seed: int, device, rank: int = 0):
    """``[pool, batch, seq_len]`` token ids from the seed (and the rank),
    drawn on the device; every row differs."""
    gen = torch.Generator(device=device).manual_seed(
        (seed * 4 + rank + TOKEN_STREAM) % 2 ** 63)
    return torch.randint(0, cfg["vocab_size"],
                         (traffic["pool"], traffic["batch"],
                          traffic["seq_len"]),
                         generator=gen, device=device)


def inner_state(opt):
    """The AdamW that steps the f32 masters, and the masters."""
    mw = opt._opt
    return mw._inner, mw.masters()


def first_grad_norms(model, opt, beta1: float) -> dict:
    """Each leaf's first gradient as AdamW holds it after one step."""
    inner, masters = inner_state(opt)
    names = [n for n, _ in model.named_parameters()]
    out = {}
    for n, m in zip(names, masters):
        st = inner.state.get(m, {})
        avg = st.get("exp_avg")
        out[n] = 0.0 if avg is None else float(avg.norm()) / (1 - beta1)
    return out


def change_norms(cfg, model, opt, seed, device) -> dict:
    """Each leaf's change of its f32 master copy since the seed's
    weights."""
    _, masters = inner_state(opt)
    names = [n for n, _ in model.named_parameters()]
    flat = decoder.init_flat(cfg, seed, device)
    w0 = dict(decoder.iter_weights(cfg, flat))
    with torch.no_grad():
        out = {n: float((m - w0[n].float()).norm())
               for n, m in zip(names, masters)}
    del flat, w0
    return out


def reference_weights(cfg, seed, device):
    def make():
        flat = decoder.init_flat(cfg, seed, device)
        w = {n: t.float() for n, t in decoder.iter_weights(cfg, flat)}
        del flat
        return w
    return make


def program_readings(run, model, opt, pool, step) -> dict:
    """Drive the trainer through the checked steps; its readings."""
    cfg, traffic = run.cfg, run.traffic
    losses, grads = [], {}
    for i in range(traffic["check_steps"]):
        losses.append(float(step(model, opt, pool[i])))
        if i == 0:
            grads = first_grad_norms(model, opt,
                                     hparams(cfg)["betas"][0])
    return {"losses": losses, "grad_norms": grads,
            "change_norms": change_norms(cfg, model, opt, run.seed,
                                         run.device)}


def reference_readings(run, batches, quant=None, rows=None,
                       world: int = 1) -> dict:
    """The plain reference over ``batches``; with ``world`` > 1, this
    rank's rows of each global batch, the gradients summed across the
    ranks by ``torch.distributed`` (the reference's own exchange)."""
    from perfbench.reference import decoder as ref

    ref.strict_f32()
    allreduce = None
    if world > 1:
        import torch.distributed as dist

        def allreduce(t):
            dist.all_reduce(t)
    return ref.train(run.cfg, hparams(run.cfg),
                     reference_weights(run.cfg, run.seed, run.device),
                     batches, quant=quant, rows=rows, world=world,
                     allreduce=allreduce)


def run(run) -> dict:
    if run.chips > 1:
        from perfbench import ranks

        return ranks.launch(run, rank_main)
    return rank_main(run, 0, 1, None)


def rank_main(run, rank: int, world: int, init_method) -> dict:
    from horovod_tpu_torch import basics

    basics.init(device=str(run.device), rank=rank, size=world,
                init_method=init_method)
    try:
        return _run(run, basics)
    finally:
        basics.shutdown()


def _across(values, device, op="mean"):
    """``values`` (floats) reduced over the ranks: mean, max or gathered
    as a list of every rank's."""
    import torch.distributed as dist

    world = dist.get_world_size()
    t = torch.tensor(values, dtype=torch.float64, device=device)
    if op == "gather":
        out = [torch.empty_like(t) for _ in range(world)]
        dist.all_gather(out, t)
        return [o.tolist() for o in out]
    dist.all_reduce(t, op=dist.ReduceOp.MAX if op == "max"
                    else dist.ReduceOp.SUM)
    return (t / world if op == "mean" else t).tolist()


def _run(run, basics) -> dict:
    cfg, traffic, dev = run.cfg, run.traffic, run.device
    world = basics.size()
    step = program_step()
    model, opt = make_trainer(cfg, run.seed, dev, run.trace)
    pool = token_pool(cfg, traffic, run.seed, dev, basics.rank())
    log("trainer built")
    prog = program_readings(run, model, opt, pool, step)
    if world > 1:
        prog["losses"] = _across(prog["losses"], dev)
    log(f"checked steps: losses {prog['losses']}")
    checked = pool[:traffic["check_steps"]].clone()
    tokens_per_step = traffic["batch"] * traffic["seq_len"] * world
    seconds = min(run.seconds, traffic["trace_seconds"]) if run.trace \
        else run.seconds
    steps = None
    if world > 1:
        # Every rank runs the same number of steps: as many as rank 0's
        # timing of two more steps says fill the window.
        loop.sync(dev)
        t = time.perf_counter()
        for i in range(2):
            step(model, opt, pool[(traffic["check_steps"] + i)
                                  % traffic["pool"]])
        loop.sync(dev)
        per = (time.perf_counter() - t) / 2
        steps = int(_across([max(1.0, seconds / per)], dev, "max")[0])
    first, size = traffic["check_steps"], traffic["pool"]
    loop.sync(dev)
    setup_s = time.perf_counter() - run.t0
    n, wall, failed, window = loop.window(
        lambda i: step(model, opt, pool[(first + i) % size]), seconds, dev,
        run.trace, steps=steps)
    log(f"window: {n} steps in {wall:.3f} s")
    peak = loop.peak_bytes(dev)
    busy = window.busy_s if window is not None else 0.0
    if world > 1:
        wall, peak, failed = _across([wall, peak, failed], dev, "max")
        peak, failed = int(peak), int(failed)
        busy = _across([busy], dev)[0]
    del model, opt, pool
    loop.free(dev)
    ref = reference_readings(run, list(checked), world=world)
    log(f"reference: losses {ref['losses']}")
    result = {
        "attempted": n, "failed": failed, "peak_bytes": peak,
        "numbers": compare.training_numbers(prog, ref),
        "e2e": {"train_tokens_per_s": n * tokens_per_step / wall,
                "setup_s": setup_s},
        "window": window,
    }
    if window is not None:
        flops, nbytes = counts.attention_train_work(
            traffic["batch"], traffic["seq_len"],
            cfg["num_attention_heads"], counts.head_dim(cfg))
        result["trace"] = {
            "family": "decoder", "phase": "train", "steps": n,
            "window_s": wall, "busy_s": busy,
            "events": window.events, "chips": world,
            "tokens_per_s": n * tokens_per_step / wall,
            "flops_per_token": counts.decoder_train_flops_per_token(
                cfg, traffic["seq_len"]),
            "attention_span": ATTENTION_SPAN,
            "attention_least_s": cfg["num_hidden_layers"]
            * counts.least_seconds(flops, nbytes),
            "optimizer_span": OPTIMIZER_SPAN}
    return result
