"""``python -m horovod_tpu_torch.train_transformer`` — the 162M decoder's
synchronous data-parallel training step on the card, one process per card.

Counterpart of ``examples/jax_transformer_benchmark.py`` at its defaults
with ``--fused-norm``: ``init()`` → the 162M decoder (12 × 768, 6 heads of
128, GLU 3072, vocab 32000, bf16 compute over f32 parameters, bf16 logits)
with the flash-attention and RMSNorm kernels → ``softmax_cross_entropy`` →
backward → ``DistributedOptimizer(AdamW(3e-4, weight_decay=1e-4))`` (optax's
``adamw`` defaults) on a fixed token batch, seeded weights from
``convert.init_params``.  The global batch of ``BATCH`` rows is split
evenly over the processes, as the JAX benchmark shards it over its chips.

The JAX benchmark's mixed-precision and memory flags, with its meanings:

* ``--bf16-params``: parameters resident in bf16 (``param_dtype``) and
  ``DistributedOptimizer(master_weights(AdamW(...)))``: AdamW steps an f32
  master copy, bf16 gradients go on the wire;
* ``--remat``: every block rematerialised in the backward pass
  (``TransformerConfig.remat``);
* ``--accumulate N``: ``accumulate_gradients`` over N microbatches a step,
  with ``backward_passes_per_step=N``; ``BATCH`` stays the effective batch,
  activations peak at ``BATCH / N`` rows.

``--profile DIR`` traces one more step after the warm-up into a Chrome
trace under ``DIR`` (rank 0; ``horovod_tpu_torch.profiling.trace``, the
step inside a ``span("train_step")``), as the JAX benchmark's
``--profile`` traces one dispatch.

It prints one JSON line, ``transformer_train_throughput``: tokens/s over the
timed steps (host clock around steps that end in a synchronize), step time,
MFU against the H100's dense bf16 peak, counting ``6·N + 6·L·S·E``
operations per token as the JAX benchmark does, the flags, and the peak
device memory over the warm-up and timed steps.  The TPU tiling flags and
its ``lax.scan`` device loop have no counterpart here.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from horovod_tpu_torch import basics
from horovod_tpu_torch.models.convert import init_params
from horovod_tpu_torch.models.transformer import (Transformer,
                                                  TransformerConfig,
                                                  config_162m)
from horovod_tpu_torch.ops.losses import softmax_cross_entropy
from horovod_tpu_torch.training import (DistributedOptimizer,
                                        accumulate_gradients,
                                        broadcast_parameters, master_weights)
from horovod_tpu_torch.utils import profiling

BATCH = 8
SEQ_LEN = 1024
LR = 3e-4
WEIGHT_DECAY = 1e-4          # optax.adamw's default; torch's is 1e-2
WARMUP_STEPS = 3
TIMED_STEPS = 10
PEAK_BF16_FLOPS = 989e12     # H100 SXM, dense (NVIDIA data sheet)


def train_config(**overrides) -> TransformerConfig:
    """The 162M decoder as the JAX benchmark trains it: bf16 logits (the
    loss widens them to f32 inside), both kernels on."""
    return config_162m(**{"max_seq_len": SEQ_LEN,
                          "logits_dtype": torch.bfloat16, **overrides})


def make_trainer(cfg: TransformerConfig, device, seed: int = 0,
                 accumulate: int = 1):
    """Model with seeded weights, broadcast from rank 0, and its
    distributed AdamW, over f32 master weights when the parameters are
    not f32 (``--bf16-params``); ``accumulate`` backward passes a step.
    Needs :func:`basics.init`."""
    model = Transformer(cfg, device=device)
    model.load_state_dict(init_params(cfg, seed))
    broadcast_parameters(model, root_rank=0)
    opt = torch.optim.AdamW(model.parameters(), lr=LR,
                            weight_decay=WEIGHT_DECAY)
    if cfg.param_dtype != torch.float32:
        opt = master_weights(opt)
    opt = DistributedOptimizer(opt, named_parameters=model.named_parameters(),
                               backward_passes_per_step=accumulate)
    return model, opt


def loss_fn(model, tokens):
    """Mean next-token cross entropy over ``tokens`` [B, S]."""
    logits = model(tokens)
    return softmax_cross_entropy(logits[:, :-1], tokens[:, 1:]).mean()


def train_step(model, opt, tokens, accumulate: int = 1) -> torch.Tensor:
    """One step: forward, backward (over ``accumulate`` microbatches),
    averaged gradients, AdamW update.  Returns the loss (on the device;
    reading it waits for the step)."""
    opt.zero_grad(set_to_none=True)
    if accumulate > 1:
        loss = accumulate_gradients(lambda mb: loss_fn(model, mb), tokens,
                                    accumulate)
    else:
        with profiling.span("train.forward"):
            loss = loss_fn(model, tokens)
        with profiling.span("train.backward"):
            loss.backward()
    with profiling.span("train.optimizer"):
        opt.step()
    return loss.detach()


def token_batch(vocab: int, device) -> torch.Tensor:
    """This process's rows of the fixed global batch (numpy seed 0)."""
    rng = np.random.RandomState(0)
    tokens = torch.from_numpy(rng.randint(0, vocab, (BATCH, SEQ_LEN)))
    n, r = basics.size(), basics.rank()
    if BATCH % n:
        raise ValueError(f"the batch of {BATCH} rows does not split over "
                         f"{n} processes")
    return tokens[r * BATCH // n:(r + 1) * BATCH // n].to(device)


def flops_per_token(n_params: int, cfg: TransformerConfig,
                    seq_len: int) -> float:
    """Training operations per token: ``6·N`` for the matrix products plus
    ``6·L·S·E`` for causal attention (the JAX benchmark's count)."""
    return 6 * n_params + 6 * cfg.num_layers * seq_len * cfg.embed_dim


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m horovod_tpu_torch.train_transformer",
        description="The 162M decoder's training step on the card.")
    ap.add_argument("--bf16-params", action="store_true",
                    help="parameters resident in bf16, AdamW on f32 master "
                         "weights (master_weights)")
    ap.add_argument("--remat", action="store_true",
                    help="rematerialise each block in the backward pass")
    ap.add_argument("--accumulate", type=int, default=1,
                    help="microbatches a step (accumulate_gradients); the "
                         "batch stays the effective batch")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="trace one step after the warm-up into DIR (rank "
                         "0; horovod_tpu_torch.profiling.trace)")
    return ap.parse_args(argv)


def flag_config(args) -> TransformerConfig:
    """:func:`train_config` with the flags' ``param_dtype`` and ``remat``."""
    return train_config(
        param_dtype=torch.bfloat16 if args.bf16_params else torch.float32,
        remat=args.remat)


def main(argv=None) -> int:
    args = parse_args(argv)
    basics.init()
    try:
        dev = basics.device()
        cfg = flag_config(args)
        model, opt = make_trainer(cfg, dev, accumulate=args.accumulate)
        n_params = sum(p.numel() for p in model.parameters())
        tokens = token_batch(cfg.vocab_size, dev)
        if tokens.shape[0] % args.accumulate:
            raise ValueError(f"{tokens.shape[0]} rows a process do not "
                             f"split into {args.accumulate} microbatches")
        torch.cuda.reset_peak_memory_stats(dev)
        for _ in range(WARMUP_STEPS):
            train_step(model, opt, tokens, args.accumulate)
        if args.profile:
            with profiling.trace(args.profile):
                with profiling.span("train_step"):
                    train_step(model, opt, tokens, args.accumulate)
                torch.cuda.synchronize()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(TIMED_STEPS):
            loss = train_step(model, opt, tokens, args.accumulate)
        torch.cuda.synchronize()
        step_s = (time.perf_counter() - t0) / TIMED_STEPS
        tok_s = BATCH * SEQ_LEN / step_s    # global tokens per second
        if basics.rank() == 0:
            print(json.dumps({
                "metric": "transformer_train_throughput",
                "params_m": round(n_params / 1e6, 1), "seq_len": SEQ_LEN,
                "batch": BATCH, "processes": basics.size(),
                "tok_per_s": tok_s, "step_ms": step_s * 1e3,
                "mfu": tok_s * flops_per_token(n_params, cfg, SEQ_LEN)
                / (PEAK_BF16_FLOPS * basics.num_chips()),
                "loss": float(loss), "bf16_params": args.bf16_params,
                "remat": args.remat, "accumulate": args.accumulate,
                "max_memory_allocated": torch.cuda.max_memory_allocated(dev),
                "device": torch.cuda.get_device_name(dev)}), flush=True)
    finally:
        basics.shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
