"""``python -m horovod_tpu_torch.run -np N -- python -m
horovod_tpu_torch.train_longseq`` — long-context training with the
sequence sharded over the job's N processes, the context width.

Counterpart of ``examples/jax_longseq_transformer.py`` and ``bench.py``'s
``longctx_bench``: for each sequence length, one :func:`plan_long_context`
call decides the layout (zigzag for causal multi-rank, plain at width 1)
and the remat policy (against the card's free memory less what the
trainer holds beside the activations), and the model wires attention (the ring or zigzag
flash path over the job's group) and positions from the plan
(``TransformerConfig.context_axis`` / ``context_plan``).  Tokens are
seeded, ``shard_sequence``'d into the planned layout, and each rank takes
its contiguous shard.  The loss is next-token cross entropy within each
contiguous chunk of the shard (two chunks under zigzag, each shifted on
its own), the mean over the ranks; ``DistributedOptimizer(AdamW(3e-4,
weight_decay=1e-4))`` averages the gradients over the group.

The full width is ``longctx_bench``'s: 8 layers, embed 2048, 16 heads of
128, GLU 8192, vocab 32000 (0.67 B parameters), bf16 compute over f32
parameters, the RMSNorm kernels on (``fused_norm``), sequence lengths
8192 and 32768 by default.  Each length prints one JSON line,
``longseq_train_throughput``: tokens/s over the timed steps (host clock,
steps ending in a synchronize), step ms, MFU against the H100's dense bf16
peak counting ``6·P + 6·L·S·H·D`` operations per token (P: the matrix
products' parameters, as ``longctx_bench`` counts them), the peak device
memory, the losses and ``plan.as_dict()``.

It runs on ``cuda`` (one card a process) unless ``--device`` says
otherwise, and raises without a card.  Several processes on one card take
``--device cuda:0 --backend gloo``: NCCL refuses two ranks on one device,
and the ring's exchange then goes through host memory.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch
import torch.distributed as dist

from horovod_tpu_torch import basics
from horovod_tpu_torch.models.convert import init_params
from horovod_tpu_torch.models.transformer import (Transformer,
                                                  TransformerConfig)
from horovod_tpu_torch.ops.collective_ops import allreduce
from horovod_tpu_torch.ops.losses import softmax_cross_entropy
from horovod_tpu_torch.ops.schedule_plan import probe_headroom_mb
from horovod_tpu_torch.parallel.context import (plan_long_context,
                                                shard_sequence)
from horovod_tpu_torch.training import (DistributedOptimizer,
                                        broadcast_parameters)

LAYERS, HEADS, HEAD_DIM, EMBED, MLP, VOCAB = 8, 16, 128, 2048, 8192, 32000
SEQ_LENS = (8192, 32768)
BATCH = 1
LR = 3e-4
WEIGHT_DECAY = 1e-4          # optax.adamw's default; torch's is 1e-2
WARMUP_STEPS = 3
TIMED_STEPS = 5
PEAK_BF16_FLOPS = 989e12     # H100 SXM, dense (NVIDIA data sheet)


def context_group():
    """The process group the sequence is sharded over: the job's."""
    return basics.process_group() or dist.group.WORLD


def trainer_resident_mb(cfg: TransformerConfig, seq_local: int,
                        batch: int = BATCH) -> float:
    """MB a rank's trainer holds beside the layers' activations, which the
    plan's activation model leaves out: the parameters, their gradients
    and AdamW's two moments (four copies at the parameters' dtype), and
    the loss head's logits with their gradient.  The parameters are
    counted on the ``meta`` device, so nothing is allocated."""
    params = sum(p.numel() * p.element_size()
                 for p in Transformer(cfg, device="meta").parameters())
    logits = 2 * batch * seq_local * cfg.vocab_size \
        * torch.finfo(cfg.logits_dtype).bits // 8
    return (4 * params + logits) / (1024.0 * 1024.0)


def plan_for(seq_len: int, layers: int = LAYERS, heads: int = HEADS,
             head_dim: int = HEAD_DIM, embed: int = EMBED, mlp: int = MLP,
             vocab: int = VOCAB, batch: int = BATCH, dtype=torch.bfloat16):
    """The one :func:`plan_long_context` call for ``seq_len`` over the
    job's processes.  Its headroom is what the card has free
    (:func:`probe_headroom_mb`) less :func:`trainer_resident_mb`: the
    room left for the layers' activations, which is what the plan weighs
    them against."""
    width = basics.size()
    headroom = probe_headroom_mb()
    if headroom is not None:
        cfg = longseq_config(None, seq_len, layers, heads, head_dim, embed,
                             mlp, vocab, dtype)
        headroom -= trainer_resident_mb(cfg, seq_len // width, batch)
    return plan_long_context(
        seq_len=seq_len, num_heads=heads, head_dim=head_dim, width=width,
        batch=batch, embed_dim=embed, mlp_dim=mlp, num_layers=layers,
        dtype_bytes=torch.finfo(dtype).bits // 8, headroom_mb=headroom)


def longseq_config(plan, seq_len: int, layers: int = LAYERS,
                   heads: int = HEADS, head_dim: int = HEAD_DIM,
                   embed: int = EMBED, mlp: int = MLP, vocab: int = VOCAB,
                   dtype=torch.bfloat16, **overrides) -> TransformerConfig:
    """The long-context decoder wired from ``plan``: attention, positions
    and remat come from it over :func:`context_group`."""
    base = dict(vocab_size=vocab, num_layers=layers, num_heads=heads,
                head_dim=head_dim, embed_dim=embed, mlp_dim=mlp,
                max_seq_len=seq_len, dtype=dtype, param_dtype=torch.float32,
                fused_norm=True, context_axis=context_group(),
                context_plan=plan)
    base.update(overrides)
    return TransformerConfig(**base)


def make_trainer(cfg: TransformerConfig, device, seed: int = 0):
    """Model with seeded weights (``convert.init_params``), broadcast from
    rank 0, and its distributed AdamW.  Needs :func:`basics.init`."""
    model = Transformer(cfg, device=device)
    model.load_state_dict(init_params(cfg, seed))
    broadcast_parameters(model, root_rank=0)
    opt = DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), lr=LR,
                          weight_decay=WEIGHT_DECAY),
        named_parameters=model.named_parameters())
    return model, opt


def token_shard(plan, vocab: int, device, seed: int = 0,
                batch: int = BATCH) -> torch.Tensor:
    """This rank's contiguous shard of the seeded global tokens, permuted
    into the planned layout first."""
    seq = plan.width * plan.seq_local
    tokens = torch.from_numpy(np.random.RandomState(seed).randint(
        0, vocab, (batch, seq)))
    tokens = shard_sequence(tokens, plan)
    r = basics.rank()
    return tokens[:, r * plan.seq_local:(r + 1) * plan.seq_local].to(device)


def loss_fn(model, tokens, plan) -> torch.Tensor:
    """This rank's next-token cross entropy: under zigzag the shard is two
    chunks of the sequence, each shifted on its own."""
    logits = model(tokens)
    ce = lambda lg, t: softmax_cross_entropy(lg, t).mean()  # noqa: E731
    if plan.layout == "zigzag":
        c = tokens.shape[1] // 2
        return 0.5 * (ce(logits[:, :c - 1], tokens[:, 1:c])
                      + ce(logits[:, c:-1], tokens[:, c + 1:]))
    return ce(logits[:, :-1], tokens[:, 1:])


def train_step(model, opt, tokens, plan) -> torch.Tensor:
    """One step: forward, backward, averaged gradients, AdamW.  Returns the
    loss averaged over the ranks (on the device)."""
    opt.zero_grad(set_to_none=True)
    loss = loss_fn(model, tokens, plan)
    loss.backward()
    opt.step()
    return allreduce(loss.detach())


def matmul_params(cfg: TransformerConfig) -> int:
    """Parameters of the matrix products (the embedding lookup is none),
    as ``longctx_bench`` counts them."""
    hd = cfg.num_heads * cfg.head_dim
    return cfg.num_layers * (4 * cfg.embed_dim * hd
                             + 3 * cfg.embed_dim * cfg.mlp_dim) \
        + cfg.embed_dim * cfg.vocab_size


def flops_per_token(cfg: TransformerConfig, seq_len: int) -> float:
    """``6·P`` for the matrix products plus ``6·L·S·H·D`` for causal
    attention, per token."""
    return 6 * matmul_params(cfg) + 6 * cfg.num_layers * seq_len \
        * cfg.num_heads * cfg.head_dim


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_length(seq_len: int, args) -> dict:
    """Plan, build, and train ``args.warmup`` + ``args.steps`` steps at one
    sequence length; the JSON-ready row."""
    dev = basics.device()
    dtype = getattr(torch, args.dtype)
    dims = dict(layers=args.layers, heads=args.heads,
                head_dim=args.embed // args.heads, embed=args.embed,
                mlp=args.mlp)
    plan = plan_for(seq_len, vocab=args.vocab, batch=args.batch,
                    dtype=dtype, **dims)
    cfg = longseq_config(plan, seq_len, vocab=args.vocab, dtype=dtype,
                         **dims)
    model, opt = make_trainer(cfg, dev, args.seed)
    tokens = token_shard(plan, cfg.vocab_size, dev, args.seed, args.batch)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    losses = [train_step(model, opt, tokens, plan)
              for _ in range(args.warmup)]
    _sync(dev)
    t0 = time.perf_counter()
    losses += [train_step(model, opt, tokens, plan)
               for _ in range(args.steps)]
    _sync(dev)
    step_s = (time.perf_counter() - t0) / max(args.steps, 1)
    tok_s = args.batch * seq_len / step_s
    return {
        "metric": "longseq_train_throughput", "seq_len": seq_len,
        "processes": basics.size(), "batch": args.batch,
        "params": sum(p.numel() for p in model.parameters()),
        "tok_per_s": tok_s, "step_ms": step_s * 1e3,
        "mfu": tok_s * flops_per_token(cfg, seq_len)
        / (PEAK_BF16_FLOPS * basics.num_chips()),
        "losses": [float(x) for x in losses],
        "max_memory_allocated": (torch.cuda.max_memory_allocated(dev)
                                 if dev.type == "cuda" else None),
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "plan": plan.as_dict()}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m horovod_tpu_torch.train_longseq",
        description="Long-context training, the sequence sharded over the "
                    "job's processes.")
    ap.add_argument("--seq-lens", default=",".join(map(str, SEQ_LENS)),
                    help="comma-separated sequence lengths, one plan each")
    ap.add_argument("--layers", type=int, default=LAYERS)
    ap.add_argument("--embed", type=int, default=EMBED)
    ap.add_argument("--heads", type=int, default=HEADS)
    ap.add_argument("--mlp", type=int, default=MLP)
    ap.add_argument("--vocab", type=int, default=VOCAB)
    ap.add_argument("--batch", type=int, default=BATCH)
    ap.add_argument("--warmup", type=int, default=WARMUP_STEPS)
    ap.add_argument("--steps", type=int, default=TIMED_STEPS,
                    help="timed steps")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dtype", default="bfloat16",
                    choices=("bfloat16", "float32"),
                    help="compute dtype (parameters stay float32)")
    ap.add_argument("--device", default=None,
                    help="cuda (default), cuda:N or cpu")
    ap.add_argument("--backend", default=None, choices=("nccl", "gloo"),
                    help="the group's backend (default: nccl on cuda, gloo "
                         "on cpu; gloo lets processes share a card)")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    basics.init(device=args.device, backend=args.backend)
    try:
        for seq_len in (int(s) for s in args.seq_lens.split(",")):
            row = run_length(seq_len, args)
            if basics.rank() == 0:
                print(json.dumps(row), flush=True)
    finally:
        basics.shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
