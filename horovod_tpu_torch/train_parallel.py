"""``python -m horovod_tpu_torch.run -np N -- python -m
horovod_tpu_torch.train_parallel --strategy {pipeline,moe,zero,fsdp}`` —
the 162M decoder trained over the job's N processes by one of the
parallelism strategies of ``horovod_tpu_torch.parallel``.

Counterpart of ``examples/jax_pipeline_transformer.py``,
``examples/jax_moe_transformer.py`` and ``examples/jax_fsdp_transformer.py``:

* ``pipeline`` — GPipe (``parallel/pipeline.py``): the 12 blocks split
  ``12 / N`` a stage, ``--microbatches`` (default 4) a step; the
  embedding, final norm and head replicated on every rank, the
  embedding's gradient summed over the group (it lands on stage 0 only),
  the head's exact everywhere; every rank runs the whole batch;
* ``moe`` — every block's MLP a switch-MoE layer (``models/moe.py``), one
  expert a rank; each rank its rows of the batch, ``moe_grad_sync`` after
  the backward;
* ``zero`` — ``DistributedOptimizer(..., sharded_state=True)`` (ZeRO-1);
* ``fsdp`` — ``fsdp_device_put`` with a unit a block (ZeRO-3).

By default the model is ``train_transformer``'s 162M decoder at full
width (12 × 768, 6 heads of 128, GLU 3072, vocab 32000, bf16 compute over
f32 parameters, the flash-attention and RMSNorm kernels on), B = 8, S =
1024, AdamW(3e-4, weight decay 1e-4), seeded weights
(``convert.init_params``).  It prints one JSON line,
``parallel_train_throughput``: tokens/s over the timed steps (host clock,
steps ending in a synchronize), step ms, MFU (``train_transformer``'s
count over the job's cards), the losses, and for every rank its parameter,
gradient and optimizer-state bytes, its peak device memory, the tokens its
experts dropped (``moe``) and the collective calls a step by kind
(``parallel.collective_stats``).

It runs on ``cuda`` unless ``--device`` says otherwise, and raises without
a card.  Several processes on one card take ``--device cuda:0 --backend
gloo`` (NCCL refuses two ranks on one device; CUDA tensors then go through
host memory).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from horovod_tpu_torch import basics
from horovod_tpu_torch import train_transformer as tt
from horovod_tpu_torch.models.convert import init_params, stage_state_dict
from horovod_tpu_torch.models.transformer import (Block, Transformer,
                                                  TransformerConfig, _linear)
from horovod_tpu_torch.ops.losses import softmax_cross_entropy
from horovod_tpu_torch.ops.rmsnorm import FusedRMSNorm
from horovod_tpu_torch.parallel import (collective_stats, fsdp_device_put,
                                        fsdp_shardings, moe_grad_sync,
                                        moe_stats, pipeline_apply,
                                        reset_collective_stats,
                                        reset_moe_stats)
from horovod_tpu_torch.parallel.common import all_gather, all_reduce
from horovod_tpu_torch.training import DistributedOptimizer

STRATEGIES = ("pipeline", "moe", "zero", "fsdp")
MICROBATCHES = 4
WARMUP_STEPS, TIMED_STEPS = 3, 10


def parallel_group():
    """The process group every strategy runs over: the job's."""
    return basics.process_group() or dist.group.WORLD


class PipelineDecoder(nn.Module):
    """One pipeline stage's share of the decoder: the embedding, final norm
    and head (replicated), and blocks ``first .. first + count - 1``
    (``layers.0 ..``; ``convert.stage_state_dict`` maps a whole model's
    weights onto it)."""

    def __init__(self, cfg: TransformerConfig, count: int, device=None):
        super().__init__()
        self.cfg = cfg
        self.embed = nn.Embedding(cfg.vocab_size, cfg.embed_dim,
                                  dtype=cfg.param_dtype, device=device)
        self.layers = nn.ModuleList(Block(cfg, device) for _ in range(count))
        self.final_norm = FusedRMSNorm(
            cfg.embed_dim, dtype=cfg.dtype, param_dtype=cfg.param_dtype,
            use_fused=cfg.fused_norm, device=device)
        self.lm_head = nn.Linear(cfg.embed_dim, cfg.vocab_size, bias=False,
                                 dtype=cfg.param_dtype, device=device)

    def forward(self, tokens, microbatches: int, group=None):
        cfg = self.cfg
        b, s = tokens.shape
        x = self.embed(tokens.long()).to(cfg.dtype)
        positions = torch.arange(s, device=tokens.device)[None].expand(
            b // microbatches, s)

        def stage(layers, mb):
            for block in layers:
                mb = block(mb, positions)
            return mb

        y = pipeline_apply(stage, self.layers, x, microbatches, group)
        return _linear(self.final_norm(y), self.lm_head,
                       cfg.dtype).to(cfg.logits_dtype)


@dataclasses.dataclass
class Trainer:
    """One rank's share of a strategy: its model, optimizer and rows."""

    strategy: str
    model: nn.Module
    opt: object
    tokens: torch.Tensor
    group: object
    microbatches: int = 1
    fsdp: object = None


def token_batch(vocab: int, batch: int, seq_len: int, seed: int = 0):
    """The fixed global batch (numpy seed), on the host."""
    return torch.from_numpy(np.random.RandomState(seed).randint(
        0, vocab, (batch, seq_len)))


def make_trainer(strategy: str, cfg: TransformerConfig, device,
                 seed: int = 0, batch: int = tt.BATCH,
                 microbatches: int = MICROBATCHES) -> Trainer:
    """``strategy``'s model with seeded weights, its AdamW and this rank's
    rows of the batch; ``"replicated"`` is the data-parallel step it is
    held against (``DistributedOptimizer``).  Needs :func:`basics.init`."""
    group = parallel_group()
    n, r = dist.get_world_size(group), dist.get_rank(group)
    tokens = token_batch(cfg.vocab_size, batch, cfg.max_seq_len, seed)
    rows = tokens[r * batch // n:(r + 1) * batch // n].to(device)
    adamw = lambda ps: torch.optim.AdamW(  # noqa: E731
        ps, lr=tt.LR, weight_decay=tt.WEIGHT_DECAY)
    if strategy == "pipeline":
        if cfg.num_layers % n:
            raise ValueError(f"{cfg.num_layers} blocks do not split into "
                             f"{n} stages")
        count = cfg.num_layers // n
        model = PipelineDecoder(cfg, count, device)
        model.load_state_dict(stage_state_dict(init_params(cfg, seed),
                                               r * count, count))
        return Trainer(strategy, model, adamw(model.parameters()),
                       tokens.to(device), group, microbatches)
    if strategy == "moe":
        cfg = dataclasses.replace(cfg, moe_axis=group)
    model = Transformer(cfg, device=device)
    model.load_state_dict(init_params(cfg, seed))
    if strategy == "moe":
        return Trainer(strategy, model, adamw(model.parameters()), rows,
                       group)
    if strategy in ("zero", "replicated"):
        return Trainer(strategy, model, DistributedOptimizer(
            adamw(model.parameters()), sharded_state=strategy == "zero"),
            rows, group)
    if strategy == "fsdp":
        f = fsdp_device_put(model, fsdp_shardings(model, group), group,
                            units=model.layers)
        return Trainer(strategy, model, adamw(model.parameters()), rows,
                       group, fsdp=f)
    raise ValueError(f"unknown strategy {strategy!r}")


def loss_fn(tr: Trainer) -> torch.Tensor:
    """This rank's mean next-token cross entropy (under ``pipeline`` every
    rank's is the whole batch's)."""
    if tr.strategy == "pipeline":
        logits = tr.model(tr.tokens, tr.microbatches, tr.group)
    else:
        logits = tr.model(tr.tokens)
    return softmax_cross_entropy(logits[:, :-1], tr.tokens[:, 1:]).mean()


def sync_grads(tr: Trainer) -> None:
    """What a strategy does to the gradients between backward and step:
    the pipeline's embedding sums over the stages, MoE syncs its shared
    and expert leaves; ZeRO's and FSDP's reduce inside."""
    if tr.strategy == "pipeline":
        g = tr.model.embed.weight.grad
        g.copy_(all_reduce(g, tr.group))
    elif tr.strategy == "moe":
        moe_grad_sync(tr.model.named_parameters(), tr.group)


def train_step(tr: Trainer) -> torch.Tensor:
    """One step; returns the loss averaged over the ranks."""
    tr.opt.zero_grad(set_to_none=True)
    loss = loss_fn(tr)
    loss.backward()
    sync_grads(tr)
    tr.opt.step()
    return all_reduce(loss.detach(), tr.group) / \
        dist.get_world_size(tr.group)


def _bytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if isinstance(t, torch.Tensor))


def memory_bytes(tr: Trainer) -> dict:
    """This rank's parameter, gradient and optimizer-state bytes."""
    params = list(tr.model.parameters())
    state = tr.opt.state_bytes() if hasattr(tr.opt, "state_bytes") else \
        _bytes(t for s in tr.opt.state.values() for t in s.values())
    return {"param_bytes": _bytes(params),
            "grad_bytes": _bytes(p.grad for p in params),
            "state_bytes": state}


def per_rank(tr: Trainer, row: dict) -> list[dict]:
    """``row`` (numbers) from every rank of the group, in rank order."""
    keys = sorted(row)
    mine = torch.tensor([float(row[k]) for k in keys], dtype=torch.float64,
                        device=tr.tokens.device)
    rows = all_gather(mine[None], tr.group).cpu().tolist()
    return [dict(zip(keys, r)) for r in rows]


def run(args) -> dict:
    """Build, train ``args.warmup`` + ``args.steps`` steps; the JSON-ready
    row."""
    dev = basics.device()
    dims = dict(num_layers=args.layers, embed_dim=args.embed,
                num_heads=args.heads, head_dim=args.embed // args.heads,
                mlp_dim=args.mlp, vocab_size=args.vocab,
                max_seq_len=args.seq_len, dtype=getattr(torch, args.dtype))
    cfg = tt.train_config(**dims)
    tr = make_trainer(args.strategy, cfg, dev, args.seed, args.batch,
                      args.microbatches)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    losses = [train_step(tr) for _ in range(args.warmup)]
    _sync(dev)
    reset_collective_stats()
    reset_moe_stats()
    t0 = time.perf_counter()
    losses += [train_step(tr) for _ in range(args.steps)]
    _sync(dev)
    step_s = (time.perf_counter() - t0) / max(args.steps, 1)
    calls = {k: v / max(args.steps, 1) for k, v in collective_stats().items()
             if not k.endswith("_bytes")}
    mem = memory_bytes(tr)
    mem["max_memory_allocated"] = (torch.cuda.max_memory_allocated(dev)
                                   if dev.type == "cuda" else 0)
    mem["tokens_dropped"] = moe_stats()["dropped"]
    ranks = per_rank(tr, mem)
    dense = sum(p.numel() for p in Transformer(
        dataclasses.replace(cfg, moe_axis=None), device="meta")
        .parameters())
    tok_s = args.batch * args.seq_len / step_s
    return {
        "metric": "parallel_train_throughput", "strategy": args.strategy,
        "processes": dist.get_world_size(tr.group), "batch": args.batch,
        "seq_len": args.seq_len, "layers": args.layers,
        "microbatches": args.microbatches if args.strategy == "pipeline"
        else None,
        "params": dense, "tok_per_s": tok_s, "step_ms": step_s * 1e3,
        "mfu": tok_s * tt.flops_per_token(dense, cfg, args.seq_len)
        / (tt.PEAK_BF16_FLOPS * basics.num_chips()),
        "losses": [float(x) for x in losses],
        "collective_calls_per_step": calls, "ranks": ranks,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu")}


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m horovod_tpu_torch.train_parallel",
        description="The 162M decoder trained over the job's processes by "
                    "pipeline, expert, ZeRO-1 or FSDP parallelism.")
    ap.add_argument("--strategy", required=True, choices=STRATEGIES)
    ap.add_argument("--microbatches", type=int, default=MICROBATCHES,
                    help="GPipe microbatches a step (pipeline)")
    ap.add_argument("--layers", type=int, default=12)
    ap.add_argument("--embed", type=int, default=768)
    ap.add_argument("--heads", type=int, default=6)
    ap.add_argument("--mlp", type=int, default=3072)
    ap.add_argument("--vocab", type=int, default=32000)
    ap.add_argument("--batch", type=int, default=tt.BATCH)
    ap.add_argument("--seq-len", type=int, default=tt.SEQ_LEN)
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
        row = run(args)
        if basics.rank() == 0:
            print(json.dumps(row), flush=True)
    finally:
        basics.shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
