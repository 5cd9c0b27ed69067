"""``python -m horovod_tpu_torch.examples.int8_convergence`` — does error
feedback earn its keep on the int8 wire at real widths?  Counterpart of
``examples/int8_convergence.py``.

One small tanh classifier on synthetic MNIST-shaped data is trained three
ways from the same start: an f32 wire, the int8 wire with error feedback
(each worker's quantization residual added to its next gradient), and the
int8 wire without it.  The JAX harness runs ``--width`` virtual devices;
this host cannot start 16–64 processes, so the port simulates the width's
workers in one process: each worker's gradient (its 4 rows of the batch,
``torch.func.vmap`` over the workers) goes through the wire's codec, the
workers' int8 rows are summed and decoded, and Adam steps on the mean.

``--wire qwire`` (the default) is the port's int8 wire, the only one it
ships (``core/qwire.py``: a scale a worker, ±127 levels, the rows summed
in f32 rank by rank), exactly as ``collective_ops.
quantized_grouped_allreduce`` computes it across processes.  ``--wire
sumfit`` is the JAX package's in-mesh grid, which no port path runs: one
scale a tensor from the largest |gradient| of any worker, each worker's
values on ±``127 // n`` levels so that the int8 sum cannot overflow; with
``--hierarchical`` the workers form an (outer, inner) grid and each tier
sum-fits on its own (±``127 // inner`` levels, the inner partial sums
requantized onto ±``127 // outer``).  It stays because the JAX harness's
convergence properties (±7 levels at width 16, ±1 flat and ±15 at (8, 8)
at width 64) are stated on that grid, and the tests hold the port to
them there; ``--hierarchical`` applies to it alone.  One JSON line: the
three loss trajectories (the mean loss of the workers, every
``--record-every`` steps and the last), with the card's ``nvidia-smi``
name and power limit.

Run:  python -m horovod_tpu_torch.examples.int8_convergence --width 16
          --layers 2 [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import math

import numpy as np
import torch
import torch.nn.functional as F

from horovod_tpu_torch.core import qwire
from horovod_tpu_torch.examples._common import add_device
from horovod_tpu_torch.train_synthetic import card
from horovod_tpu_torch.utils.device import resolve_device

_TINY = float(torch.finfo(torch.float32).tiny)
ROWS_PER_WORKER = 4


def tiers(width: int, hierarchical: bool) -> tuple[int, int]:
    """``(outer, inner)``: the JAX harness's (dcn, ici) mesh, or (1, n)."""
    if not hierarchical:
        return 1, width
    outer = 2 ** (int(math.log2(width)) // 2)
    return outer, width // outer


def sumfit_reduce(stack: torch.Tensor, outer: int, inner: int):
    """The in-mesh sum-fit route on one tensor of every worker
    (``stack``: ``[n, ...]``, error feedback already added).  Returns
    ``(mean, residuals)``: the decoded mean and each worker's
    ``g − q·scale``."""
    n = stack.shape[0]
    qcap = max(127 // inner, 1)
    amax = stack.abs().amax()
    finite = torch.isfinite(amax)
    # amax times the float32 reciprocal of qcap, not amax / qcap: XLA
    # compiles the JAX route's division by the constant so.
    inv_qcap = torch.tensor(1.0 / qcap, dtype=torch.float32,
                            device=stack.device)
    scale = torch.where(finite, torch.clamp(amax * inv_qcap, min=_TINY),
                        amax)
    q = torch.where(finite, torch.clamp(torch.round(stack / scale),
                                        -qcap, qcap),
                    torch.zeros_like(stack)).to(torch.int8)
    # g − q·scale rounded once, as XLA's fused multiply-add gives it: the
    # float64 difference is exact (|q| <= 127, and g lies within half a
    # level of q·scale).
    resid = torch.where(finite, (stack.double() - q.double() * scale.double())
                        .float(), torch.zeros_like(stack))
    if outer > 1:
        # Inner tier: int8 sums within each group (|partial| <= 127);
        # outer tier: the partials requantized on ±127 // outer levels.
        partial = q.view(outer, inner, *q.shape[1:]).to(torch.int32) \
            .sum(1).float()
        qcap2 = max(127 // outer, 1)
        s1_max = inner * qcap
        q2 = torch.round(partial * (qcap2 / s1_max)).to(torch.int32)
        summed = q2.sum(0).float() * (s1_max / qcap2)
    else:
        summed = q.to(torch.int32).sum(0).float()
    return summed * (scale * (1.0 / n)), resid


def qwire_reduce(workers: list[list[torch.Tensor]]):
    """The port's process wire over simulated workers, the arithmetic of
    ``quantized_grouped_allreduce`` step for step: ``workers[w]`` is
    worker ``w``'s tensors (error feedback already added).  Returns
    ``(reduced, residuals)``: the mean of each tensor and each worker's
    residuals."""
    sizes = [t.numel() for t in workers[0]]
    packed = [qwire.pack_int8(ts) for ts in workers]
    rows = torch.stack([p[0] for p in packed])
    acc = qwire.unpack_sum_int8(rows, sizes)
    acc = acc / torch.full((), float(len(workers)), dtype=torch.float32,
                           device=acc.device)
    reduced, off = [], 0
    for t in workers[0]:
        reduced.append(acc[off:off + t.numel()].to(t.dtype).view(t.shape))
        off += t.numel()
    resids = []
    for ts, (_, scales, qs) in zip(workers, packed):
        mine = []
        for a, q, scale in zip(ts, qs, scales):
            local = a.detach().reshape(-1).float() - q.float() * scale
            local = torch.where(torch.isfinite(scale), local,
                                torch.zeros_like(local))
            mine.append(local.to(a.dtype).view(a.shape))
        resids.append(mine)
    return reduced, resids


def init_params(layers: int, device) -> dict:
    gen = torch.Generator().manual_seed(0)

    def normal(*shape):
        return (torch.randn(*shape, generator=gen) * 0.05).to(device)

    p = {"w1": normal(784, 64), "b1": torch.zeros(64, device=device)}
    if layers == 2:
        p.update(w2=normal(64, 32), b2=torch.zeros(32, device=device),
                 w3=normal(32, 10), b3=torch.zeros(10, device=device))
    else:
        p.update(w2=normal(64, 10), b2=torch.zeros(10, device=device))
    return p


def loss_fn(p: dict, x, y):
    h = torch.tanh(x @ p["w1"] + p["b1"])
    if "w3" in p:
        h = torch.tanh(h @ p["w2"] + p["b2"])
        logits = h @ p["w3"] + p["b3"]
    else:
        logits = h @ p["w2"] + p["b2"]
    return F.cross_entropy(logits, y)


def worker_grads(p: dict, xs, ys):
    """Every worker's ``(loss, grads)`` on its own rows: ``[n]`` and
    ``{name: [n, ...]}``."""
    return torch.func.vmap(torch.func.grad_and_value(loss_fn),
                           in_dims=(None, 0, 0))(p, xs, ys)[::-1]


def train(mode: str, args, data, device) -> list[float]:
    """One run: ``mode`` is ``f32``, ``int8_ef`` or ``int8_noef``."""
    xs, ys = data
    n = xs.shape[0]
    outer, inner = tiers(n, args.hierarchical)
    params = init_params(args.layers, device)
    leaves = list(params.values())
    for t in leaves:
        t.requires_grad_(True)
    opt = torch.optim.Adam(leaves, lr=args.lr)
    errors = None
    losses = []
    for s in range(args.steps):
        loss, grads = worker_grads({k: v.detach() for k, v in
                                    params.items()}, xs, ys)
        names = list(grads)
        if mode == "f32":
            reduced = [grads[k].mean(0) for k in names]
        else:
            stacks = [grads[k] for k in names]
            if errors is not None:
                stacks = [g + e for g, e in zip(stacks, errors)]
            if args.wire == "qwire":
                reduced, res = qwire_reduce(
                    [[g[w] for g in stacks] for w in range(n)])
                res = [torch.stack([res[w][i] for w in range(n)])
                       for i in range(len(names))]
            else:
                pairs = [sumfit_reduce(g, outer, inner) for g in stacks]
                reduced, res = [m for m, _ in pairs], [r for _, r in pairs]
            if mode == "int8_ef":
                errors = res
        for k, g in zip(names, reduced):
            params[k].grad = g.detach().clone()
        opt.step()
        if s % args.record_every == 0 or s == args.steps - 1:
            losses.append(round(float(loss.mean()), 5))
    return losses


def synthetic(width: int, device):
    """The JAX harness's data: ``[n·4, 784]`` uniform rows labelled by a
    random linear map; worker ``w`` takes rows ``4w … 4w + 3``."""
    rng = np.random.RandomState(0)
    x = rng.rand(width * ROWS_PER_WORKER, 784).astype(np.float32)
    w_true = rng.randn(784, 10).astype(np.float32)
    y = (x @ w_true).argmax(1).astype(np.int64)
    return (torch.as_tensor(x, device=device).view(width, ROWS_PER_WORKER,
                                                   784),
            torch.as_tensor(y, device=device).view(width, ROWS_PER_WORKER))


def run(args) -> dict:
    device = resolve_device(args.device)
    data = synthetic(args.width, device)
    outer, inner = tiers(args.width, args.hierarchical)
    levels = 127 if args.wire == "qwire" else max(127 // inner, 1)
    return {
        "width": args.width, "wire": args.wire,
        "mesh": f"{outer}x{inner}" if args.hierarchical else
        str(args.width),
        "per_worker_levels": levels, "steps": args.steps,
        **{mode: train(mode, args, data, device)
           for mode in ("f32", "int8_ef", "int8_noef")},
        "card": card(device)}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="python -m horovod_tpu_torch.examples"
                                 ".int8_convergence")
    ap.add_argument("--width", type=int, default=64)
    ap.add_argument("--hierarchical", action="store_true",
                    help="(outer, inner) workers: each tier sum-fits "
                    "(--wire sumfit)")
    ap.add_argument("--steps", type=int, default=80)
    ap.add_argument("--lr", type=float, default=2e-3)
    ap.add_argument("--record-every", type=int, default=10)
    ap.add_argument("--layers", type=int, default=1, choices=(1, 2),
                    help="hidden tanh layers; 2 is a non-convex landscape")
    ap.add_argument("--wire", choices=("qwire", "sumfit"), default="qwire",
                    help="qwire: the port's wire; sumfit: the JAX "
                    "package's in-mesh grid")
    add_device(ap)
    args = ap.parse_args(argv)
    if args.hierarchical and args.wire != "sumfit":
        ap.error("--hierarchical applies to --wire sumfit: the port's wire "
                 "has no tiers")
    return args


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.device == "cpu":
        # Tensors of a few KB a worker: one thread beats a contended pool.
        torch.set_num_threads(1)
    print(json.dumps(run(args)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
