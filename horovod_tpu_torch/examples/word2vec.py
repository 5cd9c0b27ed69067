"""``python -m horovod_tpu_torch.examples.word2vec`` — skip-gram word2vec
over the sparse gradient path; counterpart of ``examples/jax_word2vec.py``.

The embedding's gradient is taken per gathered row (the reference's
``IndexedSlices``: one value row and its index per occurrence), all-gathered
with ``allreduce_sparse`` and summed into rows with ``sparse_to_dense``;
the dense output matrix's gradient goes through ``grouped_allreduce``.
Full softmax over a small vocabulary (5000 × 128, 64 pairs a card a step
by default), plain SGD at the linearly scaled rate; the tables start from
N(0, 0.01²) drawn from seeded ``torch.Generator`` s.

Run:  python -m horovod_tpu_torch.examples.word2vec [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch
import torch.nn.functional as F

import horovod_tpu_torch as hvd
from horovod_tpu_torch import basics
from horovod_tpu_torch.examples._common import add_device

LR = 0.05


def init_tables(vocab: int, dim: int, device):
    """``(emb, out_w)``, each ``[vocab, dim]`` N(0, 0.01²), seeds 0 and 1."""
    return tuple(
        (torch.randn(vocab, dim, generator=torch.Generator().manual_seed(s))
         * 0.01).to(device) for s in (0, 1))


def train_step(emb, out_w, centers, contexts, lr: float):
    """One step: ``(emb, out_w, loss)`` after the update.  ``centers`` and
    ``contexts`` are this card's word ids."""
    vec = emb[centers].requires_grad_()              # [b, dim] gather
    w = out_w.detach().requires_grad_()
    loss = F.cross_entropy(vec @ w.T, contexts)      # full softmax
    g_vec, g_out = torch.autograd.grad(loss, (vec, w))
    # Dense path for the output matrix (fused allreduce)...
    (g_out,) = hvd.grouped_allreduce([g_out])
    # ...sparse path for the embedding: only the touched rows move.
    vals, idx = hvd.allreduce_sparse(g_vec, centers)
    g_emb = hvd.sparse_to_dense(vals, idx, emb.shape[0])
    with torch.no_grad():
        return emb - lr * g_emb, out_w - lr * g_out, loss.detach()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m horovod_tpu_torch.examples"
                                 ".word2vec")
    ap.add_argument("--vocab", type=int, default=5000)
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=64)
    add_device(ap)
    args = ap.parse_args(argv)

    hvd.init(device=args.device)
    dev = basics.device()
    emb, out_w = init_tables(args.vocab, args.dim, dev)
    lr = hvd.scale_learning_rate(LR)
    rng = np.random.RandomState(hvd.rank())
    loss = None
    for i in range(args.steps):
        centers = torch.as_tensor(
            rng.randint(0, args.vocab, args.batch), device=dev)
        contexts = torch.as_tensor(
            rng.randint(0, args.vocab, args.batch), device=dev)
        emb, out_w, loss = train_step(emb, out_w, centers, contexts, lr)
        if hvd.rank() == 0 and i % 10 == 0:
            print(f"step {i}: loss={float(loss):.4f}", flush=True)
    if loss is not None:
        final = float(hvd.allreduce(loss, average=True))
        print(f"[rank {hvd.rank()}/{hvd.size()}] final loss={final:.6f}",
              flush=True)
    hvd.shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
