"""``python -m horovod_tpu_torch.serving.breakdown`` — where a replica's
time goes on the card.

Builds the replica of ``python -m horovod_tpu_torch.serving`` (the 162M
decoder with seeded weights, both kernels on) and measures four regions
of its serving loop, two on the dense KV cache and two on the paged pool:

* ``decode`` — ``STEPS`` ticks of ``ServingEngine.step`` over a
  ``TransformerBackend`` with all 8 slots active and nothing queued, so
  each tick is one decode over all slots;
* ``prefill`` — one admission's prefill of a ``PROMPT_LEN``-token prompt,
  through ``TransformerBackend.prefill`` at its bucket (1024);
* ``paged_decode`` — the same ticks over a ``PagedTransformerBackend``
  (page size 16, ``CACHE_PAGES`` cache pages) of the same model, every
  slot's prompt opening with a ``SHARED_LEN``-token prefix that the first
  admission donated and the other seven attached to;
* ``paged_prefill_prefixed`` — a prefix-attached prefill: the
  ``PROMPT_LEN - SHARED_LEN``-token suffix at position ``SHARED_LEN``
  through ``prefill_prefixed`` at its bucket (512).

For each region it prints one JSON line: the host wall time per call
(host clock around calls that end in ``torch.cuda.synchronize``, taken
without the profiler), the device busy time per call and its share of the
wall (from a ``torch.profiler`` trace of the same calls: the union of the
kernel, copy and fill intervals), the device time by kind of kernel — the
port's kernels, matrix products (cuBLAS), everything else — with the
costliest kernels by name and by launching op, the costliest copy kernel
by launching op (``largest_copy``), and, on the paged regions, the device
time of the page gather and scatter (``span_ms``; ``utils/trace.py``).
Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile

import numpy as np
import torch

from horovod_tpu_torch.serving.__main__ import make_backend
from horovod_tpu_torch.serving.engine import (PagedTransformerBackend,
                                              ServingConfig, ServingEngine)
from horovod_tpu_torch.utils.trace import measure

PROMPT_LEN = 1000   # top of the smoke's prompt lengths (100-1000)
SHARED_LEN = 512    # the smoke's serve_paged shared prefix
CACHE_PAGES = 512
STEPS = 16
SPANS = ("paged_gather", "paged_scatter")


def _fill(eng, prompts, max_new: int) -> None:
    """Admit one request per slot and take two steps, so that the next
    steps are decodes over every slot with nothing queued."""
    for p in prompts:
        eng.submit(p, max_new)
    eng.step()
    eng.step()
    if eng._active_count() != eng.config.num_slots or eng.queue:
        raise AssertionError("decode region needs every slot active")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m horovod_tpu_torch.serving.breakdown")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trace-dir", default=None,
                    help="keep the chrome traces here (default: a "
                         "temporary directory, removed at exit)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("the breakdown measures the card; no CUDA device")
    cfg = ServingConfig(num_slots=8, buckets=(128, 256, 512, 1024),
                        max_seq_len=2048)
    backend, vocab = make_backend(cfg, "cuda", args.seed)
    rng = np.random.default_rng(args.seed)
    bucket = next(b for b in cfg.buckets if b >= PROMPT_LEN)
    padded = np.zeros((1, bucket), np.int32)
    padded[0, :PROMPT_LEN] = rng.integers(1, vocab, PROMPT_LEN)

    eng = ServingEngine(backend, cfg)
    _fill(eng, [list(map(int, rng.integers(1, vocab, PROMPT_LEN)))
                for _ in range(cfg.num_slots)], 4 * STEPS + 8)

    paged = PagedTransformerBackend(backend.model, cfg.num_slots,
                                    cfg.max_seq_len, cache_pages=CACHE_PAGES,
                                    page_size=16)
    peng = ServingEngine(paged, cfg)
    shared = list(map(int, rng.integers(1, vocab, SHARED_LEN)))
    prompts = [shared + list(map(int, rng.integers(
        1, vocab, PROMPT_LEN - SHARED_LEN))) for _ in range(cfg.num_slots)]
    _fill(peng, prompts, 4 * STEPS + 8)
    if peng.counters["prefix_hits"] != cfg.num_slots - 1:
        raise AssertionError("paged regions need the shared prefix cached")
    suffix = prompts[0][SHARED_LEN:]
    sbucket = next(b for b in cfg.buckets if b >= len(suffix))
    spadded = np.zeros((1, sbucket), np.int32)
    spadded[0, :len(suffix)] = suffix

    with tempfile.TemporaryDirectory() as tmp:
        out = args.trace_dir or tmp
        os.makedirs(out, exist_ok=True)
        # Decodes first: the prefill regions rewrite slot 0's cache.
        rows = [measure("decode", eng.step, STEPS, out),
                measure("prefill", lambda: backend.prefill(
                    padded, PROMPT_LEN, 0), 3, out),
                measure("paged_decode", peng.step, STEPS, out, SPANS),
                measure("paged_prefill_prefixed", lambda:
                        paged.prefill_prefixed(spadded, len(suffix), 0,
                                               SHARED_LEN), 3, out, SPANS)]
    pool_bytes = 2 * paged.pk.numel() * paged.pk.element_size()
    rows[2].update(pool_bytes=pool_bytes, cache_pages=CACHE_PAGES,
                   shared_len=SHARED_LEN)
    rows[3].update(pool_bytes=pool_bytes, shared_len=SHARED_LEN,
                   suffix_len=len(suffix), bucket=sbucket)
    card = torch.cuda.get_device_name(0)
    for row in rows:
        print(json.dumps({"device": card, "bucket": bucket,
                          "prompt_len": PROMPT_LEN,
                          "slots": cfg.num_slots, **row}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
