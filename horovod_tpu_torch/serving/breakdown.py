"""``python -m horovod_tpu_torch.serving.breakdown`` — where a replica's
time goes on the card.

Builds the replica of ``python -m horovod_tpu_torch.serving`` (the 162M
decoder with seeded weights, both kernels on) and measures two regions of
its serving loop:

* ``prefill`` — one admission's prefill of a ``PROMPT_LEN``-token prompt,
  through ``TransformerBackend.prefill`` at its bucket (1024);
* ``decode`` — ``STEPS`` ticks of ``ServingEngine.step`` with all 8 slots
  active and nothing queued, so each tick is one decode over all slots.

For each region it prints one JSON line: the host wall time per call
(host clock around calls that end in ``torch.cuda.synchronize``, taken
without the profiler), the device busy time per call and its share of the
wall (from a ``torch.profiler`` trace of the same calls: the union of the
kernel, copy and fill intervals), and the device time by kind of kernel —
the port's kernels, matrix products (cuBLAS), everything else — with the
costliest kernels by name (``utils/trace.py``).  Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile

import numpy as np
import torch

from horovod_tpu_torch.serving.__main__ import make_backend
from horovod_tpu_torch.serving.engine import ServingConfig, ServingEngine
from horovod_tpu_torch.utils.trace import measure

PROMPT_LEN = 1000   # top of the smoke's prompt lengths (100-1000)
STEPS = 16


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
    for _ in range(cfg.num_slots):   # fill every slot; warms up both paths
        eng.submit(list(map(int, rng.integers(1, vocab, PROMPT_LEN))),
                   4 * STEPS + 8)
    eng.step()
    eng.step()
    if eng._active_count() != cfg.num_slots or eng.queue:
        raise AssertionError("decode region needs every slot active")

    with tempfile.TemporaryDirectory() as tmp:
        out = args.trace_dir or tmp
        os.makedirs(out, exist_ok=True)
        # Decode first: the prefill region rewrites slot 0's cache.
        rows = [measure("decode", eng.step, STEPS, out),
                measure("prefill", lambda: backend.prefill(
                    padded, PROMPT_LEN, 0), 3, out)]
    card = torch.cuda.get_device_name(0)
    for row in rows:
        print(json.dumps({**row, "device": card, "bucket": bucket,
                          "prompt_len": PROMPT_LEN,
                          "slots": cfg.num_slots}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
