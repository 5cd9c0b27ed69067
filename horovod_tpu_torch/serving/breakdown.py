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
the port's two kernels, matrix products (cuBLAS), everything else — with
the costliest kernels by name.  Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from collections import defaultdict

import numpy as np
import torch

from horovod_tpu_torch.serving.__main__ import make_backend
from horovod_tpu_torch.serving.engine import ServingConfig, ServingEngine

# Substrings of kernel names, first match wins.
KINDS = (("flash_fwd", ("flash_fwd_kernel",)),
         ("rmsnorm_fwd", ("rmsnorm_fwd_kernel",)),
         ("matmul", ("gemm", "nvjet", "xmma", "cutlass", "sm90_")))
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
PROMPT_LEN = 1000   # top of the smoke's prompt lengths (100-1000)
STEPS = 16


def kind_of(name: str) -> str:
    for kind, keys in KINDS:
        if any(k in name for k in keys):
            return kind
    return "other"


def device_events(trace_path: str) -> list[dict]:
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    return [e for e in events
            if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]


def busy_us(events) -> float:
    """Length of the union of the events' intervals."""
    total, end = 0.0, float("-inf")
    for e in sorted(events, key=lambda e: e["ts"]):
        lo, hi = e["ts"], e["ts"] + e["dur"]
        if hi > end:
            total += hi - max(lo, end)
            end = hi
    return total


def measure(name: str, fn, calls: int, trace_dir: str) -> dict:
    """Wall per call without the profiler, then device time per call from
    a profiled repeat of the same calls."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / calls
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA])
    with prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    path = os.path.join(trace_dir, f"{name}.trace.json")
    prof.export_chrome_trace(path)
    events = device_events(path)
    by_kind, by_name = defaultdict(float), defaultdict(float)
    for e in events:
        by_kind[kind_of(e["name"])] += e["dur"] / 1e3 / calls
        by_name[e["name"][:80]] += e["dur"] / 1e3 / calls
    busy_ms = busy_us(events) / 1e3 / calls
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"region": name, "calls": calls, "wall_ms": wall_ms,
            "device_busy_ms": busy_ms if events else "not measured",
            "device_idle_share": (1.0 - busy_ms / wall_ms) if events
            else "not measured",
            "device_ms_by_kind": dict(by_kind),
            "kernels_per_call": len(events) / calls,
            "top_kernels_ms": dict(top)}


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
