"""Where a region's time goes on the card: host wall time, device busy
time and its share of the wall, and device time by kind of kernel.

Used by ``python -m horovod_tpu_torch.serving.breakdown`` (prefill and
decode) and by ``chip_smoke.py``'s train phase (the training step).  The
wall comes from the host clock around calls that end in
``torch.cuda.synchronize``, taken without the profiler; device time from a
``torch.profiler`` trace of the same calls repeated (the union of the
kernel, copy and fill intervals).  Needs a CUDA device.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from collections import defaultdict

import torch

# Substrings of kernel names, first match wins.
KINDS = (("flash_fwd", ("flash_fwd_kernel", "flash_fwd_wgmma_kernel")),
         ("flash_bwd_dq", ("flash_bwd_dq_kernel",
                           "flash_bwd_dq_wgmma_kernel")),
         ("flash_bwd_dkv", ("flash_bwd_dkv_kernel",
                            "flash_bwd_dkv_wgmma_kernel")),
         ("rmsnorm_fwd", ("rmsnorm_fwd_kernel", "rmsnorm_fwd_regs_kernel")),
         ("rmsnorm_bwd", ("rmsnorm_bwd_kernel", "rmsnorm_bwd_regs_kernel",
                          "rmsnorm_bwd_wide_kernel")),
         # Batch norm, and cuDNN's convolutions (forward, data and weight
         # gradients), before the matrix products whose names they share.
         ("batchnorm", ("batch_norm", "BatchNorm", "bn_fw", "bn_bw")),
         ("conv", ("fprop", "dgrad", "wgrad", "convolve", "conv2d")),
         ("matmul", ("gemm", "nvjet", "xmma", "cutlass", "sm90_")))
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
TRACE_TRIES = 3


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


def kernels_in_one_call(fn) -> list[str]:
    """Names of the kernels, copies and fills the card ran for one call of
    ``fn``, after a warm-up call (which may allocate), from a trace.

    A trace with no device event at all has lost the call's records (seen
    on the H100: one empty trace among some ninety of calls that launched
    their kernel), so the call is traced again, up to ``TRACE_TRIES``
    times; a call that runs nothing on the card still gives ``[]``."""
    fn()
    torch.cuda.synchronize()
    for _ in range(TRACE_TRIES):
        prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA])
        with prof:
            fn()
            torch.cuda.synchronize()
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "call.trace.json")
            prof.export_chrome_trace(path)
            names = [e["name"] for e in device_events(path)]
        if names:
            break
    return names


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
