"""Where a region's time goes on the card: host wall time, device busy
time and its share of the wall, and device time by kind of kernel.

Used by ``python -m horovod_tpu_torch.serving.breakdown`` (prefill and
decode) and by ``chip_smoke.py``'s train phase (the training step).  The
wall comes from the host clock around calls that end in
``torch.cuda.synchronize``, taken without the profiler; device time from a
``torch.profiler`` trace of the same calls repeated (the union of the
kernel, copy and fill intervals).  Needs a CUDA device.

Each kernel is also attributed to the operator that launched it:
``torch.profiler`` gives the kernel the "External id" of the innermost
CPU op open when it was launched (directly, or through the runtime call
its "correlation" names), and the op's outermost enclosing op on its
thread says where in the step it ran (an autograd node's
``evaluate_function``, the optimizer's step, or the forward's top-level
op).  :func:`measure` reports the "other" kind of kernel by that pair,
the costliest copy kernel by that pair, and the device time of the
kernels launched inside named ``record_function`` spans (the paged
backend's ``paged_gather`` and ``paged_scatter``).
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from collections import defaultdict

import torch

# Substrings of kernel names, first match wins.
KINDS = (("flash_fwd", ("flash_fwd_kernel", "flash_fwd_wgmma_kernel",
                        "flash_fwd_wide_kernel")),
         ("flash_bwd_dq", ("flash_bwd_dq_kernel", "flash_bwd_dq_wgmma_kernel",
                           "flash_bwd_dq_wide_kernel")),
         ("flash_bwd_dkv", ("flash_bwd_dkv_kernel",
                            "flash_bwd_dkv_wgmma_kernel",
                            "flash_bwd_dkv_wide_kernel")),
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


def _events(trace_path: str) -> list[dict]:
    with open(trace_path) as f:
        return json.load(f)["traceEvents"]


def device_events(trace_path: str) -> list[dict]:
    return [e for e in _events(trace_path)
            if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]


def launching_ops(events) -> dict:
    """``{External id: (op, outermost op)}`` over a trace's CPU ops: each
    op's name and the name of the outermost op enclosing it on its thread
    (itself at top level)."""
    threads = defaultdict(list)
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "cpu_op":
            threads[(e.get("pid"), e.get("tid"))].append(e)
    out = {}
    for ops in threads.values():
        ops.sort(key=lambda e: (e["ts"], -e["dur"]))
        stack: list[dict] = []
        for e in ops:
            while stack and stack[-1]["ts"] + stack[-1]["dur"] <= e["ts"]:
                stack.pop()
            ext = e.get("args", {}).get("External id")
            if ext is not None:
                out[ext] = (e["name"], (stack[0] if stack else e)["name"])
            stack.append(e)
    return out


def ops_of_kernels(events) -> list[tuple[dict, str, str]]:
    """``(device event, op, outermost op)`` for every device event of a
    trace; ``"?"`` where the trace links it to no op."""
    ops = launching_ops(events)
    runtime = {e["args"]["correlation"]: e["args"].get("External id")
               for e in events
               if e.get("cat") in ("cuda_runtime", "cuda_driver")
               and "correlation" in e.get("args", {})}
    out = []
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        args = e.get("args", {})
        ext = args.get("External id")
        if ext not in ops:
            ext = runtime.get(args.get("correlation"))
        op, root = ops.get(ext, ("?", "?"))
        out.append((e, op, root))
    return out


def span_us(events, names) -> dict:
    """``{name: device µs}`` of the kernels, copies and fills whose launch
    (the runtime call their "correlation" names) falls inside a
    ``record_function`` span of that name on the launching thread."""
    spans = [e for e in events if e.get("ph") == "X"
             and e.get("cat") in ("user_annotation", "cpu_op")
             and e.get("name") in names]
    launch = {e["args"]["correlation"]: e for e in events
              if e.get("cat") in ("cuda_runtime", "cuda_driver")
              and "correlation" in e.get("args", {})}
    out = dict.fromkeys(names, 0.0)
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        r = launch.get(e.get("args", {}).get("correlation"))
        if r is None:
            continue
        for s in spans:
            if (s.get("pid"), s.get("tid")) == (r.get("pid"), r.get("tid")) \
                    and s["ts"] <= r["ts"] <= s["ts"] + s["dur"]:
                out[s["name"]] += e["dur"]
                break
    return out


def device_us_by_stream(events) -> dict:
    """``{stream: device µs}`` over a trace's device events (the stream in
    each event's args, else its ``tid``)."""
    out = defaultdict(float)
    for e in events:
        out[str(e.get("args", {}).get("stream", e.get("tid")))] += e["dur"]
    return dict(out)


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


def measure(name: str, fn, calls: int, trace_dir: str,
            spans: tuple[str, ...] = ()) -> dict:
    """Wall per call without the profiler, then device time per call from
    a profiled repeat of the same calls; ``spans`` names the
    ``record_function`` spans whose device time is reported apart."""
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
    all_events = _events(path)
    attributed = ops_of_kernels(all_events)
    events = [e for e, _, _ in attributed]
    by_kind, by_name = defaultdict(float), defaultdict(float)
    other = defaultdict(lambda: [0.0, 0.0])
    name_op = defaultdict(float)
    copies = defaultdict(lambda: defaultdict(float))
    for e, op, root in attributed:
        if "copy" in e["name"].lower() or e.get("cat") == "gpu_memcpy":
            copies[e["name"]][f"{root} / {op}"] += e["dur"] / 1e3 / calls
        kind = kind_of(e["name"])
        by_kind[kind] += e["dur"] / 1e3 / calls
        by_name[e["name"][:80]] += e["dur"] / 1e3 / calls
        name_op[(e["name"][:80], f"{root} / {op}")] += e["dur"] / 1e3 / calls
        if kind == "other":
            entry = other[f"{root} / {op}"]
            entry[0] += e["dur"] / 1e3 / calls
            entry[1] += 1 / calls
    busy_ms = busy_us(events) / 1e3 / calls
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    other_top = sorted(other.items(), key=lambda kv: -kv[1][0])[:12]
    top_ops = {name: dict(sorted(((o, ms) for (n, o), ms in name_op.items()
                                  if n == name), key=lambda kv: -kv[1])[:4])
               for name, _ in top}
    copy_name = max(copies, key=lambda n: sum(copies[n].values()),
                    default=None)
    largest_copy = None if copy_name is None else {
        "kernel": copy_name, "ms": sum(copies[copy_name].values()),
        # Device ms per call by "outermost op / op".
        "by_op": dict(sorted(copies[copy_name].items(),
                             key=lambda kv: -kv[1])[:6])}
    span_ms = {k: v / 1e3 / calls
               for k, v in span_us(all_events, spans).items()}
    return {"region": name, "calls": calls, "wall_ms": wall_ms,
            "device_busy_ms": busy_ms if events else "not measured",
            "device_idle_share": (1.0 - busy_ms / wall_ms) if events
            else "not measured",
            "device_ms_by_kind": dict(by_kind),
            "kernels_per_call": len(events) / calls,
            "top_kernels_ms": dict(top),
            # For each of those: device ms per call by "outermost op / op".
            "top_kernels_by_op": top_ops,
            # "outermost op / op": [device ms, kernels] per call.
            "other_by_op": {k: v for k, v in other_top},
            "largest_copy": largest_copy,
            # Device ms per call of the kernels launched in each span.
            "span_ms": span_ms,
            # Device ms per call on each stream.
            "device_ms_by_stream": {
                k: v / 1e3 / calls
                for k, v in device_us_by_stream(events).items()}}
