"""The traced window and the reduction of its profiler trace.

A kind runs its traced window inside :class:`Window`: ``torch.profiler``
(CPU and CUDA activities) around the same loop the untraced run times,
with the window's wall taken by the host clock between two device
synchronisations, so the device's busy time and the wall come from one
window.  The trace goes to a temporary file under ``TMPDIR`` and is read
back as Chrome trace events.

The interval arithmetic (``busy_us``, the launching-op attribution of
:func:`ops_of_kernels` and the span attribution) is a frozen copy of the program's
``horovod_tpu_torch/utils/trace.py``, extended to attribute a span's
autograd backward nodes to it (by the sequence numbers the profiler gives
a forward op and the backward node it made) and to name the device's idle
gaps by the host op that was running.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
import time
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
BACKWARD_PREFIX = "autograd::engine::evaluate_function: "
WINDOW_MARK = "perfbench.window"


def busy_us(events) -> float:
    """Length of the union of the events' intervals."""
    total, end = 0.0, float("-inf")
    for e in sorted(events, key=lambda e: e["ts"]):
        lo, hi = e["ts"], e["ts"] + e["dur"]
        if hi > end:
            total += hi - max(lo, end)
            end = hi
    return total


def merged(events) -> list[tuple[float, float]]:
    """The union of the events' intervals as sorted disjoint pieces."""
    out: list[list[float]] = []
    for e in sorted(events, key=lambda e: e["ts"]):
        lo, hi = e["ts"], e["ts"] + e["dur"]
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return [(a, b) for a, b in out]


def covered_us(events, cover) -> float:
    """Time of ``events``' union that ``cover``'s union overlaps."""
    a, b = merged(events), merged(cover)
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def device_events(events) -> list[dict]:
    return [e for e in events
            if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]


def kernels(events) -> list[dict]:
    return [e for e in events if e.get("ph") == "X"
            and e.get("cat") == "kernel"]


def cpu_ops(events) -> list[dict]:
    return [e for e in events if e.get("ph") == "X"
            and e.get("cat") in ("cpu_op", "user_annotation")]


def _launches(events) -> dict:
    return {e["args"]["correlation"]: e for e in events
            if e.get("cat") in ("cuda_runtime", "cuda_driver")
            and "correlation" in e.get("args", {})}


def launched_within(events, intervals_by_thread) -> list[dict]:
    """The device events whose launch (the runtime call their
    "correlation" names) falls in one of the host intervals, given as
    ``{(pid, tid): [(start, end), ...]}``."""
    launch = _launches(events)
    out = []
    for e in device_events(events):
        r = launch.get(e.get("args", {}).get("correlation"))
        if r is None:
            continue
        for lo, hi in intervals_by_thread.get((r.get("pid"), r.get("tid")),
                                              ()):
            if lo <= r["ts"] <= hi:
                out.append(e)
                break
    return out


def span_device_events(events, name: str, backward: bool = True):
    """The device events of the work in ``record_function`` spans called
    ``name``: those launched inside a span, and with ``backward`` those
    launched by the autograd backward nodes that the ops inside a span
    made (matched by the profiler's "Sequence number")."""
    ops = cpu_ops(events)
    spans = [e for e in ops if e["name"] == name]
    inside: dict = defaultdict(list)
    seqs = set()
    for s in spans:
        inside[(s.get("pid"), s.get("tid"))].append(
            (s["ts"], s["ts"] + s["dur"]))
    if backward:
        for e in ops:
            seq = e.get("args", {}).get("Sequence number")
            if seq is None or e["name"].startswith(BACKWARD_PREFIX):
                continue
            for lo, hi in inside.get((e.get("pid"), e.get("tid")), ()):
                if lo <= e["ts"] <= hi:
                    seqs.add(seq)
                    break
        for e in ops:
            if e["name"].startswith(BACKWARD_PREFIX) and \
                    e.get("args", {}).get("Sequence number") in seqs:
                inside[(e.get("pid"), e.get("tid"))].append(
                    (e["ts"], e["ts"] + e["dur"]))
    return launched_within(events, inside)


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
    trace, by the "External id" of the op that launched it (directly, or
    through the runtime call its "correlation" names); ``"?"`` where the
    trace links it to no op."""
    ops = launching_ops(events)
    runtime = {e["args"]["correlation"]: e["args"].get("External id")
               for e in events
               if e.get("cat") in ("cuda_runtime", "cuda_driver")
               and "correlation" in e.get("args", {})}
    out = []
    for e in device_events(events):
        args = e.get("args", {})
        ext = args.get("External id")
        if ext not in ops:
            ext = runtime.get(args.get("correlation"))
        op, root = ops.get(ext, ("?", "?"))
        out.append((e, op, root))
    return out


def idle_gaps(events, lo: float, hi: float, top: int = 10):
    """The device's idle time inside ``[lo, hi]`` (µs), by what the host
    was doing: each gap between busy pieces is named by the innermost
    host op open at its middle on the thread that launched most work
    (``"host"`` where none but the window's own mark is open).
    ``[[name, seconds], ...]``, the longest first."""
    dev = device_events(events)
    pieces = [p for p in merged(dev) if p[1] > lo and p[0] < hi]
    launch = _launches(events)
    counts: dict = defaultdict(int)
    for e in dev:
        r = launch.get(e.get("args", {}).get("correlation"))
        if r is not None:
            counts[(r.get("pid"), r.get("tid"))] += 1
    main = max(counts, key=counts.get) if counts else None
    ops = sorted((e for e in cpu_ops(events)
                  if (e.get("pid"), e.get("tid")) == main),
                 key=lambda e: e["ts"])
    gaps, prev = [], lo
    for a, b in pieces:
        if a > prev:
            gaps.append((prev, min(a, hi)))
        prev = max(prev, b)
    if prev < hi:
        gaps.append((prev, hi))
    # Ops of one thread nest: each op's parent is the innermost op open
    # at its start, and the innermost op open at a gap's middle is the
    # last op started before it or one of that op's ancestors.
    starts = [e["ts"] for e in ops]
    parent, stack = [], []
    for i, e in enumerate(ops):
        while stack and ops[stack[-1]]["ts"] + ops[stack[-1]]["dur"] \
                < e["ts"]:
            stack.pop()
        parent.append(stack[-1] if stack else -1)
        stack.append(i)
    out: dict = defaultdict(float)
    for a, b in gaps:
        mid, name = (a + b) / 2, "host"
        i = bisect.bisect_right(starts, mid) - 1
        while i >= 0:
            if ops[i]["ts"] + ops[i]["dur"] >= mid:
                if ops[i]["name"] != WINDOW_MARK:
                    name = ops[i]["name"]
                break
            i = parent[i]
        out[name] += (b - a) / 1e6
    return sorted(([k, v] for k, v in out.items()),
                  key=lambda kv: -kv[1])[:top]


def top_device_ops(events, top: int = 10):
    """``[[kernel name, seconds], ...]``: the device operations that took
    most time, summed by name."""
    out: dict = defaultdict(float)
    for e in device_events(events):
        out[e["name"][:120]] += e["dur"] / 1e6
    return sorted(([k, v] for k, v in out.items()),
                  key=lambda kv: -kv[1])[:top]


class Window:
    """A traced window: ``with Window(device) as w: <loop>``; then
    ``w.events`` (the trace's events), ``w.window_s`` (host wall between
    the synchronisations that open and close it), ``w.busy_s`` (union of
    the device's kernel, copy and fill intervals inside it) and
    ``w.lo``/``w.hi`` (its bounds on the trace's clock, µs)."""

    def __init__(self, device):
        self.device = device
        self.events: list[dict] = []

    def _sync(self):
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def __enter__(self):
        import torch

        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.__enter__()
        self._sync()
        self._mark = torch.autograd.profiler.record_function(
            WINDOW_MARK)
        self._mark.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._sync()
        self.window_s = time.perf_counter() - self._t0
        self._mark.__exit__(None, None, None)
        self._prof.__exit__(*exc)
        if exc[0] is not None:
            return False
        fd, path = tempfile.mkstemp(suffix=".trace.json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                self.events = json.load(f)["traceEvents"]
        finally:
            os.remove(path)
        marks = [e for e in cpu_ops(self.events)
                 if e["name"] == WINDOW_MARK]
        if marks:
            self.lo = marks[0]["ts"]
            self.hi = marks[0]["ts"] + marks[0]["dur"]
        else:
            self.lo, self.hi = 0.0, float("inf")
        dev = [e for e in device_events(self.events)
               if e["ts"] + e["dur"] > self.lo and e["ts"] < self.hi]
        clipped = [{"ts": max(e["ts"], self.lo),
                    "dur": min(e["ts"] + e["dur"], self.hi)
                    - max(e["ts"], self.lo)} for e in dev]
        self.busy_s = busy_us(clipped) / 1e6
        return False

    def breakdown(self) -> dict:
        return {"device_ops": top_device_ops(self.events),
                "idle_gaps": idle_gaps(self.events, self.lo, self.hi)}
