"""Readings of the program's own spans: the ``record_function`` ranges that
``horovod_tpu_torch`` opens at its layer boundaries
(``utils/profiling.span``: ``train.forward``, ``serve.decode``, ...), in
the same profiler trace as the kernels.

A span's device work is the device events whose launching runtime call
falls inside it in time, on any thread of the span's process: the
autograd engine launches a backward's kernels from its own thread while
the thread that opened ``train.backward`` waits in ``backward()``.  A
span's device idle time is its wall less the part of it that the device's
busy union overlaps.  Each reader returns None where the trace has no such
span, as a program without them gives, or no device work."""

from __future__ import annotations

import bisect
from collections import defaultdict

from perfbench import tracing


def spans(events, name: str) -> list[dict]:
    return [e for e in tracing.cpu_ops(events) if e["name"] == name]


def pieces(evs) -> dict:
    """``{pid: [(start, end), ...]}``: the union of the spans' intervals
    in each process, as sorted disjoint pieces."""
    by_pid = defaultdict(list)
    for e in evs:
        by_pid[e.get("pid")].append(e)
    return {pid: tracing.merged(es) for pid, es in by_pid.items()}


def _within(cover):
    """A test ``(pid, ts) -> bool``: does ``ts`` fall inside one of the
    pieces ``cover`` (as :func:`pieces` gives them) of process ``pid``?"""
    starts = {pid: [a for a, _ in p] for pid, p in cover.items()}

    def test(pid, ts) -> bool:
        p = cover.get(pid)
        if not p:
            return False
        i = bisect.bisect_right(starts[pid], ts) - 1
        return i >= 0 and ts <= p[i][1]
    return test


def inside(evs, outer) -> list[dict]:
    """The spans of ``evs`` that start inside one of ``outer``'s."""
    test = _within(pieces(outer))
    return [e for e in evs if test(e.get("pid"), e["ts"])]


def launched_in(events, evs) -> list[dict]:
    """The device events whose launch falls inside one of the spans
    ``evs``, by time, on any thread of the span's process."""
    test = _within(pieces(evs))
    launch = {e["args"]["correlation"]: e for e in events
              if e.get("cat") in ("cuda_runtime", "cuda_driver")
              and "correlation" in e.get("args", {})}
    out = []
    for d in tracing.device_events(events):
        r = launch.get(d.get("args", {}).get("correlation"))
        if r is not None and test(r.get("pid"), r["ts"]):
            out.append(d)
    return out


def device_ms(events, evs, per: float):
    """Device time (the busy union) of the work launched inside the spans
    ``evs``, over ``per`` (ms); None without spans or device work."""
    if not evs or not per:
        return None
    dev = launched_in(events, evs)
    if not dev:
        return None
    return tracing.busy_us(dev) / 1e3 / per


def idle_ms(events, intervals, per: float):
    """The device's idle time inside ``intervals`` (``[(start, end)]``,
    disjoint), over ``per`` (ms); None without intervals or device
    work."""
    dev = tracing.device_events(events)
    if not intervals or not dev or not per:
        return None
    cover = [{"ts": a, "dur": b - a} for a, b in intervals]
    wall = sum(b - a for a, b in intervals)
    return (wall - tracing.covered_us(dev, cover)) / 1e3 / per


def minus(a, b) -> list[tuple[float, float]]:
    """The sorted disjoint pieces ``a`` less the sorted disjoint pieces
    ``b``."""
    out, j = [], 0
    for lo, hi in a:
        while j < len(b) and b[j][1] <= lo:
            j += 1
        k, cur = j, lo
        while k < len(b) and b[k][0] < hi:
            if b[k][0] > cur:
                out.append((cur, b[k][0]))
            cur = max(cur, b[k][1])
            k += 1
        if cur < hi:
            out.append((cur, hi))
    return out


def train_cell(t, family: str) -> bool:
    return t.get("family") == family and t.get("phase") == "train"


def train_device_ms(t, family: str, *names):
    """Device ms a step of the work launched inside the spans ``names`` of
    a ``family`` training trace."""
    if not train_cell(t, family):
        return None
    evs = [e for n in names for e in spans(t["events"], n)]
    return device_ms(t["events"], evs, t["steps"])


def serve_decode_ms(t, name: str | None = None):
    """Device ms a decode of the work launched inside the ``serve.decode``
    spans, or with ``name`` inside that span's ranges within them."""
    if t.get("phase") != "serve":
        return None
    decodes = spans(t["events"], "serve.decode")
    evs = decodes if name is None else \
        inside(spans(t["events"], name), decodes)
    return device_ms(t["events"], evs, len(decodes))
