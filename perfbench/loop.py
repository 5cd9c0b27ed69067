"""What the training kinds share: the timed window over a step, and
freeing the device between the program and the reference."""

from __future__ import annotations

import contextlib
import gc
import time

import torch

from perfbench import tracing


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def free(device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def peak_bytes(device) -> int:
    return torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0


def spanned(fn, name):
    """``fn`` inside a ``record_function`` span called ``name``."""
    def call(*args, **kwargs):
        with torch.autograd.profiler.record_function(name):
            return fn(*args, **kwargs)
    return call


def window(step, seconds: float, device, trace: bool, steps=None):
    """Run ``step(i)`` for i = 0, 1, ... until ``seconds`` have passed on
    the host clock (or, with ``steps``, that many times), from one device
    synchronisation to another after the last step, inside a traced
    :class:`tracing.Window` when ``trace``.
    Each step returns its loss; a loss that is not finite counts as a
    failed step.  Returns ``(steps, wall seconds, failed, window)``."""
    bad = torch.zeros((), dtype=torch.int64, device=device)
    w = tracing.Window(device) if trace else contextlib.nullcontext()
    sync(device)
    n = 0
    with w:
        t0 = time.perf_counter()
        while True:
            loss = step(n)
            bad += (~torch.isfinite(loss)).long()
            n += 1
            if n == steps or steps is None and \
                    time.perf_counter() - t0 >= seconds:
                break
        sync(device)
        wall = time.perf_counter() - t0
    if trace:
        return n, w.window_s, int(bad), w
    return n, wall, int(bad), None
