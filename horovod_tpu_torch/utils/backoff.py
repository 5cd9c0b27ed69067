"""Bounded exponential backoff with jitter — counterpart of
``horovod_tpu/utils/backoff.py``, kept line for line.

The one Python-side retry policy (the C++ core mirrors the same schedule
in ``core/src/controller.cc``'s ``Backoff``).  Deterministic for a given
``seed`` so tests can assert exact schedules; jitter is the standard
decorrelation trick (each delay is uniform in [base/2, base]) so N ranks
restarting together don't thundering-herd the coordinator.
"""

from __future__ import annotations

import random
import time
from typing import Callable, Iterator


class Backoff:
    """Yield bounded, jittered exponential delays.

    ``delays()`` produces ``attempts`` values: attempt k's base is
    ``initial_s * mult**k`` capped at ``max_s``; with jitter the emitted
    delay is uniform in ``[base/2, base]``.
    """

    def __init__(self, *, initial_s: float = 0.1, max_s: float = 30.0,
                 mult: float = 2.0, jitter: bool = True,
                 seed: int | None = None):
        if initial_s <= 0 or max_s < initial_s or mult < 1.0:
            raise ValueError(
                f"bad backoff policy: initial_s={initial_s}, max_s={max_s}, "
                f"mult={mult}")
        self.initial_s = initial_s
        self.max_s = max_s
        self.mult = mult
        self.jitter = jitter
        self._rng = random.Random(seed)

    def delay(self, attempt: int) -> float:
        base = min(self.initial_s * (self.mult ** attempt), self.max_s)
        if not self.jitter:
            return base
        return base / 2.0 + self._rng.random() * (base / 2.0)

    def delays(self, attempts: int) -> Iterator[float]:
        for k in range(attempts):
            yield self.delay(k)


def retry(fn: Callable, *, deadline_s: float,
          initial_s: float = 0.05, max_s: float = 2.0,
          retry_on: tuple[type[BaseException], ...] = (Exception,),
          sleep=time.sleep, clock=time.monotonic):
    """Call ``fn`` until it succeeds or ``deadline_s`` elapses.

    Between failures, sleep per the :class:`Backoff` schedule (never past
    the deadline).  The last exception propagates when the budget runs
    out — callers get the real error, not a retry wrapper.
    """
    policy = Backoff(initial_s=initial_s, max_s=max_s)
    start = clock()
    attempt = 0
    while True:
        try:
            return fn()
        except retry_on:
            left = deadline_s - (clock() - start)
            if left <= 0:
                raise
            sleep(min(policy.delay(attempt), left))
            attempt += 1
