"""Elastic autoscaling for the serving fleet — counterpart of
``horovod_tpu/serving/autoscale.py``.

* **Policy** (:class:`Autoscaler`) — a pure decision function over the
  load a fleet sees (queue depth, p99 TTFT; in a fleet, the aggregates of
  the ``serving.tick`` collective): GROW when the backlog per replica or
  the tail latency crosses its threshold, SHRINK after a sustained idle
  window, both rate-limited by a cooldown and clamped to
  ``[min_replicas, max_replicas]``.  With ``collective=`` each verdict
  also lands as an AUTOSCALE instant on the engine's timeline.  The
  policy only *decides*; acting on a verdict (spawning or retiring a
  replica) is the supervisor's job (``serving/soak.py``), which keeps the
  policy deterministic and testable without processes.
* **Weight motion** — a freshly joined replica pulls the model from a
  ring neighbour's host memory over the bulk data plane instead of disk:
  the donor ships one complete snapshot blob (:func:`ship_weights`, over
  :func:`replication.ship_blob`), the joiner drains its shard inbox until
  the blob is whole (:func:`pull_weights`).  The same path hot-swaps a
  newer version into live replicas (:func:`poll_weights`).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any

from horovod_tpu_torch import replication


@dataclasses.dataclass(frozen=True)
class AutoscaleConfig:
    """Thresholds; :func:`from_env` reads the ``HVD_TPU_SERVE_*`` table
    (``utils/env.py``)."""

    min_replicas: int = 1
    max_replicas: int = 8
    # GROW above this many queued requests per replica...
    queue_high: float = 16.0
    # ...or above this p99 TTFT (0 disables the latency trigger).
    p99_high_ms: float = 500.0
    # SHRINK after this long with an empty queue and idle slots.
    idle_s: float = 5.0
    # Minimum seconds between decisions, so the policy does not flap.
    cooldown_s: float = 2.0

    @staticmethod
    def from_env(**overrides) -> "AutoscaleConfig":
        from horovod_tpu_torch.utils import env

        base = dict(min_replicas=env.serve_min_replicas(),
                    max_replicas=env.serve_max_replicas(),
                    queue_high=env.serve_queue_high(),
                    p99_high_ms=env.serve_p99_ms(),
                    idle_s=env.serve_idle_s(),
                    cooldown_s=env.serve_cooldown_s())
        base.update(overrides)
        return AutoscaleConfig(**base)


class Autoscaler:
    """Queue-depth / p99-latency replica-count policy.

    Call :meth:`decide` once per serving tick with the current replica
    count and observed load; it returns ``"grow"``, ``"shrink"`` or
    ``None``, and appends each verdict to :attr:`decisions` as ``(time,
    verdict, why)``; with a collective engine attached, each verdict also
    lands as an AUTOSCALE timeline instant."""

    def __init__(self, config: AutoscaleConfig | None = None,
                 collective=None, clock=time.monotonic):
        self.config = config or AutoscaleConfig()
        self.collective = collective
        self.clock = clock
        self._last_decision_t = -1e9
        self._idle_since: float | None = None
        self.decisions: list[tuple[float, str, str]] = []

    def decide(self, replicas: int, queued: float, active_slots: float,
               p99_ttft_ms: float = 0.0) -> str | None:
        cfg, now = self.config, self.clock()
        if queued > 0 or active_slots > 0:
            self._idle_since = None
        elif self._idle_since is None:
            self._idle_since = now
        if now - self._last_decision_t < cfg.cooldown_s:
            return None
        verdict, why = None, ""
        if replicas < cfg.max_replicas and (
                queued / max(replicas, 1) > cfg.queue_high
                or (cfg.p99_high_ms > 0 and p99_ttft_ms > cfg.p99_high_ms)):
            verdict = "grow"
            why = (f"queued={queued:.0f}/{replicas}r "
                   f"p99={p99_ttft_ms:.0f}ms")
        elif replicas > cfg.min_replicas and self._idle_since is not None \
                and now - self._idle_since >= cfg.idle_s:
            verdict, why = "shrink", f"idle={now - self._idle_since:.1f}s"
        if verdict is None:
            return None
        self._last_decision_t = now
        self._idle_since = None
        self.decisions.append((now, verdict, why))
        if self.collective is not None:
            self.collective.timeline_instant(
                "AUTOSCALE", f"{verdict} replicas={replicas} {why}")
        return verdict


# -- data-plane weight motion ------------------------------------------------


def ship_weights(eng, dst: int, version: int, state: Any,
                 metadata: dict | None = None) -> str | None:
    """Donor side: encode ``state`` (a tree of numpy arrays or torch
    tensors, a ``state_dict`` say) and stream it to rank ``dst`` over the
    bulk data plane (relay fallback).  Returns the transport used
    ("direct"/"relay") or None when both paths failed."""
    blob = replication.encode_snapshot(version, state, metadata)
    return replication.ship_blob(eng, dst, version, blob)


def pull_weights(eng, timeout_s: float = 30.0, min_version: int = 0,
                 device=None) -> dict | None:
    """Joiner side: drain the shard inbox until a complete snapshot at
    ``version >= min_version`` lands, then decode it with its tensors on
    ``device`` — host memory to host memory, no disk.  Returns ``{"step",
    "state", "metadata"}`` or None on timeout."""
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        replication.drain(eng)
        snap = replication.restore_local(eng.epoch, device)
        if snap is not None and snap["step"] >= min_version:
            return snap
        time.sleep(0.02)
    return None


def poll_weights(eng, current_version: int, device=None) -> dict | None:
    """Hot-swap poll, called between serving steps: absorb anything the
    donor shipped and return a decoded snapshot strictly newer than
    ``current_version``, else None.  Swapping is the caller's one-liner
    (``backend.swap_params``): shapes don't change, in-flight sequences
    keep their KV."""
    replication.drain(eng)
    snap = replication.restore_local(eng.epoch, device)
    if snap is not None and snap["step"] > current_version:
        return snap
    return None
