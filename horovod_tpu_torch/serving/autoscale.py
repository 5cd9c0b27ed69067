"""Replica-count autoscaling policy — counterpart of the policy half of
``horovod_tpu/serving/autoscale.py``.

:class:`Autoscaler` is a pure decision function over the load a fleet
sees (queue depth, p99 TTFT): GROW when the backlog per replica or the
tail latency crosses its threshold, SHRINK after a sustained idle window,
both rate-limited by a cooldown and clamped to ``[min_replicas,
max_replicas]``.  The policy only *decides*; acting on a verdict (spawning
or retiring a replica) is the supervisor's job, which keeps the policy
deterministic and testable without processes.

Not ported yet, with fleet serving and the native control plane: the
AUTOSCALE timeline instants of ``collective=``, and the data-plane weight
motion (``ship_weights``, ``pull_weights``, ``poll_weights``, which ride
``replication.py``).
"""

from __future__ import annotations

import dataclasses
import time


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
    verdict, why)``."""

    def __init__(self, config: AutoscaleConfig | None = None,
                 clock=time.monotonic):
        self.config = config or AutoscaleConfig()
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
        return verdict
