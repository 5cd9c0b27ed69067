"""Multi-model serving router — counterpart of
``horovod_tpu/serving/router.py``: one admission point, N model fleets.

Every model's replica set sits behind one ``submit(model, prompt, ...)``
door.  Each model keeps its own queue-depth / p99 policy
(``serving/autoscale.py``), and :class:`RouterAutoscaler` rebalances a
shared replica budget between models: a pressured model can grow by
taking the seat of an idle one, not only by adding hardware.

* A replica is a plain :class:`~horovod_tpu_torch.serving.engine.
  ServingEngine`; prefix cache and speculation compose per engine.
  Replicas share nothing in-process (separate KV pools).
* The router only *decides* scale moves (:class:`RouterAutoscaler`
  verdicts); acting on them — :meth:`Router.add_replica` /
  :meth:`Router.remove_replica` for in-process fleets — is the
  supervisor's job.

``stats()`` reports per-model queue depth, occupancy, TTFT percentiles
and SLO attainment (the fraction of completions whose TTFT met the
model's ``slo_ttft_ms``).  Not ported yet, with fleet serving and the
native control plane: the JAX router's ``collective=`` (its AUTOSCALE
timeline instants).
"""

from __future__ import annotations

import dataclasses
import time
from collections import defaultdict

from horovod_tpu_torch.serving.autoscale import Autoscaler, AutoscaleConfig
from horovod_tpu_torch.serving.engine import (Request, ServingEngine,
                                              _pctile)

__all__ = ["ModelSpec", "Router", "RouterAutoscaler"]


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """One routable model: a name and its TTFT target in milliseconds,
    against which the router's attainment stat is judged."""

    name: str
    slo_ttft_ms: float = 100.0

    @staticmethod
    def from_env(name: str) -> "ModelSpec":
        from horovod_tpu_torch.utils import env

        return ModelSpec(name, slo_ttft_ms=env.serve_slo_ms())


class Router:
    """Admission and scheduling across heterogeneous model fleets."""

    def __init__(self, clock=time.monotonic):
        self.clock = clock
        self._specs: dict[str, ModelSpec] = {}
        self._engines: dict[str, list[ServingEngine]] = {}
        self._slo_ok: dict[str, int] = defaultdict(int)
        self._slo_total: dict[str, int] = defaultdict(int)
        self._completed: dict[str, list[Request]] = defaultdict(list)

    # -- topology -----------------------------------------------------

    def add_model(self, spec: ModelSpec, engines) -> None:
        if spec.name in self._specs:
            raise ValueError(f"model {spec.name!r} already registered")
        engines = list(engines)
        if not engines:
            raise ValueError(f"model {spec.name!r} needs >= 1 replica")
        self._specs[spec.name] = spec
        self._engines[spec.name] = engines

    def add_replica(self, model: str, engine: ServingEngine) -> None:
        self._engines[model].append(engine)

    def remove_replica(self, model: str) -> ServingEngine | None:
        """Retire the first drained replica of ``model``, never the last
        one: in-flight sequences hold KV that does not migrate."""
        engines = self._engines[model]
        if len(engines) <= 1:
            return None
        for i, eng in enumerate(engines):
            if not eng.queue and not eng._active_count():
                return engines.pop(i)
        return None

    def models(self) -> list[str]:
        return list(self._specs)

    def replicas(self, model: str) -> int:
        return len(self._engines[model])

    # -- request plane ------------------------------------------------

    def submit(self, model: str, prompt, max_new_tokens: int,
               **kw) -> Request:
        """Admit to the least-loaded replica of ``model`` (queue depth +
        active slots)."""
        if model not in self._engines:
            raise KeyError(f"unknown model {model!r}; "
                           f"registered: {sorted(self._specs)}")
        eng = min(self._engines[model],
                  key=lambda e: len(e.queue) + e._active_count())
        return eng.submit(prompt, max_new_tokens, **kw)

    def step(self) -> dict[str, list[Request]]:
        """One tick across every replica of every model; returns the
        completions per model and scores each against its model's SLO."""
        done: dict[str, list[Request]] = {}
        for name, engines in self._engines.items():
            out: list[Request] = []
            for eng in engines:
                out.extend(eng.step())
            slo_s = self._specs[name].slo_ttft_ms / 1e3
            for req in out:
                self._slo_total[name] += 1
                self._slo_ok[name] += (req.ttft_s is not None
                                       and req.ttft_s <= slo_s)
            self._completed[name].extend(out)
            done[name] = out
        return done

    def run_until_idle(self, max_steps: int = 100000) \
            -> dict[str, list[Request]]:
        for _ in range(max_steps):
            if all(not e.queue and not e._active_count()
                   for es in self._engines.values() for e in es):
                out, self._completed = dict(self._completed), \
                    defaultdict(list)
                return out
            self.step()
        raise RuntimeError(f"router did not drain within {max_steps} steps")

    # -- introspection ------------------------------------------------

    def stats(self) -> dict[str, dict]:
        out = {}
        for name, engines in self._engines.items():
            ttfts = [t for e in engines for t in e._ttft_s]
            total = self._slo_total[name]
            out[name] = {
                "replicas": len(engines),
                "queued": sum(len(e.queue) for e in engines),
                "active_slots": sum(e._active_count() for e in engines),
                "occupancy": sum(e._occupancy() for e in engines)
                / len(engines),
                "completed": sum(e.counters["completed"] for e in engines),
                "ttft_p50_ms": _pctile(ttfts, 50) * 1e3,
                "ttft_p99_ms": _pctile(ttfts, 99) * 1e3,
                "slo_ttft_ms": self._specs[name].slo_ttft_ms,
                "slo_attainment": (self._slo_ok[name] / total) if total
                else 1.0,
            }
        return out


class RouterAutoscaler:
    """Per-model queue / latency policies under one shared replica budget.

    Each model keeps its own :class:`Autoscaler`.  Arbitration happens
    only when the budget is exhausted: a model whose policy wants to GROW
    is paired with a model whose policy independently wants to SHRINK,
    and the verdict list carries both moves.  With budget headroom,
    verdicts pass through untouched."""

    def __init__(self, specs, budget: int,
                 config: AutoscaleConfig | None = None,
                 clock=time.monotonic):
        self.budget = budget
        self._policies = {
            s.name: Autoscaler(config or AutoscaleConfig(), clock=clock)
            for s in specs}
        self.decisions: list[tuple[str, str]] = []

    def decide(self, router: Router) -> list[tuple[str, str]]:
        """One arbitration round over live router state.  Returns
        ``[(model, "grow" | "shrink"), ...]`` for the supervisor to act
        on, in order (a shrink that funds a paired grow comes first)."""
        stats = router.stats()
        wants: dict[str, str] = {}
        for name, policy in self._policies.items():
            st = stats[name]
            verdict = policy.decide(
                replicas=st["replicas"], queued=st["queued"],
                active_slots=st["active_slots"],
                p99_ttft_ms=st["ttft_p99_ms"])
            if verdict is not None:
                wants[name] = verdict
        total = sum(st["replicas"] for st in stats.values())
        shrinks = [m for m, v in wants.items() if v == "shrink"]
        out: list[tuple[str, str]] = []
        for name, verdict in wants.items():
            if verdict != "grow":
                continue
            if total < self.budget:
                out.append((name, "grow"))
                total += 1
            elif shrinks:
                # Paired move: the donor's seat funds the grow, so the
                # fleet never exceeds the budget mid-transition.
                out.append((shrinks.pop(0), "shrink"))
                out.append((name, "grow"))
            # else: budget exhausted, nobody idle — the grow waits.
        out.extend((m, "shrink") for m in shrinks)
        self.decisions.extend(out)
        return out
