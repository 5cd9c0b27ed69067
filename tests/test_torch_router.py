"""Port's multi-model router and autoscaling policy against the JAX
package's.

Each scenario of ``tests/test_serving.py``'s router and autoscaler tests
runs twice on stub-backed engines, once over the JAX classes and once over
the port's, with the same fake clock; the verdicts and ``stats()`` must be
equal, and the scenario's own asserts hold on both.
"""

import types
import warnings

import pytest

from horovod_tpu.serving import autoscale as jauto
from horovod_tpu.serving import engine as jeng
from horovod_tpu.serving import router as jrouter
from horovod_tpu_torch.serving import autoscale as tauto
from horovod_tpu_torch.serving import engine as teng
from horovod_tpu_torch.serving import router as trouter

JAX = types.SimpleNamespace(eng=jeng, auto=jauto, router=jrouter)
PORT = types.SimpleNamespace(eng=teng, auto=tauto, router=trouter)


class Clock:
    """Advances by ``tick`` seconds on every read, so TTFTs depend only on
    how many times the code under test reads it."""

    def __init__(self, tick: float = 0.0):
        self.t, self.tick = 0.0, tick

    def __call__(self) -> float:
        self.t += self.tick
        return self.t


def _engine(pkg, clock, slots=2):
    return pkg.eng.ServingEngine(
        pkg.eng.StubBackend(slots),
        pkg.eng.ServingConfig(num_slots=slots, buckets=(8,),
                              max_seq_len=64), clock=clock)


def _routing(pkg):
    clock = Clock(tick=0.004)
    router = pkg.router.Router(clock=clock)
    spec = pkg.router.ModelSpec
    router.add_model(spec("chat", slo_ttft_ms=1000.0),
                     [_engine(pkg, clock), _engine(pkg, clock)])
    router.add_model(spec("code", slo_ttft_ms=50.0), [_engine(pkg, clock)])
    with pytest.raises(KeyError):
        router.submit("nope", [1], 1)
    with pytest.raises(ValueError, match="already registered"):
        router.add_model(spec("chat"), [_engine(pkg, clock)])
    with pytest.raises(ValueError, match="replica"):
        router.add_model(spec("empty"), [])
    for i in range(6):
        router.submit("chat" if i % 2 else "code", [1, 2, i], 4)
    mid = router.stats()
    done = router.run_until_idle()
    st = router.stats()
    assert st["chat"]["completed"] == 3 and st["code"]["completed"] == 3
    assert st["chat"]["slo_attainment"] == 1.0
    # Three code requests through one 2-slot replica: the queued one
    # misses the 50 ms target.
    assert st["code"]["slo_attainment"] == 2 / 3
    # Least-loaded admission spread chat across both replicas.
    per_replica = [e.counters["completed"] for e in router._engines["chat"]]
    assert all(n >= 1 for n in per_replica)
    tokens = {m: [r.tokens for r in reqs] for m, reqs in done.items()}
    return mid, st, per_replica, tokens, router.models(), \
        router.replicas("chat")


def _remove_replica(pkg):
    clock = Clock()
    router = pkg.router.Router(clock=clock)
    spec = pkg.router.ModelSpec
    busy, idle = _engine(pkg, clock), _engine(pkg, clock)
    router.add_model(spec("chat"), [busy, idle])
    router.add_model(spec("code"), [_engine(pkg, clock)])
    busy.submit([1, 2], 4)
    # The last seat of a model is never retired; only a drained one is.
    assert router.remove_replica("code") is None
    assert router.remove_replica("chat") is idle
    assert router.remove_replica("chat") is None
    router.add_replica("chat", idle)
    return router.replicas("chat"), router.replicas("code")


def _router_autoscaler(pkg):
    clock = Clock()
    specs = [pkg.router.ModelSpec("chat"), pkg.router.ModelSpec("code")]
    router = pkg.router.Router(clock=clock)
    router.add_model(specs[0], [_engine(pkg, clock)])
    router.add_model(specs[1], [_engine(pkg, clock), _engine(pkg, clock)])
    for _ in range(20):              # chat is pressured, code fully idle
        router.submit("chat", [1, 2], 4)
    t = [0.0]
    cfg = pkg.auto.AutoscaleConfig(min_replicas=1, max_replicas=4,
                                   queue_high=4.0, idle_s=1.0,
                                   cooldown_s=0.0)
    auto = pkg.router.RouterAutoscaler(specs, budget=3, config=cfg,
                                       clock=lambda: t[0])
    # Budget full, the donor's idle window not yet elapsed: the grow waits.
    first = auto.decide(router)
    assert first == []
    t[0] += 2.0
    # Now code's policy wants to shrink: its seat moves to chat.
    second = auto.decide(router)
    assert second == [("code", "shrink"), ("chat", "grow")]
    # With headroom in the budget a grow passes through alone.
    roomy = pkg.router.RouterAutoscaler(specs, budget=8, config=cfg,
                                        clock=lambda: t[0])
    third = roomy.decide(router)
    assert ("chat", "grow") in third
    return first, second, third, auto.decisions, router.stats()


def _autoscaler(pkg):
    t = [0.0]
    auto = pkg.auto.Autoscaler(pkg.auto.AutoscaleConfig(
        min_replicas=1, max_replicas=3, queue_high=4.0, idle_s=1.0,
        cooldown_s=10.0), clock=lambda: t[0])
    out = [auto.decide(1, queued=40, active_slots=8)]
    assert out[-1] == "grow"
    t[0] += 1.0                       # within the cooldown: no flapping
    out.append(auto.decide(2, queued=40, active_slots=8))
    assert out[-1] is None
    t[0] += 20.0
    out.append(auto.decide(3, queued=400, active_slots=8))   # at the cap
    assert out[-1] is None
    for _ in range(60):               # idle long enough to shrink
        t[0] += 0.5
        d = auto.decide(3, queued=0, active_slots=0)
        if d is not None:
            break
    out.append(d)
    assert d == "shrink"
    t[0] += 100.0
    out.append(auto.decide(1, queued=0, active_slots=0))     # at the floor
    assert out[-1] is None
    t[0] += 100.0
    out.append(auto.decide(2, queued=0, active_slots=1,
                           p99_ttft_ms=900.0))                # latency grow
    assert out[-1] == "grow"
    return out, auto.decisions


@pytest.mark.parametrize("scenario", [_routing, _remove_replica,
                                      _router_autoscaler, _autoscaler])
def test_scenario_matches_jax(scenario):
    assert scenario(PORT) == scenario(JAX)


def test_tick_name_default_and_per_model():
    assert teng.ServingEngine.TICK_NAME == jeng.ServingEngine.TICK_NAME
    for name in (None, "serving.tick.chat"):
        port = teng.ServingEngine(teng.StubBackend(1), tick_name=name)
        ref = jeng.ServingEngine(jeng.StubBackend(1), tick_name=name)
        assert port.tick_name == ref.tick_name


@pytest.mark.parametrize("env", [
    {}, {"HVD_TPU_SERVE_QUEUE_HIGH": "3", "HVD_TPU_SERVE_P99_MS": "0",
         "HVD_TPU_SERVE_IDLE_S": "1.5", "HVD_TPU_SERVE_MIN_REPLICAS": "2",
         "HVD_TPU_SERVE_MAX_REPLICAS": "5", "HVD_TPU_SERVE_COOLDOWN_S": "x",
         "HVD_TPU_SERVE_SLO_MS": "250"}])
def test_configs_from_env_match_jax(monkeypatch, env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert vars(tauto.AutoscaleConfig.from_env(cooldown_s=1.0)) == \
            vars(jauto.AutoscaleConfig.from_env(cooldown_s=1.0))
        assert vars(tauto.AutoscaleConfig.from_env()) == \
            vars(jauto.AutoscaleConfig.from_env())
        assert vars(trouter.ModelSpec.from_env("chat")) == \
            vars(jrouter.ModelSpec.from_env("chat"))
