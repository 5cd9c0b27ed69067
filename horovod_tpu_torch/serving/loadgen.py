"""Open-loop Poisson load generator and latency report.

Open-loop means arrivals follow the clock, not the server: a request
lands every Exp(1/qps) seconds whether or not the engine has capacity,
so queueing delay shows up in TTFT instead of being hidden by a closed
feedback loop — the standard methodology for serving benchmarks.

The workload is deterministic from its seed (arrival times, prompt
lengths, output lengths), so continuous vs static batching — and a
replica that retries a request after a kill — see the byte-identical
request stream.  Output lengths are bimodal (mostly short, a long tail):
the mix that makes static batching pay for its drain barrier, because a
whole batch waits on its longest member while continuous batching
refills the freed slots.

Own copy of ``horovod_tpu/serving/loadgen.py``: the same workload from the
same seed gives the same request stream in both packages.
"""

from __future__ import annotations

import dataclasses
import random
import time

from horovod_tpu_torch.serving.engine import ServingEngine, _pctile


@dataclasses.dataclass(frozen=True)
class Workload:
    qps: float = 20.0
    duration_s: float = 3.0
    seed: int = 0
    # Prompt lengths drawn uniformly from this menu — sized to exercise
    # several prefill buckets.
    prompt_lens: tuple[int, ...] = (6, 14, 30, 60)
    # Bimodal output lengths: long_frac of requests run long.
    short_new: int = 4
    long_new: int = 64
    long_frac: float = 0.1
    vocab: int = 256
    # Shared-system-prompt traffic: this fraction of arrivals opens with
    # the same deterministic shared_prefix_len-token prefix (then a
    # random tail drawn from prompt_lens as usual) — the mix that makes
    # a prefix cache pay.  0.0 keeps every prompt fully random.
    shared_frac: float = 0.0
    shared_prefix_len: int = 0


def make_arrivals(w: Workload) -> list[tuple[float, list[int], int]]:
    """``[(arrival_t, prompt, max_new_tokens), ...]`` — pure function of
    the workload, shared by every mode/replica being compared."""
    rng = random.Random(w.seed)
    # The shared system prompt is a function of the seed alone, not of
    # the arrival sequence — every replica (and every cache-on/off
    # comparison run) sees the identical prefix bytes.
    srng = random.Random(w.seed ^ 0x5EED)
    shared = [srng.randrange(1, w.vocab) for _ in range(w.shared_prefix_len)]
    out, t = [], 0.0
    while True:
        t += rng.expovariate(w.qps)
        if t >= w.duration_s:
            return out
        n = rng.choice(w.prompt_lens)
        prompt = [rng.randrange(1, w.vocab) for _ in range(n)]
        if shared and rng.random() < w.shared_frac:
            prompt = shared + prompt
        max_new = w.long_new if rng.random() < w.long_frac else w.short_new
        out.append((t, prompt, max_new))


def run_load(engine: ServingEngine, workload: Workload,
             max_wall_s: float | None = None) -> dict:
    """Drive one engine through the workload in real time and report.

    Steps the engine whenever work exists, sleeps to the next arrival
    otherwise; stops when every arrival has been submitted and the engine
    drained (or at ``max_wall_s``, reported as ``timed_out``)."""
    arrivals = make_arrivals(workload)
    clock = engine.clock
    t0 = clock()
    done, i, timed_out = [], 0, False
    while True:
        now = clock() - t0
        while i < len(arrivals) and arrivals[i][0] <= now:
            engine.submit(arrivals[i][1], arrivals[i][2])
            i += 1
        if i >= len(arrivals) and not engine.queue \
                and engine._active_count() == 0:
            break
        if max_wall_s is not None and now > max_wall_s:
            timed_out = True
            break
        if engine.queue or engine._active_count():
            done.extend(engine.step())
        else:
            time.sleep(min(0.005, max(0.0, arrivals[i][0] - now)))
    wall = max(clock() - t0, 1e-9)
    return report(done, wall, offered=len(arrivals), timed_out=timed_out)


def report(done, wall_s: float, offered: int = 0,
           timed_out: bool = False) -> dict:
    """Latency/throughput summary over completed requests — the headline
    row format docs/benchmarks.md "Serving" records."""
    ttft = [r.ttft_s for r in done if r.ttft_s is not None]
    tok = [s for r in done for s in r.token_lat_s]
    tokens = sum(len(r.tokens) for r in done)
    return {
        "offered": offered, "completed": len(done), "tokens": tokens,
        "wall_s": wall_s, "tokens_per_s": tokens / wall_s,
        "ttft_p50_ms": _pctile(ttft, 50) * 1e3,
        "ttft_p99_ms": _pctile(ttft, 99) * 1e3,
        "token_p50_ms": _pctile(tok, 50) * 1e3,
        "token_p99_ms": _pctile(tok, 99) * 1e3,
        "timed_out": timed_out,
    }
