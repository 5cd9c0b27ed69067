"""Kind ``serve_decoder``: the program's continuous-batching engine,
``ServingEngine`` over ``TransformerBackend``, under a closed loop of
clients.

Set-up builds the program's ``Transformer`` with the seed's weights in
bf16, the backend's per-slot cache and the engine; runs a prefill at
every bucket of the menu and a decode, which warms every shape; then
starts the clients.  Each client sends its next request when its last
completes.  The requests' lengths are a fixed multiset drawn once from
the mix's ``length_seed`` (log-normal prompt and output lengths, clipped;
prompt and output within a slot), taken in an order drawn from
``--seed``, with token ids from ``--seed``, so every seed serves the
same work in another order.  The window opens at the step that brings
the ``warm_completions``-th completion, so the opening burst of prefills
falls in set-up, and closes at the first step that returns
``--seconds`` later.

``serve_tokens_per_s`` is every output token the steps of the window
returned, over the window's wall.  With ``--trace 1`` the same window
runs untraced first, for the time to first token's tail (the 95th
percentile, nearest rank, of the time from a request's submission to the
``step()`` return that first shows its token, over every request whose
first token falls in the window), and then a traced window of
``trace_seconds``, in which the backend's calls are timed.

Correctness: once the window has closed, a sample of the requests
finished in the window, drawn from the seed, the longest among them,
until ``check_requests`` requests and ``check_tokens`` served tokens are
covered; the plain reference runs
once over each prompt and its served tokens, and the number is the
widest gap by which a served token's logit lies below the reference's
best at its position (greedy decoding serves the program's best).

Traffic parameters: ``slots``, ``clients``, ``max_seq_len``, ``buckets``,
``prompt`` and ``output`` (``median``, ``sigma``, ``min``, ``max``),
``requests`` (the multiset's size), ``length_seed``,
``warm_completions``, ``check_requests``, ``check_tokens``,
``trace_seconds``."""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from perfbench import compare, loop
from perfbench.harness import log
from perfbench.models import decoder


def lengths(traffic: dict) -> list[tuple[int, int]]:
    """The mix's fixed multiset of ``(prompt, output)`` lengths."""
    rng = np.random.default_rng(traffic["length_seed"])
    n, cap = traffic["requests"], traffic["max_seq_len"]
    out = []
    p, o = traffic["prompt"], traffic["output"]
    ps = rng.lognormal(math.log(p["median"]), p["sigma"], n)
    os_ = rng.lognormal(math.log(o["median"]), o["sigma"], n)
    for a, b in zip(ps, os_):
        pl = int(min(max(round(a), p["min"]), p["max"]))
        ol = int(min(max(round(b), o["min"]), o["max"], cap - pl))
        out.append((pl, ol))
    return out


class Requests:
    """The seed's order of the multiset, and each request's token ids
    drawn from the seed as it is taken."""

    def __init__(self, traffic: dict, vocab: int, seed: int):
        self.items = lengths(traffic)
        self.rng = np.random.default_rng(seed)
        self.order = self.rng.permutation(len(self.items))
        self.vocab = vocab
        self.next = 0

    def take(self) -> tuple[list[int], int]:
        pl, ol = self.items[self.order[self.next % len(self.order)]]
        self.next += 1
        return self.rng.integers(0, self.vocab, pl).tolist(), ol


class Timed:
    """Host wall and count of a backend call, summed while ``on``."""

    def __init__(self, fn):
        self.fn, self.on, self.seconds, self.calls = fn, False, 0.0, 0

    def __call__(self, *args, **kwargs):
        t = time.perf_counter()
        out = self.fn(*args, **kwargs)
        if self.on:
            self.seconds += time.perf_counter() - t
            self.calls += 1
        return out


def nearest_rank(xs, q: float) -> float:
    xs = sorted(xs)
    return xs[max(0, math.ceil(q / 100.0 * len(xs)) - 1)]


def build_engine(cfg, traffic, seed, device):
    from horovod_tpu_torch.serving.engine import (ServingConfig,
                                                  ServingEngine,
                                                  TransformerBackend)

    model = decoder.build(cfg, seed, device, train=False)
    backend = TransformerBackend(model, traffic["slots"],
                                 traffic["max_seq_len"])
    engine = ServingEngine(backend, ServingConfig(
        num_slots=traffic["slots"], buckets=tuple(traffic["buckets"]),
        max_seq_len=traffic["max_seq_len"], eos_id=None))
    return model, backend, engine


def release_engine() -> None:
    """Drop the program's reference to its last engine (and so to the
    model and the cache), before the reference needs the memory."""
    from horovod_tpu_torch.serving import engine

    engine._ACTIVE = None


def warm(backend, traffic) -> None:
    """A prefill at every bucket into slot 0 and a decode of every slot:
    each shape the traffic uses, before the clients start."""
    for b in traffic["buckets"]:
        backend.prefill(np.zeros((1, b), np.int32), b, 0)
    backend.decode(np.zeros(traffic["slots"], np.int32),
                   np.ones(traffic["slots"], np.int32))


def check_sample(finished, traffic, seed) -> list:
    """The longest of ``finished`` and others drawn from the seed, until
    at least ``check_requests`` requests and ``check_tokens`` served
    tokens are covered."""
    rng = np.random.default_rng(seed + 1)
    pool = sorted(finished, key=lambda r: r.rid)
    longest = max(pool, key=lambda r: len(r.tokens))
    out, n = [longest], len(longest.tokens)
    for i in rng.permutation(len(pool)):
        if n >= traffic["check_tokens"] and \
                len(out) >= traffic["check_requests"]:
            break
        if pool[i] is not longest:
            out.append(pool[i])
            n += len(pool[i].tokens)
    return out


def reference_gaps(cfg, seed, device, sample, control=None) -> dict:
    """``logit_gap``: the widest gap, over the sample's served tokens,
    below the reference's best logit.  With ``control`` (a precision of
    the reference's ``quant``) also ``control``: the widest gap of the
    token that the reference in that precision puts first at each of the
    same positions."""
    from perfbench.reference import decoder as ref

    ref.strict_f32()
    flat = decoder.init_flat(cfg, seed, device)
    w = {n: t.float() for n, t in decoder.iter_weights(cfg, flat)}
    del flat
    out = {"logit_gap": 0.0}
    if control:
        out["control"] = 0.0
    for r in sample:
        seq = torch.tensor(r.prompt + r.tokens[:-1], device=device)
        pos = torch.arange(len(r.prompt) - 1, seq.shape[0], device=device)
        logits = ref.served_logits(cfg, w, seq, pos)
        served = torch.tensor(r.tokens, device=device)
        out["logit_gap"] = max(out["logit_gap"],
                               compare.logit_gap(logits, served))
        if control:
            first = ref.served_logits(cfg, w, seq, pos,
                                      quant=control).argmax(-1)
            out["control"] = max(out["control"],
                                 compare.logit_gap(logits, first))
        del logits
    return out


class ClosedLoop:
    """The clients: each sends its next request the moment its last one
    completes, and times each request's first token from its side."""

    def __init__(self, engine, reqs, clients: int):
        self.engine, self.reqs = engine, reqs
        self.submitted: dict = {}
        self.waiting: dict = {}
        self.finished: list = []
        self.first_token: list = []     # (time shown, seconds from submit)
        now = time.perf_counter()
        for _ in range(clients):
            self.submit(now)

    def submit(self, now) -> None:
        prompt, out_len = self.reqs.take()
        req = self.engine.submit(prompt, out_len)
        self.submitted[req.rid] = now
        if req.state == "DONE":             # rejected at submission
            self.finished.append(req)
        else:
            self.waiting[req.rid] = req

    def tick(self) -> float:
        done = self.engine.step()
        now = time.perf_counter()
        for rid in [rid for rid, r in self.waiting.items() if r.tokens]:
            self.first_token.append((now, now - self.submitted[rid]))
            del self.waiting[rid]
        for r in done:
            self.finished.append(r)
            self.submit(now)
        return now

    def window(self, seconds: float) -> dict:
        """Steps until ``seconds`` have passed since the first; what the
        window served."""
        counters = self.engine.counters
        t0 = time.perf_counter()
        tok0, rej0 = counters["tokens"], counters["rejected"]
        sub0, ttft0 = len(self.submitted), len(self.first_token)
        done0 = len(self.finished)
        while True:
            now = self.tick()
            if now - t0 >= seconds:
                break
        return {"wall": now - t0, "tokens": counters["tokens"] - tok0,
                "ttfts": [s for t, s in self.first_token[ttft0:]
                          if t0 < t <= now],
                "attempted": len(self.submitted) - sub0,
                "failed": counters["rejected"] - rej0,
                "finished": self.finished[done0:]}


def ttft_p95_ms(ttfts) -> float:
    return 1e3 * nearest_rank(ttfts, 95) if ttfts else float("nan")


def run(run, control=None) -> dict:
    cfg, traffic, dev = run.cfg, run.traffic, run.device
    model, backend, engine = build_engine(cfg, traffic, run.seed, dev)
    backend.decode = decode = Timed(backend.decode)
    backend.prefill = prefill = Timed(backend.prefill)
    warm(backend, traffic)
    log("engine built and warmed")
    clients = ClosedLoop(engine, Requests(traffic, cfg["vocab_size"],
                                          run.seed), traffic["clients"])
    while len(clients.finished) < traffic["warm_completions"]:
        clients.tick()
    setup_s = time.perf_counter() - run.t0
    log(f"steady: {len(clients.finished)} completions")
    w = clients.window(run.seconds)
    log(f"window: {w['tokens']} tokens, {len(w['ttfts'])} first tokens "
        f"in {w['wall']:.3f} s")
    window = traced = None
    if run.trace:
        from perfbench import tracing

        window = tracing.Window(dev)
        decode.on = prefill.on = True
        with window:
            traced = clients.window(traffic["trace_seconds"])
        decode.on = prefill.on = False
        log(f"traced window: {traced['tokens']} tokens in "
            f"{window.window_s:.3f} s")
    peak = loop.peak_bytes(dev)
    served = [r for r in w["finished"] if r.finish_reason != "rejected"]
    sample = check_sample(served or clients.finished, traffic, run.seed)
    timings = {"decode_s": decode.seconds, "decode_calls": decode.calls,
               "prefill_s": prefill.seconds, "prefill_calls": prefill.calls}
    del engine, backend, model, decode, prefill, clients
    release_engine()
    loop.free(dev)
    gaps = reference_gaps(cfg, run.seed, dev, sample, control)
    log(f"reference: {len(sample)} requests, "
        f"{sum(len(r.tokens) for r in sample)} served tokens")
    result = {
        "attempted": w["attempted"], "failed": w["failed"],
        "peak_bytes": peak,
        "numbers": {"logit_gap": gaps["logit_gap"]},
        "control": {"logit_gap": gaps.get("control")},
        "e2e": {"serve_tokens_per_s": w["tokens"] / w["wall"],
                "setup_s": setup_s},
        "window": window,
    }
    if window is not None:
        result["trace"] = {
            "family": "decoder", "phase": "serve",
            "window_s": window.window_s, "busy_s": window.busy_s,
            "events": window.events, "chips": 1,
            "ttft_p95_ms": ttft_p95_ms(w["ttfts"]),
            "ttft_count": len(w["ttfts"]), **timings}
    return result
