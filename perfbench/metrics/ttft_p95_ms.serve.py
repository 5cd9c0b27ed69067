"""``ttft_p95_ms.serve`` (ms): the 95th percentile (nearest rank) of the
client's time from ``submit`` to the ``step()`` return that first shows
the request's token, over every request whose first token falls in the
trace run's untraced window (of ``--seconds``, before its traced one).
Layer: the scheduler's admission (``ServingEngine.step``: the prefills
of the requests admitted into freed slots run in the step before its
decode).  Recorded, not judged: with as many clients as slots the
replica runs at capacity, and a tail of some ninety requests swings
between runs.  Moves ``serve_tokens_per_s``: in this closed loop a
request's first token comes from the step that carries its prefill, and
that step holds back the next token of every other slot, so the steps
that make the tail are the ones that lower the rate."""


def read(t):
    if t.get("phase") != "serve" or not t.get("ttft_count"):
        return None
    return t["ttft_p95_ms"]
