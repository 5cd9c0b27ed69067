"""``decode_graph_share.serve`` on synthetic profiler events: a trace
whose decodes replay no graph (the program before it captured the cache
step) reads 0, one where every ``serve.decode`` holds a
``serve.decode_graph`` reads 100, a mix reads its share, and a training
trace or a serving trace without decodes reads None."""

from __future__ import annotations

import pytest

from perfbench import harness

NAME = "decode_graph_share.serve"


def span(name, ts, dur, pid=100, tid=1):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts,
            "dur": dur, "pid": pid, "tid": tid, "args": {}}


def decodes(n: int, graphed) -> list[dict]:
    """``n`` engine ticks, each a prefill and a decode; decode ``i`` holds
    a graph replay where ``graphed(i)``."""
    out = []
    for i in range(n):
        t0 = 1000 * i
        out += [span("serve.step", t0, 900),
                span("serve.prefill", t0 + 10, 100),
                span("serve.decode", t0 + 200, 600),
                span("serve.to_host", t0 + 700, 90)]
        if graphed(i):
            out.append(span("serve.decode_graph", t0 + 300, 50))
    return out


def read(t):
    return harness.metric(NAME).read(t)


def serve(events):
    return {"family": "decoder", "phase": "serve", "events": events}


@pytest.mark.parametrize("graphed, want", [
    (lambda i: False, 0.0),
    (lambda i: True, 100.0),
    (lambda i: i % 4 != 0, 75.0),
], ids=["parent", "every_decode", "three_of_four"])
def test_share_of_decodes_holding_a_replay(graphed, want):
    assert read(serve(decodes(8, graphed))) == pytest.approx(want)


def test_a_replay_outside_any_decode_or_in_another_process_counts_not():
    evs = decodes(2, lambda i: False)
    evs += [span("serve.decode_graph", 100, 20),            # in the prefill
            span("serve.decode_graph", 1300, 20, pid=200)]  # other process
    assert read(serve(evs)) == 0.0


def test_none_outside_a_serving_trace():
    evs = decodes(2, lambda i: True)
    assert read({"family": "decoder", "phase": "train", "steps": 1,
                 "events": evs}) is None
    no_decode = [e for e in evs if e["name"] != "serve.decode"]
    assert read(serve(no_decode)) is None
    assert read(serve([])) is None


def test_listed_for_the_serving_cell_only():
    (m,) = [m for m in harness.spec()["per_layer"] if m["name"] == NAME]
    assert m["workloads"] == ["deepseek-llm-7b.serve.chat32"]
    assert (m["unit"], m["better"], m["moves"]) == \
        ("%", "higher", "serve_tokens_per_s")
