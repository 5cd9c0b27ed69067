"""``scheduler_idle_ms.serve`` (ms): the device's idle time a decode while
the host is inside the program's ``serve.step`` spans but outside its
``serve.prefill`` and ``serve.decode`` spans (the scheduler's own work:
admission, token bookkeeping, eviction), over the number of decodes
(``perfbench/spans.py``).  Layer: scheduler admission.  Moves
``serve_tokens_per_s``."""

from perfbench import spans, tracing


def read(t):
    if t.get("phase") != "serve":
        return None
    evs = t["events"]
    calls = spans.spans(evs, "serve.prefill") + \
        spans.spans(evs, "serve.decode")
    own = spans.minus(tracing.merged(spans.spans(evs, "serve.step")),
                      tracing.merged(calls))
    return spans.idle_ms(evs, own, len(spans.spans(evs, "serve.decode")))
