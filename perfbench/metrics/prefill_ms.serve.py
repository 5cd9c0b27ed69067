"""``prefill_ms.serve`` (ms): host wall of the serving backend's
``prefill`` calls in the traced window over their number, timed by the
benchmark's wrapper around ``TransformerBackend.prefill`` (the call ends
in a copy to the host).  Layer: the serving backend.  Moves
``serve_tokens_per_s`` (a step runs its admissions' prefills before its
decode)."""


def read(t):
    if t.get("phase") != "serve" or not t.get("prefill_calls"):
        return None
    return 1e3 * t["prefill_s"] / t["prefill_calls"]
