"""``decode_step_ms.serve`` (ms): host wall of the serving backend's
``decode`` calls in the traced window over their number, each call
timed by the benchmark's wrapper around ``TransformerBackend.decode``
(the call ends in a copy to the host); the sum spans the whole window.
Layer: the serving backend.  Moves ``serve_tokens_per_s``."""


def read(t):
    if t.get("phase") != "serve" or not t.get("decode_calls"):
        return None
    return 1e3 * t["decode_s"] / t["decode_calls"]
