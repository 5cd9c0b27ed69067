"""``to_host_device_ms.serve`` (ms): device time a decode of the work
launched inside the program's ``serve.to_host`` spans within
``serve.decode`` spans: the argmax, the f32 cast of the logits and both
copies to the host (``perfbench/spans.py``).  Layer: the serving
backend.  Moves ``serve_tokens_per_s``."""

from perfbench import spans


def read(t):
    return spans.serve_decode_ms(t, "serve.to_host")
