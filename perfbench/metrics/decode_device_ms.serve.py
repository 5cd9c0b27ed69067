"""``decode_device_ms.serve`` (ms): device time a decode of the work
launched inside the program's ``serve.decode`` spans (the backend's cache
step over every slot, through its copies to the host), over the number of
those spans in the window (``perfbench/spans.py``).  Layer: the serving
backend.  Moves ``serve_tokens_per_s``."""

from perfbench import spans


def read(t):
    return spans.serve_decode_ms(t)
