"""``decode_attention_device_ms.serve`` (ms): device time a decode of the
work launched inside the program's ``attention.decode`` spans
(``cached_decode_attention``, every layer) within ``serve.decode`` spans,
over the number of decodes (``perfbench/spans.py``).  Layer: decode
attention.  Moves ``serve_tokens_per_s``."""

from perfbench import spans


def read(t):
    return spans.serve_decode_ms(t, "attention.decode")
