"""``forward_idle_ms.cnn`` (ms): the device's idle time a step while the
host is inside the program's ``train.forward`` spans: their union less
the part of it the device's busy union overlaps (``perfbench/spans.py``),
the time the host's dispatch of the forward holds the card back.  Layer:
trainer dispatch.  Moves ``train_images_per_s``."""

from perfbench import spans, tracing


def read(t):
    if not spans.train_cell(t, "resnet"):
        return None
    fwd = tracing.merged(spans.spans(t["events"], "train.forward"))
    return spans.idle_ms(t["events"], fwd, t["steps"])
