"""``optimizer_device_ms.train`` (ms): device time a step of the work
launched inside the benchmark's span around the optimizer's ``step()``
(the distributed optimizer's averaging and the master-weight AdamW).
Layer: the optimizer.  Moves ``train_tokens_per_s``."""

from perfbench import tracing


def read(t):
    if t.get("family") != "decoder" or t.get("phase") != "train":
        return None
    evs = tracing.span_device_events(t["events"], t["optimizer_span"],
                                     backward=False)
    if not evs:
        return None
    return tracing.busy_us(evs) / 1e3 / t["steps"]
