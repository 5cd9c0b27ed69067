"""``optimizer_sync_device_ms.train`` (ms): device time a step of the work
launched inside the program's ``optimizer.synchronize`` span: the
distributed optimizer's whole averaging of the gradients (at width 1 the
fused pass: packing, the division by one, the copies back).  Layer: the
optimizer.  Moves ``train_tokens_per_s``."""

from perfbench import spans


def read(t):
    return spans.train_device_ms(t, "decoder", "optimizer.synchronize")
