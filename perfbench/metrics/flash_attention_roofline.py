"""``flash_attention_roofline`` (%): the training step's attention work
against its roofline: the least time of a step's causal attention, every
layer, forward and backward (``counts.attention_train_work``: the
larger of its operations over the bf16 peak and its bytes over HBM's
bandwidth), times the traced steps, over the device time of the work
launched inside the benchmark's span around the ``attention_fn`` it
hands the model and by that span's autograd backward nodes, whatever
implements it.  Layer: the kernels (flash attention).  Moves
``train_tokens_per_s``."""

from perfbench import tracing


def read(t):
    if t.get("family") != "decoder" or t.get("phase") != "train":
        return None
    evs = tracing.span_device_events(t["events"], t["attention_span"])
    busy = tracing.busy_us(evs) / 1e6
    if not evs or busy <= 0:
        return None
    return 100.0 * t["attention_least_s"] * t["steps"] / busy
