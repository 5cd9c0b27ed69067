"""``forward_device_ms.train`` (ms): device time a step of the work
launched inside the program's ``train.forward`` spans (the model and the
loss in ``train_transformer.train_step``), by time on any thread
(``perfbench/spans.py``).  Layer: the model step.  Moves
``train_tokens_per_s``."""

from perfbench import spans


def read(t):
    return spans.train_device_ms(t, "decoder", "train.forward")
