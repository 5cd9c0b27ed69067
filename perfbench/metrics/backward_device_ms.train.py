"""``backward_device_ms.train`` (ms): device time a step of the work
launched while the program's ``train.backward`` span is open
(``loss.backward()`` in ``train_transformer.train_step``), on any thread:
the autograd engine's thread launches it (``perfbench/spans.py``).  Layer: the model
step.  Moves ``train_tokens_per_s``."""

from perfbench import spans


def read(t):
    return spans.train_device_ms(t, "decoder", "train.backward")
