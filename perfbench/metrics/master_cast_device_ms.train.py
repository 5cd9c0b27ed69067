"""``master_cast_device_ms.train`` (ms): device time a step of the work
launched inside the program's ``master.grads_in`` and ``master.params_out``
spans: ``master_weights``' casts of the gradients to the f32 masters and
of the masters back onto the bf16 parameters.  Layer: the optimizer.
Moves ``train_tokens_per_s``."""

from perfbench import spans


def read(t):
    return spans.train_device_ms(t, "decoder", "master.grads_in",
                                 "master.params_out")
