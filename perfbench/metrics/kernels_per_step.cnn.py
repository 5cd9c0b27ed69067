"""``kernels_per_step.cnn`` (kernels): device kernels launched in the
traced window over the CNN training steps it ran.  Layer: the trainer's
dispatch.  Moves ``train_images_per_s``."""

from perfbench import tracing


def read(t):
    if t.get("family") != "resnet" or t.get("phase") != "train":
        return None
    n = len(tracing.kernels(t["events"]))
    return n / t["steps"] if n else None
