"""``optimizer_device_ms.cnn`` (ms): device time a step of the work
launched inside the program's ``train.optimizer`` span (the distributed
optimizer's averaging and SGD's update; ``perfbench/spans.py``).  Layer:
the optimizer.  Moves ``train_images_per_s``."""

from perfbench import spans


def read(t):
    return spans.train_device_ms(t, "resnet", "train.optimizer")
