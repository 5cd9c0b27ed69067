"""``forward_device_ms.cnn`` (ms): device time a step of the work launched
inside the program's ``train.forward`` spans (the CNN and its loss in
``train_synthetic.train_step``; ``perfbench/spans.py``).  Layer: the
model step.  Moves ``train_images_per_s``."""

from perfbench import spans


def read(t):
    return spans.train_device_ms(t, "resnet", "train.forward")
