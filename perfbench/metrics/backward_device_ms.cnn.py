"""``backward_device_ms.cnn`` (ms): device time a step of the work launched
while the program's ``train.backward`` span is open, on any thread (the
autograd engine's launches it; ``perfbench/spans.py``).  Layer: the model
step.  Moves ``train_images_per_s``."""

from perfbench import spans


def read(t):
    return spans.train_device_ms(t, "resnet", "train.backward")
