"""``mfu.cnn`` (%): the CNN training step's share of the card's dense
bf16 peak: images a second in the trace run's untraced window (of
``--seconds``, before its traced one, so that the profiler's cost on a
step that the host paces is not counted) times the benchmark's
count of training operations an image (``counts.
resnet_train_flops_per_image``: the forward's products from the
convolutions' and the head's shapes, their weight gradients, and their
data gradients but the stem's, two operations a multiply-add), over the
peak times the cards.  Layer: the model step.  Moves
``train_images_per_s``."""

from perfbench import counts


def read(t):
    if t.get("family") != "resnet" or t.get("phase") != "train":
        return None
    return 100.0 * t["images_per_s"] * t["flops_per_image"] / (
        counts.PEAK_BF16_FLOPS * t["chips"])
