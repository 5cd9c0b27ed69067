"""``device_idle_share.cnn`` (%): the share of the traced window in which
no kernel, copy or fill ran on the card, in a CNN training cell.  Layer:
the device.  Moves ``train_images_per_s``."""


def read(t):
    if t.get("family") != "resnet" or t.get("phase") != "train":
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
