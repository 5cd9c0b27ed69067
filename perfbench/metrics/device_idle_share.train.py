"""``device_idle_share.train`` (%): the share of the traced window in
which no kernel, copy or fill ran on the card, in a decoder training
cell (rank 0's card).  Layer: the device.  Moves ``train_tokens_per_s``."""


def read(t):
    if t.get("family") != "decoder" or t.get("phase") != "train":
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
