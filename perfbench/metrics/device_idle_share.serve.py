"""``device_idle_share.serve`` (%): the share of the traced window in
which no kernel, copy or fill ran on the card, in a serving cell.
Layer: the device.  Moves ``serve_tokens_per_s``."""


def read(t):
    if t.get("phase") != "serve":
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
