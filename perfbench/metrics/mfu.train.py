"""``mfu.train`` (%): the decoder training step's share of the card's
dense bf16 peak: tokens a second in the traced window times the
benchmark's own count of operations a token (``perfbench/counts.py``:
``6·N`` over the matrix-product parameters, head included, embedding
excluded, plus ``6·L·S·E`` for causal attention, nothing recomputed),
over the peak times the cards.  Layer: the model step.  Moves
``train_tokens_per_s``."""

from perfbench import counts


def read(t):
    if t.get("family") != "decoder" or t.get("phase") != "train":
        return None
    return 100.0 * t["tokens_per_s"] * t["flops_per_token"] / (
        counts.PEAK_BF16_FLOPS * t["chips"])
