"""The numbers that decide ``correct``: each a gap between what the
program produced and what the plain reference computes from the same
inputs.

Training (one number each):

* ``loss_gap``: the largest absolute difference of a checked step's loss
  (nats);
* ``grad_norm_gap``: the worst leaf's gap between the two norms of the
  first step's gradient, ``|‖g_p‖ - ‖g_r‖|``, over the reference's norm
  of that leaf or of the median leaf, whichever is larger (the median
  over the leaves whose reference norm is not 0, so that a leaf the
  reference leaves still and the program moves fails);
* ``change_norm_gap``: the same of the parameters' change over the
  checked steps, over the leaves whose first reference gradient is at
  least ``MOVING`` of the median leaf's (a leaf below that moves by
  round-off and weight decay alone).

Serving: ``logit_gap``, the widest gap by which a served token's logit
lies below the best logit of the reference at that position.
"""

from __future__ import annotations

import statistics

MOVING = 1e-3


def leaf_gap(prog: dict, ref: dict, names=None) -> float:
    """Worst leaf's ``|prog - ref| / max(ref, floor)``, ``floor`` the
    median of the leaves whose reference norm is not 0: a leaf that the
    reference leaves at 0 and the program moves reads its norm over the
    floor.  A leaf the program does not report reads as 0."""
    names = list(ref) if names is None else list(names)
    moved = [ref[n] for n in names if ref[n] > 0]
    floor = statistics.median(moved) if moved else 0.0
    worst = 0.0
    for n in names:
        gap = abs(prog.get(n, 0.0) - ref[n])
        den = max(ref[n], floor)
        worst = max(worst, gap / den if den > 0 else
                    (0.0 if gap == 0 else float("inf")))
    return worst


def moving_leaves(ref_grad_norms: dict) -> list[str]:
    med = statistics.median(ref_grad_norms.values())
    return [n for n, g in ref_grad_norms.items() if g >= MOVING * med]


def training_numbers(prog: dict, ref: dict) -> dict:
    """The three training numbers from two readings of the form
    ``{"losses", "grad_norms", "change_norms"}``."""
    pl, rl = prog["losses"], ref["losses"]
    loss_gap = max(abs(a - b) for a, b in zip(pl, rl)) \
        if len(pl) == len(rl) else float("inf")
    return {"loss_gap": loss_gap,
            "grad_norm_gap": leaf_gap(prog["grad_norms"], ref["grad_norms"]),
            "change_norm_gap": leaf_gap(
                prog["change_norms"], ref["change_norms"],
                moving_leaves(ref["grad_norms"]))}


def logit_gap(ref_logits, tokens) -> float:
    """Widest ``max(ref_logits[i]) - ref_logits[i, tokens[i]]`` over the
    positions ``i``; ``ref_logits`` a [N, V] tensor, ``tokens`` [N]."""
    import torch

    best = ref_logits.max(dim=-1).values
    got = ref_logits.gather(1, tokens[:, None].long())[:, 0]
    return float(torch.max(best - got))
