"""The check's control comes out as not correct: the plain reference in
the precision below the configuration's (float8 operands for bf16), put
in the program's place.

On the CPU at a small size the control reads above a sound run of the
program on the same seed; on the card (marked ``cuda``) at the cell's
own size it fails the cell's limits, as ``python3 -m perfbench.control``
reads it for setting them."""

from __future__ import annotations

import pytest
import torch

from perfbench import control, harness, run
from perfbench.tests import small

SEED = 2 ** 31 + 4242
CELLS = harness.spec()["workloads"]  # the cells BENCHMARK.json lists
SERVE = [w["name"] for w in CELLS
         if harness.traffic(w["traffic"])["kind"].startswith("serve")]
TRAIN = [w["name"] for w in CELLS if w["name"] not in SERVE]


def _worst(numbers: dict, lims: dict) -> float:
    """The largest ratio of a number to its limit."""
    return max(numbers[k] / lims[k] for k in lims)


@pytest.mark.parametrize("cell", TRAIN)
def test_training_control_reads_above_the_program(cell):
    from horovod_tpu_torch.ops import schedule_plan

    schedule_plan._reset_for_tests()
    cfg, traffic = small.sizes(cell)
    lims = harness.limits(cell)
    sound = run.execute(cell, SEED, 0.2, False, device="cpu", cfg=cfg,
                        traffic=traffic, lims=lims)
    prog = {k: c["value"] for k, c in sound["checks"].items()}
    ctl = control.training(harness.cell(cell), cfg, traffic, SEED,
                           torch.device("cpu"))
    assert _worst(ctl["control"], lims) > 2 * _worst(prog, lims)


@pytest.mark.parametrize("cell", SERVE)
def test_serving_control_reads_above_the_program(cell):
    cfg, traffic = small.sizes(cell)
    out = control.serving(harness.cell(cell), cfg, traffic, SEED, 0.3,
                          torch.device("cpu"))
    assert out["control"]["logit_gap"] > 2 * out["program"]["logit_gap"]


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control runs at the cell's "
                    "own size")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", TRAIN + SERVE)
def test_control_fails_at_the_cells_size(cell, card):
    c = harness.cell(cell)
    cfg, traffic = harness.config(c["config"]), harness.traffic(c["traffic"])
    harness.env_for_program()
    lims = harness.limits(cell)
    if traffic["kind"].startswith("serve"):
        out = control.serving(c, cfg, traffic, SEED, 10.0, card)
    else:
        out = control.training(c, cfg, traffic, SEED, card)
    ok, _ = harness.judge(out["control"], lims)
    assert not ok
