"""Each cell's check fails a run whose timed path is broken underneath:
the whole of a run but the look for a card, at a small size on the CPU
(every rank of a four-chip cell a process over gloo), against the cell's
own limits: some number of the broken run reads past its limit and at
least three times what a sound run of the same seed and size reads.

The faults, each where the cell can have it (``tests/faults.py``): a step
that returns its state unchanged; half of the batch left out, the mean
taken over the rest; the exchange between chips left out; a served token
altered where it is produced; and in a ResNet, one block's 3x3
convolution handing on zeros, inside a branch that gets no first gradient
while the block's last BatchNorm scale is 0."""

from __future__ import annotations

import pytest

from perfbench import harness, run
from perfbench.tests import small

SEED = 2 ** 31 + 777
BENCH = harness.spec()
FAULTS = {"train_decoder": ["unchanged", "half_batch"],
          "train_cnn": ["unchanged", "half_batch", "branch_conv_zero"],
          "serve_decoder": ["altered_token"]}
CASES = []
for w in BENCH["workloads"]:
    faults = list(FAULTS[harness.traffic(w["traffic"])["kind"]])
    if w["chips"] > 1:
        faults.append("no_exchange")
    CASES += [(w["name"], f) for f in faults]


def _run(cell, patches=()):
    from horovod_tpu_torch.ops import schedule_plan

    schedule_plan._reset_for_tests()
    cfg, traffic = small.sizes(cell)
    lims = harness.limits(cell)
    assert lims, f"no limits for {cell}"
    return run.execute(cell, SEED, 0.3, False, device="cpu", cfg=cfg,
                       traffic=traffic, lims=lims, patches=patches)


def _worst(out) -> float:
    """The largest ratio of a compared number to its limit."""
    return max(c["value"] / c["limit"] for c in out["checks"].values())


def _caught(out, sound) -> bool:
    """Some number reads past its limit and three times the sound run's."""
    return any(c["value"] > c["limit"]
               and c["value"] > 3 * sound["checks"][k]["value"]
               for k, c in out["checks"].items())


@pytest.fixture()
def restore(monkeypatch):
    """What the patches replace in this process, put back after the test."""
    from horovod_tpu_torch import training
    from horovod_tpu_torch.models import resnet
    from horovod_tpu_torch.serving import engine
    from perfbench.kinds import train_cnn, train_decoder

    for obj, name in ((train_decoder, "program_step"),
                      (train_cnn, "program_step"),
                      (resnet.ResNet, "__init__"),
                      (training._DistributedOptimizer, "synchronize"),
                      (engine._ModelBackend, "_cache_step")):
        monkeypatch.setattr(obj, name, getattr(obj, name))


@pytest.mark.parametrize("cell,fault", CASES)
def test_fault_fails(cell, fault, restore):
    sound = _run(cell)
    out = _run(cell, (f"perfbench.tests.faults:{fault}",))
    assert out["result"]["correct"] is False, out["checks"]
    assert _caught(out, sound), (out["checks"], sound["checks"])


def _dp_bench():
    """The benchmark with the four-chip cell of the decoder's training mix
    (``traffic/train.s4096.dp4.json``), which ``BENCHMARK.json`` does not
    list yet, each rank a process."""
    import copy

    bench = copy.deepcopy(BENCH)
    name = "deepseek-llm-7b.train.s4096.dp4"
    bench["workloads"].append({
        "name": name, "config": "deepseek-llm-7b",
        "traffic": "train.s4096.dp4", "chips": 4, "why": "four ranks"})
    bench["end_to_end"][0]["workloads"].append(name)
    return bench, name


@pytest.mark.parametrize("fault", [None, "no_exchange", "half_batch"])
def test_four_ranks_over_gloo(fault, restore):
    """Four processes on the CPU run the decoder's step as one job: sound,
    they agree with the reference's step over the global batch as closely
    as one process does with its own; with the exchange or half of each
    rank's batch left out, they do not."""
    from horovod_tpu_torch.ops import schedule_plan

    schedule_plan._reset_for_tests()
    bench, name = _dp_bench()
    cfg, traffic = small.sizes("deepseek-llm-7b.train.s4096")
    patches = () if fault is None else (f"perfbench.tests.faults:{fault}",)
    out = run.execute(name, SEED, 0.3, False, device="cpu", cfg=cfg,
                      traffic=traffic, bench=bench, patches=patches,
                      lims=harness.limits("deepseek-llm-7b.train.s4096"))
    assert out["result"]["device"]["count"] == 4
    if fault is None:
        assert _worst(out) < 1, out["checks"]
    else:
        assert out["result"]["correct"] is False, out["checks"]
