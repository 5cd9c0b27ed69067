"""``python -m horovod_tpu_torch.train_parallel`` on the CPU: every
strategy on two gloo processes at a small width, held against the same
model's replicated data-parallel step (``DistributedOptimizer``), which
the port's other tests hold against the JAX package.

At float32 the pipeline, ZeRO and FSDP steps compute the replicated
step's loss on the same weights and batch (1e-5 over three steps: the
same products, summed in other orders); the MoE decoder trains (finite,
falling); each strategy's per-rank bytes show what it shards.
"""

import json
import subprocess
import sys

import numpy as np
import pytest

from test_torch_tensor_parallel import run_gloo

ARGS = ["--device", "cpu", "--layers", "2", "--embed", "32", "--heads",
        "2", "--mlp", "64", "--vocab", "64", "--seq-len", "16", "--batch",
        "8", "--dtype", "float32", "--warmup", "1", "--steps", "2"]


def _worker(rank, n):
    import gc
    import weakref

    import torch

    from horovod_tpu_torch import train_parallel as tp

    out = {}
    for strategy in tp.STRATEGIES:
        out[strategy] = tp.run(tp.parse_args(["--strategy", strategy]
                                             + ARGS))
    args = tp.parse_args(["--strategy", "zero"] + ARGS)
    cfg = tp.tt.train_config(num_layers=2, embed_dim=32, num_heads=2,
                             head_dim=16, mlp_dim=64, vocab_size=64,
                             max_seq_len=16, dtype=torch.float32)
    tr = tp.make_trainer("replicated", cfg, torch.device("cpu"), args.seed,
                         args.batch)
    out["replicated"] = {
        "losses": [float(tp.train_step(tr)) for _ in range(3)],
        "memory": tp.memory_bytes(tr)}
    # A trainer dropped after its steps frees its model (the replicated
    # optimizer's gradient hooks once kept it alive for ever).
    del tr
    out["freed"] = {}
    for strategy in tp.STRATEGIES + ("replicated",):
        tr = tp.make_trainer(strategy, cfg, torch.device("cpu"), args.seed,
                             args.batch)
        tp.train_step(tr)
        tp.train_step(tr)
        refs = [weakref.ref(p) for p in tr.model.parameters()]
        del tr
        gc.collect()
        out["freed"][strategy] = sum(r() is not None for r in refs)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_gloo(_worker, 2, tmp_path_factory.mktemp("train_parallel"))


@pytest.mark.parametrize("strategy", ["pipeline", "zero", "fsdp"])
def test_strategy_matches_the_replicated_step(runs, strategy):
    for r in range(2):
        np.testing.assert_allclose(runs[r][strategy]["losses"],
                                   runs[r]["replicated"]["losses"],
                                   atol=1e-5, rtol=1e-5)


def test_moe_decoder_trains(runs):
    losses = runs[0]["moe"]["losses"]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    assert runs[0]["moe"]["collective_calls_per_step"]["all_to_all"] == 8


def test_each_strategy_reports_what_it_shards(runs):
    rep = runs[0]["replicated"]["memory"]
    for strategy in ("zero", "fsdp"):
        ranks = runs[0][strategy]["ranks"]
        assert len(ranks) == 2
        for rk in ranks:
            # Half the optimizer state a rank (ZeRO pads the flat vector;
            # FSDP replicates what is too small to shard).
            assert rk["state_bytes"] == pytest.approx(
                rep["state_bytes"] / 2, rel=0.02)
    fsdp = runs[0]["fsdp"]["ranks"][0]
    assert fsdp["param_bytes"] == pytest.approx(rep["param_bytes"] / 2,
                                                rel=0.02)
    pipe = runs[0]["pipeline"]
    assert pipe["microbatches"] == 4
    calls = pipe["collective_calls_per_step"]
    # Four microbatches forward one way; one broadcast of the outputs; the
    # cotangent mean, the loss mean and the embedding gradient's sum.
    assert calls == {"send": 4.0, "broadcast": 1.0, "all_reduce": 3.0}


@pytest.mark.parametrize("strategy", ["pipeline", "moe", "zero", "fsdp",
                                      "replicated"])
def test_a_dropped_trainer_frees_its_model(runs, strategy):
    for r in range(2):
        assert runs[r]["freed"][strategy] == 0


def test_cli_runs_on_the_card_unless_asked(tmp_path):
    # Without --device the trainer asks for cuda, which this host lacks.
    proc = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.train_parallel",
         "--strategy", "zero"], capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and "CUDA" in proc.stderr
    proc = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.train_parallel",
         "--strategy", "fsdp"] + ARGS, capture_output=True, text=True,
        timeout=120)
    assert proc.returncode == 0, proc.stderr
    row = json.loads(proc.stdout.strip().splitlines()[-1])
    assert row["processes"] == 1 and row["device"] == "cpu"
