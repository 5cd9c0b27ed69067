"""``horovod_tpu_torch.profiling`` — the counterpart of
``horovod_tpu/utils/profiling.py`` on ``torch.profiler``: a Chrome trace
file under the path, the ``annotate`` span in it, rank 0 only unless
``all_ranks``, as the JAX package gates its trace; and the ``--profile``
flag of ``train_synthetic`` and ``train_transformer``."""

import glob
import json
import os

import pytest
import torch

import horovod_tpu_torch as hvd
from horovod_tpu import profiling as jax_profiling
from horovod_tpu_torch import basics, train_synthetic, train_transformer
from horovod_tpu_torch.utils import profiling


def _traces(path):
    return sorted(glob.glob(os.path.join(str(path), "*.pt.trace.json")))


def _names(trace):
    with open(trace) as f:
        return {e.get("name") for e in json.load(f)["traceEvents"]}


def test_reachable_as_the_jax_package_makes_it():
    assert hvd.profiling is profiling
    assert callable(jax_profiling.trace) and callable(jax_profiling.annotate)
    assert {"trace", "annotate"} <= set(dir(profiling))
    assert "profiling" in hvd.__all__


def test_trace_writes_a_chrome_trace_with_the_span(tmp_path):
    with profiling.trace(str(tmp_path / "t")) as prof:
        assert prof is not None
        with profiling.annotate("my_span"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    (trace,) = _traces(tmp_path / "t")
    assert os.path.basename(trace).startswith("rank0.")
    names = _names(trace)
    assert "my_span" in names and "aten::mm" in names
    # A second trace beside it does not overwrite the first.
    with profiling.trace(str(tmp_path / "t")):
        torch.zeros(4) + 1
    assert len(_traces(tmp_path / "t")) == 2


@pytest.mark.parametrize("all_ranks", [False, True])
def test_only_rank_0_traces_unless_all_ranks(tmp_path, monkeypatch,
                                              all_ranks):
    monkeypatch.setattr(basics, "is_initialized", lambda: True)
    monkeypatch.setattr(basics, "rank", lambda: 1)
    with profiling.trace(str(tmp_path), all_ranks=all_ranks) as prof:
        torch.zeros(4) + 1
    assert (prof is not None) == all_ranks
    traces = _traces(tmp_path)
    if all_ranks:
        (trace,) = traces
        assert os.path.basename(trace).startswith("rank1.")
    else:
        assert traces == []


def test_train_synthetic_profile_flag(tmp_path, monkeypatch, capsys):
    for name in ("RANK", "WORLD_SIZE", "JAX_PROCESS_ID", "JAX_NUM_PROCESSES",
                 "JAX_COORDINATOR_ADDRESS", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(name, raising=False)
    assert train_synthetic.main([
        "--device", "cpu", "--model", "ResNet50", "--image-size", "32",
        "--batch-size", "2", "--num-warmup-batches", "0", "--num-iters", "1",
        "--num-batches-per-iter", "1", "--profile", str(tmp_path)]) == 0
    (trace,) = _traces(tmp_path)
    names = _names(trace)
    assert "train_step" in names and "aten::convolution" in names


def test_train_transformer_takes_the_profile_flag():
    args = train_transformer.parse_args(["--profile", "/tmp/x"])
    assert args.profile == "/tmp/x"
    assert train_transformer.parse_args([]).profile is None
