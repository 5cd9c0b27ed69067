"""``horovod_tpu_torch.profiling`` — the counterpart of
``horovod_tpu/utils/profiling.py`` on ``torch.profiler``: a Chrome trace
file under the path, the ``annotate`` span in it, rank 0 only unless
``all_ranks``, as the JAX package gates its trace; and the ``--profile``
flag of ``train_synthetic`` and ``train_transformer``."""

import contextlib
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


# ---------------------------------------------------------------------------
# span: the port's one span helper, and the spans at its layer boundaries
# ---------------------------------------------------------------------------

SMALL = dict(vocab_size=64, num_layers=2, num_heads=2, head_dim=8,
             embed_dim=16, mlp_dim=32, max_seq_len=64)


def _spans(trace):
    """``[(name, start, end, tid)]`` of the trace's host ranges."""
    with open(trace) as f:
        evs = json.load(f)["traceEvents"]
    return [(e["name"], e["ts"], e["ts"] + e["dur"], e.get("tid"))
            for e in evs if e.get("ph") == "X"
            and e.get("cat") in ("cpu_op", "user_annotation")]


def _named(spans, name):
    return [s for s in spans if s[0] == name]


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def _each_inside(spans, inner, outer):
    outs = _named(spans, outer)
    return all(any(_inside(s, o) for o in outs) for s in _named(spans, inner))


@pytest.fixture()
def world1(monkeypatch):
    for name in ("RANK", "WORLD_SIZE", "JAX_PROCESS_ID", "JAX_NUM_PROCESSES",
                 "JAX_COORDINATOR_ADDRESS", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(name, raising=False)
    basics.init(device="cpu")
    yield
    basics.shutdown()


def test_span_is_the_shared_null_context_without_a_profiler():
    assert profiling.annotate is profiling.span
    off = profiling.span("a")
    assert isinstance(off, contextlib.nullcontext)
    assert profiling.span("b") is off
    with off:
        with profiling.span("c"):
            pass


def test_span_is_a_real_range_under_trace(tmp_path):
    def work():
        # Built before the profiler opens: the check runs at each entry.
        with profiling.span("late_span"):
            return torch.ones(8) + 1

    with profiling.trace(str(tmp_path)):
        assert isinstance(profiling.span("x"),
                          torch.profiler.record_function)
        work()
    assert isinstance(profiling.span("x"), contextlib.nullcontext)
    (trace,) = _traces(tmp_path)
    assert [s[0] for s in _named(_spans(trace), "late_span")] == \
        ["late_span"]


def test_span_records_inside_backward(tmp_path):
    seen = []

    class Twice(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return 2 * x

        @staticmethod
        def backward(ctx, g):
            seen.append(torch._C._autograd._profiler_enabled())
            with profiling.span("in_backward"):
                return 2 * g

    x = torch.ones(4, requires_grad=True)
    with profiling.trace(str(tmp_path)):
        Twice.apply(x).sum().backward()
    assert seen == [True]
    (trace,) = _traces(tmp_path)
    assert len(_named(_spans(trace), "in_backward")) == 1


def _tiny_trainer(accumulate=1):
    from horovod_tpu_torch.models import transformer as ttm
    from horovod_tpu_torch.ops.flash_attention import make_flash_attention
    from horovod_tpu_torch.training import (DistributedOptimizer,
                                            master_weights)

    torch.manual_seed(0)
    cfg = ttm.TransformerConfig(**SMALL, dtype=torch.float32,
                                attention_fn=make_flash_attention(),
                                fused_norm=True)
    model = ttm.Transformer(cfg, device="cpu")
    opt = DistributedOptimizer(
        master_weights(torch.optim.AdamW(model.parameters(), lr=1e-3)),
        named_parameters=model.named_parameters(),
        backward_passes_per_step=accumulate)
    tokens = torch.randint(0, SMALL["vocab_size"], (2, 16))
    return model, opt, tokens


TRAIN_SPANS = ("train.forward", "train.backward", "train.optimizer",
               "optimizer.synchronize", "master.grads_in",
               "master.params_out")


@pytest.mark.parametrize("accumulate", [1, 2])
def test_train_step_spans(tmp_path, world1, accumulate):
    model, opt, tokens = _tiny_trainer(accumulate)
    steps = 2
    with profiling.trace(str(tmp_path)):
        for _ in range(steps):
            train_transformer.train_step(model, opt, tokens, accumulate)
    (trace,) = _traces(tmp_path)
    spans = _spans(trace)
    per_step = {n: len(_named(spans, n)) / steps for n in TRAIN_SPANS}
    assert per_step == {**dict.fromkeys(TRAIN_SPANS, 1),
                        "train.forward": accumulate,
                        "train.backward": accumulate}
    for inner in ("optimizer.synchronize", "master.grads_in",
                  "master.params_out"):
        assert _each_inside(spans, inner, "train.optimizer")
    # The flash kernels' autograd function: forward and backward, a layer
    # each, inside the step's forward and backward.
    flash = _named(spans, "attention.flash")
    assert len(flash) == 2 * SMALL["num_layers"] * accumulate * steps
    fwd, bwd = _named(spans, "train.forward"), _named(spans, "train.backward")
    assert sum(any(_inside(f, s) for s in fwd) for f in flash) == \
        sum(any(_inside(f, s) for s in bwd) for f in flash) == len(flash) // 2


def test_train_synthetic_step_spans(tmp_path):
    model = torch.nn.Linear(8, 4)
    opt = torch.optim.SGD(model.parameters(), lr=0.1)

    class Net(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.lin = model

        def forward(self, x, train=True):
            return self.lin(x)

    x, y = torch.randn(4, 8), torch.tensor([0, 1, 2, 3])
    with profiling.trace(str(tmp_path)):
        train_synthetic.train_step(Net(), opt, x, y)
    (trace,) = _traces(tmp_path)
    spans = _spans(trace)
    assert [len(_named(spans, n)) for n in
            ("train.forward", "train.backward", "train.optimizer")] == \
        [1, 1, 1]


def _tiny_model():
    from horovod_tpu_torch.models import transformer as ttm
    from horovod_tpu_torch.ops.flash_attention import make_flash_attention

    torch.manual_seed(0)
    cfg = ttm.TransformerConfig(**SMALL, dtype=torch.float32,
                                attention_fn=make_flash_attention(),
                                fused_norm=True)
    return ttm.Transformer(cfg, device="cpu").eval()


def _serve_traced(tmp_path, backend, steps=4, **config):
    from horovod_tpu_torch.serving.engine import ServingConfig, ServingEngine

    eng = ServingEngine(backend, ServingConfig(
        num_slots=2, buckets=(8, 16), max_seq_len=64, **config))
    eng.submit([3, 1, 4, 1, 5], 6)
    eng.submit(list(range(1, 12)), 6)
    with profiling.trace(str(tmp_path)):
        for _ in range(steps):
            eng.step()
    (trace,) = _traces(tmp_path)
    return _spans(trace)


def test_serving_engine_spans(tmp_path):
    from horovod_tpu_torch.serving.engine import TransformerBackend

    spans = _serve_traced(tmp_path, TransformerBackend(_tiny_model(), 2, 64))
    steps, prefills, decodes = (_named(spans, n) for n in
                                ("serve.step", "serve.prefill",
                                 "serve.decode"))
    assert len(steps) == 4 and len(prefills) == 2 and len(decodes) == 4
    assert _each_inside(spans, "serve.prefill", "serve.step")
    assert _each_inside(spans, "serve.decode", "serve.step")
    # Decode's cached attention, once a layer, inside the decode.
    assert len(_named(spans, "attention.decode")) == \
        SMALL["num_layers"] * len(decodes)
    assert _each_inside(spans, "attention.decode", "serve.decode")
    # The copies to the host close every prefill and every decode.
    to_host = _named(spans, "serve.to_host")
    assert len(to_host) == len(prefills) + len(decodes)
    assert all(any(_inside(t, c) for c in prefills + decodes)
               for t in to_host)


def test_paged_backend_keeps_its_gather_and_scatter_spans(tmp_path):
    from horovod_tpu_torch.serving import breakdown
    from horovod_tpu_torch.serving.engine import PagedTransformerBackend

    backend = PagedTransformerBackend(_tiny_model(), 2, 64, cache_pages=8,
                                      page_size=8)
    spans = _serve_traced(tmp_path, backend, prefix_cache_pages=8,
                          page_size=8)
    names = [s[0] for s in spans]
    calls = names.count("serve.prefill") + names.count("serve.decode")
    assert calls == 2 + 4
    # One gather and one scatter a backend call, as the breakdown reads.
    assert names.count("paged_gather") == names.count("paged_scatter") \
        == calls
    assert set(breakdown.SPANS) == {"paged_gather", "paged_scatter"}
    calls = _named(spans, "serve.prefill") + _named(spans, "serve.decode")
    for name in breakdown.SPANS:
        assert all(any(_inside(s, c) for c in calls)
                   for s in _named(spans, name))
