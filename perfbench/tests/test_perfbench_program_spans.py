"""The readers of the program's own spans (``perfbench/spans.py`` and the
twelve metrics on it) on synthetic profiler events: device time launched
inside a span by time on any thread of the process (a backward span on
the main thread whose kernels the autograd thread launches), spans within
spans, idle time inside spans and outside their children, and None where
the program opens no such span."""

from __future__ import annotations

import pytest

from perfbench import harness, spans, tracing

NEW = {
    "deepseek-llm-7b.train.s4096": (
        "forward_device_ms.train", "backward_device_ms.train",
        "optimizer_sync_device_ms.train", "master_cast_device_ms.train"),
    "resnet50-v1.5.train.b256": (
        "forward_device_ms.cnn", "backward_device_ms.cnn",
        "optimizer_device_ms.cnn", "forward_idle_ms.cnn"),
    "deepseek-llm-7b.serve.chat32": (
        "decode_device_ms.serve", "decode_attention_device_ms.serve",
        "to_host_device_ms.serve", "scheduler_idle_ms.serve"),
}


def kern(ts, dur, corr, name="k", cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": 0, "tid": 7, "args": {"correlation": corr}}


def launch(ts, corr, tid=1, pid=100):
    return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
            "ts": ts, "dur": 1, "pid": pid, "tid": tid,
            "args": {"correlation": corr}}


def span(name, ts, dur, tid=1, pid=100):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts,
            "dur": dur, "pid": pid, "tid": tid, "args": {}}


def read(name, t):
    return harness.metric(name).read(t)


def train_step_events():
    """One step on the main thread (tid 1); the backward's kernels are
    launched from the autograd thread (tid 2) while the main thread waits
    inside ``train.backward``."""
    return [
        span("train.forward", 0, 100),
        launch(10, 1), kern(20, 40, 1, "fwd"),
        launch(50, 2), kern(55, 30, 2, "fwd2"),          # overlaps fwd
        span("train.backward", 100, 300),
        launch(150, 3, tid=2), kern(160, 40, 3, "bwd"),
        launch(250, 4, tid=2), kern(260, 40, 4, "bwd2"),
        span("attention.flash", 240, 40, tid=2),
        span("train.optimizer", 400, 200),
        span("optimizer.synchronize", 405, 45),
        launch(410, 5), kern(420, 30, 5, "pack"),
        span("master.grads_in", 455, 20),
        launch(460, 6), kern(460, 20, 6, "cast_in"),
        launch(480, 7), kern(485, 50, 7, "adamw"),
        span("master.params_out", 540, 50),
        launch(545, 8), kern(545, 10, 8, "cast_out"),
        launch(700, 9), kern(700, 10, 9, "after"),         # outside
        launch(150, 10, pid=200), kern(150, 5, 10, "other process"),
    ]


def test_backward_span_takes_kernels_launched_on_another_thread():
    events = train_step_events()
    t = {"family": "decoder", "phase": "train", "steps": 1,
         "events": events}
    assert read("forward_device_ms.train", t) == pytest.approx(65 / 1e3)
    assert read("backward_device_ms.train", t) == pytest.approx(80 / 1e3)
    # Matched by thread, as the benchmark's own spans are, the backward
    # span would find nothing: its kernels come from the autograd thread.
    assert tracing.span_device_events(events, "train.backward",
                                      backward=False) == []
    # A range opened on the launching thread itself is found either way.
    flash = spans.launched_in(events, spans.spans(events, "attention.flash"))
    assert [e["name"] for e in flash] == ["bwd2"]


def test_optimizer_parts():
    t = {"family": "decoder", "phase": "train", "steps": 2,
         "events": train_step_events()}
    assert read("optimizer_sync_device_ms.train", t) == \
        pytest.approx(30 / 1e3 / 2)
    assert read("master_cast_device_ms.train", t) == \
        pytest.approx((20 + 10) / 1e3 / 2)
    assert spans.train_device_ms(t, "decoder", "train.optimizer") == \
        pytest.approx((30 + 20 + 50 + 10) / 1e3 / 2)


def test_cnn_step_and_forward_idle():
    t = {"family": "resnet", "phase": "train", "steps": 1,
         "events": train_step_events()}
    assert read("forward_device_ms.cnn", t) == pytest.approx(65 / 1e3)
    assert read("backward_device_ms.cnn", t) == pytest.approx(80 / 1e3)
    assert read("optimizer_device_ms.cnn", t) == \
        pytest.approx(110 / 1e3)
    # train.forward [0, 100] against the busy union [20, 85]: 35 idle.
    assert read("forward_idle_ms.cnn", t) == pytest.approx(35 / 1e3)
    # The decoder's readers see no CNN trace, and the reverse.
    assert read("forward_device_ms.train", t) is None
    assert read("forward_device_ms.cnn",
                {**t, "family": "decoder"}) is None


def serve_events():
    """One engine tick: a prefill and a decode inside ``serve.step``;
    ``attention.decode`` in both, ``serve.to_host`` closing both."""
    return [
        span("serve.step", 0, 1000),
        launch(10, 1), kern(10, 30, 1, "admit"),
        span("serve.prefill", 50, 150),
        span("attention.decode", 100, 50),
        launch(120, 2), kern(130, 60, 2, "prefill_attn"),
        span("serve.to_host", 190, 10),
        launch(192, 3), kern(192, 5, 3, "prefill_copy", "gpu_memcpy"),
        span("serve.decode", 300, 500),
        span("attention.decode", 350, 50),
        launch(360, 4), kern(360, 60, 4, "attn0"),
        span("attention.decode", 450, 50),
        launch(460, 5), kern(470, 50, 5, "attn1"),
        launch(600, 6), kern(600, 50, 6, "mlp"),
        span("serve.to_host", 700, 100),
        launch(710, 7), kern(710, 10, 7, "argmax"),
        launch(720, 8), kern(720, 70, 8, "logits", "gpu_memcpy"),
    ]


def test_serving_readers():
    t = {"family": "decoder", "phase": "serve", "events": serve_events()}
    assert read("decode_device_ms.serve", t) == \
        pytest.approx((60 + 50 + 50 + 80) / 1e3)
    # Only the decode's attention: the prefill's range is not inside a
    # decode.
    assert read("decode_attention_device_ms.serve", t) == \
        pytest.approx((60 + 50) / 1e3)
    assert read("to_host_device_ms.serve", t) == pytest.approx(80 / 1e3)
    # Step less its calls: [0, 50], [200, 300], [800, 1000], 350 µs, of
    # which the admission's kernel covers 30.
    assert read("scheduler_idle_ms.serve", t) == pytest.approx(320 / 1e3)


def test_per_decode():
    evs = serve_events()
    twice = evs + [{**e, "ts": e["ts"] + 2000,
                    "args": {"correlation": e["args"]["correlation"] + 100}
                    if "correlation" in e["args"] else {}} for e in evs]
    one = {"family": "decoder", "phase": "serve", "events": evs}
    two = {**one, "events": twice}
    for name in NEW["deepseek-llm-7b.serve.chat32"]:
        assert read(name, two) == pytest.approx(read(name, one))


@pytest.mark.parametrize("cell", sorted(NEW))
def test_none_without_the_programs_spans(cell):
    """A trace of a program that opens none of the spans (the parent's)
    reads None in every new metric, and so does a trace with spans but no
    device work (a CPU run)."""
    family, phase = ("resnet", "train") if "resnet" in cell else \
        ("decoder", "serve" if "serve" in cell else "train")
    evs = train_step_events() if phase == "train" else serve_events()
    bare = [e for e in evs if e["cat"] != "user_annotation"]
    cpu = [e for e in evs if e["cat"] == "user_annotation"]
    for events in (bare, cpu, []):
        t = {"family": family, "phase": phase, "steps": 1,
             "events": events}
        for name in NEW[cell]:
            assert read(name, t) is None, (name, len(events))


def test_the_new_metrics_are_listed_for_their_cells():
    bench = harness.spec()
    for cell, names in NEW.items():
        listed = {m["name"] for m in
                  harness.metrics_of(cell, "per_layer", bench)}
        assert set(names) <= listed
        for m in bench["per_layer"]:
            if m["name"] in names:
                assert m["workloads"] == [cell]
                assert m["source"] == "device_trace" and m["unit"] == "ms"


def test_minus():
    assert spans.minus([(0, 10), (20, 30)], [(2, 4), (5, 6), (9, 21)]) == \
        [(0, 2), (4, 5), (6, 9), (21, 30)]
    assert spans.minus([(0, 10)], []) == [(0, 10)]
    assert spans.minus([(0, 10)], [(-5, 15)]) == []
    assert spans.minus([], [(0, 1)]) == []
