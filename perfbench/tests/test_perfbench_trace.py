"""The trace arithmetic on synthetic profiler events: busy time and idle
share, the time of one kind of work not covered by another, span
attribution with the span's backward nodes, and the idle gaps' names."""

from __future__ import annotations

import pytest

from perfbench import harness, tracing


def kern(ts, dur, corr, name="k"):
    return {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur,
            "args": {"correlation": corr}}


def launch(ts, corr, tid=1):
    return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
            "ts": ts, "dur": 1, "pid": 0, "tid": tid,
            "args": {"correlation": corr}}


def op(name, ts, dur, tid=1, seq=None):
    args = {} if seq is None else {"Sequence number": seq}
    return {"ph": "X", "cat": "cpu_op", "name": name, "ts": ts, "dur": dur,
            "pid": 0, "tid": tid, "args": args}


def test_busy_and_idle_share():
    evs = [kern(0, 10, 1), kern(5, 10, 2), kern(30, 10, 3)]
    assert tracing.busy_us(evs) == 25
    trace = {"busy_s": 25e-6, "window_s": 50e-6, "family": "decoder",
             "phase": "train"}
    read = harness.metric("device_idle_share.train").read
    assert read(trace) == pytest.approx(50.0)
    assert read({**trace, "phase": "serve"}) is None


def test_exposed_time():
    comm = [kern(0, 10, 1), kern(20, 10, 2)]
    compute = [kern(5, 10, 3), kern(25, 2, 4)]
    covered = tracing.covered_us(comm, compute)
    assert covered == 5 + 2
    assert tracing.busy_us(comm) - covered == 13


def test_span_takes_its_backward_nodes():
    events = [
        op("perfbench.attention", 0, 100),
        op("aten::mm", 10, 20, seq=7),
        launch(15, 1),
        kern(200, 50, 1, "fwd"),
        op("aten::add", 300, 10, seq=8),                    # outside
        launch(305, 2), kern(400, 20, 2, "other"),
        op(tracing.BACKWARD_PREFIX + "MmBackward0", 500, 50, tid=2, seq=7),
        launch(510, 3, tid=2), kern(600, 30, 3, "bwd"),
        op(tracing.BACKWARD_PREFIX + "AddBackward0", 700, 50, tid=2, seq=8),
        launch(710, 4, tid=2), kern(800, 30, 4, "other_bwd"),
    ]
    got = tracing.span_device_events(events, "perfbench.attention")
    assert sorted(e["name"] for e in got) == ["bwd", "fwd"]
    got = tracing.span_device_events(events, "perfbench.attention",
                                     backward=False)
    assert [e["name"] for e in got] == ["fwd"]


def test_idle_gaps_named_by_the_innermost_host_op():
    events = [
        op("step", 0, 1000), op("aten::copy_", 100, 50),
        launch(120, 1), kern(0, 100, 1),
        op("aten::mm", 400, 100), launch(410, 2), kern(300, 100, 2),
    ]
    gaps = dict(tracing.idle_gaps(events, 0, 1000))
    # 100-300: middle 200 inside "step" only; 400-1000: middle 700 too.
    assert gaps == {"step": pytest.approx((200 + 600) / 1e6)}
    events.append(op("aten::sum", 150, 200))
    gaps = dict(tracing.idle_gaps(events, 0, 1000))
    assert gaps["aten::sum"] == pytest.approx(200 / 1e6)


def test_roofline_and_mfu_readers():
    events = [op("perfbench.attention", 0, 100), launch(10, 1),
              kern(0, 1e6, 1, "flash_fwd")]
    t = {"family": "decoder", "phase": "train", "events": events,
         "attention_span": "perfbench.attention", "attention_least_s": 0.25,
         "steps": 2, "tokens_per_s": 1e4, "flops_per_token": 9.89e9,
         "chips": 1}
    assert harness.metric("flash_attention_roofline").read(t) == \
        pytest.approx(50.0)
    assert harness.metric("mfu.train").read(t) == pytest.approx(10.0)
    assert harness.metric("kernels_per_step.train").read(t) == 0.5
    t["events"] = []
    assert harness.metric("flash_attention_roofline").read(t) is None


def test_exposed_allreduce_reader():
    events = [kern(0, 100, 1, "ncclDevKernel_AllReduce_Sum_bf16"),
              kern(50, 100, 2, "nvjet_gemm"),
              kern(300, 40, 3, "ncclDevKernel_AllReduce_Sum_bf16")]
    t = {"phase": "train", "chips": 4, "steps": 2, "events": events}
    read = harness.metric("allreduce_exposed_ms.dp").read
    # 50 µs of the first collective and all 40 of the second are exposed.
    assert read(t) == pytest.approx((50 + 40) / 1e3 / 2)
    assert read({**t, "chips": 1}) is None


def test_batchnorm_by_launching_op():
    def ext_op(name, ts, dur, ext, tid=1):
        e = op(name, ts, dur, tid)
        e["args"]["External id"] = ext
        return e

    def launch_by(ts, corr, ext, tid=1):
        e = launch(ts, corr, tid)
        e["args"]["External id"] = ext
        return e

    events = [
        ext_op("aten::batch_norm", 0, 100, 1),
        ext_op("aten::cudnn_batch_norm", 10, 50, 2), launch_by(20, 1, 2),
        kern(200, 40, 1, "bn_fw"),
        ext_op("aten::mul", 120, 10, 3), launch_by(122, 2, 3),     # running stats
        kern(300, 10, 2, "mul"),
        ext_op(tracing.BACKWARD_PREFIX + "CudnnBatchNormBackward0", 500, 50,
               4, tid=2),
        ext_op("aten::cudnn_batch_norm_backward", 510, 30, 5, tid=2),
        launch_by(515, 3, 5, tid=2), kern(600, 60, 3, "bn_bw"),
        ext_op(tracing.BACKWARD_PREFIX + "ConvolutionBackward0", 700, 50, 6,
               tid=2),
        launch_by(710, 4, 6, tid=2), kern(800, 30, 4, "dgrad"),
    ]
    roots = {e["name"]: root for e, _, root in tracing.ops_of_kernels(events)}
    assert roots["bn_fw"] == "aten::batch_norm"
    assert roots["mul"] == "aten::mul"
    t = {"family": "resnet", "phase": "train", "events": events, "steps": 2}
    read = harness.metric("batchnorm_device_ms.cnn").read
    assert read(t) == pytest.approx((40 + 60) / 1e3 / 2)
    assert read({**t, "events": events[4:6]}) is None
