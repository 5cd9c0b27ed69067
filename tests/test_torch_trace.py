"""The breakdown's attribution of each kernel to the operator that
launched it (``utils/trace.py``), on a trace written as ``torch.profiler``
writes one: CPU ops with their "External id", runtime calls and kernels
with their "correlation"."""

import json

from horovod_tpu_torch.utils import trace


def _op(name, ts, dur, ext, tid=1):
    return {"ph": "X", "cat": "cpu_op", "name": name, "ts": ts, "dur": dur,
            "pid": 1, "tid": tid, "args": {"External id": ext}}


def _kernel(name, ts, dur, corr, ext=None):
    args = {"correlation": corr}
    if ext is not None:
        args["External id"] = ext
    return {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur,
            "pid": 0, "tid": 7, "args": args}


def _events():
    return [
        # The forward: linear -> matmul -> mm, and a cast on its own.
        _op("aten::linear", 0, 100, 1), _op("aten::matmul", 5, 90, 2),
        _op("aten::mm", 10, 80, 3), _op("aten::to", 120, 30, 4),
        _op("aten::_to_copy", 121, 28, 5),
        # Backward, on the autograd thread.
        _op("autograd::engine::evaluate_function: MulBackward0", 200, 50, 6,
            tid=2),
        _op("aten::mul", 210, 20, 7, tid=2),
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 212, "dur": 3, "pid": 1, "tid": 2,
         "args": {"correlation": 99, "External id": 7}},
        _kernel("sm90_xmma_gemm", 20, 50, 90, ext=3),
        _kernel("elementwise_kernel<copy>", 125, 10, 91, ext=5),
        _kernel("elementwise_kernel<mul>", 230, 8, 99),   # via correlation
        _kernel("vectorized_elementwise_kernel", 300, 4, 100),   # no link
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoD", "ts": 310,
         "dur": 2, "pid": 0, "tid": 7, "args": {"External id": 4}},
    ]


def test_each_kernel_names_its_op_and_outermost_op():
    got = [(e["name"], op, root)
           for e, op, root in trace.ops_of_kernels(_events())]
    assert got == [
        ("sm90_xmma_gemm", "aten::mm", "aten::linear"),
        ("elementwise_kernel<copy>", "aten::_to_copy", "aten::to"),
        ("elementwise_kernel<mul>", "aten::mul",
         "autograd::engine::evaluate_function: MulBackward0"),
        ("vectorized_elementwise_kernel", "?", "?"),
        ("Memcpy DtoD", "aten::to", "aten::to")]


def test_wide_route_kernels_keep_their_kind():
    for name, kind in (
            ("void (anonymous namespace)::wide::flash_fwd_wide_kernel<float>",
             "flash_fwd"),
            ("void (anonymous namespace)::wide::flash_bwd_dq_wide_kernel<"
             "__nv_bfloat16>", "flash_bwd_dq"),
            ("void (anonymous namespace)::wide::flash_bwd_dkv_wide_kernel<"
             "float>", "flash_bwd_dkv")):
        assert trace.kind_of(name) == kind


def test_measure_reports_other_kernels_by_op(monkeypatch, tmp_path):
    # measure() on a profiler that writes the trace above: "other" device
    # time per call by "outermost op / op", and kernels per call.
    class FakeProfile:
        def __init__(self, **kw):
            pass

        def __enter__(self):
            return self

        def __exit__(self, *a):
            return False

        def export_chrome_trace(self, path):
            with open(path, "w") as f:
                json.dump({"traceEvents": _events()}, f)

    monkeypatch.setattr(trace.torch.profiler, "profile", FakeProfile)
    monkeypatch.setattr(trace.torch.cuda, "synchronize", lambda: None)
    row = trace.measure("step", lambda: None, 2, str(tmp_path))
    assert row["kernels_per_call"] == 2.5
    assert row["device_ms_by_kind"]["matmul"] == 0.025
    assert row["other_by_op"] == {
        "aten::to / aten::_to_copy": [0.005, 0.5],
        "autograd::engine::evaluate_function: MulBackward0 / aten::mul":
            [0.004, 0.5],
        "? / ?": [0.002, 0.5],
        "aten::to / aten::to": [0.001, 0.5]}
    assert row["top_kernels_by_op"]["sm90_xmma_gemm"] == {
        "aten::linear / aten::mm": 0.025}
    # Every device event of the trace above runs on stream 7 (its tid).
    assert row["device_ms_by_stream"] == {"7": 0.037}
