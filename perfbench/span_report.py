"""The program's own spans on the card, beside the benchmark's outside
readings; the benchmark's runs never run it.

    python3 -m perfbench.span_report --workload <cell> --seed <n> \\
        --seconds <s>
    python3 -m perfbench.span_report --cost

With ``--workload``: one traced run of the cell, as ``--trace 1`` makes
it, and one JSON line: the cell's per-layer metrics, the program's spans
a step (training) or a decode (serving) by name, the traced window's
throughput, the breakdown, and the pairs of a program span's reading and
the benchmark's outside metric that measures the same work:

* ``train.optimizer``'s device ms a step against
  ``optimizer_device_ms.train`` (the benchmark's span around
  ``opt.step``);
* ``optimizer.synchronize`` + ``master.grads_in`` + ``master.params_out``
  + torch's own ``Optimizer.step#AdamW.step`` range, against the same;
* the flash roofline over the ``attention.flash`` spans against
  ``flash_attention_roofline`` (the benchmark's span around
  ``attention_fn`` and its backward nodes);
* ``serve.decode``'s and ``serve.prefill``'s host wall a call against
  ``decode_step_ms.serve`` and ``prefill_ms.serve`` (the benchmark's
  wrappers around the backend's calls).

With ``--cost``: the host cost of one ``profiling.span`` with no
profiler recording and inside a recording profiler, and of a bare
``record_function`` with none, in µs a span."""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

from perfbench import harness, run, spans, tracing  # noqa: E402

PROGRAM_SPANS = (
    "train.forward", "train.backward", "train.optimizer",
    "optimizer.synchronize", "master.grads_in", "master.params_out",
    "attention.flash", "serve.step", "serve.prefill", "serve.decode",
    "attention.decode", "serve.to_host", "paged_gather", "paged_scatter")


def _pair(program, outside) -> dict:
    gap = None if program is None or not outside else \
        (program - outside) / outside
    return {"program": program, "outside": outside, "gap": gap}


def _ending(events, suffix: str) -> list[dict]:
    return [e for e in tracing.cpu_ops(events) if e["name"].endswith(suffix)]


def agreement(t: dict, metrics: dict) -> dict:
    """The pairs of readings of the module's docstring for trace ``t``."""
    evs = t["events"]
    out = {}
    outside = {k: v["value"] for k, v in metrics.items()}
    if t.get("phase") == "train" and t.get("family") == "decoder":
        steps = t["steps"]
        opt = spans.train_device_ms(t, "decoder", "train.optimizer")
        adamw = spans.device_ms(evs, _ending(evs, "AdamW.step"), steps)
        parts = [outside.get("optimizer_sync_device_ms.train"),
                 outside.get("master_cast_device_ms.train"), adamw]
        flash = spans.launched_in(evs, spans.spans(evs, "attention.flash"))
        busy = tracing.busy_us(flash) / 1e6
        out["adamw_step_device_ms"] = adamw
        out["train.optimizer"] = _pair(
            opt, outside.get("optimizer_device_ms.train"))
        out["optimizer_parts"] = _pair(
            None if None in parts else sum(parts),
            outside.get("optimizer_device_ms.train"))
        out["flash_roofline"] = _pair(
            100.0 * t["attention_least_s"] * steps / busy if busy else None,
            outside.get("flash_attention_roofline"))
    elif t.get("phase") == "train":
        out["train.optimizer_device_ms"] = spans.train_device_ms(
            t, t["family"], "train.optimizer")
    if t.get("phase") == "serve":
        for name, metric in (("serve.decode", "decode_step_ms.serve"),
                             ("serve.prefill", "prefill_ms.serve")):
            s = spans.spans(evs, name)
            wall = sum(e["dur"] for e in s) / 1e3 / len(s) if s else None
            out[name + "_host_ms"] = _pair(wall, outside.get(metric))
    return out


def per(t: dict) -> float:
    """Steps (training) or decodes (serving) in the window."""
    if t.get("phase") == "serve":
        return len(spans.spans(t["events"], "serve.decode"))
    return t["steps"]


def report(cell_name: str, seed: int, seconds: float) -> dict:
    bench = harness.spec()
    cell = harness.cell(cell_name, bench)
    cfg = harness.config(cell["config"])
    traffic = harness.traffic(cell["traffic"])
    harness.env_for_program()
    harness.require_cuda(cell["chips"])
    import torch

    device = torch.device("cuda", 0)
    r = run.Run(cell=cell, cfg=cfg, traffic=traffic, seed=seed,
                seconds=seconds, trace=True, device=device, t0=T0,
                chips=cell["chips"])
    out = harness.kind(traffic["kind"]).run(r)
    correct, checks = harness.judge(out["numbers"],
                                    harness.limits(cell_name))
    t = out["trace"]
    metrics = run.per_layer(cell_name, t, bench)
    n = per(t)
    counts = {name: len(spans.spans(t["events"], name)) / n
              for name in PROGRAM_SPANS}
    traced = None
    if t.get("phase") == "train":
        unit = traffic["batch"] * (traffic.get("seq_len", 1)
                                   if t["family"] == "decoder" else 1)
        traced = t["steps"] * unit / t["window_s"]
    return {"cell": cell_name, "seed": seed, "correct": correct,
            "checks": checks, "device": torch.cuda.get_device_name(0),
            # The decoder's training kind runs only its traced window
            # under --trace 1; the others time an untraced one first.
            "e2e": out["e2e"], "traced_per_s": traced,
            "window_s": t["window_s"], "busy_s": t["busy_s"], "per": n,
            "metrics": metrics, "spans_per": {k: v for k, v in counts.items()
                                              if v},
            "agreement": agreement(t, metrics),
            "breakdown": out["window"].breakdown()}


def _per_span_us(make, n: int) -> float:
    t = time.perf_counter()
    for _ in range(n):
        with make("x"):
            pass
    return (time.perf_counter() - t) / n * 1e6


def cost(n: int = 200_000) -> dict:
    """µs a span: ``profiling.span`` off and on, ``record_function``
    with no profiler; the best of five rounds of ``n``."""
    import torch

    from horovod_tpu_torch.utils import profiling

    bare = torch.profiler.record_function
    out = {"span_off_us": min(_per_span_us(profiling.span, n)
                              for _ in range(5)),
           "record_function_off_us": min(_per_span_us(bare, n // 10)
                                         for _ in range(5))}
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts):
        out["span_on_us"] = min(_per_span_us(profiling.span, n // 10)
                                for _ in range(5))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m perfbench.span_report")
    ap.add_argument("--workload")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--seconds", type=float, default=45.0)
    ap.add_argument("--cost", action="store_true")
    args = ap.parse_args(argv)
    if args.cost:
        print(json.dumps(cost()), flush=True)
        return 0
    if not args.workload:
        ap.error("--workload or --cost")
    print(json.dumps(report(args.workload, args.seed, args.seconds)),
          flush=True)
    harness.check_imports()
    return 0


if __name__ == "__main__":
    sys.exit(main())
