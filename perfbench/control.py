"""Readings of a cell's control and planted faults, for setting its
limits (``limits/<cell>.json``); the benchmark's own runs never run it.

    python3 -m perfbench.control --workload <cell> --seeds <n> [<n> ...] \\
        [--seconds <s>]

Training cells: the control is the plain reference computed with what
the program holds in bf16 rounded through float8 e4m3 (the step below
the configuration's bf16), put in the program's place; the planted fault
is half of each batch left out, the mean taken over the rest, in the
reference put in the program's place.  A cell of several chips is read
on one card over its global batch.  Each is compared with the float32
reference by the cell's own numbers (``compare.training_numbers``), at
the cell's own sizes.  A state left unchanged reads 1 on the gradient
and change numbers by their definition and needs no run.

Serving cells: a run of the cell with a short window at its own load,
then on the same sample of served requests both the program's number and
the control's: at each position, the gap of the token that the float8
reference puts first.

One JSON line a seed."""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402

from perfbench import compare, harness  # noqa: E402


def training(cell, cfg, traffic, seed, device) -> dict:
    """On one card; a cell of several chips as its global batch, every
    rank's rows of each step together."""
    kind = harness.kind(traffic["kind"])
    if traffic["kind"] == "train_decoder":
        import torch

        pools = [kind.token_pool(cfg, traffic, seed, device, rank)
                 for rank in range(cell["chips"])]
        batches = [torch.cat([p[i] for p in pools])
                   for i in range(traffic["check_steps"])]
    else:
        x, y = kind.image_pool(cfg, traffic, seed, device)
        batches = [(x[i], y[i]) for i in range(traffic["check_steps"])]
    from perfbench.run import Run

    run = Run(cell=cell, cfg=cfg, traffic=traffic, seed=seed, seconds=0,
              trace=False, device=device, t0=T0)
    ref = kind.reference_readings(run, batches)
    ctl = kind.reference_readings(run, batches, quant="fp8")
    half = kind.reference_readings(run, batches,
                                   rows=batches[0].shape[0] // 2
                                   if traffic["kind"] == "train_decoder"
                                   else traffic["batch"] // 2)
    return {"seed": seed,
            "control": compare.training_numbers(ctl, ref),
            "faults": {"half_batch": compare.training_numbers(half, ref)},
            "reference_losses": ref["losses"]}


def serving(cell, cfg, traffic, seed, seconds, device) -> dict:
    from perfbench.kinds import serve_decoder
    from perfbench.run import Run

    run = Run(cell=cell, cfg=cfg, traffic=traffic, seed=seed,
              seconds=seconds, trace=False, device=device, t0=T0)
    out = serve_decoder.run(run, control="fp8")
    return {"seed": seed, "program": out["numbers"],
            "control": out["control"], "e2e": out["e2e"]}


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(prog="python3 -m perfbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args(argv)
    cell = harness.cell(args.workload)
    cfg, traffic = harness.config(cell["config"]), \
        harness.traffic(cell["traffic"])
    harness.env_for_program()
    harness.require_cuda(1)
    device = torch.device("cuda", 0)
    for seed in args.seeds:
        if traffic["kind"].startswith("serve"):
            line = serving(cell, cfg, traffic, seed, args.seconds, device)
        else:
            line = training(cell, cfg, traffic, seed, device)
        print(json.dumps(line), flush=True)
    harness.check_imports()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
