"""``python -m horovod_tpu_torch.examples.overlap_audit`` — does the
port's ``DistributedOptimizer`` issue its gradient buckets while backward
is still running?  Counterpart of ``examples/overlap_audit.py``.

The JAX audit reads the compiled HLO's schedule; the port has no compiled
schedule to read, so this one reads the port's own events.  It builds the
JAX audit's MLP (eight 1024-wide dense layers and a 10-way head, f32) under
``DistributedOptimizer`` with the schedule planner's default, takes two
steps (the first plans) and on the second records

* every gradient's arrival, from a post-accumulate-grad hook of its own
  registered after the optimizer's;
* every bucket's allreduce as it is issued (the optimizer's ``_issue``),
  with its index and whether backward had returned yet;
* ``overlap_plan()``, the planner's decision for the step.

Run at the job's width (one JSON row from rank 0)::

    python -m horovod_tpu_torch.examples.overlap_audit            # width 1
    python -m horovod_tpu_torch.run -np 2 -- \\
        python -m horovod_tpu_torch.examples.overlap_audit --device cpu

``--assert-planner`` runs both branches of the planner and exits 1 on a
regression: a width-2 job (two gloo processes on the CPU, under the
launcher) must chain at depth ``DEFAULT_OVERLAP_BUCKETS`` with the
adaptive planner and issue every bucket, in plan order, from the hooks
before backward returns; width 1 (in this process, on ``--device``) must
bypass: no hook, no bucket issued from one.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

import horovod_tpu_torch as hvd
from horovod_tpu_torch import basics
from horovod_tpu_torch.examples._common import add_device
from horovod_tpu_torch.utils import env as hvd_env

WIDTH, DEPTH, BATCH = 1024, 8, 16


def build_model(device) -> torch.nn.Sequential:
    torch.manual_seed(0)
    layers = []
    for _ in range(DEPTH):
        layers += [torch.nn.Linear(WIDTH, WIDTH), torch.nn.ReLU()]
    return torch.nn.Sequential(*layers, torch.nn.Linear(WIDTH, 10)).to(device)


def train_step(model, opt, x, y, on_backward_end=None) -> torch.Tensor:
    opt.zero_grad(set_to_none=True)
    loss = F.cross_entropy(model(x), y)
    loss.backward()
    if on_backward_end is not None:
        on_backward_end()
    opt.step()
    return loss.detach()


def audit(device) -> dict:
    """The audit at the job's width; needs :func:`hvd.init`."""
    model = build_model(device)
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.01),
        named_parameters=model.named_parameters())
    x = torch.randn(BATCH, WIDTH, device=device)
    y = torch.randint(0, 10, (BATCH,), device=device)
    train_step(model, opt, x, y)          # the first step plans

    events: list[tuple] = []
    in_backward = [True]
    t0 = time.perf_counter()

    def stamp():
        return (time.perf_counter() - t0) * 1e3

    issue = opt._issue

    def issued(b):
        events.append(("issue", b, in_backward[0], stamp()))
        issue(b)

    opt._issue = issued
    names = {id(p): n for n, p in model.named_parameters()}
    hooks = [p.register_post_accumulate_grad_hook(
        lambda p: events.append(("grad", names[id(p)], True, stamp())))
        for p in model.parameters()]

    def backward_end():
        in_backward[0] = False
        events.append(("backward_end", None, False, stamp()))

    try:
        train_step(model, opt, x, y, backward_end)
    finally:
        for h in hooks:
            h.remove()
        del opt._issue
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    order = [b for kind, b, _, _ in events if kind == "issue"]
    end = next(t for kind, _, _, t in events if kind == "backward_end")
    return {
        "width": hvd.size(), "plan": hvd.overlap_plan(),
        "optimizer_hooks": len(opt._hooks),
        "buckets_issued": order,
        "issued_in_backward": sum(1 for kind, _, live, _ in events
                                  if kind == "issue" and live),
        "gradients": sum(1 for kind, *_ in events if kind == "grad"),
        "backward_end_ms": end,
        "issue_ms": [t for kind, _, _, t in events if kind == "issue"],
        "manifest": [[list(p.shape), str(p.dtype).replace("torch.", "")]
                     for p in model.parameters()],
    }


def width2_audit(timeout: float = 600.0) -> dict:
    """The audit of a two-process gloo job on the CPU, under the launcher:
    rank 0's row."""
    out = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.run", "-np", "2", "--",
         sys.executable, "-m", "horovod_tpu_torch.examples.overlap_audit",
         "--device", "cpu"], capture_output=True, text=True,
        timeout=timeout)
    rows = [json.loads(line.split("]: ", 1)[1]) for line in
            out.stdout.splitlines() if line.startswith("[0]: {")]
    if out.returncode != 0 or not rows:
        raise RuntimeError(f"the width-2 audit exited {out.returncode}:\n"
                           f"{out.stdout[-2000:]}\n{out.stderr[-2000:]}")
    return rows[-1]


def planner_failures(wide: dict, w1: dict) -> list[str]:
    depth = hvd_env.DEFAULT_OVERLAP_BUCKETS
    failures = []
    plan = wide["plan"]
    if not (plan and plan["chained"] and plan["chain_depth"] == depth
            and plan["planner"] == "adaptive" and plan["width"] == 2):
        failures.append(f"width-2 plan lost the default chain: {plan}")
    if wide["buckets_issued"] != list(range(depth)):
        failures.append(f"width-2 buckets issued out of plan order: "
                        f"{wide['buckets_issued']}")
    if wide["issued_in_backward"] != depth:
        failures.append(f"width-2: {wide['issued_in_backward']} of {depth} "
                        f"buckets issued before backward returned")
    plan = w1["plan"]
    if not (plan and not plan["chained"] and plan["chain_depth"] == 0
            and plan["planner"] == "adaptive" and plan["width"] == 1):
        failures.append(f"width-1 plan failed to bypass the chain: {plan}")
    if w1["optimizer_hooks"] or w1["issued_in_backward"]:
        failures.append(f"width-1 registered {w1['optimizer_hooks']} hooks "
                        f"and issued {w1['issued_in_backward']} buckets "
                        f"from them")
    return failures


def assert_planner(device) -> int:
    """Both branches of the planner; 1 on any regression."""
    for v in ("HOROVOD_OVERLAP_BUCKETS", "HVD_TPU_OVERLAP_BUCKETS"):
        os.environ.pop(v, None)   # audit the shipped default
    wide = width2_audit()
    hvd.init(device=device)
    try:
        w1 = audit(basics.device())
    finally:
        hvd.shutdown()
    failures = planner_failures(wide, w1)
    print(json.dumps({"width2": wide, "width1": w1, "failures": failures}),
          flush=True)
    return 1 if failures else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m horovod_tpu_torch.examples"
                                 ".overlap_audit")
    ap.add_argument("--assert-planner", action="store_true")
    add_device(ap)
    args = ap.parse_args(argv)
    if args.assert_planner:
        return assert_planner(args.device)
    hvd.init(device=args.device)
    try:
        row = audit(basics.device())
        if hvd.rank() == 0:
            print(json.dumps(row), flush=True)
    finally:
        hvd.shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
