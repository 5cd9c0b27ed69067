"""``python -m horovod_tpu_torch.examples.longctx_audit`` — is the ring's
K/V exchange posted before the step's flash kernel?  Counterpart of
``examples/longctx_audit.py``.

The JAX audit reads the traced jaxpr; the port's ring passes run eagerly,
so this one records the port's own events while they run: every ring
exchange posted (``_Rotation``, with the storages of the tensors it
sends), every wait for one, and every flash kernel call
(``flash_attention_with_lse`` forward, ``flash_attention_backward``), with
the storages of its outputs.  Run over a group of two or more processes
(``python -m horovod_tpu_torch.run -np 2 -- ...``; on one card pass
``--backend gloo``, as NCCL refuses two ranks on one device):

* **overlap**: in every ring pass of the plain and zigzag layouts,
  forward and gradient, each step but the last posts its next K/V
  exchange (two tensors) before the step's first kernel call, and sends no
  storage that a kernel of the step wrote; each pass posts ``n − 1`` K/V
  exchanges (the last step forwards nothing).  The backward's dk/dv
  rotation (``_rotate``) depends on the kernels by design and is not
  counted, as in the JAX audit.
* **step skipping**: on the plain causal layout, rank ``r`` runs ``r + 1``
  flash steps (``ring_flash_attention_stats``), gathered over the group.
* **planner**: ``plan_context`` picks zigzag for causal multi-shard work
  at S = 8192 and 32768 (width 8, 16 heads of 128), its remat decision,
  and every tile fits the card's 227 KB of shared memory a block.

``--assert-planner`` runs the three and exits 1 on any failure; rank 0
prints the JSON either way.  On the card the passes run the three flash
kernels at the ring's offsets; ``launches`` sums each kernel's launches
over the ranks (0 on the CPU, where the plain versions run), and
``flash_calls`` lists every distinct call the ranks made (``fwd`` for the
forward kernel, ``bwd`` for the dq and dk/dv pair: batch, query and key
lengths, heads, head dim, dtype, causal, query and key offsets, and
whether q, k and v were contiguous), so that a caller can hold the kernels
against their plain versions at exactly those calls.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import json
import os

import torch
import torch.distributed as dist

import horovod_tpu_torch as hvd
from horovod_tpu_torch import basics
from horovod_tpu_torch.examples._common import add_device
from horovod_tpu_torch.ops import _build

# The module, not the function that ``horovod_tpu_torch.parallel`` exports
# under the same name.
ra = importlib.import_module("horovod_tpu_torch.parallel.ring_attention")

B, H, D = 1, 2, 64
HOPPER_SMEM_BYTES = 227 * 1024


def _storages(tensors) -> list[int]:
    return [t.untyped_storage().data_ptr() for t in tensors
            if isinstance(t, torch.Tensor)]


@contextlib.contextmanager
def recording():
    """Record the ring's events into the list yielded: ``("pass", name)``,
    ``("post", storages, exempt)``, ``("wait",)``, ``("kernel",
    storages)``."""
    events: list[tuple] = []
    exempt = [0]
    saved = {name: getattr(ra, name) for name in (
        "_Rotation", "_rotate", "flash_attention_with_lse",
        "flash_attention_backward", "_ring_flash_forward",
        "_zigzag_flash_forward")}
    backwards = {cls: cls.backward for cls in (ra._RingFlash,
                                               ra._ZigzagFlash)}

    class Rotation(saved["_Rotation"]):
        def __init__(self, tensors, group, shift: int = 1):
            events.append(("post", _storages(tensors), exempt[0] > 0,
                           len(tensors)))
            super().__init__(tensors, group, shift)

        def wait(self):
            events.append(("wait", exempt[0] > 0))
            return super().wait()

    def rotate(tensors, group):
        exempt[0] += 1
        try:
            return saved["_rotate"](tensors, group)
        finally:
            exempt[0] -= 1

    def kernel(fn):
        def call(*args, **kw):
            out = fn(*args, **kw)
            events.append(("kernel", _storages(out)))
            return out
        return call

    def marked(name, fn):
        def call(*args, **kw):
            events.append(("pass", name))
            return fn(*args, **kw)
        return call

    ra._Rotation, ra._rotate = Rotation, rotate
    ra.flash_attention_with_lse = kernel(saved["flash_attention_with_lse"])
    ra.flash_attention_backward = kernel(saved["flash_attention_backward"])
    ra._ring_flash_forward = marked("fwd", saved["_ring_flash_forward"])
    ra._zigzag_flash_forward = marked("fwd", saved["_zigzag_flash_forward"])
    for cls, fn in backwards.items():
        cls.backward = staticmethod(marked("bwd", fn))
    try:
        yield events
    finally:
        for name, fn in saved.items():
            setattr(ra, name, fn)
        for cls, fn in backwards.items():
            cls.backward = staticmethod(fn)


def _signature(kind: str, q, k, causal, q_off, k_off) -> tuple:
    b, s_q, h, d = q.shape
    return (kind, b, s_q, k.shape[1], h, d, str(q.dtype).removeprefix(
        "torch."), bool(causal), int(q_off), int(k_off),
        q.is_contiguous() and k.is_contiguous())


@contextlib.contextmanager
def flash_calls():
    """Add the signature (see the module docstring) of every flash call
    the ring makes to the set yielded."""
    seen: set[tuple] = set()
    fwd, bwd = ra.flash_attention_with_lse, ra.flash_attention_backward

    def forward(q, k, v, causal, q_off, k_off):
        seen.add(_signature("fwd", q, k, causal, q_off, k_off))
        return fwd(q, k, v, causal, q_off, k_off)

    def backward(q, k, v, dout, lse, delta, causal, q_off, k_off):
        seen.add(_signature("bwd", q, k, causal, q_off, k_off))
        return bwd(q, k, v, dout, lse, delta, causal, q_off, k_off)

    ra.flash_attention_with_lse, ra.flash_attention_backward = forward, \
        backward
    try:
        yield seen
    finally:
        ra.flash_attention_with_lse, ra.flash_attention_backward = fwd, bwd


def _passes(events) -> list[tuple[str, list]]:
    out = []
    for e in events:
        if e[0] == "pass":
            out.append((e[1], []))
        elif out:
            out[-1][1].append(e)
    return out


def audit_pass(events, n: int) -> dict:
    """One ring pass: split into steps at each K/V wait, then check each
    step's prefetch."""
    steps, cur = [], []
    for e in events:
        cur.append(e)
        if e[0] == "wait" and not e[1]:
            steps.append(cur)
            cur = []
    steps.append(cur)
    kv_posts = [e for e in events if e[0] == "post" and not e[2]]
    prefetched = 0
    for step in steps[:-1]:
        kernels = [i for i, e in enumerate(step) if e[0] == "kernel"]
        first = kernels[0] if kernels else len(step)
        written = {p for i in kernels for p in step[i][1]}
        if any(e[0] == "post" and not e[2] and i < first and e[3] >= 2
               and not written & set(e[1]) for i, e in enumerate(step)):
            prefetched += 1
    return {"steps": len(steps), "kv_exchanges": len(kv_posts),
            "prefetched_steps": prefetched,
            "kernel_calls": sum(1 for e in events if e[0] == "kernel"),
            "exempt_rotations": sum(1 for e in events
                                    if e[0] == "post" and e[2])}


def _qkv(s_local: int, device, dtype):
    gen = torch.Generator().manual_seed(basics.rank())
    return [torch.randn(B, s_local, H, D, generator=gen).to(device, dtype)
            .requires_grad_() for _ in range(3)]


def audit_overlap(s_local: int, device, dtype) -> dict:
    n = hvd.size()
    out = {"ring_size": n}
    for layout, fn in (("plain", ra.ring_flash_attention),
                       ("zigzag", ra.zigzag_ring_flash_attention)):
        for mode in ("fwd", "grad"):
            q, k, v = _qkv(s_local, device, dtype)
            with recording() as events:
                if mode == "fwd":
                    with torch.no_grad():
                        fn(q, k, v, causal=True)
                else:
                    fn(q, k, v, causal=True).float().sum().backward()
            out[f"{layout}_{mode}"] = [
                dict(audit_pass(evs, n), phase=name)
                for name, evs in _passes(events)]
    return out


def audit_step_skip(s_local: int, device, dtype) -> dict:
    n = hvd.size()
    q, k, v = (t.detach() for t in _qkv(s_local, device, dtype))
    _, steps = ra.ring_flash_attention_stats(q, k, v, causal=True)
    gathered = [None] * n
    dist.all_gather_object(gathered, int(steps),
                           group=basics.process_group())
    return {"ring_size": n, "steps_per_rank": gathered,
            "expected": list(range(1, n + 1)),
            "exact": gathered == list(range(1, n + 1)),
            "interior_ranks_skip": all(s < n for s in gathered[:-1])}


def audit_planner() -> dict:
    from horovod_tpu_torch.ops.schedule_plan import (ContextWorkload,
                                                     plan_context)

    out = {}
    for s in (8192, 32768):
        wl = ContextWorkload(seq_len=s, num_heads=16, head_dim=128)
        out[f"s{s}"] = plan_context(wl, 8).as_dict()
    out["checks"] = {
        "zigzag_default_for_causal": all(
            out[f"s{s}"]["layout"] == "zigzag" for s in (8192, 32768)),
        "smem_fits_all": all(
            out[f"s{s}"]["smem_bytes"] <= HOPPER_SMEM_BYTES
            for s in (8192, 32768)),
    }
    return out


def failures_of(overlap: dict, skip: dict, planner: dict) -> list[str]:
    n = overlap["ring_size"]
    failures = []
    for name in ("plain_fwd", "plain_grad", "zigzag_fwd", "zigzag_grad"):
        passes = overlap[name]
        want = 1 if name.endswith("fwd") else 2
        if len(passes) != want:
            failures.append(f"{name}: {len(passes)} ring passes, expected "
                            f"{want}")
        for a in passes:
            if a["kv_exchanges"] != n - 1:
                failures.append(
                    f"{name} {a['phase']}: {a['kv_exchanges']} K/V "
                    f"exchanges, expected {n - 1} (the last step forwards "
                    f"nothing)")
            if a["prefetched_steps"] != n - 1:
                failures.append(
                    f"{name} {a['phase']}: {a['prefetched_steps']} of "
                    f"{n - 1} steps post their K/V exchange before the "
                    f"kernel — the rotation is serialized behind it")
    if not skip["exact"]:
        failures.append(f"causal plain steps {skip['steps_per_rank']} != "
                        f"{skip['expected']}")
    for check, ok in planner["checks"].items():
        if not ok:
            failures.append(f"planner: {check} failed")
    return failures


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m horovod_tpu_torch.examples"
                                 ".longctx_audit")
    ap.add_argument("--assert-planner", action="store_true")
    ap.add_argument("--seq-local", type=int, default=128,
                    help="tokens a rank (even: zigzag halves it)")
    ap.add_argument("--backend", default=None,
                    help="process-group backend (gloo for ranks sharing a "
                    "card)")
    add_device(ap)
    args = ap.parse_args(argv)
    for v in list(os.environ):
        if v.startswith(("HVD_TPU_CTX_", "HOROVOD_CTX_")):
            os.environ.pop(v)   # audit the shipped defaults
    hvd.init(device=args.device, backend=args.backend)
    try:
        if hvd.size() < 2:
            raise SystemExit("longctx_audit needs a ring of at least two "
                             "processes (python -m horovod_tpu_torch.run "
                             "-np 2 -- ...)")
        dev = basics.device()
        dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
        _build.reset_launches()
        with flash_calls() as calls:
            overlap = audit_overlap(args.seq_local, dev, dtype)
            skip = audit_step_skip(args.seq_local, dev, dtype)
        planner = audit_planner()
        failures = failures_of(overlap, skip, planner)
        mine = {name: k.launches for name, k in _build.KERNELS.items()}
        every = [None] * hvd.size()
        dist.all_gather_object(every, (mine, calls),
                               group=basics.process_group())
        if hvd.rank() == 0:
            print(json.dumps({
                "overlap": overlap, "step_skip": skip, "planner": planner,
                "launches": {k: sum(r.get(k, 0) for r, _ in every)
                             for k in mine},
                "flash_calls": sorted(set().union(*(c for _, c in every))),
                "failures": failures}), flush=True)
    finally:
        hvd.shutdown()
    return 1 if args.assert_planner and failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
