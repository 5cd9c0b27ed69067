"""The port's linter (``horovod_tpu_torch.analysis.lint``): every rule fires
on its seeded violation (exact error code asserted), stays quiet on the
clean twin, and honours the ``# hvd-lint: disable=CODE`` suppression.

The carried rules (HVD101, 102, 103, 106, 107, 110) port the fixtures of
``tests/test_lint.py`` with the port's names and also know the
``torch.distributed`` spellings.  The four torch-side rules (HVD104, 105,
108, 109) have fixtures of their own, and each has a hazard test that shows
on the CPU what the rule claims PyTorch does (the CUDA-graph half of HVD104
needs a card and is marked ``cuda``).  The parity tests hold the carried
rules against the JAX linter on the same inputs: every fixture of
``tests/test_lint.py`` and every ``.py`` file of ``horovod_tpu/``,
``examples/`` and ``tests/``.  The last test dogfoods the linter on the
port's tree.

Fixtures live in strings, as ``tests/test_lint.py`` keeps its own: the JAX
linter runs over this file too.  Nothing here imports JAX at module level.
"""

import ast
import datetime
import os
import random
import re
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch

from horovod_tpu_torch.analysis import rules as port_rules
from horovod_tpu_torch.analysis.lint import lint_paths, lint_source

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CARRIED = {"HVD000", "HVD101", "HVD102", "HVD103", "HVD106", "HVD107",
           "HVD110"}


def codes(src: str) -> list[str]:
    return [e.code for e in lint_source(textwrap.dedent(src), "fixture.py")]


# ---------------------------------------------------------------------------
# HVD101 — rank-divergent collective
# ---------------------------------------------------------------------------

def test_hvd101_collective_under_rank_branch():
    assert codes("""
        import horovod_tpu_torch as hvd

        def step(x):
            if hvd.rank() == 0:
                hvd.allreduce(x)
    """) == ["HVD101"]


def test_hvd101_unbalanced_else_branch():
    assert codes("""
        import horovod_tpu_torch as hvd

        def step(x):
            if hvd.rank() == 0:
                hvd.allreduce(x)
            else:
                hvd.allgather(x)
    """) == ["HVD101"]


def test_hvd101_ifexp_and_local_rank():
    assert codes("""
        import horovod_tpu_torch as hvd

        def step(x):
            y = hvd.broadcast(x, 0) if hvd.local_rank() == 0 else None
            return y
    """) == ["HVD101"]


def test_hvd101_clean_when_branches_match():
    assert codes("""
        import horovod_tpu_torch as hvd

        def step(x, obj):
            if hvd.rank() == 0:
                out = hvd.broadcast_object(obj)
            else:
                out = hvd.broadcast_object(None)
            if hvd.rank() == 0:
                print("root only, no collectives")
            return out
    """) == []


def test_hvd101_clean_tensor_rank_not_flagged():
    assert codes("""
        import torch
        import horovod_tpu_torch as hvd

        def step(x):
            if torch.linalg.matrix_rank(x) == 2:
                hvd.allreduce(x)
    """) == []


def test_hvd101_torch_distributed_spellings():
    # The in-process collectives are plain calls in the port: under a
    # get_rank() branch they deadlock like the public ones.
    assert codes("""
        import torch
        import torch.distributed as dist

        def step(x, group):
            if dist.get_rank() == 0:
                dist.all_reduce(x)
            if dist.get_rank(group) == 1:
                torch.distributed.barrier()
            if dist.get_rank() == 0:
                dist.reduce_scatter_tensor(x, x)
            else:
                dist.all_gather_into_tensor(x, x)
    """) == ["HVD101", "HVD101", "HVD101"]


def test_hvd101_port_group_collectives():
    assert codes("""
        from horovod_tpu_torch.parallel import common
        from horovod_tpu_torch.parallel.common import all_to_all

        def step(x, group):
            if common.group_rank(group) == 0:
                common.all_gather(x, group)
            y = all_to_all(x, group) if common.group_rank(group) else x
            return y
    """) == ["HVD101", "HVD101"]


def test_hvd101_clean_point_to_point_and_world_size():
    # A rank-conditional send/recv pair is the normal idiom, a world-size
    # test is the same on every rank, and an unresolved bare all_gather is
    # not torch.distributed's.
    assert codes("""
        import torch.distributed as dist

        def step(x, all_gather):
            if dist.get_rank() == 0:
                dist.send(x, 1)
            else:
                dist.recv(x, 0)
            if dist.get_world_size() > 1:
                dist.all_reduce(x)
            if dist.get_rank() == 0:
                all_gather(x)
    """) == []


# ---------------------------------------------------------------------------
# HVD102 — unnamed engine collective in a loop
# ---------------------------------------------------------------------------

def test_hvd102_async_in_loop_without_name():
    assert codes("""
        import horovod_tpu_torch as hvd

        def push(grads):
            hs = []
            while grads:
                hs.append(hvd.allreduce_async(grads.pop()))
            return hs
    """) == ["HVD102"]


def test_hvd102_clean_with_name_or_outside_loop():
    assert codes("""
        import horovod_tpu_torch as hvd

        def push(grads, x):
            hvd.allreduce_async(x)  # not in a loop: auto-name is fine
            return [hvd.allreduce_async(g, name=f"g.{i}")
                    for i, g in enumerate(grads)]
    """) == []


# ---------------------------------------------------------------------------
# HVD103 — nondeterministic collective names
# ---------------------------------------------------------------------------

def test_hvd103_name_from_set_iteration():
    assert codes("""
        import horovod_tpu_torch as hvd

        def push(x):
            for k in {"a", "b"}:
                hvd.allreduce_async(x, name=f"t.{k}")
    """) == ["HVD103"]


def test_hvd103_name_from_dict_items():
    assert codes("""
        import horovod_tpu_torch as hvd

        def push(params):
            for k, v in params.items():
                hvd.allreduce_async(v, name=k)
    """) == ["HVD103"]


def test_hvd103_name_from_id():
    assert codes("""
        import horovod_tpu_torch as hvd

        def push(t):
            hvd.broadcast_async(t, 0, name=str(id(t)))
    """) == ["HVD103"]


def test_hvd103_clean_sorted_iteration():
    assert codes("""
        import horovod_tpu_torch as hvd

        def push(params, x):
            for k in sorted(params.items()):
                hvd.allreduce_async(x, name=f"t.{k}")
    """) == []


# ---------------------------------------------------------------------------
# HVD104 — host randomness or clock in a traced / graph-captured step
# ---------------------------------------------------------------------------

def test_hvd104_random_time_nprandom_in_traced_fn():
    assert codes("""
        import numpy as np
        import random
        import time
        import torch

        def step(x):
            return x * random.random() + time.time() + np.random.uniform()

        traced = torch.jit.trace(step, (torch.ones(2),))
    """) == ["HVD104", "HVD104", "HVD104"]


def test_hvd104_cuda_graph_graphed_callables_and_lambda():
    assert codes("""
        import datetime
        import time
        import torch
        from torch.cuda import make_graphed_callables

        def fwd(x):
            return x + time.monotonic()

        def capture(static_x):
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                y = static_x * datetime.datetime.now().timestamp()
            fns = make_graphed_callables((fwd,), ((static_x,),))
            h = torch.jit.trace(lambda x: x + time.time(), (static_x,))
            return g, y, fns, h
    """) == ["HVD104", "HVD104", "HVD104"]


def test_hvd104_clean_compile_generator_and_host_loop():
    # torch.compile draws random values afresh and reads the clock on every
    # call (test_hvd104_hazard_compile_reads_host_values_afresh), a seeded
    # torch.Generator is traced as a tensor op, and untraced code is fine.
    assert codes("""
        import random
        import time
        import torch

        @torch.compile
        def step(x):
            return x * random.random() + time.time()

        def noisy(x, gen):
            return x + torch.rand(x.shape, generator=gen)

        traced = torch.jit.trace(noisy, (torch.ones(2), torch.Generator()))

        def host_loop(x):
            t0 = time.time()  # not captured: fine
            return x, t0
    """) == []


def test_hvd104_suppressible():
    assert codes("""
        import random
        import torch

        def step(x):
            return x * random.random()  # hvd-lint: disable=HVD104

        traced = torch.jit.trace(step, (torch.ones(2),))
    """) == []


def _host_values(which):
    """A float64 tensor function that adds one host-side value."""
    def host_step(x):
        if which == "random":
            v = random.random()
        elif which == "numpy":
            v = float(np.random.rand())
        elif which == "time":
            v = time.time()
        else:
            v = datetime.datetime.now().timestamp()
        return x + v
    return host_step


@pytest.mark.parametrize("which", ["random", "numpy", "time", "datetime"])
def test_hvd104_hazard_trace_freezes_host_values(which):
    """The hazard HVD104 names: torch.jit.trace records the value drawn
    while tracing as a constant, so every later call replays it."""
    x = torch.zeros(1, dtype=torch.float64)
    traced = torch.jit.trace(_host_values(which), (x,),  # hvd-lint: disable=HVD104
                             check_trace=False)
    first = traced(x).item()
    time.sleep(0.02)
    assert traced(x).item() == first


@pytest.mark.parametrize("which", ["random", "numpy", "time", "datetime"])
def test_hvd104_hazard_compile_reads_host_values_afresh(which):
    """Why HVD104 does not flag torch.compile: dynamo draws random values
    afresh and breaks the graph at the clock, so each call sees a new
    value (float64, so that a clock 20 ms later is a different number)."""
    torch._dynamo.reset()
    compiled = torch.compile(_host_values(which), backend="eager")
    x = torch.zeros(1, dtype=torch.float64)
    first = compiled(x).item()
    time.sleep(0.02)
    assert compiled(x).item() != first
    torch._dynamo.reset()


@pytest.mark.cuda
def test_hvd104_hazard_cuda_graph_freezes_host_values():
    """The CUDA-graph half of HVD104: a value computed on the host while
    the graph was captured is what every replay adds."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    static_x = torch.zeros(1, device="cuda", dtype=torch.float64)
    out = static_x + 0.0
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        out.copy_(static_x + random.random())     # warm-up outside capture
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out.copy_(static_x + random.random())  # hvd-lint: disable=HVD104
    graph.replay()
    first = out.item()
    for _ in range(3):
        graph.replay()
        assert out.item() == first


# ---------------------------------------------------------------------------
# HVD105 — process groups not created by every process in one order
# ---------------------------------------------------------------------------

def test_hvd105_new_group_under_rank_branch():
    assert codes("""
        import torch.distributed as dist

        def my_group(members):
            g = None
            if dist.get_rank() in members:
                g = dist.new_group(members)
            return g
    """) == ["HVD105"]


def test_hvd105_branches_create_different_groups():
    assert codes("""
        import torch.distributed as dist
        import horovod_tpu_torch as hvd

        def pick():
            if hvd.rank() < 2:
                return dist.new_group([0, 1])
            else:
                return dist.new_group([2, 3])
    """) == ["HVD105", "HVD105"]


def test_hvd105_new_group_over_unordered_iteration():
    assert codes("""
        import torch.distributed as dist

        def groups(layout):
            out = {}
            for key in {"dp", "tp"}:
                out[key] = dist.new_group(layout[key])
            return out, [dist.new_group(r) for r in layout.values()]
    """) == ["HVD105", "HVD105"]


def test_hvd105_clean_every_process_creates_every_group():
    assert codes("""
        import torch.distributed as dist

        def my_group(layout, rank):
            groups = [dist.new_group(r) for r in layout]
            named = {k: dist.new_group(layout[k]) for k in sorted(layout)}
            if dist.get_rank() == 0:
                g = dist.new_group([0, 1])
            else:
                g = dist.new_group([0, 1])
            mine = [g for g, r in zip(groups, layout) if rank in r][0]
            return mine, named, g
    """) == []


def test_hvd105_suppressible():
    assert codes("""
        import torch.distributed as dist

        def my_group(members):
            if dist.get_rank() in members:
                return dist.new_group(members)  # hvd-lint: disable=HVD105
    """) == []


HVD105_HAZARD = textwrap.dedent("""
    import datetime, os, sys, threading
    import torch, torch.distributed as dist

    rank, store, skip = int(sys.argv[1]), sys.argv[2], sys.argv[3] == "1"
    window = float(sys.argv[4])
    dist.init_process_group("gloo", init_method="file://" + store,
                            rank=rank, world_size=2,
                            timeout=datetime.timedelta(seconds=5))
    print("READY", flush=True)

    def work():
        if rank == 0 or not skip:
            solo = dist.new_group([0])
        pair = dist.new_group([0, 1])
        t = torch.ones(1) * (rank + 1)
        dist.all_reduce(t, group=pair)
        print(f"SUM {t.item()}", flush=True)

    worker = threading.Thread(target=work, daemon=True)
    worker.start()
    worker.join(timeout=window)   # the window opens once the job is formed
    print("DONE" if not worker.is_alive() else "HUNG", flush=True)
    os._exit(0)
""")


def _run_pair(script, args, window):
    procs = [subprocess.Popen(
        [sys.executable, "-c", script, str(r), *args],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=REPO) for r in range(2)]
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=window)[0])
        except subprocess.TimeoutExpired:
            p.kill()
            outs.append(p.communicate()[0])
    return outs


@pytest.mark.parametrize("skip", [False, True], ids=["same", "divergent"])
def test_hvd105_hazard_divergent_new_group_hangs(skip, tmp_path):
    """The hazard HVD105 names: when one process skips a new_group that
    another makes, their NEXT group pairs up wrongly and its first
    collective never completes; made by both, it sums at once."""
    from _timing import scaled
    outs = _run_pair(HVD105_HAZARD, (str(tmp_path / "store"),
                                     "1" if skip else "0", str(scaled(5))),
                     window=scaled(120))
    assert all("READY" in o for o in outs), outs
    if skip:
        assert all("HUNG" in o and "SUM" not in o for o in outs), outs
    else:
        assert all("SUM 3.0" in o and "DONE" in o for o in outs), outs


# ---------------------------------------------------------------------------
# HVD108 — causal attention on the plain ring layout
# ---------------------------------------------------------------------------

def test_hvd108_plain_causal_literal_and_default():
    assert codes("""
        from horovod_tpu_torch.parallel import ring_flash_attention

        def f(q, k, v, group):
            a = ring_flash_attention(q, k, v, group, causal=True)
            b = ring_flash_attention(q, k, v, group)
            c = ring_flash_attention(q, k, v, group, True)
            return a, b, c
    """) == ["HVD108", "HVD108", "HVD108"]


def test_hvd108_no_tile_half():
    # The port's ring entry points take no block_q/block_k: the JAX rule's
    # tile half has nothing to flag.
    assert codes("""
        from horovod_tpu_torch.parallel import (
            make_ring_flash_attention,
            make_zigzag_ring_flash_attention,
            zigzag_ring_flash_attention,
        )

        def f(q, k, v, group):
            a = zigzag_ring_flash_attention(q, k, v, group, True)
            b = make_ring_flash_attention(group)
            c = make_zigzag_ring_flash_attention(group)
            return a, b, c
    """) == []


def test_hvd108_clean_planner_driven_sites():
    assert codes("""
        from horovod_tpu_torch.parallel import ring_flash_attention

        def f(q, k, v, group, plan):
            a = ring_flash_attention(q, k, v, group, plan.causal)
            b = ring_flash_attention(q, k, v, group, causal=False)
            return a, b
    """) == []


def test_hvd108_suppressible_for_audit_fixtures():
    assert codes("""
        from horovod_tpu_torch.parallel import ring_flash_attention

        def f(q, k, v, group):
            return ring_flash_attention(  # hvd-lint: disable=HVD108
                q, k, v, group, True)
    """) == []


HVD108_HAZARD = textwrap.dedent("""
    import sys
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import parallel as par

    rank, store = int(sys.argv[1]), sys.argv[2]
    hvd.init(device="cpu", init_method="file://" + store, rank=rank, size=2)
    g = torch.Generator().manual_seed(rank)
    q, k, v = (torch.randn(1, 8, 2, 16, generator=g) for _ in range(3))
    _, causal = par.ring_flash_attention_stats(q, k, v, None, True)
    _, full = par.ring_flash_attention_stats(q, k, v, None, False)
    print(f"STEPS {rank} {causal} {full}", flush=True)
    hvd.shutdown()
""")


def test_hvd108_hazard_plain_causal_ring_idles_ranks(tmp_path):
    """The hazard HVD108 names: on the plain ring, causal rank r runs only
    r + 1 of the n block steps, so rank 0 idles n - 1 steps waiting on the
    last rank; without the mask every rank runs n."""
    from _timing import scaled
    outs = _run_pair(HVD108_HAZARD, (str(tmp_path / "store"),),
                     window=scaled(180))
    steps = {}
    for o in outs:
        line = [ln for ln in o.splitlines() if ln.startswith("STEPS")]
        assert line, o[-3000:]
        _tag, rank, causal, full = line[0].split()
        steps[int(rank)] = (int(causal), int(full))
    assert steps == {0: (1, 2), 1: (2, 2)}


# ---------------------------------------------------------------------------
# HVD109 — unbucketed serve shapes (a recompile per request length)
# ---------------------------------------------------------------------------

def test_hvd109_len_shaped_compiled_input_in_serve_loop():
    assert codes("""
        import torch

        decode_fn = torch.compile(lambda t: t * 2, dynamic=False)

        def serve(requests):
            while requests:
                prompt = requests.pop()
                decode_fn(torch.zeros((len(prompt),), dtype=torch.int32))
    """) == ["HVD109"]


def test_hvd109_graphed_callable_and_prefill_verb():
    assert codes("""
        import torch

        (step,) = torch.cuda.make_graphed_callables((torch.nn.Linear(4, 4),),
                                                    ((torch.ones(1, 4),),))

        def serve(backend, requests, tokens):
            for prompt in requests:
                step(tokens[:len(prompt)])
                backend.prefill(tokens[:len(prompt)], len(prompt), 0)
    """) == ["HVD109", "HVD109"]


def test_hvd109_clean_bucketed_twin():
    assert codes("""
        import numpy as np
        import torch

        decode_fn = torch.compile(lambda t: t * 2, dynamic=False)

        def serve(backend, requests, buckets):
            for prompt in requests:
                bucket = min(b for b in buckets if b >= len(prompt))
                padded = np.zeros((1, bucket), np.int32)
                padded[0, :len(prompt)] = prompt
                backend.prefill(padded, len(prompt), 0)
                decode_fn(torch.zeros((bucket,)))
    """) == []


def test_hvd109_suppressible_for_one_shape_fixtures():
    assert codes("""
        import torch

        decode_fn = torch.compile(lambda t: t * 2, dynamic=False)

        def serve(requests):
            for prompt in requests:
                decode_fn(  # hvd-lint: disable=HVD109
                    torch.zeros((len(prompt),)))
    """) == []


def test_hvd109_hazard_compile_per_novel_length():
    """The hazard HVD109 names: under torch.compile(dynamic=False) every
    novel request length compiles a new frame; padded to a bucket menu,
    the count stops at the number of buckets."""
    from torch._dynamo.utils import counters

    def frames_for(lengths):
        torch._dynamo.reset()
        counters.clear()
        decode_fn = torch.compile(lambda t: t * 2, backend="eager",
                                  dynamic=False)
        for n in lengths:
            decode_fn(torch.zeros(n))
        return counters["frames"]["ok"]

    lengths = [3, 5, 7, 3, 9, 11, 5]
    buckets = (8, 16)
    assert frames_for(lengths) == len(set(lengths))
    assert frames_for([min(b for b in buckets if b >= n)
                       for n in lengths]) == len(buckets)
    torch._dynamo.reset()


# ---------------------------------------------------------------------------
# HVD106 — topology values cached where elastic resize can't reach them
# ---------------------------------------------------------------------------

def test_hvd106_module_level_size_constant():
    assert codes("""
        import horovod_tpu_torch as hvd

        WORLD = hvd.size()

        def shard(data):
            return data[::WORLD]
    """) == ["HVD106"]


def test_hvd106_default_parameter_value():
    assert codes("""
        import horovod_tpu_torch as hvd

        def scale_lr(lr, world=hvd.size()):
            return lr * world
    """) == ["HVD106"]


def test_hvd106_rank_in_class_constant_and_derived_expression():
    assert codes("""
        from horovod_tpu_torch import rank

        class Cfg:
            is_chief = rank() == 0
    """) == ["HVD106"]


def test_hvd106_clean_call_at_use_time_and_unrelated_size():
    assert codes("""
        import horovod_tpu_torch as hvd

        N = my_queue.size()

        def shard(data):
            return data[:: hvd.size()]

        def inner():
            world = hvd.size()   # runtime local: re-read every call
            return world
    """) == []


def test_hvd106_exempt_when_refreshed_in_on_reconfigure_callback():
    assert codes("""
        import horovod_tpu_torch as hvd
        from horovod_tpu_torch import elastic

        WORLD = hvd.size()

        @elastic.on_reconfigure
        def _refresh(event):
            global WORLD
            WORLD = hvd.size()
    """) == []


# ---------------------------------------------------------------------------
# HVD107 — hand-tuned overlap knob (the schedule planner owns the chain)
# ---------------------------------------------------------------------------

def test_hvd107_env_assignment_and_setdefault():
    assert codes("""
        import os

        os.environ["HOROVOD_OVERLAP_BUCKETS"] = "4"
        os.environ.setdefault("HVD_TPU_OVERLAP_BUCKETS", "0")
    """) == ["HVD107", "HVD107"]


def test_hvd107_monkeypatch_setenv():
    assert codes("""
        def test_thing(monkeypatch):
            monkeypatch.setenv("HOROVOD_OVERLAP_BUCKETS", "0")
    """) == ["HVD107"]


def test_hvd107_clean_other_knobs_and_reads():
    assert codes("""
        import os

        n = os.environ.get("HOROVOD_OVERLAP_BUCKETS")
        os.environ.pop("HOROVOD_OVERLAP_BUCKETS", None)
        os.environ["HOROVOD_CYCLE_TIME"] = "3.5"

        def test_thing(monkeypatch):
            monkeypatch.delenv("HOROVOD_OVERLAP_BUCKETS", raising=False)
            monkeypatch.setenv("HVD_TPU_DEVICE_HEADROOM_MB", "3")
    """) == []


def test_hvd107_suppressible_for_legacy_fixtures():
    assert codes("""
        def test_legacy(monkeypatch):
            monkeypatch.setenv("HOROVOD_OVERLAP_BUCKETS", "0")  # hvd-lint: disable=HVD107
    """) == []


# ---------------------------------------------------------------------------
# HVD110 — collective before reconfigure in a MembershipChanged handler
# ---------------------------------------------------------------------------

def test_hvd110_retry_without_reconfigure():
    assert codes("""
        import horovod_tpu_torch as hvd
        from horovod_tpu_torch.core.engine import MembershipChanged

        def step(x):
            try:
                return hvd.allreduce(x)
            except MembershipChanged:
                return hvd.allreduce(x)
    """) == ["HVD110"]


def test_hvd110_engine_enqueue_dotted_exception_and_dist_call():
    assert codes("""
        import torch.distributed as dist
        import horovod_tpu_torch as hvd

        def pump(engine, x):
            try:
                engine.enqueue("t", 0, 5, -1, 0, x)
            except hvd.core.engine.MembershipChanged:
                engine.enqueue("t", 0, 5, -1, 0, x)
                dist.all_reduce(x)
    """) == ["HVD110", "HVD110"]


def test_hvd110_clean_reconfigure_first():
    assert codes("""
        import horovod_tpu_torch as hvd
        from horovod_tpu_torch import elastic
        from horovod_tpu_torch.core.engine import MembershipChanged

        def step(x):
            try:
                return hvd.allreduce(x)
            except MembershipChanged:
                ev = elastic.reconfigure()
                return hvd.allreduce(x)
    """) == []


def test_hvd110_clean_cleanup_only_handler_and_other_exceptions():
    assert codes("""
        import horovod_tpu_torch as hvd
        from horovod_tpu_torch.core.engine import MembershipChanged

        def step(x, log):
            try:
                return hvd.allreduce(x)
            except MembershipChanged:
                log.warning("resized")
                raise
            except ValueError:
                return hvd.allreduce(x)
    """) == []


def test_hvd110_tuple_exception_type_and_suppression():
    src = """
        import horovod_tpu_torch as hvd
        from horovod_tpu_torch.core.engine import MembershipChanged

        def step(x):
            try:
                return hvd.allreduce(x)
            except (MembershipChanged, RuntimeError):
                return hvd.allreduce(x)  # hvd-lint: disable=HVD110
    """
    assert codes(src) == []
    assert codes(src.replace("  # hvd-lint: disable=HVD110", "")) \
        == ["HVD110"]


# ---------------------------------------------------------------------------
# Suppression + CLI behaviour
# ---------------------------------------------------------------------------

def test_suppression_comment_and_all():
    assert codes("""
        import horovod_tpu_torch as hvd

        def step(x):
            if hvd.rank() == 0:
                hvd.allreduce(x)  # hvd-lint: disable=HVD101
            if hvd.rank() == 1:
                hvd.allgather(x)  # hvd-lint: disable=all
    """) == []


def test_suppression_wrong_code_does_not_silence():
    assert codes("""
        import horovod_tpu_torch as hvd

        def step(x):
            if hvd.rank() == 0:
                hvd.allreduce(x)  # hvd-lint: disable=HVD102
    """) == ["HVD101"]


def test_syntax_error_reported_not_crash():
    assert codes("def broken(:\n    pass") == ["HVD000"]


def test_cli_exit_codes(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text(textwrap.dedent("""
        import torch.distributed as dist

        def f(x):
            if dist.get_rank() == 0:
                dist.barrier()
    """))
    good = tmp_path / "good.py"
    good.write_text("x = 1\n")
    env = {**os.environ, "PYTHONPATH": REPO}
    cmd = [sys.executable, "-m", "horovod_tpu_torch.analysis.lint"]
    rc_bad = subprocess.run(cmd + [str(bad)], capture_output=True,
                            text=True, env=env)
    assert rc_bad.returncode == 1
    assert "HVD101" in rc_bad.stdout and "hint:" in rc_bad.stdout
    rc_good = subprocess.run(cmd + [str(good)], capture_output=True,
                             text=True, env=env)
    assert rc_good.returncode == 0, rc_good.stderr
    usage = subprocess.run(cmd, capture_output=True, text=True, env=env)
    assert usage.returncode == 2
    listed = subprocess.run(cmd + ["--list-rules"], capture_output=True,
                            text=True, env=env)
    assert listed.returncode == 0
    assert [ln.split()[0] for ln in listed.stdout.splitlines()] == \
        [f"HVD{n}" for n in range(101, 111)]


def test_lint_imports_nothing_but_the_stdlib():
    code = ("import sys\n"
            "from horovod_tpu_torch.analysis import lint_paths\n"
            "lint_paths(['chip_smoke.py'])\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'torch', 'numpy', 'horovod_tpu')))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=60,
                         check=True).stdout
    assert out.strip().splitlines()[-1] == "[]"


def test_torch_repo_is_lint_clean():
    """Dogfood: the port's linter passes over the port, its tests and the
    card smoke (the lint leg of ``python -m horovod_tpu_torch.core.check``)."""
    from horovod_tpu_torch.core import check
    targets = check.lint_targets()
    assert targets[0] == "horovod_tpu_torch" and \
        targets[-1] == "chip_smoke.py" and "tests/test_torch_lint.py" in targets
    errors = lint_paths([os.path.join(REPO, p) for p in targets])
    assert errors == [], "\n".join(e.render() for e in errors)


# ---------------------------------------------------------------------------
# Parity with the JAX linter on the carried rules
# ---------------------------------------------------------------------------

def _jax_lint():
    from horovod_tpu.analysis import lint as jax_lint
    return jax_lint


def _lint_fixtures() -> list[tuple[str, str]]:
    """(test name, source) of every fixture of tests/test_lint.py: each
    multi-line string of a test that is not its docstring, plus its twin
    with the suppression comments taken out."""
    path = os.path.join(REPO, "tests", "test_lint.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    out = []
    for fn in tree.body:
        if not (isinstance(fn, ast.FunctionDef)
                and fn.name.startswith("test_")):
            continue
        doc = ast.get_docstring(fn, clean=False)
        for node in ast.walk(fn):
            if isinstance(node, ast.Constant) and \
                    isinstance(node.value, str) and "\n" in node.value \
                    and node.value != doc:
                src = textwrap.dedent(node.value)
                out.append((fn.name, src))
                bare = re.sub(r"\s*# hvd-lint: disable=\S+", "", src)
                if bare != src:
                    out.append((fn.name + "-unsuppressed", bare))
    return out


FIXTURES = _lint_fixtures()


def _carried(errors):
    return [(e.line, e.col, e.code) for e in errors if e.code in CARRIED]


def test_rule_catalog_keeps_the_ten_codes():
    from horovod_tpu.analysis import rules as jax_rules
    assert [r.code for r in port_rules.RULES] == \
        [r.code for r in jax_rules.RULES]
    assert len(FIXTURES) >= 44


@pytest.mark.parametrize("name,src", FIXTURES,
                         ids=[f"{i}-{n}" for i, (n, _s) in
                              enumerate(FIXTURES)])
def test_carried_rules_equal_jax_on_lint_fixtures(name, src):
    """The JAX fixture, its package renamed to the port's, gives the same
    carried findings in both linters."""
    jax_lint = _jax_lint()
    ported = re.sub(r"\bhorovod_tpu\b", "horovod_tpu_torch", src)
    assert _carried(lint_source(ported, "fixture.py")) == \
        _carried(jax_lint.lint_source(src, "fixture.py"))


@pytest.mark.parametrize("tree", ["horovod_tpu", "examples", "tests"])
def test_carried_rules_equal_jax_on_tree(tree):
    jax_lint = _jax_lint()
    files = jax_lint.iter_py_files([os.path.join(REPO, tree)])
    assert files
    for path in files:
        with open(path, encoding="utf-8") as f:
            src = f.read()
        assert _carried(lint_source(src, path)) == \
            _carried(jax_lint.lint_source(src, path)), path
