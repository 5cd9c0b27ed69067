"""Port's gradient overlap against the JAX package's: the schedule planner's
decisions on the same manifests, widths, headroom and knobs, and
``DistributedOptimizer``'s overlapped step across two gloo processes
against its step without overlap."""

import io
import itertools
import multiprocessing
import queue
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.ops import schedule_plan as jsp
from horovod_tpu_torch.models import resnet as tres
from horovod_tpu_torch.ops import collective_ops as tco
from horovod_tpu_torch.ops import schedule_plan as tsp


def _resnet50_shapes():
    model = tres.ResNet50(device="meta")
    return [(tuple(p.shape), "float32") for p in model.parameters()]


MANIFESTS = {
    "one": [((7, 3), "float32")],
    "three": [((5,), "float32"), ((3, 4), "bfloat16"), ((130,), "float16")],
    "resnet50": _resnet50_shapes(),   # its 161 parameter tensors
}
# HVD_TPU_DEVICE_HEADROOM_MB: unset (the probe: None on the CPU), ample,
# short of the depth-4 overlap's estimate on ResNet-50's 102 MB of
# gradients (9.6 MB) but not of depth 2's (6.4 MB), short of both, zero.
HEADROOM = [None, "100000", "8", "1", "0"]
# HOROVOD_OVERLAP_BUCKETS: unset, 0, 2, malformed.
BUCKETS = [None, "0", "2", "many"]


def _jax_tensors(spec):
    # Zero-stride views: the manifest reads only shapes and dtypes.
    return [np.broadcast_to(np.zeros((), jnp.dtype(d)), s) for s, d in spec]


def _torch_tensors(spec):
    return [torch.empty(s, dtype=getattr(torch, d), device="meta")
            for s, d in spec]


def _both_plans(monkeypatch, spec, width, headroom, buckets, override=None,
                planners=(None, None)):
    for name in ("HOROVOD_OVERLAP_BUCKETS", "HVD_TPU_OVERLAP_BUCKETS",
                 "HOROVOD_DEVICE_HEADROOM_MB", "HVD_TPU_DEVICE_HEADROOM_MB"):
        monkeypatch.delenv(name, raising=False)
    if headroom is not None:
        monkeypatch.setenv("HVD_TPU_DEVICE_HEADROOM_MB", headroom)
    if buckets is not None:   # the knob under test
        monkeypatch.setenv("HOROVOD_OVERLAP_BUCKETS", buckets)  # hvd-lint: disable=HVD107
    jsp._reset_for_tests()
    tsp._reset_for_tests()
    malformed = buckets is not None and not buckets.isdigit() \
        and override is None and planners == (None, None)
    plans = []
    for mod, tensors, planner in ((jsp, _jax_tensors(spec), planners[0]),
                                  (tsp, _torch_tensors(spec), planners[1])):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            plans.append(mod.plan_overlap(tensors, width, override=override,
                                          planner=planner).as_dict())
        # A malformed knob warns on both sides, and only then.
        assert any(issubclass(w.category, RuntimeWarning)
                   for w in caught) == malformed
        assert mod.overlap_plan() == plans[-1]
    return plans


@pytest.mark.parametrize("buckets", BUCKETS)
@pytest.mark.parametrize("headroom", HEADROOM)
@pytest.mark.parametrize("manifest", sorted(MANIFESTS))
@pytest.mark.parametrize("width", [1, 2, 8])
def test_plan_matches_jax(monkeypatch, width, manifest, headroom, buckets):
    # Exact equality of every field, the reason string included.
    jax_plan, torch_plan = _both_plans(monkeypatch, MANIFESTS[manifest],
                                       width, headroom, buckets)
    assert torch_plan == jax_plan


@pytest.mark.parametrize("case", ["override", "adaptive8", "static3",
                                  "adaptive_default1"])
@pytest.mark.parametrize("width", [1, 2, 8])
def test_explicit_planner_matches_jax(monkeypatch, width, case):
    # An explicit overlap_buckets= or planner= wins over the environment.
    kw = {"override": {"override": 3},
          "adaptive8": {"planners": (jsp.AdaptivePlanner(8),
                                     tsp.AdaptivePlanner(8))},
          "static3": {"planners": (jsp.StaticPlanner(3),
                                   tsp.StaticPlanner(3))},
          "adaptive_default1": {"planners": (jsp.AdaptivePlanner(1),
                                             tsp.AdaptivePlanner(1))}}[case]
    jax_plan, torch_plan = _both_plans(monkeypatch, MANIFESTS["resnet50"],
                                       width, "8", "2", **kw)
    assert torch_plan == jax_plan


def test_resnet50_manifest_at_one_card_is_the_bypass(monkeypatch):
    monkeypatch.delenv("HOROVOD_OVERLAP_BUCKETS", raising=False)
    monkeypatch.delenv("HVD_TPU_OVERLAP_BUCKETS", raising=False)
    tsp._reset_for_tests()
    plan = tsp.plan_overlap(_torch_tensors(MANIFESTS["resnet50"]), 1)
    assert (plan.planner, plan.chained, plan.tensor_count,
            plan.total_bytes) == ("adaptive", False, 161, 4 * 25557032)


@pytest.mark.parametrize("count,depth,bounds", [
    (8, 4, None), (7, 3, None), (161, 4, None), (3, 4, None),
    (8, 2, (0, 3, 8))])
def test_bucket_indices_follow_the_reverse_index(count, depth, bounds):
    # The JAX package's _chained_allreduce cut: linspace over the reverse
    # tensor index, or explicit bounds; every tensor in exactly one bucket.
    plan = tsp.BucketPlan("static", depth, 2, count, 0, None, 0, "",
                          bounds)
    got = tco.plan_bucket_indices(count, plan)
    cut = (np.linspace(0, count, depth + 1).astype(int) if bounds is None
           else np.asarray(bounds))
    rev = list(range(count))[::-1]
    assert got == [rev[lo:hi] for lo, hi in zip(cut[:-1], cut[1:])
                   if hi > lo]
    assert sorted(itertools.chain(*got)) == list(range(count))
    assert got[0][0] == count - 1      # the last parameter's bucket first


# -- two gloo processes ------------------------------------------------------

def _mlp(seed):
    torch.manual_seed(seed)
    layers = []
    for n_in, n_out in ((4, 8), (8, 8), (8, 8)):
        layers += [torch.nn.Linear(n_in, n_out), torch.nn.Tanh()]
    return torch.nn.Sequential(*layers, torch.nn.Linear(8, 2))


def _batch(rank, step):
    rng = np.random.default_rng(100 * rank + step)
    return torch.from_numpy(rng.standard_normal((6, 4)).astype(np.float32))


def _loss(model, rank, step):
    return model(_batch(rank, step)).pow(2).sum()


def _grads(model):
    return [p.grad.clone() for p in model.parameters()]


def _params(model):
    return [p.detach().clone() for p in model.parameters()]


def _overlap_worker(rank, store, results):
    import horovod_tpu_torch as hvd

    hvd.init(device="cpu", init_method=f"file://{store}", rank=rank, size=2)
    try:
        out = {}
        # The probed headroom is agreed across ranks: the minimum.
        tsp._reset_for_tests()
        tsp._local_headroom_mb = lambda: 1024.0 * (rank + 1)
        out["headroom"] = tsp.probe_headroom_mb()

        # Forced depth 4 against no overlap, same weights and batches:
        # three steps each, the first of which makes the plan.
        models = {name: _mlp(seed=0) for name in ("chained", "flat")}
        opts = {name: hvd.DistributedOptimizer(
                    torch.optim.SGD(m.parameters(), lr=0.1, momentum=0.9),
                    named_parameters=m.named_parameters(),
                    overlap_buckets=depth)
                for (name, m), depth in zip(models.items(), (4, 0))}
        # Fires when the first layer's weight gets its gradient, the last
        # of backward; registered before the optimizer's own hooks.
        issued_then = []
        models["chained"][0].weight.register_post_accumulate_grad_hook(
            lambda p: issued_then.append(len(opts["chained"]._handles)))
        out["steps"] = []
        for step in range(3):
            got = {}
            for name in ("chained", "flat"):
                opts[name].zero_grad(set_to_none=True)
                _loss(models[name], rank, step).backward()
                if name == "chained":
                    got["issued_in_backward"] = len(opts[name]._handles)
                opts[name].step()
                got[name] = (_grads(models[name]), _params(models[name]))
            out["steps"].append(got)
        out["issued_then"] = issued_then
        out["plans"] = {n: o._plan.as_dict() for n, o in opts.items()}

        # Two backward passes a step, summed: the same as one step of the
        # summed gradient (checked in the parent).
        acc = _mlp(seed=0)
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD(acc.parameters(), lr=0.1),
            backward_passes_per_step=2, overlap_buckets=4)
        for step in range(2):
            opt.zero_grad(set_to_none=True)
            for micro in range(2):
                _loss(acc, rank, 10 + 2 * step + micro).backward()
            opt.step()
        out["accumulated"] = _params(acc)

        # A second allreduce of one gradient before step() raises; the
        # buckets the first backward issued still complete at step().
        model = _mlp(seed=0)
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.1), overlap_buckets=4)
        opt.step()                       # no backward: makes the plan
        _loss(model, rank, 0).backward()
        try:
            _loss(model, rank, 1).backward()
            out["double"] = "no error"
        except AssertionError as e:
            out["double"] = str(e)
        opt.step()
        # step() without backward returns, with or without hooks.
        opt.zero_grad(set_to_none=True)
        opt.step()
        out["no_backward"] = _params(model)

        # The eager grouped allreduce over a chained plan.
        mixed = [torch.full((5,), rank + 1.0),
                 torch.full((3, 4), rank + 1.0, dtype=torch.bfloat16),
                 torch.full((300,), rank + 1.0)]
        out["grouped"] = hvd.grouped_allreduce(mixed, average=False,
                                               overlap_buckets=2,
                                               threshold_bytes=64)
        out["grouped_plan"] = hvd.overlap_plan()
        buf = io.BytesIO()
        torch.save(out, buf)
        results.put((rank, buf.getvalue()))
    finally:
        hvd.shutdown()


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    store = str(tmp_path_factory.mktemp("overlap") / "store")
    procs = [ctx.Process(target=_overlap_worker, args=(r, store, results))
             for r in range(2)]
    for p in procs:
        p.start()
    outs = {}
    try:
        for _ in procs:   # drain before joining
            rank, out = results.get(timeout=120)
            outs[rank] = torch.load(io.BytesIO(out))
    except queue.Empty:
        pytest.fail("a gloo worker did not report within 120 s")
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
    assert all(p.exitcode == 0 for p in procs)
    return outs


def test_overlapped_step_is_bit_equal_to_the_flat_step(two_ranks):
    for r in (0, 1):
        plans = two_ranks[r]["plans"]
        assert (plans["chained"]["chain_depth"], plans["chained"]["chained"],
                plans["flat"]["chained"]) == (4, True, False)
        for got in two_ranks[r]["steps"]:
            for a, b in zip(*(got[n][0] + got[n][1]
                              for n in ("chained", "flat"))):
                assert torch.equal(a, b)
    # Both ranks hold the same averaged gradients and parameters.
    for s0, s1 in zip(two_ranks[0]["steps"], two_ranks[1]["steps"]):
        for a, b in zip(s0["chained"][0] + s0["chained"][1],
                        s1["chained"][0] + s1["chained"][1]):
            assert torch.equal(a, b)


def test_buckets_are_issued_during_backward(two_ranks):
    for r in (0, 1):
        steps = two_ranks[r]["steps"]
        # The first step makes the plan and reduces at step(); from the
        # second on, when the last gradient of backward arrived, the
        # buckets of the layers after the first were already in flight.
        assert steps[0]["issued_in_backward"] == 0
        assert [s["issued_in_backward"] for s in steps[1:]] == [4, 4]
        assert two_ranks[r]["issued_then"] == [0, 3, 3]


def test_accumulated_passes_match_one_step_of_the_summed_gradient(
        two_ranks):
    ref = _mlp(seed=0)
    opt = torch.optim.SGD(ref.parameters(), lr=0.1)
    for step in range(2):
        grads = []
        for r in (0, 1):
            ref.zero_grad()
            for micro in range(2):
                _loss(ref, r, 10 + 2 * step + micro).backward()
            grads.append(_grads(ref))
        for p, g0, g1 in zip(ref.parameters(), *grads):
            p.grad = (g0 + g1) / 2
        opt.step()
    for r in (0, 1):
        for got, want in zip(two_ranks[r]["accumulated"], _params(ref)):
            torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)


def test_double_allreduce_raises_and_step_without_backward_returns(
        two_ranks):
    for r in (0, 1):
        assert "allreduced twice before step()" in two_ranks[r]["double"]
        assert all(torch.isfinite(p).all()
                   for p in two_ranks[r]["no_backward"])
    for a, b in zip(two_ranks[0]["no_backward"], two_ranks[1]["no_backward"]):
        assert torch.equal(a, b)


def test_headroom_is_agreed_and_grouped_allreduce_chains(two_ranks):
    for r in (0, 1):
        assert two_ranks[r]["headroom"] == 1024.0
        plan = two_ranks[r]["grouped_plan"]
        assert (plan["planner"], plan["chain_depth"], plan["width"]) == \
            ("static", 2, 2)
        grouped = two_ranks[r]["grouped"]
        assert [t.dtype for t in grouped] == [torch.float32, torch.bfloat16,
                                              torch.float32]
        for t in grouped:
            assert torch.equal(t, torch.full_like(t, 3))
