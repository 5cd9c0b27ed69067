"""The port's native control-plane tools (``horovod_tpu_torch/core/
tools.py``): ``star_bench`` and ``fleet_sim`` built by ``core/_build.py``
from the port's copy of the sources into the git-ignored build directory,
run on the scenarios ``tests/test_tree.py`` runs on the JAX package's
builds (each run with its own timeout), and their sources held byte for
byte to the JAX package's."""

import filecmp
import os

import pytest

from _timing import scaled
from horovod_tpu_torch.core import _build, tools

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("name", sorted(_build.TOOLS))
def test_tool_sources_are_the_jax_packages(name):
    for src in (name,) + _build.TOOLS[name]:
        ours = os.path.join(_build.TOOLS_SRC if src == name else _build.SRC,
                            src + ".cc")
        theirs = os.path.join(REPO, "horovod_tpu", "core", "src",
                              src + ".cc")
        assert filecmp.cmp(ours, theirs, shallow=False), src


@pytest.mark.parametrize("name", sorted(_build.TOOLS))
def test_tools_build_into_the_ignored_build_directory(name):
    exe = _build.build_tool(name)
    assert os.path.dirname(exe) == _build.BUILD_DIR
    assert os.access(exe, os.X_OK)
    assert _build.build_tool(name) == exe          # built once, then found


def test_star_bench_ticks_at_p8():
    r = tools.star_bench(8, ticks=20, timeout=scaled(120))
    assert r["p"] == 8 and r["ticks"] == 20
    assert r["tick_us"] > 0 and r["per_worker_us"] == pytest.approx(
        r["tick_us"] / 7, rel=0.01)


def test_star_bench_refuses_a_bad_width():
    with pytest.raises(RuntimeError, match="exited 2"):
        tools.star_bench(1, ticks=20, timeout=scaled(60))


def test_fleet_sim_tree_converges():
    r = tools.fleet_sim(16, 8, fanout=4, timeout=scaled(300))
    assert r["ok"] and r["topology"] == "tree"
    assert r["num_groups"] == 4 and r["depth"] == 2
    assert r["modeled_tick_us"] > 0
    # The root's aggregate fan-in is one frame a group a tick: O(fanout),
    # not O(size).  A star would see 15.
    assert r["agg_frames_per_tick"] == pytest.approx(4.0)


def test_fleet_sim_star_converges():
    r = tools.fleet_sim(8, 6, topology="star", timeout=scaled(300))
    assert r["ok"] and r["topology"] == "star"
    assert r["depth"] == 1 and r["modeled_tick_us"] > 0


def test_fleet_sim_aggregator_sigkill_promotes_standby():
    # EOF-driven promotion: every run detects and recovers.  The members'
    # re-attach count is a relaxed counter the simulator reads as its last
    # round completes, and a member's can land after it: through a
    # captured pipe 2 of 12 runs of the JAX package's build and 1 of 12 of
    # the port's reported 0.  So one of three runs must count one.
    runs = [tools.fleet_sim(16, 10, fanout=4, chaos="kill",
                            timeout=scaled(300)) for _ in range(3)]
    for r in runs:
        assert r["ok"], r
        assert 0 < r["mttr_ms"] < scaled(5000), r
    assert max(r["reattaches"] for r in runs) >= 1, runs


def test_fleet_sim_aggregator_sigstop_partition_recovers():
    r = tools.fleet_sim(16, 10, fanout=4, chaos="stop", timeout=scaled(300))
    assert r["ok"], r
    # No EOF from a stopped relay: the promote-silence path plus the
    # members' own silence sweep, so the floor is ~1 s.
    assert 0 < r["mttr_ms"] < scaled(20000), r
    assert r["reattaches"] >= 1, r
