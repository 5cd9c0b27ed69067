"""The port's ``tree.py`` and ``relay.py`` against the JAX package's: the
pure plan mirror over a knob grid, against both packages' native
``hvd_tree_plan`` (each its own build of ``core/src/tree.cc``), the group
partition, the ``HVD_TPU_TREE_AGG_MAP`` grammar, and the relay sidecar's
refusal of a topology the plan does not activate."""

import ctypes
import os
import subprocess
import sys

import pytest

from horovod_tpu import tree as jtree
from horovod_tpu.core import engine as jengine
from horovod_tpu_torch import tree as ttree
from horovod_tpu_torch.core import engine as tengine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SIZES = (1, 2, 3, 4, 5, 16, 63, 64, 65, 129, 257, 513, 4096)
FANOUTS = (0, 1, 2, 3, 8, 64, 128)
THRESHOLDS = (0, 3, 256, 10000)


def _native(lib, size, fanout, threshold, enable):
    out = (ctypes.c_int * 4)()
    lib.hvd_tree_plan(size, fanout, threshold, 1 if enable else 0, out)
    return (bool(out[0]), out[1], out[2], out[3])


def _fields(p):
    return (p.active, p.size, p.fanout, p.num_groups, p.depth)


@pytest.mark.parametrize("size", SIZES)
def test_plan_matches_jax_and_both_native_plans(size):
    tlib, jlib = tengine.lib(), jengine.lib()
    for fanout in FANOUTS:
        for threshold in THRESHOLDS:
            for enable in (False, True):
                knobs = (size, fanout, threshold, enable)
                mine = ttree.plan(*knobs)
                assert _fields(mine) == _fields(jtree.plan(*knobs)), knobs
                nat = _native(tlib, *knobs)
                assert nat == _native(jlib, *knobs), knobs
                assert mine.active == nat[0], (knobs, mine, nat)
                if mine.active:
                    assert (mine.fanout, mine.num_groups, mine.depth) == \
                        nat[1:] and mine.depth == 2, (knobs, mine, nat)


@pytest.mark.parametrize("size,fanout", [(16, 4), (17, 4), (64, 8),
                                         (4096, 128)])
def test_group_partition_matches_jax(size, fanout):
    mine, ref = ttree.plan(size, fanout, 3, True), jtree.plan(size, fanout,
                                                              3, True)
    assert mine.active
    seen = []
    for g in range(mine.num_groups):
        members = ttree.members_of(g, mine)
        assert members == jtree.members_of(g, ref)
        assert all(ttree.group_of(r, mine) == g == jtree.group_of(r, ref)
                   for r in members)
        seen.extend(members)
    assert seen == list(range(1, size))
    assert ttree.group_of(0, mine) == -1
    assert ttree.members_of(mine.num_groups, mine) == []


def test_agg_map_roundtrip_matches_jax():
    eps = [(("127.0.0.1", 9001), ("127.0.0.1", 9002)),
           (("10.0.0.7", 9003), None)]
    spec = ttree.format_agg_map(eps)
    assert spec == jtree.format_agg_map(eps) == \
        "0=127.0.0.1:9001|127.0.0.1:9002,1=10.0.0.7:9003"
    assert ttree.parse_agg_map(spec, 2) == jtree.parse_agg_map(spec, 2) == eps


@pytest.mark.parametrize("spec,groups", [
    ("", 1), ("0=127.0.0.1:9001", 2), ("0=127.0.0.1", 1),
    ("0=127.0.0.1:0", 1), ("0=127.0.0.1:9001|", 1), ("1=127.0.0.1:9001", 1),
    ("x=127.0.0.1:9001", 1), ("127.0.0.1:9001", 1),
    ("0=h:9001,1=", 2), ("0=h:9001|h:x", 1),
])
def test_agg_map_malformed_matches_jax(spec, groups):
    assert ttree.parse_agg_map(spec, groups) is None
    assert jtree.parse_agg_map(spec, groups) == ttree.parse_agg_map(spec,
                                                                    groups)


@pytest.mark.parametrize("args", [
    # A job of 2 activates no tree: invalid topology, exit 2, at once.
    ["--agg-id", "0", "--parent-port", "1", "--size", "2", "--fanout", "2"],
    # Group 3 of a 16-rank, fanout-8 tree does not exist.
    ["--agg-id", "3", "--parent-port", "1", "--size", "16", "--fanout", "8"],
    # A standby without its primary's endpoint: a usage error.
    ["--agg-id", "0", "--parent-port", "1", "--size", "16", "--fanout", "8",
     "--standby"],
])
def test_relay_refuses_a_bad_topology_as_jax_does(args):
    codes = []
    for mod in ("horovod_tpu_torch.relay", "horovod_tpu.relay"):
        res = subprocess.run([sys.executable, "-m", mod, *args], cwd=REPO,
                             capture_output=True, text=True, timeout=120,
                             env={**os.environ, "PYTHONPATH": REPO})
        codes.append(res.returncode)
    assert codes == [2, 2]
