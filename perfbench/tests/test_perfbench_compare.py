"""The training numbers' arithmetic: a leaf's gap of norms over the
larger of its reference norm and the median of the leaves that the
reference moves, so that a leaf the reference leaves at 0 and the
program moves fails."""

from __future__ import annotations

import math

import pytest

from perfbench import compare


def test_leaf_gap_over_the_median_leaf():
    ref = {"a": 1.0, "b": 2.0, "c": 4.0}
    # b's gap of 0.2 over its own norm; a's 0.1 over the median, 2.
    assert compare.leaf_gap({"a": 1.1, "b": 2.2, "c": 4.0}, ref) == \
        pytest.approx(0.1)


@pytest.mark.parametrize("moved,expect", [(0.0, 0.0), (0.4, 0.2)])
def test_leaf_gap_sees_a_leaf_the_reference_leaves_still(moved, expect):
    ref = {"a": 1.0, "b": 2.0, "c": 4.0, "z1": 0.0, "z2": 0.0, "z3": 0.0,
           "z4": 0.0}
    prog = dict(ref, z1=moved)
    assert compare.leaf_gap(prog, ref) == pytest.approx(expect)


def test_leaf_gap_with_no_leaf_moved():
    ref = {"a": 0.0, "b": 0.0}
    assert compare.leaf_gap(dict(ref), ref) == 0.0
    assert math.isinf(compare.leaf_gap({"a": 1e-3, "b": 0.0}, ref))
