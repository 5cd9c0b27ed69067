"""The port's input pipeline (``horovod_tpu_torch/data.py``) against the
JAX package's ``horovod_tpu/data.py``: the scenarios of
``tests/test_data.py``, and the sharded index order equal to the
reference's for the same arrays, rank, size, seed and epoch."""

import threading
import time

import numpy as np
import pytest
import torch

from horovod_tpu import basics as jbasics
from horovod_tpu import data as jdata
from horovod_tpu_torch import basics as tbasics
from horovod_tpu_torch.data import (BackgroundLoader, ShardedBatches,
                                    prefetch_to_device, shard_arrays)


@pytest.fixture
def world(monkeypatch):
    """Set both packages' view of (rank, size) without a process group;
    the JAX side drives one chip a process, as the port does."""
    def put(rank, size):
        for mod in (jbasics, tbasics):
            monkeypatch.setattr(mod, "rank", lambda: rank)
            monkeypatch.setattr(mod, "size", lambda: size)
        monkeypatch.setattr(jbasics, "local_num_chips", lambda: 1)
    put(0, 1)
    return put


def test_shard_arrays_single_process(world):
    x = np.arange(10)
    np.testing.assert_array_equal(shard_arrays(x), x)


def test_shard_arrays_pair(world):
    x = np.arange(10)
    y = np.arange(10) * 2
    xs, ys = shard_arrays(x, y)
    np.testing.assert_array_equal(xs * 2, ys)


def test_sharded_batches_iterates(world):
    x = np.arange(64, dtype=np.float32)
    y = np.arange(64, dtype=np.int32)
    batches = ShardedBatches(x, y, batch_per_chip=16, shuffle=False)
    got = list(batches)
    assert len(got) == len(batches) == 4
    assert got[0][0].shape == (16,)
    np.testing.assert_array_equal(got[0][0].astype(np.int32), got[0][1])


def test_sharded_batches_shuffle_deterministic(world):
    x = np.arange(32, dtype=np.float32)
    a = list(ShardedBatches(x, batch_per_chip=1, shuffle=True, seed=3))
    b = list(ShardedBatches(x, batch_per_chip=1, shuffle=True, seed=3))
    for (xa,), (xb,) in zip(a, b):
        np.testing.assert_array_equal(xa, xb)
    s = ShardedBatches(x, batch_per_chip=1, shuffle=True, seed=3)
    e1 = np.concatenate([b[0] for b in s])
    e2 = np.concatenate([b[0] for b in s])
    assert not np.array_equal(e1, e2)  # another epoch reshuffles


@pytest.mark.parametrize("size", [1, 2, 3, 4])
@pytest.mark.parametrize("seed", [0, 3, 17])
def test_sharded_batches_index_order_matches_jax(world, size, seed):
    x = np.arange(101, dtype=np.float32)
    y = np.arange(101, dtype=np.int64) * 7
    for rank in range(size):
        world(rank, size)
        for shuffle in (True, False):
            got_s = ShardedBatches(x, y, batch_per_chip=4, shuffle=shuffle,
                                   seed=seed)
            want_s = jdata.ShardedBatches(x, y, batch_per_chip=4,
                                          shuffle=shuffle, seed=seed)
            assert len(got_s) == len(want_s)
            for _epoch in range(3):
                got, want = list(got_s), list(want_s)
                assert len(got) == len(want)
                for g, w in zip(got, want):
                    for ga, wa in zip(g, w):
                        np.testing.assert_array_equal(ga, wa)
        for drop in (True, False):
            for g, w in zip(shard_arrays(x, y, drop_remainder=drop),
                            jdata.shard_arrays(x, y, drop_remainder=drop)):
                np.testing.assert_array_equal(g, w)


def test_background_loader_preserves_order_and_restarts():
    src = [np.full(2, i) for i in range(6)]
    loader = BackgroundLoader(src, depth=2)
    for _ in range(2):  # re-iterating restarts the source
        got = list(loader)
        assert len(got) == 6
        for i, b in enumerate(got):
            np.testing.assert_array_equal(b, np.full(2, i))


def test_background_loader_overlaps_production():
    produced = []

    def gen():
        for i in range(5):
            produced.append(i)
            yield i

    it = iter(BackgroundLoader(gen(), depth=3))
    first = next(it)
    deadline = time.monotonic() + 5.0
    while len(produced) < 4 and time.monotonic() < deadline:
        time.sleep(0.01)
    assert first == 0
    assert len(produced) >= 4, produced  # ran ahead without being asked
    assert list(it) == [1, 2, 3, 4]


def test_background_loader_relays_producer_exception():
    def gen():
        yield 1
        raise RuntimeError("disk on fire")

    it = iter(BackgroundLoader(gen(), depth=2))
    assert next(it) == 1
    with pytest.raises(RuntimeError, match="disk on fire"):
        next(it)


def test_background_loader_abandoned_iteration_stops_thread():
    before = threading.active_count()
    it = iter(BackgroundLoader((np.zeros(1) for _ in range(100)), depth=1))
    next(it)
    it.close()  # generator finally -> stop event
    deadline = time.monotonic() + 5.0
    while threading.active_count() > before and time.monotonic() < deadline:
        time.sleep(0.01)
    assert threading.active_count() <= before


def test_prefetch_to_device_values_and_structure():
    batches = [(np.full((8, 2), i, np.float32), {"y": np.full(8, i),
                                                 "step": i})
               for i in range(4)]
    got = list(prefetch_to_device(batches, size=2, device="cpu"))
    assert len(got) == 4
    for i, (x, rest) in enumerate(got):
        assert isinstance(x, torch.Tensor) and x.device.type == "cpu"
        assert torch.equal(x, torch.full((8, 2), float(i)))
        assert torch.equal(rest["y"], torch.full((8,), i))
        assert rest["step"] == i  # a non-array leaf passes through


def test_prefetch_issues_copies_ahead():
    pulled = []

    def gen():
        for i in range(5):
            pulled.append(i)
            yield np.full(1, i)

    it = prefetch_to_device(gen(), size=3, device="cpu")
    first = next(it)
    assert int(first) == 0
    assert len(pulled) >= 3  # batches 1 and 2 already moved


def test_prefetch_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a card")
    with pytest.raises(RuntimeError, match="CUDA"):
        next(prefetch_to_device([np.zeros(1)]))
