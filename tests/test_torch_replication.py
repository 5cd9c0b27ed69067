"""The checkpoint half of the port's replication store
(``horovod_tpu_torch/replication.py``: ``cut_shards``, ``put``,
``have_shards``, the inventory agreement, ``ship_missing``) against the JAX
package's on the same bytes and inventories, and the peer-restore cases of
the port's ``CheckpointManager`` (``tests/test_replication.py``'s manager
cases).  A duck-typed engine loops every shard frame back into its own
inbox and refuses tickets, so shipping takes the relay leg."""

import numpy as np
import pytest
import torch

from horovod_tpu import replication as jrep
from horovod_tpu_torch import checkpoint as tckpt
from horovod_tpu_torch import replication as trep


class FakeEngine:
    """The NativeEngine shard API: ``shard_put`` stamps this engine's
    epoch and loops the frame into ``inbox``, so ``drain`` on the same
    object plays the receiving rank; tickets are refused."""

    def __init__(self, rank=0, size=2, epoch=0):
        self.rank, self.size, self.epoch = rank, size, epoch
        self.sent, self.inbox, self.acks = [], [], []

    def shard_put(self, target_rank, step, payload):
        self.sent.append((target_rank, step, bytes(payload)))
        self.inbox.append((self.rank, step, self.epoch, bytes(payload)))
        self.acks.append((self.rank, target_rank, step, self.epoch))
        return True

    def shard_poll(self):
        return self.inbox.pop(0) if self.inbox else None

    def shard_acks(self):
        out, self.acks = self.acks, []
        return out

    def ticket_request(self, dst, step, nbytes, manifest=b""):
        return False

    def ticket_poll(self):
        return None

    def timeline_instant(self, name, args=""):
        pass

    def resize_event(self):
        return None


@pytest.fixture(autouse=True)
def _clean_store():
    for mod in (trep, jrep):
        mod.clear()
    yield
    for mod in (trep, jrep):
        mod.clear()


def _np_state(v: float):
    return {"w": np.full(4, v, np.float32), "step_arr": np.array(int(v)),
            "opt": [np.arange(3.0), (1, 2.5)]}


def _t_state(v: float):
    return {"w": torch.full((4,), v), "step_arr": torch.tensor(int(v)),
            "opt": [torch.arange(3.0), (1, 2.5)]}


def _seed_full_set(mod, step, epoch, state, n=2, metadata=None):
    blob = mod.encode_snapshot(step, state, metadata)
    cut, shards = mod.cut_shards(blob, n)
    for i, sh in enumerate(shards):
        assert mod.absorb_remote_shard(
            owner=i % n, step=step, epoch=epoch, shard_index=i,
            cut_size=cut, total_len=len(blob), payload=sh, via="local")
    return blob


@pytest.mark.parametrize("n", [1, 2, 3, 4, 7])
def test_cut_shards_matches_jax(n):
    blob = bytes(range(256)) * 13
    assert trep.cut_shards(blob, n) == jrep.cut_shards(blob, n)
    assert trep.cut_shards(b"ab", n) == jrep.cut_shards(b"ab", n)


def test_numpy_snapshot_shards_are_the_jax_packages_bytes():
    state = _np_state(3.0)
    blob_t = trep.encode_snapshot(5, state, {"rng": [1]})
    blob_j = jrep.encode_snapshot(5, state, {"rng": [1]})
    assert blob_t == blob_j
    assert trep.cut_shards(blob_t, 3) == jrep.cut_shards(blob_j, 3)


@pytest.mark.parametrize("invs", [
    {0: {6: {"cut": 5, "total": 13, "shards": [0, 1]}},
     1: {6: {"cut": 5, "total": 13, "shards": [2]}}},
    {0: {6: {"cut": 5, "total": 13, "shards": [0, 1]}}},
    {0: {4: {"cut": 2, "total": 4, "shards": [0, 1]},
         9: {"cut": 2, "total": 4, "shards": [0]},
         7: {"cut": 2, "total": 4, "shards": [0, 1]},
         "bad": "not-a-dict"}},
    {0: {3: {"cut": 4, "total": 8, "shards": [1]}},
     1: {3: {"cut": 4, "total": 8, "shards": [0, 1]},
         5: {"cut": 3, "total": 9, "shards": [0, 2]}},
     2: {5: {"cut": 3, "total": 9, "shards": [1]}}},
])
def test_elect_matches_jax(invs):
    assert trep.elect(invs) == jrep.elect(invs)


def test_put_have_shards_and_inventories_match_jax():
    for mod, state in ((trep, _t_state(1.0)), (jrep, _np_state(1.0))):
        eng = FakeEngine(rank=1, size=3, epoch=0)
        assert mod.put(7, state, {"rng": [1]}, eng=eng)
        assert eng.sent[0][0] == 2  # the ring neighbour of rank 1
        assert mod.have_shards(7, 0) == [1]  # the kept shard is the rank's
        assert mod.drain(eng) == 1  # the loopback relay lands it too
        assert mod.stats()["puts"] == 1
        assert mod.replication_stats()["shards_shipped_relay"] == 1
    # Same step, epoch and shard layout on both sides (the torch tensors
    # encode to other bytes than numpy's, so only the layout compares).
    tv, jv = trep.local_inventory(0), jrep.local_inventory(0)
    assert tv[7]["shards"] == jv[7]["shards"] == [1]


def test_put_refuses_single_rank_jobs():
    assert not trep.put(1, {"w": 0}, eng=FakeEngine(rank=0, size=1))
    assert trep.have_shards(1, 0) == []


def test_inventory_exchange_pins_own_view_like_jax():
    views = []
    for mod in (trep, jrep):
        eng = FakeEngine(rank=0, size=2, epoch=0)
        _seed_full_set(mod, 3, 0, _np_state(3.0))
        inv = mod.send_inventory(eng)
        assert inv[3]["shards"] == [0, 1]
        assert len(eng.sent) == 1  # broadcast to the one peer
        assert mod.inventories(0)[0] == inv
        assert mod.inventories(1) == {}  # stale-epoch views invisible
        # The peer's view arrives through the inbox and drain.
        peer = FakeEngine(rank=1, size=2, epoch=0)
        peer.inbox.append(eng.inbox.pop(0))
        mod.drain(peer)
        views.append(mod.inventories(0))
    assert views[0] == views[1]


def test_ship_missing_sends_each_missing_shard_once():
    for mod in (trep, jrep):
        eng = FakeEngine(rank=0, size=3, epoch=0)
        blob = _seed_full_set(mod, 6, 0, _np_state(6.0), n=3)
        cut = -(-len(blob) // 3)
        with mod._lock:
            mod._inventories.clear()
            mod._inventories[0] = ({6: {"cut": cut, "total": len(blob),
                                        "shards": [0, 1, 2]}}, 0)
            mod._inventories[1] = ({6: {"cut": cut, "total": len(blob),
                                        "shards": [1]}}, 0)
            mod._inventories[2] = ({}, 0)
        el = mod.elect(mod.inventories(0))
        assert mod.ship_missing(el, eng) == 5  # 2 to rank 1, 3 to rank 2
        assert sorted(dst for dst, _s, _p in eng.sent) == [1, 1, 2, 2, 2]
        mod.clear()


# -- the manager's peer restore ----------------------------------------------

def test_manager_peer_restore_zero_disk_reads(tmp_path, monkeypatch):
    from horovod_tpu_torch.core import engine as core_engine

    monkeypatch.setenv("HVD_TPU_CKPT_REPLICATE", "1")
    monkeypatch.setattr(core_engine, "peek_engine",
                        lambda: FakeEngine(rank=1, size=3, epoch=2))
    _seed_full_set(trep, 5, 2, _t_state(5.0), n=3)
    mgr = tckpt.CheckpointManager(tmp_path / "peer", rank=1, size=1)
    tckpt.reset_disk_read_count()
    ck = mgr.restore_latest(template=_t_state(0.0), broadcast=False)
    assert ck is not None and ck.step == 5
    assert torch.equal(ck.state["w"], torch.full((4,), 5.0))
    assert ck.state["opt"][1] == (1, 2.5)
    assert tckpt.disk_read_count() == 0


def test_manager_peer_restore_stale_epoch_falls_back_to_disk(tmp_path,
                                                             monkeypatch):
    from horovod_tpu_torch.core import engine as core_engine

    monkeypatch.setenv("HVD_TPU_CKPT_REPLICATE", "1")
    monkeypatch.setattr(core_engine, "peek_engine",
                        lambda: FakeEngine(rank=0, size=2, epoch=3))
    mgr = tckpt.CheckpointManager(tmp_path / "stale", rank=0, size=1)
    mgr.save(2, _t_state(2.0))
    _seed_full_set(trep, 9, 1, _t_state(9.0))  # stale epoch
    tckpt.reset_disk_read_count()
    ck = mgr.restore_latest(template=_t_state(0.0), broadcast=False)
    assert ck is not None and ck.step == 2  # disk won
    assert torch.equal(ck.state["w"], torch.full((4,), 2.0))
    assert tckpt.disk_read_count() > 0


def test_manager_peer_restore_prefers_newer_disk(tmp_path, monkeypatch):
    from horovod_tpu_torch.core import engine as core_engine

    monkeypatch.setenv("HVD_TPU_CKPT_REPLICATE", "1")
    monkeypatch.setattr(core_engine, "peek_engine",
                        lambda: FakeEngine(rank=0, size=2, epoch=0))
    mgr = tckpt.CheckpointManager(tmp_path / "newer", rank=0, size=1)
    mgr.save(8, _t_state(8.0))
    _seed_full_set(trep, 4, 0, _t_state(4.0))
    ck = mgr.restore_latest(template=_t_state(0.0), broadcast=False)
    assert ck is not None and ck.step == 8


def test_manager_peer_restore_disabled_without_knob(tmp_path, monkeypatch):
    from horovod_tpu_torch.core import engine as core_engine

    monkeypatch.delenv("HVD_TPU_CKPT_REPLICATE", raising=False)
    monkeypatch.delenv("HOROVOD_CKPT_REPLICATE", raising=False)
    monkeypatch.setattr(core_engine, "peek_engine",
                        lambda: FakeEngine(rank=0, size=2, epoch=0))
    _seed_full_set(trep, 9, 0, _t_state(9.0))
    mgr = tckpt.CheckpointManager(tmp_path / "off", rank=0, size=1)
    assert mgr.restore_latest(template=_t_state(0.0), broadcast=False) \
        is None


def test_manager_save_replicates_the_snapshot(tmp_path, monkeypatch):
    """Every rank's save shards the host snapshot into the membership
    (the disk writer's too), so a later update of the live tensors never
    reaches the replica."""
    from horovod_tpu_torch.core import engine as core_engine

    eng = FakeEngine(rank=0, size=2, epoch=0)
    monkeypatch.setenv("HVD_TPU_CKPT_REPLICATE", "1")
    monkeypatch.setattr(core_engine, "peek_engine", lambda: eng)
    mgr = tckpt.CheckpointManager(tmp_path / "rep", rank=0, size=1)
    state = _t_state(3.0)
    mgr.save(3, state)
    state["w"].add_(1.0)
    assert trep.have_shards(3, 0) == [0] and eng.sent[0][0] == 1
    _cut, want = trep.cut_shards(trep.encode_snapshot(3, _t_state(3.0), {}),
                                 2)
    assert trep._shards[(3, 0)].payload == want[0]
