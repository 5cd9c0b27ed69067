"""Host-memory snapshot store and its transport — counterpart of
``horovod_tpu/replication.py``: the parts that clone a serving replica's
weights over the bulk data plane.

* ``encode_snapshot`` flattens a state tree (dicts with sorted keys,
  lists, plain tuples are structure; everything else is a leaf), pickles
  each leaf behind a ``<q`` length prefix, and prepends a skeleton blob
  ``{step, treedef, metadata, n_leaves}``.  For a tree of numpy arrays the
  blob is byte for byte the JAX package's.  A ``torch.Tensor`` leaf
  becomes a :class:`TensorLeaf`: its bytes as a CPU numpy array and its
  torch dtype's name; bfloat16, which numpy has no dtype for, travels as
  a ``uint16`` view, so every tensor comes back bit for bit.
  ``decode_snapshot(blob, device=)`` puts tensors back on ``device``.
* ``ship_blob`` ships one complete blob to one peer as a single shard
  (shard 0, cut == total) down the fallback chain: a direct bulk stream
  under a coordinator ticket (``dataplane.py``), else the coordinator's
  SHARD_PUT relay.  The receiver's store then holds a complete set, and
  ``restore_local(epoch)`` decodes it with no disk read.
* The store is process-global host memory keyed by ``(step,
  shard_index)``, pruned to the two newest steps.  It survives an elastic
  re-form of the engine: ``bump_epoch`` re-stamps held shards to the new
  membership epoch (``elastic.reconfigure`` calls it), and ``reshard``
  re-ships them to the new ring partner under ``HVD_TPU_CKPT_REPLICATE``.

The checkpoint half (``checkpoint.CheckpointManager`` under
``HVD_TPU_CKPT_REPLICATE=1``):

* ``cut_shards`` cuts an encoded blob into equal BYTE ranges (``cut =
  ceil(total/N)``, shard *i* = bytes ``[i*cut, (i+1)*cut)``); ``put``
  keeps shard ``rank`` locally and ships that one shard to the ring
  partner ``(rank+1) % size``, so any single rank loss leaves a complete
  shard set among the survivors.  Single-rank jobs refuse (the disk has
  the data).
* The restore agreement: every rank broadcasts an *inventory* view
  (``send_inventory``: which shards of which steps it holds, at which
  cut), ``elect`` picks the newest step with a COMPLETE shard set across
  the union of announced inventories (``inventories``), ``ship_missing``
  has the lowest-rank holder of each shard stream it to every rank that
  lacks it, and ``assemble`` reassembles the byte ranges for
  ``decode_snapshot``.  A torn or incomplete set is never restored.

Sharded reassembly assumes the data-parallel invariant: every rank's
snapshot of a step encodes to the same byte stream.
:func:`note_disk_restore` counts restores that fell through to disk, the
number a serving joiner reports as ``disk_reads``.
"""

from __future__ import annotations

import pickle
import struct
import threading
import time
import zlib
from typing import Any, NamedTuple

import numpy as np
import torch

from horovod_tpu_torch.core import engine as core_engine
from horovod_tpu_torch.utils import env

_PICKLE = pickle.HIGHEST_PROTOCOL


class ShardEntry(NamedTuple):
    """One byte-range shard of an encoded snapshot held in host memory."""

    owner_rank: int
    step: int
    epoch: int
    shard_index: int
    cut_size: int
    total_len: int
    payload: bytes
    via: str  # "local" | "direct" | "relay"


_lock = threading.Lock()
# (step, shard_index) -> newest ShardEntry.  Pruned to the two newest steps:
# the newest may be incomplete mid-replication, so the previous complete set
# must stay electable.
_shards: dict[tuple[int, int], ShardEntry] = {}
# Newest step the control plane has acknowledged accepting (relay/enqueue
# succeeded).  Observability only — an ack is NOT end-to-end delivery.
_last_acked_step: int = -1
_puts: int = 0
_drained: int = 0
_direct_shards: int = 0
_relay_shards: int = 0
_direct_bytes: int = 0
_relay_bytes: int = 0
_disk_restores: int = 0
# (epoch, dst) pairs whose ticket came back with dst_port == 0 — the peer
# has no bulk listener this epoch, skip the ticket round-trip and relay.
_no_bulk: set[tuple[int, int]] = set()

# Restore-time agreement messages ride the same SHARD_PUT relay as the
# fallback shards: an inventory view is a magic-prefixed pickled dict
# ``{step: {"cut": int, "total": int, "shards": [indices]}}``; a relay
# shard is a magic-prefixed metadata header plus the byte range.
_VIEW_MAGIC = b"\x00hvdview2\x00"
_WRAP_MAGIC = b"\x00hvdshard2\x00"
_WRAP_HDR = struct.Struct("<iiqqI")  # shard_index, src_rank, cut, total, crc
_inventories: dict[int, tuple[dict, int]] = {}  # rank -> (inventory, epoch)


def enabled() -> bool:
    return env.ckpt_replicate()


def target_rank(rank: int, size: int) -> int:
    """The ring partner holding this rank's shard: the next rank mod size."""
    return (rank + 1) % size


# -- snapshot codec ---------------------------------------------------------


class TensorLeaf(NamedTuple):
    """A ``torch.Tensor`` as it travels in a snapshot: the torch dtype's
    name and the tensor's bytes as a CPU numpy array of its shape
    (``uint16`` for bfloat16)."""

    dtype: str
    array: np.ndarray


def _tensor_leaf(t: torch.Tensor) -> TensorLeaf:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return TensorLeaf("bfloat16", t.view(torch.int16).numpy()
                          .view(np.uint16))
    return TensorLeaf(str(t.dtype).removeprefix("torch."), t.numpy())


def _from_leaf(leaf: TensorLeaf, device) -> torch.Tensor:
    t = torch.from_numpy(leaf.array)
    if leaf.dtype == "bfloat16":
        t = t.view(torch.int16).view(torch.bfloat16)
    return t if device is None else t.to(device)


def _flatten_tree(obj: Any) -> tuple[list, Any]:
    """Tree flatten: dicts (sorted keys), lists, and plain tuples are
    structure; a ``torch.Tensor`` is a :class:`TensorLeaf`; everything
    else — numpy arrays, scalars, namedtuples — is a leaf pickled whole."""
    leaves: list = []

    def go(x):
        if isinstance(x, dict):
            keys = sorted(x.keys(), key=repr)
            return ("d", [(k, go(x[k])) for k in keys])
        if isinstance(x, list):
            return ("l", [go(v) for v in x])
        if isinstance(x, tuple) and not hasattr(x, "_fields"):
            return ("t", [go(v) for v in x])
        leaves.append(_tensor_leaf(x) if isinstance(x, torch.Tensor) else x)
        return "*"

    treedef = go(obj)
    return leaves, treedef


def _unflatten_tree(treedef: Any, it) -> Any:
    if treedef == "*":
        return next(it)
    tag, children = treedef
    if tag == "d":
        return {k: _unflatten_tree(c, it) for k, c in children}
    vals = [_unflatten_tree(c, it) for c in children]
    return vals if tag == "l" else tuple(vals)


def encode_snapshot(step: int, state: Any,
                    metadata: dict | None = None) -> bytes:
    """Snapshot -> one byte blob: skeleton, then per-leaf pickles, each
    behind a ``<q`` length prefix so the cut points never need to align
    with value boundaries."""
    leaves, treedef = _flatten_tree(state)
    skeleton = pickle.dumps(
        {"step": int(step), "treedef": treedef, "metadata": metadata or {},
         "n_leaves": len(leaves)}, protocol=_PICKLE)
    parts = [struct.pack("<q", len(skeleton)), skeleton]
    for leaf in leaves:
        blob = pickle.dumps(leaf, protocol=_PICKLE)
        parts.append(struct.pack("<q", len(blob)))
        parts.append(blob)
    return b"".join(parts)


def decode_snapshot(blob: bytes, device=None) -> dict:
    """Inverse of :func:`encode_snapshot`: ``{step, state, metadata}``,
    each tensor of ``state`` on ``device`` (default: the CPU)."""
    (n,) = struct.unpack_from("<q", blob, 0)
    off = 8
    skel = pickle.loads(blob[off:off + n])
    off += n
    leaves = []
    for _ in range(skel["n_leaves"]):
        (ln,) = struct.unpack_from("<q", blob, off)
        off += 8
        leaf = pickle.loads(blob[off:off + ln])
        leaves.append(_from_leaf(leaf, device)
                      if isinstance(leaf, TensorLeaf) else leaf)
        off += ln
    return {"step": skel["step"],
            "state": _unflatten_tree(skel["treedef"], iter(leaves)),
            "metadata": skel["metadata"]}


def tensor_crcs(state: dict) -> dict[str, int]:
    """CRC32 of each tensor's bytes in a flat ``{name: tensor}`` state
    dict (a bfloat16 tensor's as its ``uint16`` view) — what a donor and a
    joiner compare to show a clone arrived bit for bit."""
    return {k: zlib.crc32(_tensor_leaf(v).array.tobytes())
            for k, v in sorted(state.items())}


def cut_shards(blob: bytes, n: int) -> tuple[int, list[bytes]]:
    """Equal byte-range partition: ``(cut_size, shards)``.  Fewer than
    ``n`` shards come back for blobs smaller than ``n`` bytes — empty
    shards are never materialized, and ``n_shards(total, cut)`` is how
    every holder derives the complete-set size."""
    total = len(blob)
    cut = max(1, -(-total // max(n, 1)))
    return cut, [blob[i * cut:(i + 1) * cut]
                 for i in range(n_shards(total, cut))]


def n_shards(total_len: int, cut_size: int) -> int:
    """Shard count implied by a (total, cut) pair — ceil(total/cut)."""
    if cut_size <= 0:
        return 0
    return max(1, -(-total_len // cut_size))


# -- store ------------------------------------------------------------------


def _prune_locked() -> None:
    steps = sorted({s for (s, _i) in _shards}, reverse=True)
    for s in steps[2:]:
        for key in [k for k in _shards if k[0] == s]:
            del _shards[key]


def absorb_remote_shard(*, owner: int, step: int, epoch: int,
                        shard_index: int, cut_size: int, total_len: int,
                        payload: bytes, via: str) -> bool:
    """Land one shard in the store (called by drain's relay path and by
    the data-plane receive thread).  A shard whose length disagrees with
    its (index, cut, total) coordinates is torn — dropped, never stored:
    assemble() must only ever concatenate consistent byte ranges."""
    global _drained
    if cut_size <= 0 or total_len < 0 or shard_index < 0:
        return False
    expect = max(0, min(cut_size, total_len - shard_index * cut_size))
    if expect == 0 or len(payload) != expect:
        return False
    entry = ShardEntry(int(owner), int(step), int(epoch), int(shard_index),
                       int(cut_size), int(total_len), payload, via)
    with _lock:
        cur = _shards.get((entry.step, entry.shard_index))
        if cur is None or entry.epoch >= cur.epoch:
            _shards[(entry.step, entry.shard_index)] = entry
        if via != "local":
            _drained += 1
        _prune_locked()
    return True


def have_shards(step: int, epoch: int) -> list[int]:
    """Sorted shard indices held locally for (step, epoch)."""
    with _lock:
        return sorted(i for (s, i), e in _shards.items()
                      if s == step and e.epoch == epoch)


# -- shipping ---------------------------------------------------------------


def _acquire_ticket(eng, dst: int, step: int, nbytes: int,
                    manifest: bytes) -> dict | None:
    """Ticket round-trip: TICKET_REQ up to the coordinator, poll the
    answering TICKET out of the engine inbox.  The wait is bounded by the
    bulk timeout; tickets from earlier timed-out requests are discarded
    (ships are sequential per process, so the match is (dst, step))."""
    if not eng.ticket_request(dst, step, nbytes, manifest):
        return None
    deadline = time.monotonic() + env.bulk_timeout_ms() / 1000.0
    while time.monotonic() < deadline:
        t = eng.ticket_poll()
        if t is not None:
            if t["dst_rank"] == dst and t["step"] == step:
                return t
            continue  # stale ticket from an abandoned request: drop it
        time.sleep(0.002)
    return None


def _ship_shard(eng, dst: int, step: int, shard_index: int, cut_size: int,
                total_len: int, payload: bytes) -> str | None:
    """One shard toward one peer, down the fallback chain: direct bulk
    stream (ticketed) -> coordinator SHARD_PUT relay -> None (the caller's
    disk copy is the last resort).  Returns the path taken."""
    global _direct_shards, _direct_bytes, _relay_shards, _relay_bytes
    from horovod_tpu_torch import dataplane

    if env.bulk_plane():
        key = (eng.epoch, dst)
        with _lock:
            skip = key in _no_bulk
        if not skip:
            manifest = pickle.dumps(
                {"shard": shard_index, "cut": cut_size, "total": total_len,
                 "crc": zlib.crc32(payload)}, protocol=_PICKLE)
            ticket = _acquire_ticket(eng, dst, step, len(payload), manifest)
            if ticket is not None and ticket["dst_port"] <= 0:
                with _lock:
                    _no_bulk.add(key)
            elif ticket is not None and dataplane.send(
                    ticket, owner=eng.rank, shard_index=shard_index,
                    cut_size=cut_size, total_len=total_len, payload=payload,
                    rank=eng.rank):
                with _lock:
                    _direct_shards += 1
                    _direct_bytes += len(payload)
                eng.timeline_instant(
                    "SHARD_STREAM",
                    f"direct s{shard_index}->r{dst} {len(payload)}B")
                return "direct"
    wrapped = (_WRAP_MAGIC
               + _WRAP_HDR.pack(shard_index, eng.rank, cut_size, total_len,
                                zlib.crc32(payload))
               + payload)
    if eng.shard_put(dst, max(int(step), 0), wrapped):
        with _lock:
            _relay_shards += 1
            _relay_bytes += len(payload)
        eng.timeline_instant(
            "SHARD_STREAM", f"relay s{shard_index}->r{dst} {len(payload)}B")
        return "relay"
    return None


def ship_blob(eng, dst: int, step: int, blob: bytes) -> str | None:
    """Ship one COMPLETE snapshot blob to one peer as a single shard
    (shard 0, cut == total), riding the same direct->relay fallback chain
    as replica shards.  The receiver's store then has a trivially complete
    set, so ``restore_local(epoch)`` decodes it with zero transfers and
    zero disk reads — this is the serving autoscaler's weight-clone and
    hot-swap path (serving/autoscale.py): ``step`` carries the weight
    version, and election's newest-step rule makes later versions win."""
    return _ship_shard(eng, dst, int(step), 0, len(blob), len(blob), blob)


def put(step: int, state: Any, metadata: dict | None = None,
        eng: "core_engine.NativeEngine | None" = None) -> bool:
    """Shard a snapshot across the membership: keep shard ``rank``
    locally, ship that one shard to the ring partner.  Returns True when
    the shard reached a transport (direct or relay) or this rank had no
    shard to ship (tiny blob); single-rank jobs and a dead plane return
    False — the disk path still has the data."""
    global _puts
    eng = eng or core_engine.peek_engine()
    if eng is None or eng.size <= 1:
        return False
    blob = encode_snapshot(step, state, metadata)
    cut, shards = cut_shards(blob, eng.size)
    total = len(blob)
    if eng.rank >= len(shards):
        return True  # blob smaller than the membership: others cover it
    mine = shards[eng.rank]
    absorb_remote_shard(owner=eng.rank, step=int(step), epoch=eng.epoch,
                        shard_index=eng.rank, cut_size=cut, total_len=total,
                        payload=mine, via="local")
    path = _ship_shard(eng, target_rank(eng.rank, eng.size), int(step),
                       eng.rank, cut, total, mine)
    if path is not None:
        with _lock:
            _puts += 1
    return path is not None


def drain(eng: "core_engine.NativeEngine | None" = None) -> int:
    """Pull everything waiting in the native shard inbox into this module
    — relayed shards into the store, inventory views into the agreement
    table — and fold in acks.  Returns shards absorbed.  (Direct-stream
    shards bypass this path: the data-plane receive thread lands them in
    the store the moment they pass CRC.)"""
    global _last_acked_step
    eng = eng or core_engine.peek_engine()
    if eng is None:
        return 0
    count = 0
    while True:
        item = eng.shard_poll()
        if item is None:
            break
        owner, step, epoch, payload = item
        if payload.startswith(_VIEW_MAGIC):
            try:
                inv = pickle.loads(payload[len(_VIEW_MAGIC):])
            except Exception:
                continue  # torn view: the sender will look empty, disk wins
            with _lock:
                _inventories[owner] = (inv, epoch)
            continue
        if payload.startswith(_WRAP_MAGIC):
            off = len(_WRAP_MAGIC)
            try:
                shard_index, _src, cut, total, crc = _WRAP_HDR.unpack_from(
                    payload, off)
            except struct.error:
                continue
            body = payload[off + _WRAP_HDR.size:]
            if zlib.crc32(body) != crc:
                continue  # torn relay shard: drop, never store
            if absorb_remote_shard(owner=owner, step=step, epoch=epoch,
                                   shard_index=shard_index, cut_size=cut,
                                   total_len=total, payload=body,
                                   via="relay"):
                count += 1
            continue
        # Unknown payload (fuzz): ignore rather than guess at a decode.
    for _owner, _tgt, step, _epoch in eng.shard_acks():
        with _lock:
            _last_acked_step = max(_last_acked_step, step)
    return count


# -- restore agreement ------------------------------------------------------


def local_inventory(epoch: int) -> dict:
    """``{step: {"cut": c, "total": t, "shards": [indices]}}`` for every
    epoch-valid entry held locally."""
    with _lock:
        inv: dict = {}
        for (step, idx), e in _shards.items():
            if e.epoch != epoch:
                continue
            d = inv.setdefault(step, {"cut": e.cut_size,
                                      "total": e.total_len, "shards": []})
            if d["cut"] == e.cut_size and d["total"] == e.total_len:
                d["shards"].append(idx)
        for d in inv.values():
            d["shards"].sort()
        return inv


def send_inventory(eng: "core_engine.NativeEngine | None" = None) -> dict:
    """Broadcast this rank's inventory view to every peer and PIN it as
    this rank's own announced view — election must run on what was
    announced, not on a store that kept absorbing in-flight shards, or
    ranks would elect from different worldviews."""
    eng = eng or core_engine.peek_engine()
    if eng is None or eng.size <= 1:
        return {}
    inv = local_inventory(eng.epoch)
    with _lock:
        _inventories[eng.rank] = (inv, eng.epoch)
    payload = _VIEW_MAGIC + pickle.dumps(inv, protocol=_PICKLE)
    tag = max((int(s) for s in inv), default=0)
    for r in range(eng.size):
        if r != eng.rank:
            eng.shard_put(r, max(tag, 0), payload)
    return inv


def inventories(epoch: int) -> dict[int, dict]:
    """Per-rank announced inventories stamped with *this* epoch (stale-
    epoch views are invisible, like stale shards)."""
    with _lock:
        return {r: inv for r, (inv, e) in _inventories.items() if e == epoch}


def elect(invs: dict[int, dict]) -> dict | None:
    """The restore verdict: the newest step whose shard set is COMPLETE
    across the union of announced inventories, with per-shard holder
    lists.  Pure function of the inventories — every rank that exchanged
    the same views computes the same verdict.  None: no complete set
    survives, fall back to disk."""
    candidates: dict[tuple[int, int, int], dict[int, list[int]]] = {}
    for r, inv in invs.items():
        for step, d in inv.items():
            try:
                key = (int(step), int(d["cut"]), int(d["total"]))
                shards = [int(i) for i in d["shards"]]
            except (KeyError, TypeError, ValueError):
                continue  # malformed view: that rank contributes nothing
            holders = candidates.setdefault(key, {})
            for i in shards:
                holders.setdefault(i, []).append(r)
    best = None
    for (step, cut, total), holders in candidates.items():
        need = n_shards(total, cut)
        if need == 0 or not all(i in holders for i in range(need)):
            continue
        if best is None or step > best["step"]:
            best = {"step": step, "cut_size": cut, "total_len": total,
                    "n_shards": need,
                    "holders": {i: sorted(holders[i]) for i in range(need)}}
    return best


def ship_missing(election: dict,
                 eng: "core_engine.NativeEngine | None" = None) -> int:
    """Execute this rank's slice of the deterministic transfer plan: for
    every shard whose LOWEST-rank announced holder is this rank, stream it
    (direct -> relay) to each rank whose announced inventory lacks it.
    Every rank derives the same plan from the same election + views, so
    each transfer has exactly one sender."""
    eng = eng or core_engine.peek_engine()
    if eng is None:
        return 0
    invs = inventories(eng.epoch)
    step, cut, total = (election["step"], election["cut_size"],
                        election["total_len"])
    shipped = 0
    for i in range(election["n_shards"]):
        holders = election["holders"].get(i, [])
        if not holders or holders[0] != eng.rank:
            continue
        with _lock:
            entry = _shards.get((step, i))
        if entry is None or entry.cut_size != cut \
                or entry.total_len != total:
            continue  # announced it but lost it: receivers fall to disk
        for r in range(eng.size):
            if r == eng.rank:
                continue
            rinv = invs.get(r, {}).get(step)
            if rinv is not None and rinv.get("cut") == cut \
                    and i in rinv.get("shards", []):
                continue  # already holds it
            if _ship_shard(eng, r, step, i, cut, total, entry.payload):
                shipped += 1
    return shipped


def assemble(election: dict, epoch: int) -> bytes | None:
    """Reassemble the elected step's byte ranges from the local store;
    None while any shard is missing or inconsistent (the caller keeps
    draining until the deadline, then falls to disk — a torn set is never
    decoded)."""
    step, cut, total = (election["step"], election["cut_size"],
                        election["total_len"])
    parts = []
    with _lock:
        for i in range(election["n_shards"]):
            e = _shards.get((step, i))
            if e is None or e.epoch != epoch or e.cut_size != cut \
                    or e.total_len != total:
                return None
            parts.append(e.payload)
    blob = b"".join(parts)
    return blob if len(blob) == total else None


def restore_local(epoch: int, device=None) -> dict | None:
    """Uncoordinated restore from the LOCAL store only: the newest
    locally-complete step, decoded with its tensors on ``device``; None
    otherwise."""
    election = elect({-1: local_inventory(epoch)})
    if election is None:
        return None
    blob = assemble(election, epoch)
    return decode_snapshot(blob, device) if blob is not None else None


# -- membership changes -----------------------------------------------------


def bump_epoch(new_epoch: int) -> None:
    """Re-stamp every held shard to the new membership epoch.  Called by
    elastic.reconfigure on ranks that PARTICIPATED in the reconfiguration:
    their shards describe state the new membership agrees on.  Ranks that
    missed the reconfig never call this, so their stale stamps are
    invisible to election and they restore from disk."""
    with _lock:
        for key, e in list(_shards.items()):
            _shards[key] = e._replace(epoch=int(new_epoch))


def reshard(eng: "core_engine.NativeEngine | None" = None) -> int:
    """Post-RECONFIG shard shuffle: every survivor re-ships its held
    shards of the newest step to its NEW ring partner, restoring the
    two-holders-per-shard redundancy under the new membership.  Best
    effort — a failed ship leaves disk as the fallback."""
    eng = eng or core_engine.peek_engine()
    if eng is None or eng.size <= 1:
        return 0
    with _lock:
        steps = sorted({s for (s, _i) in _shards}, reverse=True)
        if not steps:
            return 0
        newest = steps[0]
        mine = [e for (s, _i), e in sorted(_shards.items())
                if s == newest and e.epoch == eng.epoch]
    dst = target_rank(eng.rank, eng.size)
    count = 0
    for e in mine:
        if _ship_shard(eng, dst, e.step, e.shard_index, e.cut_size,
                       e.total_len, e.payload):
            count += 1
    return count


def clear() -> None:
    global _last_acked_step, _puts, _drained, _direct_shards, _relay_shards
    global _direct_bytes, _relay_bytes, _disk_restores
    with _lock:
        _shards.clear()
        _inventories.clear()
        _no_bulk.clear()
        _last_acked_step = -1
        _puts = 0
        _drained = 0
        _direct_shards = 0
        _relay_shards = 0
        _direct_bytes = 0
        _relay_bytes = 0
        _disk_restores = 0


def note_disk_restore() -> None:
    """Count a restore that fell through to disk — the tail of the
    fallback chain, reported by ``replication_stats()["disk_restores"]``
    and by a serving joiner as ``disk_reads``."""
    global _disk_restores
    with _lock:
        _disk_restores += 1


# -- observability ----------------------------------------------------------


def stats() -> dict:
    with _lock:
        steps_held = sorted({s for (s, _i) in _shards})
        return {
            "replicas": len(_shards),
            "shards_held": len(_shards),
            "steps_held": steps_held,
            "newest_step": steps_held[-1] if steps_held else -1,
            "last_acked_step": _last_acked_step,
            "puts": _puts,
            "drained": _drained,
        }


def replication_stats() -> dict:
    """Bytes shipped per path, shard counts, fallback-chain usage, and
    the measured direct-stream bandwidth."""
    from horovod_tpu_torch import dataplane

    dp = dataplane.stats()
    with _lock:
        return {
            "shards_held": len(_shards),
            "shards_shipped_direct": _direct_shards,
            "shards_shipped_relay": _relay_shards,
            "bytes_shipped_direct": _direct_bytes,
            "bytes_shipped_relay": _relay_bytes,
            "bytes_received_direct": dp["bytes_received"],
            "streams_received": dp["streams_received"],
            "recv_rejects": dp["recv_rejects"],
            "send_failures": dp["send_failures"],
            "disk_restores": _disk_restores,
            "bandwidth_bytes_per_s": dp["send_bandwidth_bytes_per_s"],
            "last_stream_error": dp["last_error"],
        }
