"""Rank-to-rank bulk data plane — counterpart of
``horovod_tpu/dataplane.py``: ticketed peer streams for snapshot shards
and weight clones.  One difference: a stream that arrives before its
receiver has registered an engine waits for one (:func:`_await_engine`).

The control plane is a star: every frame a worker sends is relayed by the
rank-0 coordinator (``core/src/controller.cc``).  That suits negotiation
metadata and not bulk payloads, so payloads move here:

* Each rank binds ONE process-global TCP listener (:func:`ensure_listener`)
  *before* its engine is created, so the port rides the rank's HELLO and
  survives elastic re-forms — the listener outlives any single engine.
* Transfers are authorized by coordinator-issued **tickets** (TICKET_REQ /
  TICKET control frames): the sender asks the coordinator for a ticket
  naming {src, dst, step, manifest}; the coordinator answers with the
  destination's advertised endpoint, a fresh transfer id, and a
  deterministic token (``core/src/message.cc`` BulkToken).  The receiver
  recomputes the token from its OWN rank and epoch, so a misrouted or
  stale-epoch stream is rejected at the header.
* Payloads move as CRC32-framed chunks (``HVD_TPU_BULK_CHUNK_BYTES``)
  directly between peers, every socket operation bounded by
  ``HVD_TPU_BULK_TIMEOUT_MS`` so a partitioned peer aborts the transfer —
  landing the caller on the fallback chain (direct -> coordinator relay)
  — instead of hanging it.

Malformed input (bad magic, oversized total, token mismatch, chunk CRC
mismatch, truncation) becomes a structured :class:`CollectiveError` naming
the peer and the transfer id, recorded in :func:`stats` and retrievable
via :func:`last_error` — never a desynced stream, never a hang, never a
torn shard landing in the replica store.

Chaos: ``HVD_TPU_FAULT_BULK_{DROP,CORRUPT,TRUNCATE}`` (``faults.py``
``on_bulk_send``) deterministically break the nth outgoing stream.
"""

from __future__ import annotations

import socket
import struct
import threading
import time
import zlib

from horovod_tpu_torch import faults
from horovod_tpu_torch.core import engine as core_engine
from horovod_tpu_torch.core.engine import CollectiveError
from horovod_tpu_torch.utils import env

# Stream header: everything the receiver needs to validate and store the
# shard before a single payload byte is read.  payload_len is THIS
# stream's byte count; total_len is the whole encoded blob the shard was
# cut from (the store needs both — the last shard of a blob is shorter
# than cut_size).
#   magic u32, version u16, src_rank i16 (fits: ranks are small),
#   transfer_id i64, token u64, owner i32, shard_index i32, step i64,
#   epoch i64, cut_size i64, total_len i64, payload_len i64,
#   payload_crc u32
_HDR = struct.Struct("<IHhqQiiqqqqqI")
_MAGIC = 0x48564442  # "BDVH" little-endian — distinct from the frame magic
_VERSION = 1
_ACK_OK = b"\x01"

_lock = threading.Lock()
_listener: socket.socket | None = None
_listener_port = 0
_accept_thread: threading.Thread | None = None
_stats = {
    "streams_sent": 0,
    "streams_received": 0,
    "bytes_sent": 0,
    "bytes_received": 0,
    "send_failures": 0,
    "recv_rejects": 0,
    "send_seconds": 0.0,
}
_last_error: CollectiveError | None = None


def _token(transfer_id: int, epoch: int, src_rank: int, dst_rank: int) -> int:
    """Python mirror of core/src/message.cc BulkToken — splitmix64 over the
    ticket identity.  Receiver-side validation recomputes this from the
    receiver's OWN rank and epoch."""
    m = (1 << 64) - 1
    x = (transfer_id * 0x9E3779B97F4A7C15) & m
    x ^= (epoch + 0xBF58476D1CE4E5B9
          + ((src_rank & 0xFFFFFFFF) << 32) + (dst_rank & 0xFFFFFFFF)) & m
    x ^= x >> 30
    x = (x * 0xBF58476D1CE4E5B9) & m
    x ^= x >> 27
    x = (x * 0x94D049BB133111EB) & m
    x ^= x >> 31
    return x


def _record_error(err: CollectiveError) -> None:
    global _last_error
    with _lock:
        _last_error = err
        _stats["recv_rejects"] += 1


def last_error() -> CollectiveError | None:
    """The most recent structured receive-side rejection (peer and transfer
    id in the message), or None.  Observability only — the sender already
    took the fallback chain."""
    with _lock:
        return _last_error


def _timeout_s() -> float:
    return max(env.bulk_timeout_ms(), 1.0) / 1000.0


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    """Read exactly n bytes or raise ConnectionError (EOF mid-read is a
    truncation, not a short result)."""
    buf = bytearray()
    while len(buf) < n:
        part = sock.recv(min(1 << 20, n - len(buf)))
        if not part:
            raise ConnectionError(
                f"peer closed mid-read ({len(buf)}/{n} bytes)")
        buf += part
    return bytes(buf)


def _await_engine():
    """The process's engine.  A stream can arrive between this rank's
    rendezvous and the moment the process registers its new engine (a
    joiner's ``elastic.attach``, a worker's constructor still returning
    while the coordinator already ships), so wait for one up to the bulk
    timeout instead of rejecting the stream at once as the JAX package
    does."""
    deadline = time.monotonic() + _timeout_s()
    while True:
        eng = core_engine.peek_engine()
        if eng is not None or time.monotonic() >= deadline:
            return eng
        time.sleep(0.005)


def _handle_conn(sock: socket.socket, peer: tuple) -> None:
    """One inbound stream: header -> validate -> chunks -> store -> ack.

    Every reject path closes WITHOUT the ack byte, so the sender's ack
    wait fails fast and it falls to the relay; nothing here can raise out
    of the accept loop."""
    transfer_id = -1
    src_rank = -1
    try:
        sock.settimeout(_timeout_s())
        raw = _recv_exact(sock, _HDR.size)
        (magic, version, src_rank, transfer_id, token, owner, shard_index,
         step, epoch, cut_size, total_len, payload_len,
         payload_crc) = _HDR.unpack(raw)
        if magic != _MAGIC or version != _VERSION:
            raise CollectiveError(
                f"bulk stream from {peer[0]} rejected: bad magic/version "
                f"0x{magic:08x}/{version} (cause: frame_desync)")
        if not (0 <= payload_len <= env.bulk_max_bytes()) \
                or not (0 <= total_len <= env.bulk_max_bytes()):
            raise CollectiveError(
                f"bulk transfer {transfer_id} from rank {src_rank} "
                f"rejected: advertised {payload_len}/{total_len} bytes "
                f"exceeds HVD_TPU_BULK_MAX_BYTES={env.bulk_max_bytes()} "
                f"(cause: frame_desync)")
        eng = _await_engine()
        if eng is None:
            raise CollectiveError(
                f"bulk transfer {transfer_id} from rank {src_rank} "
                f"rejected: no engine to validate against "
                f"(cause: stale_epoch)")
        expect = _token(transfer_id, eng.epoch, src_rank, eng.rank)
        if token != expect:
            raise CollectiveError(
                f"bulk transfer {transfer_id} from rank {src_rank} "
                f"rejected: token mismatch — misrouted or stale-epoch "
                f"stream (cause: stale_epoch)")
        chunks = []
        got = 0
        while got < payload_len:
            clen, ccrc = struct.unpack("<II", _recv_exact(sock, 8))
            if clen == 0 or got + clen > payload_len:
                raise CollectiveError(
                    f"bulk transfer {transfer_id} from rank {src_rank} "
                    f"rejected: chunk length {clen} desyncs the stream "
                    f"at offset {got}/{payload_len} (cause: frame_desync)")
            chunk = _recv_exact(sock, clen)
            if zlib.crc32(chunk) != ccrc:
                raise CollectiveError(
                    f"bulk transfer {transfer_id} from rank {src_rank} "
                    f"rejected: chunk CRC mismatch at offset {got} "
                    f"(cause: frame_corrupt)")
            chunks.append(chunk)
            got += clen
        payload = b"".join(chunks)
        if zlib.crc32(payload) != payload_crc:
            raise CollectiveError(
                f"bulk transfer {transfer_id} from rank {src_rank} "
                f"rejected: payload CRC mismatch (cause: frame_corrupt)")
        from horovod_tpu_torch import replication

        if not replication.absorb_remote_shard(
                owner=owner, step=step, epoch=epoch, shard_index=shard_index,
                cut_size=cut_size, total_len=total_len, payload=payload,
                via="direct"):
            raise CollectiveError(
                f"bulk transfer {transfer_id} from rank {src_rank} "
                f"rejected: shard {shard_index} bytes disagree with its "
                f"(cut={cut_size}, total={total_len}) coordinates — torn "
                f"shard never stored (cause: frame_corrupt)")
        with _lock:
            _stats["streams_received"] += 1
            _stats["bytes_received"] += payload_len
        sock.sendall(_ACK_OK)
    except CollectiveError as e:
        _record_error(e)
    except (OSError, ConnectionError, struct.error) as e:
        _record_error(CollectiveError(
            f"bulk transfer {transfer_id} from rank {src_rank} aborted: "
            f"{e} (cause: connection_lost)"))
    finally:
        try:
            sock.close()
        except OSError:
            pass


def _accept_loop(listener: socket.socket) -> None:
    while True:
        try:
            sock, peer = listener.accept()
        except OSError:
            return  # listener closed — process-global shutdown
        t = threading.Thread(target=_handle_conn, args=(sock, peer),
                             daemon=True, name="hvd-bulk-recv")
        t.start()


def ensure_listener() -> int:
    """Bind the process-global bulk listener (idempotent) and return its
    port.  Called by ``core.engine.get_engine`` BEFORE the engine exists so
    the port can ride this rank's HELLO; elastic re-forms reuse the same
    listener, so re-advertisement is free."""
    global _listener, _listener_port, _accept_thread
    with _lock:
        if _listener is not None:
            return _listener_port
        listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        listener.bind(("0.0.0.0", 0))
        listener.listen(64)
        _listener = listener
        _listener_port = listener.getsockname()[1]
        _accept_thread = threading.Thread(
            target=_accept_loop, args=(listener,), daemon=True,
            name="hvd-bulk-accept")
        _accept_thread.start()
        return _listener_port


def listener_port() -> int:
    """The bound bulk port, or 0 when no listener was ever started."""
    with _lock:
        return _listener_port


def shutdown() -> None:
    """Close the listener (tests); in-flight receive threads finish on
    their own timeouts."""
    global _listener, _listener_port, _accept_thread
    with _lock:
        listener, _listener = _listener, None
        _listener_port = 0
        _accept_thread = None
    if listener is not None:
        try:
            listener.close()
        except OSError:
            pass


def send(ticket: dict, owner: int, shard_index: int, cut_size: int,
         total_len: int, payload: bytes, rank: int | None = None) -> bool:
    """Stream one shard to the peer named by a coordinator ticket.

    Returns True only on the receiver's explicit ack; every failure —
    no advertised endpoint (``dst_port == 0``), connect/send timeout,
    missing ack, injected fault — returns False so the caller falls to
    the coordinator relay.  Never raises."""
    if ticket.get("dst_port", 0) <= 0:
        return False  # peer advertised no bulk listener: relay only
    fault = faults.on_bulk_send(rank)
    if fault == "drop":
        with _lock:
            _stats["send_failures"] += 1
        return False
    nbytes = len(payload)
    chunk_bytes = env.bulk_chunk_bytes()
    started = time.monotonic()
    sock = None
    try:
        sock = socket.create_connection(
            (ticket["dst_host"], ticket["dst_port"]), timeout=_timeout_s())
        sock.settimeout(_timeout_s())
        hdr = _HDR.pack(
            _MAGIC, _VERSION, ticket["src_rank"], ticket["transfer_id"],
            ticket["token"], owner, shard_index, ticket["step"],
            ticket["epoch"], cut_size, total_len, nbytes,
            zlib.crc32(payload))
        sock.sendall(hdr)
        if fault == "truncate" and nbytes == 0:
            return False  # nothing to truncate: just die before the ack
        sent = 0
        first = True
        while sent < nbytes:
            chunk = payload[sent:sent + chunk_bytes]
            crc = zlib.crc32(chunk)
            if fault == "corrupt" and first:
                crc ^= 0xFFFFFFFF
            if fault == "truncate" and first:
                # Die mid-chunk: frame header promises the full chunk,
                # half the bytes arrive, then EOF — the receiver must see
                # a truncation, never a short-but-plausible payload.
                head = chunk[:max(1, len(chunk) // 2)]
                sock.sendall(struct.pack("<II", len(chunk), crc) + head)
                return False
            sock.sendall(struct.pack("<II", len(chunk), crc) + chunk)
            first = False
            sent += len(chunk)
        ack = sock.recv(1)
        if ack != _ACK_OK:
            with _lock:
                _stats["send_failures"] += 1
            return False
        with _lock:
            _stats["streams_sent"] += 1
            _stats["bytes_sent"] += nbytes
            _stats["send_seconds"] += max(time.monotonic() - started, 1e-9)
        return True
    except (OSError, ConnectionError) as e:
        _record_error(CollectiveError(
            f"bulk transfer {ticket.get('transfer_id', -1)} to rank "
            f"{ticket.get('dst_rank', -1)} failed: {e} "
            f"(cause: connection_lost)"))
        with _lock:
            _stats["send_failures"] += 1
        return False
    finally:
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass


def stats() -> dict:
    with _lock:
        out = dict(_stats)
        out["listener_port"] = _listener_port
        out["last_error"] = str(_last_error) if _last_error else None
        secs = out.pop("send_seconds")
        out["send_bandwidth_bytes_per_s"] = (
            out["bytes_sent"] / secs if secs > 0 else 0.0)
    return out


def reset_stats() -> None:
    global _last_error
    with _lock:
        for k in _stats:
            _stats[k] = 0.0 if k == "send_seconds" else 0
        _last_error = None
