"""Byte-exact Python mirror of the control-plane wire format.

Every struct in the port's own ``horovod_tpu_torch/core/src/message.{h,cc}``
is mirrored here as a frozen
dataclass with ``encode()``/``decode()`` that produce/accept the *same
bytes* as the C++ ``Serialize``/``Deserialize`` pair: little-endian
fixed-width integers, i32-length-prefixed strings, cache bits as a
byte-count-prefixed bit vector, nested length-prefixed RequestList blobs
inside AggRequestList.  The mirror is what lets the model checker
(machines.py) speak the real frame vocabulary and what the golden
wire-vector test pins: ``golden_frames()`` returns one canonical framed
message per FrameType, the native ``hvd_frame_golden`` c_api hook of the
port's core (``horovod_tpu_torch.core.engine.frame_golden``) encodes the
same canonical values from C++, and tests/golden/frames/ holds the
checked-in bytes both must match — a silent wire drift on either side
breaks a unit test instead of a soak.

Existing partial mirrors (faults.py's frame scanner, dataplane._token,
elastic.join's hand-rolled JOIN) stay authoritative for their callers;
this module is the complete docs-of-record mirror.
"""

from __future__ import annotations

import dataclasses
import struct
import zlib

FRAME_MAGIC = 0x48564446  # "FDVH" on the wire
WIRE_VERSION = 1
FRAME_HEADER_BYTES = 16
_HEADER = struct.Struct("<IBBHII")

# FrameType values (core/src/message.h enum class FrameType).
HELLO = 1
HELLO_ACK = 2
REQUEST = 3
RESPONSE = 4
HEARTBEAT = 5
ABORT = 6
RECONFIG = 7
JOIN = 8
JOIN_ACK = 9
STANDBY = 10
STATE = 11
SHARD_PUT = 12
SHARD_ACK = 13
TICKET_REQ = 14
TICKET = 15
AGG_REQUEST = 16
AGG_STATE = 17

FRAME_NAMES = {
    HELLO: "HELLO", HELLO_ACK: "HELLO_ACK", REQUEST: "REQUEST",
    RESPONSE: "RESPONSE", HEARTBEAT: "HEARTBEAT", ABORT: "ABORT",
    RECONFIG: "RECONFIG", JOIN: "JOIN", JOIN_ACK: "JOIN_ACK",
    STANDBY: "STANDBY", STATE: "STATE", SHARD_PUT: "SHARD_PUT",
    SHARD_ACK: "SHARD_ACK", TICKET_REQ: "TICKET_REQ", TICKET: "TICKET",
    AGG_REQUEST: "AGG_REQUEST", AGG_STATE: "AGG_STATE",
}
FRAME_TYPES = {name: value for value, name in FRAME_NAMES.items()}

# OpType / DataType / WireFormat / Response::Type (common.h, message.h).
OP_ALLREDUCE, OP_ALLGATHER, OP_BROADCAST, OP_ALLTOALL, OP_BARRIER = range(5)
(DT_UINT8, DT_INT8, DT_INT32, DT_INT64, DT_FLOAT16, DT_FLOAT32, DT_FLOAT64,
 DT_BOOL, DT_BFLOAT16) = range(9)
WIRE_NATIVE, WIRE_INT8 = 0, 1
(RESP_ALLREDUCE, RESP_ALLGATHER, RESP_BROADCAST, RESP_ALLTOALL, RESP_BARRIER,
 RESP_ERROR) = range(6)

_MAX_STRING = 1 << 20  # kMaxString / kMaxVector sanity bounds
_MAX_VECTOR = 1 << 20


class WireError(ValueError):
    """Malformed bytes — the mirror of Deserialize() returning false."""


class _Writer:
    """Mirror of message.cc's anonymous-namespace Writer."""

    def __init__(self) -> None:
        self._parts: list[bytes] = []

    def u8(self, v: int) -> None:
        self._parts.append(struct.pack("<B", v & 0xFF))

    def i32(self, v: int) -> None:
        self._parts.append(struct.pack("<i", v))

    def i64(self, v: int) -> None:
        self._parts.append(struct.pack("<q", v))

    def u64(self, v: int) -> None:
        self._parts.append(struct.pack("<Q", v & 0xFFFFFFFFFFFFFFFF))

    def raw(self, b: bytes) -> None:
        self._parts.append(b)

    def str(self, s: str | bytes) -> None:
        b = s.encode() if isinstance(s, str) else s
        self.i32(len(b))
        self.raw(b)

    def bytes(self) -> bytes:
        return b"".join(self._parts)


class _Reader:
    """Mirror of message.cc's Reader; raises WireError instead of a fail
    flag so decode paths can't silently run on from garbage."""

    def __init__(self, data: bytes) -> None:
        self._d = data
        self._pos = 0

    @property
    def left(self) -> int:
        return len(self._d) - self._pos

    def _take(self, n: int) -> bytes:
        if self.left < n:
            raise WireError(f"truncated: need {n} bytes, have {self.left}")
        b = self._d[self._pos:self._pos + n]
        self._pos += n
        return b

    def u8(self) -> int:
        return self._take(1)[0]

    def i32(self) -> int:
        return struct.unpack("<i", self._take(4))[0]

    def i64(self) -> int:
        return struct.unpack("<q", self._take(8))[0]

    def u64(self) -> int:
        return struct.unpack("<Q", self._take(8))[0]

    def str(self) -> str:
        return self.str_bytes().decode()

    def str_bytes(self) -> bytes:
        n = self.i32()
        if n < 0 or n > _MAX_STRING or n > self.left:
            raise WireError(f"bad string length {n}")
        return self._take(n)

    def count(self) -> int:
        n = self.i32()
        if n < 0 or n > _MAX_VECTOR:
            raise WireError(f"bad element count {n}")
        return n

    def done(self) -> None:
        if self.left:
            raise WireError(f"{self.left} trailing bytes")


def _bitvector(w: _Writer, bits: tuple[int, ...]) -> None:
    """cache_hits/hits_all: byte count then one bit per slot (message.cc)."""
    max_bit = max(bits, default=-1)
    nbytes = (max_bit + 8) // 8  # 0 when no hits
    w.i32(nbytes)
    if nbytes > 0:
        buf = bytearray(nbytes)
        for b in bits:
            if b >= 0:
                buf[b // 8] |= 1 << (b % 8)
        w.raw(bytes(buf))


def _read_bitvector(r: _Reader) -> tuple[int, ...]:
    nbytes = r.count()
    out = []
    for byte in range(nbytes):
        v = r.u8()
        for bit in range(8):
            if v & (1 << bit):
                out.append(byte * 8 + bit)
    return tuple(out)


# ---------------------------------------------------------------------------
# Struct mirrors.  Field order in encode() IS the wire order — it matches the
# C++ Serialize() statement order line-for-line.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Hello:
    """HELLO payload (controller.cc SendHello: three raw i32s, no prefix)."""

    rank: int = 0
    standby_port: int = 0
    bulk_port: int = 0

    def encode(self) -> bytes:
        return struct.pack("<iii", self.rank, self.standby_port,
                           self.bulk_port)

    @classmethod
    def decode(cls, data: bytes) -> "Hello":
        if len(data) != 12:
            raise WireError(f"HELLO payload is 12 bytes, got {len(data)}")
        return cls(*struct.unpack("<iii", data))


@dataclasses.dataclass(frozen=True)
class Join:
    """JOIN payload: one raw i32 id (elastic.join / PollJoinRequest)."""

    id: int = 0

    def encode(self) -> bytes:
        return struct.pack("<i", self.id)

    @classmethod
    def decode(cls, data: bytes) -> "Join":
        if len(data) != 4:
            raise WireError(f"JOIN payload is 4 bytes, got {len(data)}")
        return cls(struct.unpack("<i", data)[0])


@dataclasses.dataclass(frozen=True)
class Request:
    rank: int = 0
    op: int = OP_ALLREDUCE
    dtype: int = DT_FLOAT32
    root_rank: int = -1
    wire: int = WIRE_NATIVE
    name: str = ""
    dims: tuple[int, ...] = ()


@dataclasses.dataclass(frozen=True)
class VerifyEntry:
    seq: int = 0
    hash: int = 0
    desc: str = ""


@dataclasses.dataclass(frozen=True)
class RequestList:
    requests: tuple[Request, ...] = ()
    verify: tuple[VerifyEntry, ...] = ()
    cache_hits: tuple[int, ...] = ()
    cache_invalidate: tuple[str, ...] = ()
    shutdown: bool = False

    def encode(self) -> bytes:
        w = _Writer()
        w.i32(len(self.requests))
        for q in self.requests:
            w.i32(q.rank)
            w.u8(q.op)
            w.u8(q.dtype)
            w.i32(q.root_rank)
            w.u8(q.wire)
            w.str(q.name)
            w.i32(len(q.dims))
            for d in q.dims:
                w.i64(d)
        w.u8(1 if self.shutdown else 0)
        w.i32(len(self.verify))
        for v in self.verify:
            w.i64(v.seq)
            w.u64(v.hash)
            w.str(v.desc)
        _bitvector(w, self.cache_hits)
        w.i32(len(self.cache_invalidate))
        for s in self.cache_invalidate:
            w.str(s)
        return w.bytes()

    @classmethod
    def decode(cls, data: bytes) -> "RequestList":
        r = _Reader(data)
        out = cls._read(r)
        r.done()
        return out

    @classmethod
    def _read(cls, r: _Reader) -> "RequestList":
        requests = []
        for _ in range(r.count()):
            rank, op, dtype = r.i32(), r.u8(), r.u8()
            root, wire, name = r.i32(), r.u8(), r.str()
            dims = tuple(r.i64() for _ in range(r.count()))
            requests.append(Request(rank, op, dtype, root, wire, name, dims))
        shutdown = r.u8() != 0
        verify = tuple(VerifyEntry(r.i64(), r.u64(), r.str())
                       for _ in range(r.count()))
        hits = _read_bitvector(r)
        invalidate = tuple(r.str() for _ in range(r.count()))
        return cls(tuple(requests), verify, hits, invalidate, shutdown)


@dataclasses.dataclass(frozen=True)
class Response:
    type: int = RESP_ALLREDUCE
    tensor_names: tuple[str, ...] = ()
    error_reason: str = ""
    first_dim_sizes: tuple[int, ...] = ()
    cache_bit: int = -1
    store_bit: int = -1


@dataclasses.dataclass(frozen=True)
class DivergenceEntry:
    rank: int = 0
    seq: int = 0
    hash: int = 0
    desc: str = ""


@dataclasses.dataclass(frozen=True)
class ResponseList:
    responses: tuple[Response, ...] = ()
    divergence: tuple[DivergenceEntry, ...] = ()
    cache_invalidate: tuple[str, ...] = ()
    cache_clear: bool = False
    shutdown: bool = False

    def encode(self) -> bytes:
        w = _Writer()
        w.i32(len(self.responses))
        for resp in self.responses:
            w.i32(resp.cache_bit)
            if resp.cache_bit >= 0:
                continue  # cache hit: the bit is the whole response
            w.u8(resp.type)
            w.str(resp.error_reason)
            w.i32(len(resp.tensor_names))
            for s in resp.tensor_names:
                w.str(s)
            w.i32(len(resp.first_dim_sizes))
            for d in resp.first_dim_sizes:
                w.i64(d)
            w.i32(resp.store_bit)
        w.i32(len(self.cache_invalidate))
        for s in self.cache_invalidate:
            w.str(s)
        w.u8(1 if self.cache_clear else 0)
        w.u8(1 if self.shutdown else 0)
        w.i32(len(self.divergence))
        for d in self.divergence:
            w.i32(d.rank)
            w.i64(d.seq)
            w.u64(d.hash)
            w.str(d.desc)
        return w.bytes()

    @classmethod
    def decode(cls, data: bytes) -> "ResponseList":
        r = _Reader(data)
        responses = []
        for _ in range(r.count()):
            cache_bit = r.i32()
            if cache_bit >= 0:
                responses.append(Response(cache_bit=cache_bit))
                continue
            rtype, error = r.u8(), r.str()
            names = tuple(r.str() for _ in range(r.count()))
            sizes = tuple(r.i64() for _ in range(r.count()))
            store_bit = r.i32()
            responses.append(Response(rtype, names, error, sizes,
                                      cache_bit, store_bit))
        invalidate = tuple(r.str() for _ in range(r.count()))
        cache_clear = r.u8() != 0
        shutdown = r.u8() != 0
        divergence = tuple(
            DivergenceEntry(r.i32(), r.i64(), r.u64(), r.str())
            for _ in range(r.count()))
        r.done()
        return cls(tuple(responses), divergence, invalidate, cache_clear,
                   shutdown)


@dataclasses.dataclass(frozen=True)
class PeerFailureReport:
    failed_rank: int = -1
    cause: str = ""
    detail: str = ""
    last_heard_us: int = -1
    last_collective: str = ""

    def encode(self) -> bytes:
        w = _Writer()
        w.i32(self.failed_rank)
        w.str(self.cause)
        w.str(self.detail)
        w.i64(self.last_heard_us)
        w.str(self.last_collective)
        return w.bytes()

    @classmethod
    def decode(cls, data: bytes) -> "PeerFailureReport":
        r = _Reader(data)
        out = cls(r.i32(), r.str(), r.str(), r.i64(), r.str())
        r.done()
        return out


@dataclasses.dataclass(frozen=True)
class ReconfigInfo:
    epoch: int = 0
    new_size: int = 0
    failed_rank: int = -1
    cause: str = ""
    new_ranks: tuple[int, ...] = ()
    new_coord_rank: int = -1
    new_coord_host: str = ""
    new_coord_port: int = 0

    def encode(self) -> bytes:
        w = _Writer()
        w.i64(self.epoch)
        w.i32(self.new_size)
        w.i32(self.failed_rank)
        w.str(self.cause)
        w.i32(len(self.new_ranks))
        for rr in self.new_ranks:
            w.i32(rr)
        w.i32(self.new_coord_rank)
        w.str(self.new_coord_host)
        w.i32(self.new_coord_port)
        return w.bytes()

    @classmethod
    def decode(cls, data: bytes) -> "ReconfigInfo":
        r = _Reader(data)
        epoch, size, failed, cause = r.i64(), r.i32(), r.i32(), r.str()
        ranks = tuple(r.i32() for _ in range(r.count()))
        out = cls(epoch, size, failed, cause, ranks, r.i32(), r.str(),
                  r.i32())
        r.done()
        return out


@dataclasses.dataclass(frozen=True)
class JoinTicket:
    epoch: int = 0
    new_size: int = 0
    assigned_rank: int = -1

    def encode(self) -> bytes:
        w = _Writer()
        w.i64(self.epoch)
        w.i32(self.new_size)
        w.i32(self.assigned_rank)
        return w.bytes()

    @classmethod
    def decode(cls, data: bytes) -> "JoinTicket":
        r = _Reader(data)
        out = cls(r.i64(), r.i32(), r.i32())
        r.done()
        return out


@dataclasses.dataclass(frozen=True)
class StandbyInfo:
    standby_rank: int = -1
    host: str = ""
    port: int = 0

    def encode(self) -> bytes:
        w = _Writer()
        w.i32(self.standby_rank)
        w.str(self.host)
        w.i32(self.port)
        return w.bytes()

    @classmethod
    def decode(cls, data: bytes) -> "StandbyInfo":
        r = _Reader(data)
        out = cls(r.i32(), r.str(), r.i32())
        r.done()
        return out


@dataclasses.dataclass(frozen=True)
class CoordState:
    epoch: int = 0
    joins_admitted: int = 0
    verify_checked: int = 0
    verify_tick: int = 0
    lru_order: tuple[int, ...] = ()

    def encode(self) -> bytes:
        w = _Writer()
        w.i64(self.epoch)
        w.i64(self.joins_admitted)
        w.i64(self.verify_checked)
        w.i64(self.verify_tick)
        w.i32(len(self.lru_order))
        for b in self.lru_order:
            w.i32(b)
        return w.bytes()

    @classmethod
    def decode(cls, data: bytes) -> "CoordState":
        r = _Reader(data)
        epoch, joins = r.i64(), r.i64()
        checked, tick = r.i64(), r.i64()
        lru = tuple(r.i32() for _ in range(r.count()))
        r.done()
        return cls(epoch, joins, checked, tick, lru)


@dataclasses.dataclass(frozen=True)
class ShardPut:
    owner_rank: int = -1
    target_rank: int = -1
    step: int = -1
    epoch: int = 0
    payload: bytes = b""

    def encode(self) -> bytes:
        w = _Writer()
        w.i32(self.owner_rank)
        w.i32(self.target_rank)
        w.i64(self.step)
        w.i64(self.epoch)
        w.i64(len(self.payload))
        w.raw(self.payload)
        return w.bytes()

    @classmethod
    def decode(cls, data: bytes) -> "ShardPut":
        r = _Reader(data)
        owner, target, step, epoch = r.i32(), r.i32(), r.i64(), r.i64()
        n = r.i64()
        if n < 0 or n > r.left:
            raise WireError(f"bad shard payload length {n}")
        return cls(owner, target, step, epoch, r._take(n))


@dataclasses.dataclass(frozen=True)
class ShardAck:
    owner_rank: int = -1
    target_rank: int = -1
    step: int = -1
    epoch: int = 0

    def encode(self) -> bytes:
        w = _Writer()
        w.i32(self.owner_rank)
        w.i32(self.target_rank)
        w.i64(self.step)
        w.i64(self.epoch)
        return w.bytes()

    @classmethod
    def decode(cls, data: bytes) -> "ShardAck":
        r = _Reader(data)
        out = cls(r.i32(), r.i32(), r.i64(), r.i64())
        r.done()
        return out


@dataclasses.dataclass(frozen=True)
class TicketRequest:
    src_rank: int = -1
    dst_rank: int = -1
    step: int = -1
    epoch: int = 0
    nbytes: int = 0
    manifest: str = ""

    def encode(self) -> bytes:
        w = _Writer()
        w.i32(self.src_rank)
        w.i32(self.dst_rank)
        w.i64(self.step)
        w.i64(self.epoch)
        w.i64(self.nbytes)
        w.str(self.manifest)
        return w.bytes()

    @classmethod
    def decode(cls, data: bytes) -> "TicketRequest":
        r = _Reader(data)
        out = cls(r.i32(), r.i32(), r.i64(), r.i64(), r.i64(), r.str())
        r.done()
        return out


@dataclasses.dataclass(frozen=True)
class Ticket:
    transfer_id: int = 0
    token: int = 0
    src_rank: int = -1
    dst_rank: int = -1
    dst_host: str = ""
    dst_port: int = 0
    step: int = -1
    epoch: int = 0
    manifest: str = ""

    def encode(self) -> bytes:
        w = _Writer()
        w.i64(self.transfer_id)
        w.u64(self.token)
        w.i32(self.src_rank)
        w.i32(self.dst_rank)
        w.str(self.dst_host)
        w.i32(self.dst_port)
        w.i64(self.step)
        w.i64(self.epoch)
        w.str(self.manifest)
        return w.bytes()

    @classmethod
    def decode(cls, data: bytes) -> "Ticket":
        r = _Reader(data)
        out = cls(r.i64(), r.u64(), r.i32(), r.i32(), r.str(), r.i32(),
                  r.i64(), r.i64(), r.str())
        r.done()
        return out


@dataclasses.dataclass(frozen=True)
class AggRequestList:
    agg_id: int = -1
    seq: int = 0
    members: tuple[int, ...] = ()
    hits_all: tuple[int, ...] = ()
    verify_folded: bool = False
    verify_all: tuple[VerifyEntry, ...] = ()
    residual: tuple[RequestList, ...] = ()

    def encode(self) -> bytes:
        w = _Writer()
        w.i32(self.agg_id)
        w.i64(self.seq)
        w.i32(len(self.members))
        for m in self.members:
            w.i32(m)
        _bitvector(w, self.hits_all)
        w.u8(1 if self.verify_folded else 0)
        if self.verify_folded:
            w.i32(len(self.verify_all))
            for v in self.verify_all:
                w.i64(v.seq)
                w.u64(v.hash)
                w.str(v.desc)
        for i in range(len(self.members)):
            blob = (self.residual[i] if i < len(self.residual)
                    else RequestList()).encode()
            w.str(blob)
        return w.bytes()

    @classmethod
    def decode(cls, data: bytes) -> "AggRequestList":
        r = _Reader(data)
        agg_id, seq = r.i32(), r.i64()
        members = tuple(r.i32() for _ in range(r.count()))
        hits = _read_bitvector(r)
        folded = r.u8() != 0
        verify = ()
        if folded:
            verify = tuple(VerifyEntry(r.i64(), r.u64(), r.str())
                           for _ in range(r.count()))
        residual = tuple(RequestList.decode(r.str_bytes())
                         for _ in range(len(members)))
        r.done()
        return cls(agg_id, seq, members, hits, folded, verify, residual)


@dataclasses.dataclass(frozen=True)
class AggState:
    seq: int = -1
    response: bytes = b""  # serialized ResponseList

    def encode(self) -> bytes:
        w = _Writer()
        w.i64(self.seq)
        w.i64(len(self.response))
        w.raw(self.response)
        return w.bytes()

    @classmethod
    def decode(cls, data: bytes) -> "AggState":
        r = _Reader(data)
        seq = r.i64()
        n = r.i64()
        if n < 0 or n > r.left:
            raise WireError(f"bad agg response length {n}")
        return cls(seq, r._take(n))


# ---------------------------------------------------------------------------
# Framing + token
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FrameHeader:
    """16-byte header (message.h FrameHeader); flags = epoch mod 2^16."""

    magic: int = FRAME_MAGIC
    version: int = WIRE_VERSION
    type: int = 0
    flags: int = 0
    payload_len: int = 0
    crc32: int = 0

    def encode(self) -> bytes:
        return _HEADER.pack(self.magic, self.version, self.type, self.flags,
                            self.payload_len, self.crc32)

    @classmethod
    def decode(cls, data: bytes) -> "FrameHeader":
        if len(data) < FRAME_HEADER_BYTES:
            raise WireError("short frame header")
        return cls(*_HEADER.unpack(data[:FRAME_HEADER_BYTES]))


def frame(ftype: int, payload: bytes, epoch: int = 0) -> bytes:
    """Full framed message: header (CRC over payload, epoch in flags) +
    payload — what SendTypedFrame puts on the socket."""
    hdr = FrameHeader(type=ftype, flags=epoch & 0xFFFF,
                      payload_len=len(payload),
                      crc32=zlib.crc32(payload) & 0xFFFFFFFF)
    return hdr.encode() + payload


def parse_frame(data: bytes) -> tuple[FrameHeader, bytes]:
    """Split and validate one framed message (magic/version/len/CRC)."""
    hdr = FrameHeader.decode(data)
    if hdr.magic != FRAME_MAGIC:
        raise WireError(f"bad magic {hdr.magic:#x}")
    if hdr.version != WIRE_VERSION:
        raise WireError(f"version skew: {hdr.version}")
    payload = data[FRAME_HEADER_BYTES:]
    if len(payload) != hdr.payload_len:
        raise WireError(f"payload length mismatch: header says "
                        f"{hdr.payload_len}, have {len(payload)}")
    if zlib.crc32(payload) & 0xFFFFFFFF != hdr.crc32:
        raise WireError("payload CRC mismatch")
    return hdr, payload


def bulk_token(transfer_id: int, epoch: int, src: int, dst: int) -> int:
    """Mirror of hvd::BulkToken (same as dataplane._token; duplicated here
    so the golden TICKET vector needs no dataplane import)."""
    mask = 0xFFFFFFFFFFFFFFFF
    x = (transfer_id * 0x9E3779B97F4A7C15) & mask
    x ^= (epoch + 0xBF58476D1CE4E5B9 + ((src & 0xFFFFFFFF) << 32)
          + (dst & 0xFFFFFFFF)) & mask
    x ^= x >> 30
    x = (x * 0xBF58476D1CE4E5B9) & mask
    x ^= x >> 27
    x = (x * 0x94D049BB133111EB) & mask
    x ^= x >> 31
    return x


# Payload codec per frame type, for decoding arbitrary framed bytes.
PAYLOAD_CODECS = {
    HELLO: Hello, REQUEST: RequestList, RESPONSE: ResponseList,
    ABORT: PeerFailureReport, RECONFIG: ReconfigInfo, JOIN: Join,
    JOIN_ACK: JoinTicket, STANDBY: StandbyInfo, STATE: CoordState,
    SHARD_PUT: ShardPut, SHARD_ACK: ShardAck, TICKET_REQ: TicketRequest,
    TICKET: Ticket, AGG_REQUEST: AggRequestList, AGG_STATE: AggState,
}


# ---------------------------------------------------------------------------
# Canonical golden samples — one per FrameType, every field populated with
# fixed values.  core/src/c_api.cc hvd_frame_golden() hard-codes the SAME
# values; tests/golden/frames/ holds the checked-in framed bytes both sides
# must reproduce.  Changing any value here without regenerating the fixtures
# (and the C++ twin) is a test failure by design.
# ---------------------------------------------------------------------------

_GOLDEN_REQUEST = RequestList(
    requests=(
        Request(rank=1, op=OP_ALLREDUCE, dtype=DT_FLOAT32, root_rank=-1,
                wire=WIRE_NATIVE, name="grad/dense/kernel:0", dims=(4, 8)),
        Request(rank=1, op=OP_ALLGATHER, dtype=DT_INT64, root_rank=0,
                wire=WIRE_INT8, name="metrics.gather", dims=(3,)),
    ),
    verify=(VerifyEntry(seq=7, hash=0x1234567890ABCDEF,
                        desc="allreduce grad/dense/kernel:0"),),
    cache_hits=(0, 3, 9),
    cache_invalidate=("stale.tensor",),
    shutdown=False)

_GOLDEN_RESPONSE = ResponseList(
    responses=(
        Response(cache_bit=5),
        Response(type=RESP_ALLGATHER, tensor_names=("metrics.gather",
                                                    "agg.y"),
                 error_reason="", first_dim_sizes=(3, 5), cache_bit=-1,
                 store_bit=2),
        Response(type=RESP_ERROR, tensor_names=("grad/dense/kernel:0",),
                 error_reason="peer failure: rank 2", cache_bit=-1,
                 store_bit=-1),
    ),
    divergence=(DivergenceEntry(rank=1, seq=9, hash=0xDEADBEEF12345678,
                                desc="allreduce step.9"),),
    cache_invalidate=("stale.tensor",),
    cache_clear=False, shutdown=False)


def golden_frames() -> list[tuple[int, str, bytes]]:
    """(frame_type, name, framed bytes) for every FrameType, canonical
    values.  The fixture files in tests/golden/frames/ are exactly these."""
    samples: list[tuple[int, int, bytes]] = [
        (HELLO, 0, Hello(rank=3, standby_port=18443,
                         bulk_port=19001).encode()),
        (HELLO_ACK, 0, b""),  # empty = accepted
        (REQUEST, 2, _GOLDEN_REQUEST.encode()),
        (RESPONSE, 2, _GOLDEN_RESPONSE.encode()),
        (HEARTBEAT, 2, b""),
        (ABORT, 2, PeerFailureReport(
            failed_rank=2, cause="heartbeat_timeout",
            detail="silence 11000 ms", last_heard_us=11000000,
            last_collective="allreduce grad/dense/kernel:0").encode()),
        (RECONFIG, 3, ReconfigInfo(
            epoch=3, new_size=3, failed_rank=1, cause="connection_reset",
            new_ranks=(0, -1, 1, 2), new_coord_rank=-1, new_coord_host="",
            new_coord_port=0).encode()),
        (JOIN, 0, Join(id=2).encode()),
        (JOIN_ACK, 0, JoinTicket(epoch=4, new_size=4,
                                 assigned_rank=3).encode()),
        (STANDBY, 0, StandbyInfo(standby_rank=1, host="127.0.0.1",
                                 port=23456).encode()),
        (STATE, 3, CoordState(epoch=3, joins_admitted=1, verify_checked=42,
                              verify_tick=7, lru_order=(2, 0, 1)).encode()),
        (SHARD_PUT, 3, ShardPut(owner_rank=1, target_rank=2, step=10,
                                epoch=3,
                                payload=b"\x00\x01\x02\x03shard-bytes"
                                ).encode()),
        (SHARD_ACK, 3, ShardAck(owner_rank=1, target_rank=2, step=10,
                                epoch=3).encode()),
        (TICKET_REQ, 3, TicketRequest(src_rank=1, dst_rank=2, step=10,
                                      epoch=3, nbytes=4096,
                                      manifest='{"cut":2}').encode()),
        (TICKET, 3, Ticket(transfer_id=99, token=bulk_token(99, 3, 1, 2),
                           src_rank=1, dst_rank=2, dst_host="127.0.0.1",
                           dst_port=20001, step=10, epoch=3,
                           manifest='{"cut":2}').encode()),
        (AGG_REQUEST, 2, AggRequestList(
            agg_id=1, seq=5, members=(3, 4), hits_all=(1, 2),
            verify_folded=True,
            verify_all=(VerifyEntry(seq=5, hash=0x0123456789ABCDEF,
                                    desc="fold"),),
            residual=(RequestList(requests=(Request(
                rank=3, op=OP_ALLREDUCE, dtype=DT_FLOAT32, root_rank=-1,
                wire=WIRE_NATIVE, name="grad/dense/kernel:0",
                dims=(4, 8)),)), RequestList())).encode()),
        (AGG_STATE, 2, AggState(seq=5,
                                response=_GOLDEN_RESPONSE.encode()).encode()),
    ]
    return [(t, FRAME_NAMES[t], frame(t, payload, epoch))
            for t, epoch, payload in samples]
