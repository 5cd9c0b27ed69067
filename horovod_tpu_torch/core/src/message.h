// Wire protocol for the coordination control plane.
//
// The reference serializes MPIRequest/MPIResponse lists with FlatBuffers
// (reference horovod/common/mpi_message.{h,cc}, wire/mpi_message.fbs) and
// moves them with MPI_Gather/Bcast.  We use a hand-rolled little-endian
// format (no vendored schema compiler; messages are small and the schema is
// stable) moved over loopback or TCP (controller.h): workers send a
// RequestList to the coordinator every cycle, the coordinator broadcasts a
// ResponseList.
//
// This header (with message.cc) is the wire format of record.  It has two
// conformance mirrors that MUST move in lockstep with any change here:
//   * horovod_tpu/analysis/protocol/wire.py — a pure-Python codec for every
//     FrameType, used by the protocol model checker to prove the control
//     plane's state machines only ever speak frames this file accepts;
//   * tests/golden/frames/*.bin — byte-exact golden vectors for all frame
//     types, generated by hvd_frame_golden() (c_api.cc) and pinned against
//     both encoders by tests/test_protocol_model.py.
// Editing a struct or the frame header without regenerating the goldens and
// updating wire.py fails the suite by design.
#pragma once

#include <cstdint>
#include <string>
#include <vector>

#include "common.h"

namespace hvd {

enum class OpType : int8_t {
  ALLREDUCE = 0,
  ALLGATHER = 1,
  BROADCAST = 2,
  ALLTOALL = 3,
  BARRIER = 4,
};

const char* OpTypeName(OpType t);

// On-the-wire payload encoding for the executor's data plane.  NATIVE
// moves the tensor's own dtype; INT8 ships each rank's contribution as
// (f32 scale, int8 values) — 4x fewer bytes than f32 — and the receiver
// dequant-sums in f32 (allreduce only; beyond the reference's cast-based
// Compression, reference compression.py:42-63).
enum class WireFormat : int8_t {
  NATIVE = 0,
  INT8 = 1,
};

const char* WireFormatName(WireFormat w);

// One tensor's readiness announcement (reference MPIRequest:
// mpi_message.h:48-90 — {request_rank, type, dtype, name, root_rank, device,
// shape}; "device" is dropped: one process drives all its local chips).
struct Request {
  int32_t rank = 0;
  OpType op = OpType::ALLREDUCE;
  DataType dtype = DataType::FLOAT32;
  int32_t root_rank = -1;
  WireFormat wire = WireFormat::NATIVE;
  std::string name;
  TensorShape shape;
};

// One schedule-verifier checkpoint (analysis/schedule.py): after this
// rank's ``seq``-th collective submission its rolling hash over every
// (op, name, dtype, shape) so far was ``hash``; ``desc`` names that
// submission for the divergence report.  Only populated under
// HVD_TPU_VERIFY_SCHEDULE.
struct VerifyEntry {
  int64_t seq = 0;
  uint64_t hash = 0;
  std::string desc;
};

struct RequestList {
  std::vector<Request> requests;
  std::vector<VerifyEntry> verify;
  // Response-cache fast path (docs/response_cache.md): positions of cached
  // entries this rank re-announces this cycle INSTEAD of full Request
  // metadata — serialized as a compact bit vector (the Horovod 0.16
  // response-cache line our 0.15.1 snapshot predates).
  std::vector<int32_t> cache_hits;
  // Names whose local cache entry went stale (signature changed): the full
  // Request rides in `requests`; the coordinator must flush the entry on
  // every rank in the same tick.
  std::vector<std::string> cache_invalidate;
  bool shutdown = false;
};

// Coordinator verdict for one (possibly fused) set of tensors (reference
// MPIResponse: mpi_message.h:119-154).
struct Response {
  enum class Type : int8_t {
    ALLREDUCE = 0,
    ALLGATHER = 1,
    BROADCAST = 2,
    ALLTOALL = 3,
    BARRIER = 4,
    ERROR = 5,
  };
  Type type = Type::ALLREDUCE;
  std::vector<std::string> tensor_names;
  std::string error_reason;
  // Per-rank dim-0 sizes for ALLGATHER (reference's MPI_Allgatherv sizing,
  // operations.cc:576-612).
  std::vector<int64_t> first_dim_sizes;
  // Response-cache protocol (docs/response_cache.md):
  //  * cache_bit >= 0 — this response IS cache entry `cache_bit`; nothing
  //    else is serialized and every rank expands it from its local replica
  //    (negotiation and re-validation skipped entirely).
  //  * store_bit >= 0 — freshly negotiated response every rank must store
  //    into replica slot `store_bit` (evicting that slot's old occupant),
  //    keeping the replicas aligned without broadcasting positions twice.
  int32_t cache_bit = -1;
  int32_t store_bit = -1;
};

// One rank's side of a schedule divergence: its ``seq``-th collective
// submission (the first where rolling hashes disagree across ranks).
// Broadcast to every rank so hvd.divergence_report() works everywhere,
// like the coordinated ERROR responses it accompanies.
struct DivergenceEntry {
  int32_t rank = 0;
  int64_t seq = 0;
  uint64_t hash = 0;
  std::string desc;
};

struct ResponseList {
  std::vector<Response> responses;
  std::vector<DivergenceEntry> divergence;
  // Coordinated response-cache maintenance, applied by every rank BEFORE
  // processing `responses` so replicas mutate identically in the same tick:
  // cache_invalidate erases the named entries (stale signature); cache_clear
  // flushes everything (schedule divergence).
  std::vector<std::string> cache_invalidate;
  bool cache_clear = false;
  bool shutdown = false;
};

// Serialization: append to / read from a byte buffer.  Readers return false
// on malformed input (truncation, absurd lengths).
void Serialize(const RequestList& in, std::string* out);
bool Deserialize(const char* data, size_t len, RequestList* out);
void Serialize(const ResponseList& in, std::string* out);
bool Deserialize(const char* data, size_t len, ResponseList* out);

// ---------------------------------------------------------------------------
// Hardened wire framing (docs/fault_tolerance.md "Fast failure detection").
//
// Every TCP control-plane frame is {FrameHeader, payload}: magic + protocol
// version + type + payload length + CRC32.  A corrupted, truncated, or
// desynced stream — or a mixed-build peer speaking a different protocol —
// fails fast with a structured error naming the peer instead of
// deserializing garbage or hanging (the bare length-prefixed frames this
// replaces had no way to tell).
// ---------------------------------------------------------------------------

constexpr uint32_t kFrameMagic = 0x48564446;  // "FDVH" on the wire
constexpr uint8_t kWireVersion = 1;

enum class FrameType : uint8_t {
  HELLO = 1,      // worker -> coordinator at connect: {i32 rank,
                  // i32 standby_listen_port (0 = none pre-bound),
                  // i32 bulk_listen_port (0 = no data plane)}
  HELLO_ACK = 2,  // coordinator -> worker: empty = accepted, else error text
  REQUEST = 3,    // RequestList (worker -> coordinator, every cycle)
  RESPONSE = 4,   // ResponseList (coordinator -> workers)
  HEARTBEAT = 5,  // empty liveness frame (monitor threads, both directions)
  ABORT = 6,      // PeerFailureReport: coordinated job abort
  RECONFIG = 7,   // ReconfigInfo: elastic membership change (coordinator ->
                  // workers; docs/fault_tolerance.md "In-place recovery")
  JOIN = 8,       // {i32 id}: a relaunched rank asking to be admitted
  JOIN_ACK = 9,   // JoinTicket: admission verdict for a JOIN
  STANDBY = 10,   // StandbyInfo: coordinator -> workers after rendezvous —
                  // the designated successor's pre-bound listen endpoint
                  // (docs/fault_tolerance.md "Coordinator failover")
  STATE = 11,     // CoordState: coordinator -> standby delta replication of
                  // the authoritative-only coordinator state
  SHARD_PUT = 12,  // ShardPut: one rank's checkpoint shard pushed to a peer's
                   // host memory, relayed through the coordinator star
                   // (docs/fault_tolerance.md "Async & peer-replicated
                   // checkpointing")
  SHARD_ACK = 13,  // ShardAck: the control plane accepted/relayed the shard
  TICKET_REQ = 14,  // TicketRequest: a rank asking the coordinator to
                    // authorize a rank-to-rank bulk transfer
                    // (docs/fault_tolerance.md "Bulk data plane")
  TICKET = 15,      // Ticket: the coordinator's authorization — the dst
                    // endpoint plus a transfer id/token the receiver can
                    // validate without ever seeing the ticket itself
  AGG_REQUEST = 16,  // AggRequestList: one aggregator's combined subtree
                     // frame — cache bits intersected, verifier hashes
                     // folded, per-member residual requests — sent up the
                     // coordinator tree once per tick
                     // (docs/fault_tolerance.md "Hierarchical tree")
  AGG_STATE = 17,    // AggState: aggregator -> its standby, the last
                     // completed tick's {seq, ResponseList bytes} so a
                     // promoted standby can replay the response to members
                     // the dead primary never reached
};

// 16-byte little-endian header preceding every frame payload.  ``flags``
// carries the membership epoch (low 16 bits): every elastic
// reconfiguration bumps it, and both sides reject frames stamped with a
// different epoch as ``stale_epoch`` — a straggler from a pre-shrink
// membership can never smuggle requests into the new one.  Epoch 0 (the
// only epoch of a non-elastic job) keeps the field's historical all-zero
// encoding, so the wire version does not change.
struct FrameHeader {
  uint32_t magic = kFrameMagic;
  uint8_t version = kWireVersion;
  uint8_t type = 0;
  uint16_t flags = 0;  // membership epoch (mod 2^16); 0 before any resize
  uint32_t payload_len = 0;
  uint32_t crc32 = 0;  // CRC-32 (IEEE) of the payload bytes
};
constexpr size_t kFrameHeaderBytes = 16;

void EncodeFrameHeader(const FrameHeader& h, char out[/*16*/]);
// Byte-decode only — field validation is the caller's (it knows the peer).
void DecodeFrameHeader(const char in[/*16*/], FrameHeader* h);

// CRC-32 (IEEE 802.3, reflected, poly 0xEDB88320) — the checksum in every
// frame header.
uint32_t Crc32(const void* data, size_t len);

// Structured peer-failure record (docs/fault_tolerance.md): who died, how
// the death was observed, and what the job was doing.  Broadcast to
// survivors in ABORT frames and surfaced as hvd.failure_report().
struct PeerFailureReport {
  int32_t failed_rank = -1;       // -1 = no failure recorded
  std::string cause;              // "connection_reset" | "heartbeat_timeout"
                                  // | "frame_corrupt" | "version_skew"
                                  // | "frame_desync" | "connection_lost"
  std::string detail;             // human-readable context
  int64_t last_heard_us = -1;     // silence before detection (-1 unknown)
  std::string last_collective;    // a collective pending at detection time
};

void Serialize(const PeerFailureReport& in, std::string* out);
bool Deserialize(const char* data, size_t len, PeerFailureReport* out);

// Elastic membership reconfiguration (docs/fault_tolerance.md "In-place
// recovery", HVD_TPU_ELASTIC=1): the coordinator's verdict when a
// non-coordinator rank dies (shrink) or a relaunched rank asks to rejoin
// (grow).  Broadcast as a RECONFIG frame; every survivor fails in-flight
// collectives, flushes its response-cache replica, and re-forms the
// control plane under the new epoch/size/rank without exiting.
struct ReconfigInfo {
  int64_t epoch = 0;        // the NEW membership epoch (old + 1)
  int32_t new_size = 0;     // surviving/expanded job size
  int32_t failed_rank = -1; // the removed rank; -1 for a pure grow
  std::string cause;        // PeerFailureReport cause, or "join"
  // Contiguous re-assignment, indexed by OLD rank: new_ranks[r] is rank
  // r's identity in the new membership, -1 when expelled.  A grow appends
  // the joiner at new_size - 1 (it learns that from its JoinTicket).
  std::vector<int32_t> new_ranks;
  // Coordinator failover (docs/fault_tolerance.md "Coordinator failover"):
  // when the COORDINATOR itself is the removed rank, the promoted standby's
  // identity and pre-bound listen endpoint ride the verdict so survivors
  // re-rendezvous without out-of-band discovery.  new_coord_rank is the
  // standby's OLD rank; -1/empty/0 = the coordinator did not move.
  int32_t new_coord_rank = -1;
  std::string new_coord_host;
  int32_t new_coord_port = 0;
};

void Serialize(const ReconfigInfo& in, std::string* out);
bool Deserialize(const char* data, size_t len, ReconfigInfo* out);

// Admission verdict sent to a JOINing rank: the epoch and size of the
// membership it will rendezvous into, and the rank it was assigned.
struct JoinTicket {
  int64_t epoch = 0;
  int32_t new_size = 0;
  int32_t assigned_rank = -1;
};

void Serialize(const JoinTicket& in, std::string* out);
bool Deserialize(const char* data, size_t len, JoinTicket* out);

// Standby-coordinator designation (docs/fault_tolerance.md "Coordinator
// failover"): broadcast to every worker in a STANDBY frame after the
// rendezvous completes.  The standby is the lowest-ranked worker that
// pre-bound a succession listener (HVD_TPU_STANDBY overrides the choice);
// on coordinator death every survivor re-rendezvouses against host:port.
struct StandbyInfo {
  int32_t standby_rank = -1;  // -1 = no standby designated
  std::string host;
  int32_t port = 0;
};

void Serialize(const StandbyInfo& in, std::string* out);
bool Deserialize(const char* data, size_t len, StandbyInfo* out);

// Replicated authoritative-only coordinator state, streamed to the standby
// in STATE frames by the coordinator's monitor thread.  Everything else a
// promoted standby needs is already replicated by construction (the
// response-cache slots mutate identically on every rank via the broadcast
// protocol; membership rides RECONFIG); this carries the pieces only the
// coordinator knows: the epoch it currently speaks, the join-admission
// counter, the schedule verifier's interval position, and its private LRU
// recency order (so a successor's future eviction decisions match the ones
// the dead coordinator would have made).
struct CoordState {
  int64_t epoch = 0;
  int64_t joins_admitted = 0;   // grow reconfigurations granted so far
  int64_t verify_checked = 0;   // verifier: seqs matched and pruned
  int64_t verify_tick = 0;      // verifier: interval phase (cycle count)
  std::vector<int32_t> lru_order;  // cache bits, most recently used first
};

void Serialize(const CoordState& in, std::string* out);
bool Deserialize(const char* data, size_t len, CoordState* out);

// One rank's checkpoint shard replicated into a peer's host memory
// (docs/fault_tolerance.md "Async & peer-replicated checkpointing").  The
// star topology has no worker-to-worker sockets, so SHARD_PUT frames are
// relayed through the coordinator: owner -> coordinator -> target.  The
// epoch stamps the membership the shard was cut under; a restore rejects
// replicas from any other epoch (stale membership = stale sharding).
// ``payload`` is an opaque Python-side blob (pickled host arrays), bounded
// only by kMaxFrameBytes.
struct ShardPut {
  int32_t owner_rank = -1;   // the rank whose state this is
  int32_t target_rank = -1;  // the peer holding the replica
  int64_t step = -1;         // training step the shard snapshots
  int64_t epoch = 0;         // membership epoch at snapshot time
  std::string payload;
};

void Serialize(const ShardPut& in, std::string* out);
bool Deserialize(const char* data, size_t len, ShardPut* out);

// Control-plane acknowledgement for a ShardPut: sent back to the owner when
// the coordinator accepts the shard for relay (or into its own inbox), so
// the owner's persist thread can bound replication lag without end-to-end
// round trips.
struct ShardAck {
  int32_t owner_rank = -1;
  int32_t target_rank = -1;
  int64_t step = -1;
  int64_t epoch = 0;
};

void Serialize(const ShardAck& in, std::string* out);
bool Deserialize(const char* data, size_t len, ShardAck* out);

// Bulk-transfer authorization request (docs/fault_tolerance.md "Bulk data
// plane"): src asks the coordinator for a ticket to stream ``nbytes`` of
// shard payload directly to dst's bulk listener.  ``manifest`` is an opaque
// Python-side description of the shard set (offsets/lengths/CRCs) echoed
// back in the Ticket so the sender's stream header and the receiver's
// validation agree on the same cut.
struct TicketRequest {
  int32_t src_rank = -1;
  int32_t dst_rank = -1;
  int64_t step = -1;
  int64_t epoch = 0;
  int64_t nbytes = 0;
  std::string manifest;
};

void Serialize(const TicketRequest& in, std::string* out);
bool Deserialize(const char* data, size_t len, TicketRequest* out);

// The coordinator's bulk-transfer authorization, sent back to the REQUESTING
// rank only.  The receiver never needs a ticket delivered: the token is a
// deterministic mix of {transfer_id, epoch, src, dst} (BulkToken below) that
// both sides compute independently, so an inbound stream validates against
// recomputation — no ticket/stream delivery race.  ``dst_port == 0`` means
// the destination advertised no bulk listener: use the coordinator relay.
struct Ticket {
  int64_t transfer_id = 0;
  uint64_t token = 0;
  int32_t src_rank = -1;
  int32_t dst_rank = -1;
  std::string dst_host;
  int32_t dst_port = 0;
  int64_t step = -1;
  int64_t epoch = 0;
  std::string manifest;
};

void Serialize(const Ticket& in, std::string* out);
bool Deserialize(const char* data, size_t len, Ticket* out);

// The deterministic transfer token: both the ticket issuer and the stream
// receiver compute it from public fields, so possession of a matching token
// proves the sender holds a coordinator-issued ticket for THIS (id, epoch,
// src, dst) tuple.  Mirrored bit-for-bit in Python (dataplane._token).
uint64_t BulkToken(int64_t transfer_id, int64_t epoch, int32_t src_rank,
                   int32_t dst_rank);

// One aggregator's combined per-tick frame (docs/fault_tolerance.md
// "Hierarchical coordinator tree").  What today floods rank 0 as `fanout`
// individual REQUEST frames is folded into one:
//  * hits_all — cache bits announced by EVERY member this tick (the
//    subtree intersection; the root bumps each member's readiness for
//    them without seeing per-member bit vectors),
//  * verify_folded/verify_all — the schedule-verifier entries, folded
//    when every member reported an identical vector (the steady state:
//    matching rolling hashes are the *point* of the verifier),
//  * residual — the per-member leftovers (full requests, invalidations,
//    partially-announced bits, shutdown flags) that are NOT common across
//    the subtree and must reach the coordinator verbatim.
// Combining is associative: a mid-tier aggregator can merge child
// AggRequestLists the same way, so depth-3 trees need no new frames.
// ``seq`` is the lockstep tick number (one AGG_REQUEST per subtree per
// global tick); the root replays its last broadcast when a promoted
// standby re-sends an already-answered seq.
struct AggRequestList {
  int32_t agg_id = -1;
  int64_t seq = 0;
  std::vector<int32_t> members;        // global ranks, ascending
  std::vector<int32_t> hits_all;       // bits announced by every member
  bool verify_folded = false;
  std::vector<VerifyEntry> verify_all; // valid when verify_folded
  std::vector<RequestList> residual;   // parallel to members
};

void Serialize(const AggRequestList& in, std::string* out);
bool Deserialize(const char* data, size_t len, AggRequestList* out);

// Aggregator-tier standby replication delta (the per-tier analog of the
// PR-7 CoordState stream): the last tick the primary completed and the
// exact ResponseList bytes it fanned out.  Sent to the standby AFTER the
// root's response arrives and BEFORE the fan-out, so a promoted standby
// can always replay the response to members the primary never reached —
// response-stream continuity is load-bearing (cache replicas mutate by
// applying every broadcast in order).
struct AggState {
  int64_t seq = -1;
  std::string response;  // serialized ResponseList
};

void Serialize(const AggState& in, std::string* out);
bool Deserialize(const char* data, size_t len, AggState* out);

}  // namespace hvd
