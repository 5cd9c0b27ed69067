// Control plane + readiness negotiation.
//
// TPU-native rebuild of the reference's rank-0 coordinator (reference
// horovod/common/operations.cc:1694-1903): every cycle, each worker sends
// the coordinator the list of tensors it has locally enqueued; the
// coordinator counts readiness per name, validates cross-rank consistency
// (op/dtype/shape/root), and broadcasts back an ordered ResponseList that
// every process executes identically.  The transport is pluggable:
// loopback for single-process jobs (the common TPU case — one process per
// host already sees all local chips) and TCP for multi-host eager jobs,
// standing in for the reference's MPI_Gather/Gatherv/Bcast.
#pragma once

#include <atomic>
#include <chrono>
#include <deque>
#include <list>
#include <map>
#include <memory>
#include <mutex>
#include <set>
#include <string>
#include <unordered_map>
#include <vector>

#include "common.h"
#include "message.h"
#include "timeline.h"

namespace hvd {

// Transport abstraction (reference: MPI collectives on mpi_comm).
class ControlPlane {
 public:
  virtual ~ControlPlane() = default;
  // Worker side: send this cycle's RequestList to the coordinator and
  // receive the broadcast ResponseList.  Blocking; returns false on
  // transport failure.
  virtual bool Exchange(const RequestList& send, ResponseList* recv) = 0;
  // Coordinator side: gather all workers' RequestLists (index = rank;
  // coordinator's own list included), later Broadcast the verdict.
  virtual bool Gather(const RequestList& own,
                      std::vector<RequestList>* all) = 0;
  virtual bool Broadcast(const ResponseList& out) = 0;
  virtual bool is_coordinator() const = 0;

  // Liveness hooks, driven by the engine's monitor thread (TCP only; the
  // loopback plane has no peers).  HeartbeatTick sends a HEARTBEAT frame
  // to every peer and flags any peer silent for longer than timeout_s;
  // returns true once a peer failure has been recorded (transport calls
  // above also record failures — EOF, CRC mismatch, version skew).
  virtual bool HeartbeatTick(double /*timeout_s*/) { return false; }
  // Structured cause of the recorded failure; false when none.
  virtual bool GetFailure(PeerFailureReport* /*out*/) const { return false; }
  // Coordinator: broadcast an ABORT frame naming the failed rank to every
  // worker, best effort — survivors fail their pending collectives with
  // the report instead of waiting out the stall window.
  virtual void AbortPeers(const PeerFailureReport& /*report*/) {}

  // Elastic membership reconfiguration (HVD_TPU_ELASTIC=1;
  // docs/fault_tolerance.md "In-place recovery").
  // Worker side: a RECONFIG frame received while blocked on the
  // coordinator is recorded here (the transport call returns false, like a
  // failure; the engine consults GetReconfig BEFORE GetFailure).
  virtual bool GetReconfig(ReconfigInfo* /*out*/) const { return false; }
  // Coordinator: broadcast the reconfiguration verdict to every connected
  // worker (the expelled rank included — it learns it was expelled from
  // new_ranks[old_rank] == -1 and takes the legacy abort path).
  virtual void BroadcastReconfig(const ReconfigInfo& /*info*/) {}
  // Coordinator: non-blocking check for a relaunched rank knocking on the
  // listen socket with a JOIN frame.  Returns the joiner's advertised id
  // (its pre-failure rank, informational) or -1; the connection is parked
  // until SendJoinTicket answers it.
  virtual int PollJoinRequest() { return -1; }
  virtual void SendJoinTicket(const JoinTicket& /*ticket*/) {}
  // Coordinator, reconfiguration hand-off: close ONLY the listen socket so
  // the re-formed membership can bind the same port, while the old peer
  // sockets stay open (absorbing stray heartbeats from survivors that have
  // not processed the RECONFIG broadcast yet — closing them would RST the
  // peer and flush the un-read verdict out of its receive queue).
  virtual void CloseListener() {}

  // Coordinator failover (docs/fault_tolerance.md "Coordinator failover").
  // Worker side: the designated standby's endpoint, learned from the
  // coordinator's post-rendezvous STANDBY broadcast; false while none was
  // announced (non-elastic job, or the broadcast never arrived).
  virtual bool GetStandby(StandbyInfo* /*out*/) const { return false; }
  // Standby side: the last replicated CoordState delta from the
  // coordinator's monitor thread; false before the first STATE frame.
  virtual bool GetCoordState(CoordState* /*out*/) const { return false; }
  // Coordinator side: stream the authoritative-only state to the standby
  // (best effort; a send failure is a peer failure like any other).
  virtual void SyncCoordState(const CoordState& /*state*/) {}

  // Async peer-replicated checkpointing (docs/fault_tolerance.md "Async &
  // peer-replicated checkpointing").  SendShard pushes one checkpoint
  // shard toward shard.target_rank — the star topology has no
  // worker-to-worker sockets, so worker-originated shards ride SHARD_PUT
  // frames to the coordinator, which relays them to the target (or into
  // its own inbox) and answers the owner with a SHARD_ACK.  PollShard
  // pops the next shard a peer replicated into this plane's inbox;
  // PollShardAck pops the next acknowledgement for a shard this rank
  // sent.  All non-blocking; the loopback plane has no peers to
  // replicate to.
  virtual bool SendShard(const ShardPut& /*shard*/) { return false; }
  virtual bool PollShard(ShardPut* /*out*/) { return false; }
  // Return a polled shard to the front of the inbox (the C-ABI
  // grow-and-retry path: the caller's buffer was too small).
  virtual void RequeueShard(ShardPut&& /*shard*/) {}
  virtual bool PollShardAck(ShardAck* /*out*/) { return false; }

  // Bulk data plane (docs/fault_tolerance.md "Bulk data plane").
  // RequestTicket asks the coordinator to authorize a direct rank-to-rank
  // stream (TICKET_REQ frame; the coordinator answers the requester with a
  // TICKET frame carrying the dst endpoint + transfer token).  PollTicket
  // pops the next issued ticket; RequeueTicket returns one (grow-and-retry).
  // The loopback plane has no peers to stream to.
  virtual bool RequestTicket(const TicketRequest& /*req*/) { return false; }
  virtual bool PollTicket(Ticket* /*out*/) { return false; }
  virtual void RequeueTicket(Ticket&& /*ticket*/) {}

  // Observability (hvd.control_plane_stats()): completed inbound frames
  // since the plane came up (heartbeats included) and microseconds spent
  // actually processing frames (poll()-wait excluded).  The frame counter
  // feeds the per-tick frame rate; the busy counter is what the fleet
  // simulator composes into a modeled tick on a single host, where
  // wall-clock would measure the scheduler instead of the protocol.
  virtual long long FramesReceived() const { return 0; }
  virtual long long BusyMicros() const { return 0; }
};

// Single-process transport: Exchange/Gather/Broadcast are pass-throughs.
class LoopbackControlPlane : public ControlPlane {
 public:
  bool Exchange(const RequestList&, ResponseList*) override { return false; }
  bool Gather(const RequestList& own, std::vector<RequestList>* all) override {
    all->assign(1, own);
    return true;
  }
  bool Broadcast(const ResponseList& out) override {
    last = out;
    return true;
  }
  bool is_coordinator() const override { return true; }
  ResponseList last;
};

// TCP transport: coordinator (rank 0) accepts one persistent connection per
// worker.  Every frame is hardened (message.h FrameHeader: magic + protocol
// version + CRC32) with a HELLO/HELLO_ACK version handshake at connect, so
// corruption, truncation, desync, and mixed-build skew fail fast with a
// structured error naming the peer instead of hanging or deserializing
// garbage.  HEARTBEAT frames from the engine's monitor thread interleave
// with the request/response stream (a per-plane send mutex keeps frames
// atomic; receive paths demultiplex them), giving both sides a liveness
// signal that works even when negotiation is blocked on a dead peer.
class TcpControlPlane : public ControlPlane {
 public:
  // Coordinator: bind+listen on port, accept size-1 workers (identified by a
  // hello frame carrying their rank).  Worker: connect to host:port.
  // ``epoch`` is the membership epoch this plane speaks (0 for the initial
  // membership): stamped into every frame header and enforced at the HELLO
  // handshake, so stragglers from an older membership are rejected instead
  // of admitted.
  // ``bulk_port``: the Python-side bulk data-plane listener this rank
  // pre-bound (0 = none); advertised in HELLO so the coordinator can issue
  // tickets naming the destination's endpoint.
  static std::unique_ptr<TcpControlPlane> MakeCoordinator(int port, int size,
                                                          int64_t epoch,
                                                          std::string* err,
                                                          int bulk_port = 0);
  // ``standby``: pre-bind an ephemeral succession listener before the
  // handshake and advertise its port in HELLO, so this worker can be
  // promoted to coordinator without out-of-band discovery (elastic jobs;
  // docs/fault_tolerance.md "Coordinator failover").
  static std::unique_ptr<TcpControlPlane> MakeWorker(const std::string& host,
                                                     int port, int rank,
                                                     int64_t epoch,
                                                     std::string* err,
                                                     bool standby = false,
                                                     int bulk_port = 0);
  // Bind+listen a TCP socket on `port` (0 = kernel-assigned); on success
  // returns the fd and writes the bound port back through *port.  Shared by
  // rendezvous, the standby pre-bind, and star_bench's port selection.
  static int BindListener(int* port, std::string* err);
  ~TcpControlPlane() override;

  bool Exchange(const RequestList& send, ResponseList* recv) override;
  bool Gather(const RequestList& own, std::vector<RequestList>* all) override;
  bool Broadcast(const ResponseList& out) override;
  bool is_coordinator() const override { return coordinator_; }
  int bound_port() const { return port_; }

  bool HeartbeatTick(double timeout_s) override;
  bool GetFailure(PeerFailureReport* out) const override;
  void AbortPeers(const PeerFailureReport& report) override;

  bool GetReconfig(ReconfigInfo* out) const override;
  void BroadcastReconfig(const ReconfigInfo& info) override;
  int PollJoinRequest() override;
  void SendJoinTicket(const JoinTicket& ticket) override;
  void CloseListener() override;

  bool GetStandby(StandbyInfo* out) const override;
  bool GetCoordState(CoordState* out) const override;
  void SyncCoordState(const CoordState& state) override;

  bool SendShard(const ShardPut& shard) override;
  bool PollShard(ShardPut* out) override;
  void RequeueShard(ShardPut&& shard) override;
  bool PollShardAck(ShardAck* out) override;

  bool RequestTicket(const TicketRequest& req) override;
  bool PollTicket(Ticket* out) override;
  void RequeueTicket(Ticket&& ticket) override;

  long long FramesReceived() const override {
    return frames_rx_.load(std::memory_order_relaxed);
  }
  long long BusyMicros() const override {
    return busy_us_.load(std::memory_order_relaxed);
  }
  // Worker: port of the pre-bound succession listener (0 = none).  The
  // engine surfaces it as the elastic worker's bound_port so Python can
  // re-bind the same endpoint when this rank is promoted.
  int standby_listen_port() const { return standby_listen_port_; }

  // Env-driven wire-level chaos injection (faults.py table;
  // HVD_TPU_FAULT_WIRE_{DROP,CORRUPT,PARTITION,HALFCLOSE} =
  // "<rank>[:<frame>][@<epoch>]", gated on HVD_TPU_RESTART_ATTEMPT ==
  // HVD_TPU_FAULT_ON_ATTEMPT like every other injector).  The named rank
  // misbehaves from its <frame>-th sent frame on, but only while the
  // control plane speaks membership epoch <epoch> (default 0) — so an
  // elastic job that shrank past the fault runs clean at the new epoch
  // instead of re-tripping the same injector forever.
  struct WireFaultSpec {
    enum class Mode { NONE, DROP, CORRUPT, PARTITION, HALFCLOSE };
    Mode mode = Mode::NONE;
    int rank = -1;
    long long frame = 0;
    long long epoch = 0;
  };

 private:
  TcpControlPlane() = default;

  // Frame I/O.  SendTypedFrame is the single choke point for outbound
  // frames (send mutex + CRC + fault injection); RecvDataFrame reads until
  // a frame of type `expect` arrives, consuming HEARTBEATs (liveness) and
  // ABORTs (failure) along the way.  Both record structured failures.
  bool SendTypedFrame(int fd, FrameType type, const std::string& payload,
                      int peer_rank);
  bool RecvDataFrame(int fd, int peer_rank, FrameType expect,
                     std::string* payload);
  // Shard-frame demux shared by the worker's RecvDataFrame and the
  // coordinator's Gather: decode a SHARD_PUT/SHARD_ACK body, relay or
  // enqueue it, and generate the coordinator-side SHARD_ACK.  Returns
  // false on an undecodable body (recorded as frame_corrupt).
  bool HandleShardFrame(FrameType t, const std::string& body, int from_rank);
  // Ticket demux: TICKET_REQ at the coordinator (issue + answer requester),
  // TICKET at a worker (enqueue into ticket_inbox_).  Returns false on an
  // undecodable body (recorded as frame_corrupt).
  bool HandleTicketFrame(FrameType t, const std::string& body, int from_rank);
  // Coordinator: mint a Ticket for `req` (dst endpoint from the HELLO
  // advertisements, token from BulkToken) and deliver it to the requester —
  // over the wire for a worker, straight into ticket_inbox_ for itself.
  void IssueTicket(const TicketRequest& req);
  void RecordFailure(int peer_rank, const char* cause, std::string detail);
  void RecordAbort(const PeerFailureReport& report);
  void RecordReconfig(const ReconfigInfo& info);
  void NoteRx(int peer_rank);
  double SecondsSinceRx(int peer_rank) const;
  bool PartitionActive() const;
  int PeerIndex(int peer_rank) const {
    return coordinator_ ? peer_rank - 1 : 0;
  }

  bool coordinator_ = false;
  int rank_ = 0;
  int size_ = 1;
  int port_ = 0;
  int listen_fd_ = -1;
  int sock_ = -1;                    // worker → coordinator
  std::vector<int> worker_fds_;      // coordinator: index = rank-1

  // One frame on the wire at a time: the monitor thread's heartbeats and
  // the cycle thread's request/response traffic share each socket.
  std::mutex send_mu_;
  // Liveness + failure state (monitor thread vs cycle thread).
  mutable std::mutex state_mu_;
  std::vector<std::chrono::steady_clock::time_point> last_rx_;  // peer index
  PeerFailureReport failure_;
  std::atomic<bool> failed_{false};
  // Elastic state (guarded by state_mu_): a received RECONFIG verdict, and
  // a parked JOIN connection awaiting its ticket (coordinator only).
  ReconfigInfo reconfig_;
  std::atomic<bool> reconfigured_{false};
  int join_fd_ = -1;
  int join_id_ = -1;
  uint16_t epoch_ = 0;  // membership epoch stamped into frame flags

  // Coordinator failover state (guarded by state_mu_ unless noted).
  // Worker: succession listener pre-bound before HELLO (standby mode).
  int standby_listen_fd_ = -1;
  int standby_listen_port_ = 0;
  // Both sides: the announced standby (coordinator: its own selection;
  // worker: from the STANDBY broadcast).
  StandbyInfo standby_;
  bool has_standby_ = false;
  // Standby worker: last replicated coordinator state (STATE frames).
  CoordState coord_state_;
  bool has_coord_state_ = false;
  // Peer-replication inboxes (guarded by state_mu_): shards peers pushed
  // to this rank's host memory, and control-plane acks for shards this
  // rank pushed.  Bounded: the oldest entry is dropped past the cap so a
  // reader that stopped polling cannot balloon the host heap.
  std::deque<ShardPut> shard_inbox_;
  std::deque<ShardAck> shard_acks_;
  // Bulk data plane (guarded by state_mu_).  Coordinator: per-rank bulk
  // listener endpoints learned at HELLO (index = rank, [0] = its own) and
  // the monotonically increasing transfer-id mint.  Both sides: tickets
  // issued to THIS rank, awaiting a PollTicket.
  std::vector<std::string> peer_hosts_;   // coordinator: index = rank
  std::vector<int32_t> bulk_ports_;       // coordinator: index = rank
  std::deque<Ticket> ticket_inbox_;
  int own_bulk_port_ = 0;
  std::atomic<long long> next_transfer_id_{1};

  uint8_t wire_version_ = kWireVersion;  // HVD_TPU_WIRE_VERSION override
  WireFaultSpec fault_;
  std::atomic<long long> frames_sent_{0};
  std::atomic<long long> frames_rx_{0};  // completed inbound frames
  std::atomic<long long> busy_us_{0};    // Gather/Broadcast work, waits excluded
  std::atomic<bool> corrupt_fired_{false};
  std::atomic<bool> halfclosed_{false};
};

// Capacity-bounded LRU cache of negotiated responses — the rebuild of the
// response cache Horovod grew in 0.16, one minor version past our 0.15.1
// snapshot (docs/response_cache.md).  Once a collective's signature
// (op, name, dtype, shape, root, wire — the PR-2 schedule-verifier tuple)
// has been coordinated once, workers re-announce it as a bit position in
// RequestList.cache_hits instead of full Request metadata, and the
// coordinator intersects bit vectors to emit the cached Response without
// re-validating.
//
// Coherence model: every rank (coordinator included) holds a replica, and
// ALL replica mutations are driven by the broadcast ResponseList applied in
// list order — store_bit inserts, cache_invalidate erases, cache_clear —
// so replicas never diverge.  Slot assignment (free slot / LRU victim) is
// decided by the coordinator alone; worker LRU order is never consulted.
// The signature is the one per-rank-local field: each rank checks its OWN
// current request against its OWN previous one, and the coordinator's bit
// intersection lifts that to the cross-rank guarantee (every rank unchanged
// → the original negotiated verdict, ragged allgather dim-0 sizes included,
// is still valid).
//
// Thread-safety: none built in — the engine guards every access with its
// own mutex (client enqueue lookups, cycle drain, dispatch) and the
// coordinator only touches it from the engine's background thread.
class ResponseCache {
 public:
  struct Stats {
    uint64_t hits = 0;
    uint64_t misses = 0;
    uint64_t evictions = 0;
    uint64_t bypassed_ticks = 0;  // cycles announced entirely via bits
  };

  void SetCapacity(size_t capacity);
  bool enabled() const { return capacity_ > 0; }
  size_t capacity() const { return capacity_; }
  size_t size() const { return by_name_.size(); }

  // FNV-1a over (op, name, dtype, shape, root_rank, wire) — the cache key.
  static uint64_t Signature(const Request& req);

  enum class Lookup : int8_t { MISS = 0, HIT = 1, STALE = 2 };
  // HIT fills *bit.  STALE: the name is cached but the signature changed —
  // the caller must request coordinated invalidation and fall back to full
  // negotiation.
  Lookup Find(const Request& req, int32_t* bit) const;

  // Replica maintenance (identical on every rank, broadcast-driven).
  // Store evicts `bit`'s previous occupant if it held a different name.
  void Store(int32_t bit, const std::string& name, const Response& resp,
             uint64_t signature);
  void Erase(const std::string& name);
  void Clear();

  bool Has(int32_t bit) const;
  const Response& At(int32_t bit) const;        // requires Has(bit)
  const std::string& NameAt(int32_t bit) const;  // requires Has(bit)
  int32_t BitOf(const std::string& name) const;  // -1 when absent

  // Coordinator-only (authoritative) side: LRU bump on each cache-hit
  // emission, and slot choice for a freshly negotiated entry — the name's
  // existing bit, else a free slot, else the least-recently-used victim not
  // in `pinned` (bits with in-flight announcements must survive until their
  // response is emitted).  Returns -1 when every slot is pinned.
  void Touch(int32_t bit);
  int32_t AssignSlot(const std::string& name, const std::set<int32_t>& pinned);

  // Failover replication (docs/fault_tolerance.md "Coordinator failover"):
  // snapshot / restore of the coordinator-only LRU recency order (front =
  // most recently used).  SetLruOrder keeps only bits currently occupied and
  // leaves unmentioned occupied bits at the back in their existing order.
  std::vector<int32_t> LruOrder() const;
  void SetLruOrder(const std::vector<int32_t>& order);

  Stats stats;

 private:
  struct Entry {
    bool used = false;
    std::string name;
    uint64_t signature = 0;
    Response response;
    std::list<int32_t>::iterator lru_it;
  };
  void EvictSlot(int32_t bit);  // erase slot `bit`'s occupant, count it

  size_t capacity_ = 0;
  std::vector<Entry> slots_;
  std::unordered_map<std::string, int32_t> by_name_;
  std::vector<int32_t> free_;  // never-used slots, lowest position on top
  std::list<int32_t> lru_;     // front = most recently used
};

// Per-tensor negotiation record (reference message table,
// operations.cc:282-307).
struct TensorRecord {
  Request first;                       // metadata from the first announcing rank
  std::vector<bool> ready;             // which ranks announced
  int ready_count = 0;
  std::string error;                   // non-empty → coordinated error
  std::vector<int64_t> first_dim_sizes;  // per-rank dim0 (allgather)
  std::chrono::steady_clock::time_point first_seen;
};

// One stalled tensor in a structured stall report (the machine-readable
// form of the reference's log-only CheckForStalledTensors warning) —
// surfaced to Python as hvd.stall_report().
struct StallEntry {
  std::string name;
  std::vector<int> missing_ranks;
  double waited_seconds = 0;
};

// The coordinator's negotiation state machine.  Single-threaded use (from
// the engine's background thread).
class Coordinator {
 public:
  Coordinator(int size, double stall_warning_seconds, bool stall_check);

  // Rank 0's timeline receives negotiation phases (reference hooks at
  // operations.cc:292-304).  Not owned; may be null.
  void SetTimeline(Timeline* t) { timeline_ = t; }

  // Rank 0 shares the engine's cache object: the coordinator reads it to
  // resolve bits and makes the authoritative slot/eviction decisions; the
  // engine's dispatch applies the same broadcast-driven mutations every
  // other rank does.  Not owned; may be null (cache disabled).
  void SetResponseCache(ResponseCache* c) { cache_ = c; }

  // Feed one cycle's gathered requests; returns the ordered responses whose
  // tensors became globally ready this cycle (FIFO by first announcement,
  // matching the reference's in-order response construction).
  ResponseList Tick(const std::vector<RequestList>& gathered);

  // Reference CheckForStalledTensors (operations.cc:1366-1412): returns a
  // human-readable warning (empty if none) listing tensors waiting on
  // missing ranks for longer than the stall window.
  std::string CheckStalled();

  // Structured view of the same condition, rate-limit-free: every tensor
  // currently past the stall window with the ranks it is waiting on.
  std::vector<StallEntry> StalledTensors() const;

  // Seconds the oldest pending tensor has been waiting (0 when none) —
  // drives the stall-abort escalation (engine.cc).
  double OldestPendingSeconds() const;

  // Schedule verifier (HVD_TPU_VERIFY_SCHEDULE; analysis/schedule.py).
  // Tick() ingests each rank's VerifyEntry stream; CheckDivergence()
  // compares the rolling hashes seq-by-seq up to the highest sequence
  // number every rank has reported.  Matching prefixes are pruned; the
  // first mismatch returns one entry per rank naming that rank's
  // collective at the diverging sequence number (sticky: later calls
  // keep returning it).  Empty while schedules agree.
  std::vector<DivergenceEntry> CheckDivergence();

  // Verifier interval position, readable from the monitor thread for
  // standby replication (mutated by CheckDivergence on the cycle thread).
  int64_t verify_checked() const {
    return verify_checked_.load(std::memory_order_relaxed);
  }

  size_t pending() const { return table_.size(); }

 private:
  void Ingest(const Request& req);
  void IngestVerify(int rank, const std::vector<VerifyEntry>& entries);
  Response Finalize(const std::string& name);

  // One cached entry's cross-rank readiness (the bit-vector analog of
  // TensorRecord: which ranks re-announced cache position `bit` so far).
  struct BitRecord {
    std::vector<bool> ready;
    int ready_count = 0;
    std::chrono::steady_clock::time_point first_seen;
  };

  int size_;
  double stall_seconds_;
  bool stall_check_;
  Timeline* timeline_ = nullptr;
  ResponseCache* cache_ = nullptr;
  // Cache bits announced by a strict subset of ranks, awaiting the rest.
  // Ordered map: ready bits are emitted in ascending position order, a
  // deterministic choice every rank's dispatch replays identically.
  std::map<int32_t, BitRecord> pending_bits_;
  std::unordered_map<std::string, TensorRecord> table_;
  std::vector<std::string> fifo_;      // names in first-announcement order
  std::chrono::steady_clock::time_point last_stall_warn_;
  // Verifier state: per-rank checkpoint streams, contiguous from
  // verify_checked_ (lower seqs already matched and were pruned).
  std::vector<std::deque<VerifyEntry>> verify_streams_;
  std::atomic<int64_t> verify_checked_{0};
  std::vector<DivergenceEntry> divergence_;  // sticky once detected
};

}  // namespace hvd
