// Hierarchical coordinator tree (docs/benchmarks.md "Control-plane
// scaling", docs/fault_tolerance.md "Mid-tree aggregator death").
//
// The star control plane (controller.h) pays O(P) at rank 0 for every
// negotiation tick: P REQUEST frames in, P RESPONSE frames out, P
// heartbeat streams to absorb.  Measured past the 5 ms cycle budget
// somewhere above ~512 workers.  This header adds one aggregation tier
// between the workers and rank 0 — the deviceless analog of the
// reference's tree MPI_Gather (reference operations.cc:1742-1850):
//
//     rank 0 (TreeRootPlane + the existing Coordinator, unchanged)
//        ^  one AGG_REQUEST / one RESPONSE / one HEARTBEAT per tick
//     relay aggregators (RunRelay; one primary + one standby per group)
//        ^  fanout REQUESTs / fan-out RESPONSE / absorbed heartbeats
//     workers 1..P-1 (TreeMemberPlane)
//
// Relays are pure infrastructure — NOT collective members.  They combine
// their members' RequestLists associatively (cache bits intersected,
// verifier streams folded when identical, the rest carried as residual),
// so the root's Coordinator::Tick sees byte-equivalent per-rank inputs
// and the negotiated schedule is bit-for-bit the star's.  Below the
// worker-count threshold the star plane is used unchanged.
//
// Fault model: each relay streams {seq, response} deltas to a standby
// (AGG_STATE) after the root's verdict and BEFORE fanning out, so a
// mid-tree aggregator death promotes the standby in place — response-
// stream continuity is load-bearing (every rank's cache replica mutates
// by applying each broadcast exactly once, in order).  Root failover
// (PR-7 STANDBY/STATE) is disabled in tree mode; elastic reconfiguration
// falls back to abort-and-restart re-forming as a star.
#pragma once

#include <atomic>
#include <chrono>
#include <memory>
#include <mutex>
#include <string>
#include <utility>
#include <vector>

#include "controller.h"
#include "message.h"

namespace hvd {

// ---------------------------------------------------------------------------
// Topology: a pure function of (size, fanout, threshold, enable), so every
// rank computes the identical plan from the identical knobs with no
// negotiation (HVD_TPU_TREE_{ENABLE,FANOUT,THRESHOLD}; utils/env.py).
// ---------------------------------------------------------------------------

struct TreePlan {
  bool active = false;  // false = star, bit-for-bit the existing plane
  int size = 1;
  int fanout = 0;       // members per aggregator group
  int num_groups = 0;   // ceil((size - 1) / fanout)
  int depth = 1;        // frame hops from a member to the root (star: 1)
};

// Tree iff enabled, fanout >= 2, and size >= max(threshold, 3).  Workers
// 1..size-1 split into contiguous groups of `fanout`; rank 0 stays the
// negotiating coordinator.
TreePlan PlanTree(int size, int fanout, int threshold, int enable);

// Group of member rank `rank` (rank >= 1): (rank - 1) / fanout.
int TreeGroupOf(int rank, const TreePlan& plan);
// Global ranks of group `g`, ascending.
std::vector<int> TreeMembersOf(int group, const TreePlan& plan);

// Relay identity on the wire: relays HELLO with a negative rank so the
// root can never confuse infrastructure with a collective member (rank -1
// is reserved as "no rank" in failure reports).
constexpr int RelayWireRank(int agg_id) { return -(2 + agg_id); }
constexpr int AggIdFromWireRank(int wire_rank) { return -wire_rank - 2; }

// Launcher-wired aggregator endpoints:
//   HVD_TPU_TREE_AGG_MAP = "0=host:port|host:port,1=host:port,..."
// (primary endpoint first, optional standby after '|'; one entry per
// group).  The map's presence is part of tree activation — every rank
// sees the same env, so star/tree can never disagree across ranks.
struct TreeEndpoint {
  std::string host;
  int port = 0;
};
bool ParseAggMap(const char* spec, int num_groups,
                 std::vector<std::pair<TreeEndpoint, TreeEndpoint>>* out);

// ---------------------------------------------------------------------------
// Associative combining — the reason one relay frame can stand in for
// `fanout` member frames without changing the negotiated schedule.
// ---------------------------------------------------------------------------

// Fold `fanout` member RequestLists into one AggRequestList: cache bits
// announced by EVERY member move to hits_all (the common case — a warm
// steady state is all-bits on all ranks); per-member leftovers ride as
// residual; verifier streams fold to one copy when identical across the
// group.  Lossless: ExpandAggregate reconstructs byte-equivalent inputs.
AggRequestList CombineMemberRequests(int32_t agg_id, int64_t seq,
                                     const std::vector<int>& members,
                                     const std::vector<RequestList>& lists);

// Root-side inverse: scatter one aggregate back into the per-rank slots
// of `all` (sized `plan.size`).  False on a malformed aggregate (member
// set disagreeing with the plan), with a reason in *why.  Consumes
// agg->residual (moved into the slots): this runs P times per root tick,
// so per-member RequestList copies would dominate the tick at fleet
// scale.
bool ExpandAggregate(AggRequestList* agg, const TreePlan& plan,
                     std::vector<RequestList>* all, std::string* why);

// ---------------------------------------------------------------------------
// Rank 0's plane: speaks AGG_REQUEST/RESPONSE with `num_groups` relays
// instead of REQUEST/RESPONSE with P-1 workers.  The engine's Coordinator,
// response cache, verifier, and timeline are untouched above it.
// ---------------------------------------------------------------------------

class TreeRootPlane : public ControlPlane {
 public:
  // Bind + accept `plan.num_groups` relay HELLOs (negative wire ranks)
  // within the rendezvous budget.
  static std::unique_ptr<TreeRootPlane> Make(int port, int size,
                                             int64_t epoch,
                                             const TreePlan& plan,
                                             std::string* err);
  ~TreeRootPlane() override;

  bool Exchange(const RequestList&, ResponseList*) override { return false; }
  // One AGG_REQUEST per relay, expanded into per-rank RequestLists.  A
  // relay EOF is a DETACH, not a failure: the fd is parked and the listen
  // socket polled for the standby's re-HELLO (same agg_id, same epoch);
  // only a detach outlasting HVD_TPU_TREE_DETACH_TIMEOUT_MS aborts the
  // job with cause "aggregator_lost".  A re-attached relay replaying an
  // already-answered seq is resent the last response (promotion catch-up).
  bool Gather(const RequestList& own, std::vector<RequestList>* all) override;
  // Records {seq, serialized response} BEFORE any send, so replay always
  // has the authoritative bytes, then fans out to every attached relay
  // (a send failure detaches the relay, it does not fail the plane).
  bool Broadcast(const ResponseList& out) override;
  bool is_coordinator() const override { return true; }

  bool HeartbeatTick(double timeout_s) override;
  bool GetFailure(PeerFailureReport* out) const override;
  void AbortPeers(const PeerFailureReport& report) override;
  void BroadcastReconfig(const ReconfigInfo& info) override;
  void CloseListener() override;

  long long FramesReceived() const override {
    return frames_rx_.load(std::memory_order_relaxed);
  }
  long long BusyMicros() const override {
    return busy_us_.load(std::memory_order_relaxed);
  }
  // Fleet-simulator split: negotiation traffic vs absorbed liveness.  The
  // heartbeat fan-in contract (docs/benchmarks.md) pins the latter at
  // O(num_groups) per interval, not O(P).
  long long AggFramesReceived() const {
    return agg_frames_rx_.load(std::memory_order_relaxed);
  }
  long long HeartbeatFramesReceived() const {
    return hb_frames_rx_.load(std::memory_order_relaxed);
  }
  int bound_port() const { return port_; }

 private:
  TreeRootPlane() = default;
  struct Reader;
  // Accept + HELLO-validate one pending connection on the listener; a
  // valid relay re-HELLO replaces (and closes) the group's parked fd.
  void PollRelayHello();
  void Detach(int agg_id);
  void RecordFailure(int peer_rank, const char* cause, std::string detail);
  void RecordAbort(const PeerFailureReport& report);
  bool SendToRelay(int agg_id, FrameType type, const std::string& payload);

  TreePlan plan_;
  int size_ = 1;
  int port_ = 0;
  int listen_fd_ = -1;
  uint16_t epoch_ = 0;
  uint8_t wire_version_ = kWireVersion;
  long long detach_timeout_ms_ = 10000;

  mutable std::mutex state_mu_;
  std::mutex send_mu_;
  std::vector<int> relay_fds_;  // index = agg_id; -1 = detached
  std::vector<std::chrono::steady_clock::time_point> detached_since_;
  std::vector<bool> detached_;
  std::vector<std::chrono::steady_clock::time_point> last_rx_;
  std::vector<std::unique_ptr<Reader>> readers_;
  // Detached fds are shutdown() and parked here, closed only at
  // destruction: the monitor thread may be mid-send on one, and closing
  // would race an fd-number reuse.
  std::vector<int> dead_fds_;

  // Replay state (lockstep: ONE global {seq, response} suffices — no relay
  // can be more than one round behind the last broadcast).
  int64_t last_seq_ = 0;
  std::string last_response_;

  PeerFailureReport failure_;
  std::atomic<bool> failed_{false};
  std::atomic<long long> frames_rx_{0};
  std::atomic<long long> agg_frames_rx_{0};
  std::atomic<long long> hb_frames_rx_{0};
  std::atomic<long long> busy_us_{0};
};

// ---------------------------------------------------------------------------
// A worker's plane in tree mode: the star worker's Exchange, pointed at
// the group's relay, with a seq prefix and endpoint-alternating reattach.
// ---------------------------------------------------------------------------

class TreeMemberPlane : public ControlPlane {
 public:
  // Connects to the PRIMARY endpoint within the rendezvous budget (the
  // standby parks pre-promotion knocks, so initial attach must not
  // alternate).  `exchange_timeout_ms`: response wait before this member
  // closes the socket and re-attaches, alternating primary/standby.
  static std::unique_ptr<TreeMemberPlane> Make(const TreeEndpoint& primary,
                                               const TreeEndpoint& standby,
                                               int rank, int64_t epoch,
                                               long long exchange_timeout_ms,
                                               std::string* err);
  ~TreeMemberPlane() override;

  // Sends [i64 seq][RequestList] and awaits the matching RESPONSE.  On
  // timeout/EOF: reattach (alternating endpoints, backoff) and resend the
  // SAME seq — the relay replays its stored response if it already
  // answered, so the response stream never skips or duplicates.  The
  // reattach budget exhausting records cause "aggregator_lost".
  bool Exchange(const RequestList& send, ResponseList* recv) override;
  bool Gather(const RequestList&, std::vector<RequestList>*) override {
    return false;
  }
  bool Broadcast(const ResponseList&) override { return false; }
  bool is_coordinator() const override { return false; }

  // Soft liveness: sends a HEARTBEAT to the relay; prolonged silence
  // shuts the socket down to wake a blocked Exchange into its reattach
  // loop instead of declaring a job failure (the standby may be mid-
  // promotion).  Returns true only once a real failure was recorded.
  bool HeartbeatTick(double timeout_s) override;
  bool GetFailure(PeerFailureReport* out) const override;
  void AbortPeers(const PeerFailureReport& report) override;
  bool GetReconfig(ReconfigInfo* out) const override;

  long long FramesReceived() const override {
    return frames_rx_.load(std::memory_order_relaxed);
  }
  long long BusyMicros() const override {
    return busy_us_.load(std::memory_order_relaxed);
  }

 private:
  TreeMemberPlane() = default;
  struct Reader;
  // One attach attempt (connect + HELLO + HELLO_ACK) to `ep`.
  bool AttachOnce(const TreeEndpoint& ep, std::string* why);
  void CloseSock();
  void RecordFailure(int peer_rank, const char* cause, std::string detail);
  void RecordAbort(const PeerFailureReport& report);

  int rank_ = 0;
  TreeEndpoint primary_, standby_;
  uint16_t epoch_ = 0;
  uint8_t wire_version_ = kWireVersion;
  long long exchange_timeout_ms_ = 10000;
  long long reattach_budget_ms_ = 30000;
  int64_t last_seq_ = 0;

  mutable std::mutex state_mu_;
  std::mutex send_mu_;
  int sock_ = -1;
  bool on_standby_ = false;  // which endpoint sock_ points at
  std::vector<int> dead_fds_;  // shutdown() sockets, closed at destruction
  std::unique_ptr<Reader> reader_;
  std::chrono::steady_clock::time_point last_rx_;

  PeerFailureReport failure_;
  std::atomic<bool> failed_{false};
  ReconfigInfo reconfig_;
  std::atomic<bool> reconfigured_{false};
  std::atomic<long long> frames_rx_{0};
  std::atomic<long long> busy_us_{0};
};

// ---------------------------------------------------------------------------
// The relay aggregator process (python -m horovod_tpu.relay sidecar, or a
// fleet-simulator fork).  Blocking; single-threaded; exits 0 on clean
// shutdown, 1 on a failure it escalated (ABORT forwarded up AND down).
// ---------------------------------------------------------------------------

struct RelayOptions {
  int agg_id = 0;
  std::string parent_host = "127.0.0.1";  // the root's listener
  int parent_port = 0;
  int listen_port = 0;      // this relay's member-facing listener
  int size = 0;             // job size — replayed into PlanTree
  int fanout = 0;
  int threshold = 0;
  int64_t epoch = 0;
  bool standby = false;     // start parked, promote on EOF / knock+silence
  std::string peer_host;    // primary: the standby's endpoint (state stream)
  int peer_port = 0;
  long long member_timeout_ms = 30000;  // partial-round stall -> member_lost
  long long heartbeat_ms = 250;
  // Optional: append one JSON stats line ({agg_id, busy_us, rounds}) to
  // this path at exit.  The fleet simulator (fleet_sim.cc) composes the
  // relay tier's busy time into its modeled critical-path tick — on a
  // single host, per-process busy time is the honest signal; wall clock
  // would measure the scheduler.
  std::string stats_path;
};

int RunRelay(const RelayOptions& opt);

}  // namespace hvd
