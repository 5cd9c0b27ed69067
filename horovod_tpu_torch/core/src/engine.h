// The background coordination engine.
//
// Rebuild of the reference's per-process runtime (reference
// horovod/common/operations.cc: HorovodGlobalState :112-247,
// BackgroundThreadLoop :1435-1663, RunLoopOnce :1694-1903,
// EnqueueTensor* :2025-2141) with the execution half inverted: the reference
// background thread performs MPI/NCCL collectives itself; here it only
// *negotiates and schedules* — fused, ordered ExecBatches are handed to the
// embedding runtime (Python/JAX) through a polling queue, the collective
// itself is an XLA program on the TPU, and completion flows back via
// BatchDone.  This keeps the dynamic/eager path's cross-host ordering
// guarantees (SURVEY §7 hard-part (a)) native while the data plane stays
// compiled.
#pragma once

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <deque>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <unordered_map>
#include <unordered_set>
#include <vector>

#include "common.h"
#include "controller.h"
#include "message.h"
#include "timeline.h"

namespace hvd {

// One fused unit of work for the executor (the analog of a fused
// MPIResponse reaching PerformOperation, reference operations.cc:714).
struct ExecBatch {
  int64_t id = 0;
  Response::Type type = Response::Type::ALLREDUCE;
  DataType dtype = DataType::FLOAT32;
  int32_t root_rank = -1;
  WireFormat wire = WireFormat::NATIVE;
  // Parallel arrays: tensor names and their client handles.
  std::vector<std::string> names;
  std::vector<int64_t> handles;
  std::vector<TensorShape> shapes;
  std::vector<int64_t> first_dim_sizes;  // allgather: per-rank dim0 (fused: per tensor × rank)
};

struct EngineOptions {
  int rank = 0;
  int size = 1;
  double cycle_time_ms = 5.0;
  int64_t fusion_threshold_bytes = 64 * 1024 * 1024;
  double stall_warning_seconds = 60.0;
  bool stall_check = true;
  // Stall escalation (warn -> abort): when > 0 and a tensor has been
  // pending longer than this, the coordinator aborts the PROCESS with
  // stall_abort_exit_code — a distinct, restartable exit the launcher's
  // supervision recognizes, instead of a silent deadlock
  // (HVD_TPU_STALL_ABORT_SECONDS; docs/fault_tolerance.md).
  double stall_abort_seconds = 0;
  int stall_abort_exit_code = 75;  // EX_TEMPFAIL: transient, retry me
  // Response cache (HOROVOD_CACHE_CAPACITY; docs/response_cache.md): max
  // cached negotiated responses, 0 disables.  With the cache on, a stable
  // per-step schedule stops paying negotiation metadata after the first
  // step, and a cache-hit enqueue wakes the cycle immediately instead of
  // waiting out the cycle_time_ms tail.  Default mirrors upstream 0.16.
  int64_t cache_capacity = 1024;
  // Schedule verifier (HVD_TPU_VERIFY_SCHEDULE, analysis/schedule.py):
  // when on, the coordinator cross-checks per-rank rolling schedule
  // hashes every verify_interval_ticks cycles and fails every pending
  // collective with a structured divergence report on the first
  // mismatch — instead of the job stalling until the stall timeout.
  bool verify_schedule = false;
  int verify_interval_ticks = 10;
  // Control-plane heartbeats (HVD_TPU_HEARTBEAT_MS; docs/fault_tolerance.md
  // "Fast failure detection").  A monitor thread sends a liveness frame to
  // every peer each interval and maps socket EOF / ECONNRESET / heartbeat
  // silence to a structured PeerFailureReport + coordinated abort, so a
  // SIGKILLed or partitioned rank is detected in ~the interval instead of
  // the 60 s stall window.  0 disables (multi-process TCP jobs only; the
  // loopback plane has no peers).
  double heartbeat_ms = 250.0;
  double heartbeat_timeout_ms = 10000.0;  // silence = death past this
  // After a peer failure is handled (collectives failed, report published,
  // ABORT broadcast) the process exits with stall_abort_exit_code once this
  // grace elapses — time for Python to observe hvd.failure_report() — so
  // the PR-1 supervisor restarts the job even if the script is wedged.
  // < 0: report only, never exit (debugging).
  double abort_grace_ms = 1000.0;
  // In-place elastic recovery (HVD_TPU_ELASTIC=1, docs/fault_tolerance.md
  // "In-place recovery"): when a NON-coordinator rank dies and at least
  // min_size ranks survive, the coordinator broadcasts a RECONFIG verdict
  // instead of ABORT and every survivor publishes a resize event (failing
  // in-flight collectives, flushing the response cache) rather than
  // exiting — the Python layer re-forms the engine under the new
  // membership in the same process.  Coordinator death, or a shrink below
  // min_size, falls back to the legacy abort-and-restart path.  The whole
  // reconfiguration is bounded: a survivor whose Python never acknowledges
  // the resize within reconfig_timeout_ms exits restartably (75), keeping
  // the PR-4 nothing-blocks-forever guarantee.
  bool elastic = false;
  int min_size = 1;
  double reconfig_timeout_ms = 30000.0;
  int64_t epoch = 0;              // membership epoch this engine speaks
  std::string timeline_path;      // empty = disabled
  std::string coordinator_host;   // workers (rank>0)
  int coordinator_port = 0;       // 0 = pick ephemeral (coordinator)
  // Bulk data-plane listener this rank's Python side pre-bound (0 = no
  // data plane): advertised in HELLO so the coordinator can issue
  // rank-to-rank transfer tickets naming this endpoint.
  int bulk_listen_port = 0;
  // Hierarchical coordinator tree (tree.h; HVD_TPU_TREE_{ENABLE,FANOUT,
  // THRESHOLD}, docs/benchmarks.md "Control-plane scaling").  The tree
  // activates only when PlanTree says so AND HVD_TPU_TREE_AGG_MAP names an
  // aggregator endpoint per group — all pure functions of the environment,
  // so every rank picks the same topology with no negotiation.  Below the
  // threshold the star plane is used bit-for-bit unchanged.
  int tree_enable = 0;
  int tree_fanout = 0;
  int tree_threshold = 0;
  long long tree_exchange_timeout_ms = 10000;
};

class Engine {
 public:
  explicit Engine(EngineOptions opts);
  ~Engine();

  // Bring up the control plane and start the background thread.  Returns
  // error status on transport failure; fills bound_port for coordinators.
  Status Start(int* bound_port);
  void Shutdown();

  // Thread-safe enqueue (reference EnqueueTensorAllreduce/...,
  // operations.cc:2025-2141).  Returns a handle (>=0) or -1 with *status set
  // (duplicate name, shut down).
  int64_t Enqueue(const std::string& name, OpType op, DataType dtype,
                  const TensorShape& shape, int32_t root_rank,
                  WireFormat wire, Status* status);

  // Executor API.  Blocks up to timeout_ms for the next fused batch.
  // Returns: 1 = batch filled, 0 = timeout, -1 = shutdown (queue drained).
  int NextBatch(ExecBatch* out, double timeout_ms);
  // Return an un-executed batch to the front of the queue (e.g. the
  // serialization buffer was too small and the caller will retry bigger).
  void RequeueBatch(ExecBatch batch);
  void BatchDone(int64_t batch_id, const Status& status);
  // Switch the timeline activity phase for every tensor in an executing
  // batch (reference in-activity phases, operations.h:29-46 /
  // operations.cc:698-710: QUEUE, MEMCPY_IN_FUSION_BUFFER, <collective>,
  // MEMCPY_OUT_FUSION_BUFFER).  No-op when the timeline is disabled.
  void BatchActivity(int64_t batch_id, const std::string& activity);
  // Instant marker on an arbitrary timeline row — trace-time decisions
  // made outside the dispatch loop (the OVERLAP_PLAN schedule-planner
  // instants from ops/schedule_plan.py) land next to the CACHE_HIT/
  // NEGOTIATED markers.  No-op when the timeline is disabled.
  void TimelineInstant(const std::string& row, const std::string& label);

  // Structured stall report: the tensors the coordinator is warning
  // about (empty on workers and when nothing is stalled).  Thread-safe
  // snapshot of the last cycle's view — hvd.stall_report() in Python.
  std::vector<StallEntry> StallReport();

  // Response-cache counters for this rank (hvd.cache_stats() in Python):
  // hits/misses/evictions/bypassed ticks plus current entry count and the
  // configured capacity.  Thread-safe; all zeros when the cache is off.
  struct CacheStatsView {
    ResponseCache::Stats stats;
    uint64_t entries = 0;
    uint64_t capacity = 0;
  };
  CacheStatsView CacheStats();

  // Control-plane observability (hvd.control_plane_stats() in Python;
  // docs/benchmarks.md "Control-plane scaling").  Negotiated-tick latency
  // percentiles over a rolling window of completed cycles, inbound frame
  // totals from the plane (heartbeats included), and this rank's topology
  // role, so a 4096-rank operator can see where a slow tick's time goes
  // without attaching a profiler to rank 0.
  struct ControlPlaneStatsView {
    // 0 = loopback, 1 = star coordinator, 2 = star worker,
    // 3 = tree root, 4 = tree member.
    int role = 0;
    int depth = 1;    // frame hops member -> root (star: 1, tree: 2)
    int fanout = 0;   // 0 when the star plane is active
    double tick_p50_ms = 0;
    double tick_p99_ms = 0;
    double frames_per_tick = 0;  // cumulative frames_rx / completed ticks
    long long ticks = 0;         // completed negotiation cycles
    long long frames_rx = 0;     // completed inbound frames since Start
  };
  ControlPlaneStatsView ControlPlaneStats();

  // Schedule verifier intake: the Python layer reports each collective
  // submission's (seq, rolling hash, description); forwarded to the
  // coordinator with the next cycle's RequestList.  No-op when
  // verify_schedule is off.
  void SubmitVerify(int64_t seq, uint64_t hash, const std::string& desc);

  // Structured divergence report (every rank once a divergence response
  // arrived): each rank's first mismatched collective.  Empty while the
  // schedule is consistent — hvd.divergence_report() in Python.
  std::vector<DivergenceEntry> DivergenceReport();

  // Structured peer-failure report (hvd.failure_report() in Python, the
  // stall_report()/divergence_report() analog): who died, how the death
  // was observed (EOF vs heartbeat timeout vs frame corruption), and a
  // collective that was pending at detection.  failed_rank == -1 while no
  // peer failure has been detected.
  PeerFailureReport FailureReport();

  // Elastic resize event (hvd.resize_event() in Python): present after a
  // membership reconfiguration verdict reached this rank — the engine is
  // stopped, in-flight collectives were failed with a MembershipChanged
  // error, and the Python layer must AckResize() and re-form a new engine
  // at {epoch, new_rank, new_size}.  An un-acked resize exits restartably
  // after reconfig_timeout_ms (fallback to the full-restart path).
  struct ResizeEventView {
    bool present = false;
    int64_t epoch = 0;
    int32_t old_rank = -1;
    int32_t new_rank = -1;
    int32_t old_size = 0;
    int32_t new_size = 0;
    int32_t failed_rank = -1;  // -1 for a grow (join)
    std::string cause;
    // Coordinator failover: where the NEW membership's coordinator listens
    // (empty host = the coordinator did not move).  Survivors re-form
    // against this endpoint; the promoted standby re-binds new_coord_port.
    std::string new_coord_host;
    int32_t new_coord_port = 0;
  };
  ResizeEventView ResizeEvent();
  void AckResize();
  // Failover observability (hvd.coord_state() in Python): the last
  // coordinator-state delta this rank has seen — the coordinator's own
  // emission on rank 0, the replicated copy on the standby, absent
  // elsewhere.  Lets tests assert replication reached the standby before
  // the coordinator was killed.
  struct CoordStateView {
    bool present = false;
    CoordState state;
  };
  CoordStateView CoordStateReport();
  // Reconfiguration hand-off (coordinator): free the listen port for the
  // re-formed membership while keeping old peer sockets open — see
  // ControlPlane::CloseListener.
  void DetachListener();

  // Async peer-replicated checkpointing (docs/fault_tolerance.md "Async &
  // peer-replicated checkpointing"): push one opaque checkpoint shard
  // toward target_rank's host memory over the control plane (relayed
  // through the coordinator in the star topology), poll shards peers
  // pushed to this rank, and poll the control-plane acks for shards this
  // rank pushed.  All non-blocking and thread-safe (the control plane's
  // own locks); false on single-process (loopback) jobs, which have no
  // peers to replicate to.
  bool ShardPutSend(int32_t target_rank, int64_t step,
                    const std::string& payload);
  bool ShardPoll(ShardPut* out);
  void ShardRequeue(ShardPut&& shard);  // undo a poll (buffer too small)
  bool ShardAckPoll(ShardAck* out);

  // Bulk data plane (docs/fault_tolerance.md "Bulk data plane"): ask the
  // coordinator to authorize a direct rank-to-rank stream to dst_rank, and
  // poll the answering Ticket (the dst endpoint + transfer token).  Both
  // non-blocking; false on loopback jobs.
  bool TicketRequestSend(int32_t dst_rank, int64_t step, int64_t nbytes,
                         const std::string& manifest);
  bool TicketPoll(Ticket* out);
  void TicketRequeue(Ticket&& ticket);  // undo a poll (buffer too small)

  // Handle table (reference torch/handle_manager.{h,cc}).
  bool PollHandle(int64_t handle);                 // true = done
  // Block until the handle completes (condvar wait, not a poll loop).
  // Returns false on timeout.
  bool WaitHandle(int64_t handle, double timeout_ms);
  Status ReleaseHandle(int64_t handle);            // returns final status
  Status PeekHandle(int64_t handle);

  int rank() const { return opts_.rank; }
  int size() const { return opts_.size; }

 private:
  void Loop();
  void RunCycle();
  // Heartbeat monitor (docs/fault_tolerance.md): periodically pings peers
  // through the control plane and triggers HandlePeerFailure the moment
  // one is declared dead — independent of the cycle thread, so detection
  // works even while negotiation is blocked on the dead peer.
  void MonitorLoop();
  // A transport call failed mid-cycle: route the control plane's recorded
  // failure (if any) through HandlePeerFailure, else fall back to the
  // generic abort with `what`.
  void HandleTransportFailure(const char* what);
  // Idempotent peer-failure endgame: publish the report, broadcast ABORT
  // (coordinator), fail every pending collective with a CollectiveError
  // naming the failed rank, emit timeline instants, and — after
  // abort_grace_ms — exit the process with the restartable code.  Under
  // HVD_TPU_ELASTIC the coordinator reroutes a survivable non-coordinator
  // death to ReconfigEndgame (shrink in place) instead.
  void HandlePeerFailure(PeerFailureReport report);
  // The legacy post-CAS abort body (report published, ABORT broadcast,
  // collectives failed, grace exit) — shared by HandlePeerFailure and the
  // expelled-rank RECONFIG path.
  void AbortEndgame(PeerFailureReport report);
  // A RECONFIG verdict reached this rank (worker transport demux, or the
  // coordinator's own elastic decision): CAS-guarded entry point.
  void HandleReconfig(const ReconfigInfo& info);
  // Post-CAS reconfiguration body: publish the resize event, flush the
  // response cache (the PR-3 cache_clear semantics), fail in-flight
  // collectives with a MembershipChanged error, stop the engine, and wait
  // (bounded by reconfig_timeout_ms) for Python's AckResize — expiry falls
  // back to the restartable exit.
  void ReconfigEndgame(const ReconfigInfo& info);
  void AwaitResizeAckOrDie();
  // Coordinator + elastic: admit a pending JOIN request by triggering a
  // grow reconfiguration.  Returns true when a reconfiguration fired.
  bool MaybeHandleJoin();
  void DispatchResponses(const ResponseList& responses);
  void HandleDivergence(const std::vector<DivergenceEntry>& entries);
  // Coordinated-shutdown teardown: abort tensors still negotiating, but let
  // batches that every rank already dispatched drain through the executor.
  void FailUnscheduled(const Status& status);
  void FailAllPending(const Status& status);
  void MarkDone(int64_t handle, const Status& status);

  EngineOptions opts_;
  Timeline timeline_;
  std::unique_ptr<ControlPlane> control_;
  std::unique_ptr<Coordinator> coordinator_;  // rank 0 only

  std::mutex mu_;
  std::condition_variable exec_cv_;
  std::condition_variable done_cv_;
  // Wakes Loop() out of its between-cycle wait: signalled by a cache-hit
  // enqueue (run the fast path NOW instead of sleeping out the tick) and by
  // Shutdown() (don't make teardown wait out a cycle tail).
  std::condition_variable cycle_cv_;
  bool cycle_wake_ = false;  // guarded by mu_; cleared when a cycle drains
  std::deque<ExecBatch> exec_queue_;
  std::deque<std::pair<int64_t, Request>> pending_enqueues_;
  // Response-cache replica (guarded by mu_; docs/response_cache.md).  On
  // rank 0 the coordinator shares this object for its authoritative slot
  // and eviction decisions.
  ResponseCache cache_;
  // Requests this rank announced as cache bits, awaiting their response —
  // replayed as full requests if a coordinated invalidation lands first.
  std::unordered_map<std::string, Request> bit_announced_;  // guarded by mu_
  // Locally announced, not yet completed: name -> (handle, request).
  std::unordered_map<std::string, std::pair<int64_t, Request>> inflight_;
  // Batches handed to the executor, awaiting BatchDone.
  std::unordered_map<int64_t, ExecBatch> executing_;
  struct HandleState {
    bool done = false;
    Status status;
  };
  std::unordered_map<int64_t, HandleState> handles_;
  std::vector<StallEntry> last_stall_;  // guarded by mu_
  // Rolling negotiated-tick durations (µs) for control_plane_stats();
  // guarded by mu_.  512 cycles ≈ 2.5 s of history at the default tick.
  std::vector<long long> tick_ring_;
  size_t tick_ring_pos_ = 0;
  long long tick_count_ = 0;
  int cp_role_ = 0;     // ControlPlaneStatsView role code
  int cp_depth_ = 1;    // topology depth for stats
  int cp_fanout_ = 0;   // topology fanout for stats
  std::vector<VerifyEntry> pending_verify_;      // guarded by mu_
  std::vector<DivergenceEntry> divergence_;      // guarded by mu_
  PeerFailureReport failure_;                    // guarded by mu_
  // The status of the abort that stopped the engine; OK until one does.
  Status abort_status_;                          // guarded by mu_
  ResizeEventView resize_;                       // guarded by mu_
  std::atomic<bool> resize_acked_{false};
  // Cycle counter driving the verifier interval.  Atomic because the
  // monitor thread reads it for standby state replication while the cycle
  // thread increments it.
  std::atomic<int64_t> verify_tick_{0};
  int64_t next_handle_ = 0;
  int64_t next_batch_id_ = 0;

  // Grow reconfigurations admitted by this coordinator — replicated to the
  // standby as part of CoordState (monitor thread reads, monitor thread
  // writes; atomic for the hvd_coord_state test export).
  std::atomic<int64_t> joins_admitted_{0};

  std::atomic<bool> shutdown_requested_{false};
  // Set once this rank's first tick has completed (MonitorLoop).
  std::atomic<bool> first_tick_done_{false};
  std::atomic<bool> stopped_{false};
  // First thread (cycle or monitor) to observe a peer failure wins;
  // HandlePeerFailure is a no-op for the loser.
  std::atomic<bool> failure_handled_{false};
  std::thread thread_;
  // Wakes MonitorLoop out of its heartbeat-interval wait on shutdown.
  std::condition_variable monitor_cv_;
  std::thread monitor_thread_;
};

}  // namespace hvd
