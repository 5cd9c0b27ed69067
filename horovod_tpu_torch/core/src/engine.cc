#include "engine.h"

#include <algorithm>
#include <chrono>
#include <cstdio>
#include <cstdlib>
#include <sstream>

#include "tree.h"
#include "wire.h"

namespace hvd {

namespace {

// Condition-variable waits go through wait_until against system_clock, NOT
// wait_for: wait_for waits against steady_clock, which libstdc++ lowers to
// pthread_cond_clockwait — a call gcc-10's libtsan does not intercept, so
// the TSAN gate (make check) would miss the unlock inside every wait and
// report phantom double-locks on mu_.  system_clock waits lower to the
// intercepted pthread_cond_timedwait; the timeouts here are coarse polling
// windows, so wall-clock jumps only stretch/shrink a poll interval.
template <typename Pred>
bool WaitWithTimeout(std::condition_variable& cv,
                     std::unique_lock<std::mutex>& l, double timeout_ms,
                     Pred pred) {
  auto deadline =
      std::chrono::system_clock::now() +
      std::chrono::duration_cast<std::chrono::system_clock::duration>(
          std::chrono::duration<double, std::milli>(timeout_ms));
  return cv.wait_until(l, deadline, pred);
}

}  // namespace

Engine::Engine(EngineOptions opts) : opts_(std::move(opts)) {}

Engine::~Engine() {
  Shutdown();
  if (thread_.joinable()) thread_.join();
  if (monitor_thread_.joinable()) monitor_thread_.join();
}

Status Engine::Start(int* bound_port) {
  if (!opts_.timeline_path.empty() && opts_.rank == 0) {
    timeline_.Initialize(opts_.timeline_path);
  }
  // Hierarchical tree topology: a pure function of the (symmetric) knobs
  // plus the launcher-wired HVD_TPU_TREE_AGG_MAP — every rank computes the
  // identical answer, so star/tree can never disagree across the job.
  TreePlan tree_plan = PlanTree(opts_.size, opts_.tree_fanout,
                                opts_.tree_threshold, opts_.tree_enable);
  std::vector<std::pair<TreeEndpoint, TreeEndpoint>> agg_map;
  if (tree_plan.active) {
    const char* spec = std::getenv("HVD_TPU_TREE_AGG_MAP");
    if (spec == nullptr || *spec == '\0') {
      // Enabled but not wired (no relay sidecars): fall back to the star.
      tree_plan = TreePlan{};
      tree_plan.size = opts_.size;
    } else if (!ParseAggMap(spec, tree_plan.num_groups, &agg_map)) {
      return Status::InvalidArgument(
          "control plane: HVD_TPU_TREE_AGG_MAP is malformed or missing a "
          "group (need one 'g=host:port[|host:port]' entry per aggregator "
          "group; " + std::to_string(tree_plan.num_groups) + " groups)");
    }
  }
  cp_depth_ = tree_plan.depth;
  cp_fanout_ = tree_plan.active ? tree_plan.fanout : 0;
  if (opts_.size <= 1) {
    control_ = std::make_unique<LoopbackControlPlane>();
    cp_role_ = 0;
  } else if (tree_plan.active && opts_.rank == 0) {
    std::string err;
    auto cp = TreeRootPlane::Make(opts_.coordinator_port, opts_.size,
                                  opts_.epoch, tree_plan, &err);
    if (!cp) return Status::Unknown("control plane: " + err);
    if (bound_port != nullptr) *bound_port = cp->bound_port();
    control_ = std::move(cp);
    cp_role_ = 3;
  } else if (tree_plan.active) {
    std::string err;
    int g = TreeGroupOf(opts_.rank, tree_plan);
    auto cp = TreeMemberPlane::Make(
        agg_map[static_cast<size_t>(g)].first,
        agg_map[static_cast<size_t>(g)].second, opts_.rank, opts_.epoch,
        opts_.tree_exchange_timeout_ms, &err);
    if (!cp) return Status::Unknown("control plane: " + err);
    // Tree members have no succession listener — root failover is the
    // star's mechanism (tree mode's elastic path re-forms as a star).
    if (bound_port != nullptr) *bound_port = 0;
    control_ = std::move(cp);
    cp_role_ = 4;
  } else if (opts_.rank == 0) {
    std::string err;
    auto cp = TcpControlPlane::MakeCoordinator(opts_.coordinator_port,
                                               opts_.size, opts_.epoch, &err,
                                               opts_.bulk_listen_port);
    if (!cp) return Status::Unknown("control plane: " + err);
    if (bound_port != nullptr) *bound_port = cp->bound_port();
    control_ = std::move(cp);
    cp_role_ = 1;
  } else {
    std::string err;
    // Elastic workers pre-bind a succession listener (standby=true): its
    // port rides the HELLO, and Start reports it as this rank's bound
    // port so Python can re-bind the same endpoint on promotion.
    auto cp = TcpControlPlane::MakeWorker(opts_.coordinator_host,
                                          opts_.coordinator_port, opts_.rank,
                                          opts_.epoch, &err, opts_.elastic,
                                          opts_.bulk_listen_port);
    if (!cp) return Status::Unknown("control plane: " + err);
    if (bound_port != nullptr) *bound_port = cp->standby_listen_port();
    control_ = std::move(cp);
    cp_role_ = 2;
  }
  if (opts_.cache_capacity > 0) {
    cache_.SetCapacity(static_cast<size_t>(opts_.cache_capacity));
  }
  if (control_->is_coordinator()) {
    coordinator_ = std::make_unique<Coordinator>(
        opts_.size, opts_.stall_warning_seconds, opts_.stall_check);
    if (timeline_.Initialized()) coordinator_->SetTimeline(&timeline_);
    if (cache_.enabled()) coordinator_->SetResponseCache(&cache_);
  }
  thread_ = std::thread(&Engine::Loop, this);
  if (opts_.size > 1 && opts_.heartbeat_ms > 0) {
    // Peer liveness is only meaningful on the TCP plane; loopback jobs
    // have no peers to lose.
    monitor_thread_ = std::thread(&Engine::MonitorLoop, this);
  }
  return Status::OK();
}

void Engine::Shutdown() {
  shutdown_requested_.store(true);
  // Lock/unlock pairs the store with any waiter between its predicate check
  // and wait entry (classic lost-wakeup window), then kick the cycle loop so
  // teardown doesn't wait out the remainder of a cycle tail.
  { std::lock_guard<std::mutex> l(mu_); }
  cycle_cv_.notify_all();
  monitor_cv_.notify_all();
}

int64_t Engine::Enqueue(const std::string& name, OpType op, DataType dtype,
                        const TensorShape& shape, int32_t root_rank,
                        WireFormat wire, Status* status) {
  std::lock_guard<std::mutex> l(mu_);
  if (stopped_.load() || shutdown_requested_.load() || !abort_status_.ok()) {
    // An engine that an abort stopped (divergence, peer failure, transport
    // failure, reconfiguration) answers with that abort's own status, so a
    // collective issued after the verdict reports its cause; only a real
    // shutdown gets the bare text.
    *status = abort_status_.ok()
                  ? Status::Aborted("Horovod engine has been shut down.")
                  : abort_status_;
    return -1;
  }
  if (inflight_.count(name) != 0) {
    // Reference EnqueueTensorAllreduce duplicate-name check
    // (operations.cc:2035-2040): a second request for a name still in
    // flight is a client error, reported immediately.
    *status = Status::InvalidArgument(
        "Duplicate tensor name '" + name + "' for " +
        std::string(OpTypeName(op)) +
        ": a previous request with this name has not completed. "
        "Collectives submitted in a loop need an explicit, per-iteration "
        "name= kwarg (hvd-lint rule HVD102 of `python -m "
        "horovod_tpu_torch.analysis.lint`; README, \"Analysis tools and "
        "the port's pre-PR gate\").");
    return -1;
  }
  Request req;
  req.rank = opts_.rank;
  req.op = op;
  req.dtype = dtype;
  req.root_rank = root_rank;
  req.wire = wire;
  req.name = name;
  req.shape = shape;
  int64_t handle = next_handle_++;
  handles_[handle] = HandleState{};
  inflight_[name] = {handle, req};
  if (cache_.enabled()) {
    // Fast path: a signature the whole job has already coordinated skips
    // straight to the next cycle instead of waiting out the cycle tail —
    // cached tensors no longer pay up to cycle_time_ms of enqueue latency.
    int32_t bit;
    if (cache_.Find(req, &bit) == ResponseCache::Lookup::HIT) {
      cycle_wake_ = true;
      cycle_cv_.notify_one();
    }
  }
  pending_enqueues_.emplace_back(handle, std::move(req));
  *status = Status::OK();
  return handle;
}

void Engine::Loop() {
  using clock = std::chrono::steady_clock;
  auto cycle = std::chrono::duration<double, std::milli>(opts_.cycle_time_ms);
  while (!stopped_.load()) {
    auto start = clock::now();
    RunCycle();
    // Wait out the remainder of the cycle (reference operations.cc:1696-1703)
    // — but on a condvar, not an uninterruptible sleep_for: a cache-hit
    // enqueue or a shutdown request ends the wait immediately.  Uncached
    // names keep the paced cycle.
    auto elapsed = clock::now() - start;
    if (elapsed < cycle && !stopped_.load()) {
      std::unique_lock<std::mutex> l(mu_);
      WaitWithTimeout(
          cycle_cv_, l,
          std::chrono::duration<double, std::milli>(cycle - elapsed).count(),
          [&] {
            return cycle_wake_ || stopped_.load() ||
                   shutdown_requested_.load();
          });
    }
  }
}

void Engine::RunCycle() {
  RequestList own;
  {
    std::lock_guard<std::mutex> l(mu_);
    cycle_wake_ = false;  // this cycle consumes the pending wake-up
    for (auto& [handle, req] : pending_enqueues_) {
      if (cache_.enabled()) {
        int32_t bit = -1;
        switch (cache_.Find(req, &bit)) {
          case ResponseCache::Lookup::HIT:
            // Announce the bit instead of the metadata; keep the request
            // around in case a coordinated invalidation forces a replay.
            own.cache_hits.push_back(bit);
            bit_announced_[req.name] = req;
            cache_.stats.hits++;
            continue;
          case ResponseCache::Lookup::STALE:
            // Same name, new signature: ask the coordinator to flush the
            // entry on ALL ranks this tick, and fall through to a full
            // (re-)negotiation that repopulates it.
            own.cache_invalidate.push_back(req.name);
            cache_.stats.misses++;
            break;
          case ResponseCache::Lookup::MISS:
            cache_.stats.misses++;
            break;
        }
      }
      own.requests.push_back(req);
    }
    pending_enqueues_.clear();
    if (cache_.enabled() && own.requests.empty() && !own.cache_hits.empty()) {
      cache_.stats.bypassed_ticks++;
    }
    if (opts_.verify_schedule) {
      own.verify = std::move(pending_verify_);
      pending_verify_.clear();
    }
  }
  own.shutdown = shutdown_requested_.load();

  auto tick_t0 = std::chrono::steady_clock::now();
  ResponseList responses;
  if (control_->is_coordinator()) {
    std::vector<RequestList> gathered;
    if (!control_->Gather(own, &gathered)) {
      HandleTransportFailure("control plane gather failed");
      return;
    }
    {
      // Tick reads/mutates the shared response cache (authoritative slot
      // and eviction decisions), which client enqueues also probe — so the
      // pure-compute negotiation step runs under mu_.  Gather/Broadcast
      // (the blocking transport halves) stay outside the lock.
      std::lock_guard<std::mutex> l(mu_);
      responses = coordinator_->Tick(gathered);
    }
    if (opts_.verify_schedule &&
        ++verify_tick_ % std::max(opts_.verify_interval_ticks, 1) == 0) {
      responses.divergence = coordinator_->CheckDivergence();
      if (!responses.divergence.empty()) {
        // Verifier divergence: the coordinated flush rides the same tick —
        // no rank may keep serving hits from a schedule that just diverged.
        responses.cache_clear = true;
      }
    }
    std::string stall = coordinator_->CheckStalled();
    if (!stall.empty()) {
      std::fprintf(stderr, "WARNING: %s", stall.c_str());
    }
    {
      // Publish the structured stall view for hvd.stall_report().
      std::lock_guard<std::mutex> l(mu_);
      last_stall_ = coordinator_->StalledTensors();
    }
    // Escalation: warn -> abort.  A deadlocked job must become a
    // restartable exit for the launcher's supervision, not a hang the
    // operator discovers hours later (reference's stall story stopped at
    // the warning).  _Exit, not exit: the process is wedged by
    // definition — running atexit handlers (which may join the very
    // threads that are stuck) would turn the abort back into a hang.
    if (opts_.stall_abort_seconds > 0 &&
        coordinator_->OldestPendingSeconds() >= opts_.stall_abort_seconds) {
      std::fprintf(stderr,
                   "ERROR: horovod_tpu stall exceeded "
                   "HVD_TPU_STALL_ABORT_SECONDS=%.3f; aborting job with "
                   "restartable exit code %d\n",
                   opts_.stall_abort_seconds, opts_.stall_abort_exit_code);
      std::fflush(stderr);
      std::_Exit(opts_.stall_abort_exit_code);
    }
    if (!control_->Broadcast(responses)) {
      HandleTransportFailure("control plane broadcast failed");
      return;
    }
  } else {
    if (!control_->Exchange(own, &responses)) {
      HandleTransportFailure("control plane exchange failed");
      return;
    }
  }
  first_tick_done_.store(true);

  {
    // Negotiated-tick latency: the transport round (gather + negotiate +
    // broadcast on the root; exchange on workers/members), excluding the
    // local dispatch work below.  hvd.control_plane_stats() reads the ring.
    long long us = std::chrono::duration_cast<std::chrono::microseconds>(
                       std::chrono::steady_clock::now() - tick_t0)
                       .count();
    std::lock_guard<std::mutex> l(mu_);
    if (tick_ring_.size() < 512) {
      tick_ring_.push_back(us);
    } else {
      tick_ring_[tick_ring_pos_] = us;
    }
    tick_ring_pos_ = (tick_ring_pos_ + 1) % 512;
    ++tick_count_;
    if (timeline_.Initialized() && !responses.responses.empty()) {
      // Tick marker on its own timeline row: lines up negotiation rounds
      // against per-tensor NEGOTIATED/CACHE_HIT instants.
      timeline_.Instant("control_plane", "TICK");
    }
  }

  if (!responses.divergence.empty()) {
    // Schedule divergence: the collectives in flight can never pair up
    // across ranks again — fail everything NOW with the structured
    // report instead of letting the job ride to the stall timeout.
    HandleDivergence(responses.divergence);
    return;
  }

  DispatchResponses(responses);

  if (responses.shutdown) {
    // Coordinated shutdown: fail whatever never became ready with the
    // reference's "shut down in progress" error (operations.cc:1647-1662).
    // Batches already negotiated and dispatched are NOT aborted — the
    // shutdown flag rides the broadcast stream behind their responses, so
    // every rank dispatched the identical batches and every rank lets them
    // drain (the reference likewise executes whatever made it out of the
    // message table; killing a batch a finished peer already completed was
    // a shutdown/straggler race).
    FailUnscheduled(Status::Aborted(
        "Horovod has been shut down. This was caused by an exit or shutdown "
        "request on one of the ranks; pending collectives were aborted."));
    stopped_.store(true);
    exec_cv_.notify_all();
  }
}

void Engine::DispatchResponses(const ResponseList& responses) {
  std::lock_guard<std::mutex> l(mu_);
  // Response-cache maintenance first, in broadcast order, identically on
  // every rank (docs/response_cache.md): replicas only ever mutate here, so
  // they cannot diverge.  A flushed entry this rank had announced by bit is
  // replayed as a full request next cycle (same handle, no client impact).
  if (responses.cache_clear && cache_.enabled()) {
    cache_.Clear();
    for (auto& [name, req] : bit_announced_) {
      auto it = inflight_.find(name);
      if (it != inflight_.end()) {
        pending_enqueues_.emplace_back(it->second.first, req);
      }
    }
    bit_announced_.clear();
  }
  for (const auto& name : responses.cache_invalidate) {
    cache_.Erase(name);
    auto ba = bit_announced_.find(name);
    if (ba != bit_announced_.end()) {
      auto it = inflight_.find(name);
      if (it != inflight_.end()) {
        pending_enqueues_.emplace_back(it->second.first, ba->second);
      }
      bit_announced_.erase(ba);
    }
  }
  // Expand cache-hit bits into full responses from the local replica and
  // store freshly negotiated ones into their assigned slots (signature
  // computed from OUR request — the one per-rank-local cache field).
  std::vector<Response> expanded;
  expanded.reserve(responses.responses.size());
  for (const auto& r : responses.responses) {
    if (r.cache_bit >= 0) {
      if (!cache_.Has(r.cache_bit)) continue;  // flushed this very tick
      Response full = cache_.At(r.cache_bit);
      full.cache_bit = r.cache_bit;
      full.store_bit = -1;
      for (const auto& name : full.tensor_names) bit_announced_.erase(name);
      expanded.push_back(std::move(full));
    } else {
      if (r.store_bit >= 0 && cache_.enabled() &&
          r.type != Response::Type::ERROR && r.tensor_names.size() == 1) {
        auto it = inflight_.find(r.tensor_names[0]);
        if (it != inflight_.end()) {
          Response tostore = r;
          tostore.cache_bit = -1;
          tostore.store_bit = -1;
          cache_.Store(r.store_bit, r.tensor_names[0], tostore,
                       ResponseCache::Signature(it->second.second));
        }
      }
      expanded.push_back(r);
    }
  }
  if (timeline_.Initialized()) {
    // Tag each tensor's cycle by how its verdict was produced: negotiated
    // through the full coordinator round, or served from the cache.
    for (const auto& r : expanded) {
      for (const auto& name : r.tensor_names) {
        timeline_.Instant(name, r.cache_bit >= 0 ? "CACHE_HIT"
                                                 : "NEGOTIATED");
      }
    }
  }
  // Fuse adjacent same-type/same-dtype ALLREDUCE responses up to the byte
  // threshold — in-order, no skipping (reference fusion loop,
  // operations.cc:1807-1842).  Other op types execute one per batch.
  size_t i = 0;
  const auto& rs = expanded;
  while (i < rs.size()) {
    const Response& r = rs[i];
    // Look up without erasing: the name stays "in flight" (blocking duplicate
    // enqueues) until BatchDone — the reference frees a name only when its
    // callback fires (operations.cc:2035-2040 duplicate check semantics).
    auto take = [&](const std::string& name)
        -> std::pair<int64_t, Request> {
      auto it = inflight_.find(name);
      if (it == inflight_.end()) return {-1, Request{}};
      return it->second;
    };

    if (r.type == Response::Type::ERROR) {
      auto [handle, req] = take(r.tensor_names[0]);
      if (handle >= 0) {
        inflight_.erase(r.tensor_names[0]);
        MarkDone(handle, Status::PreconditionError(r.error_reason));
      }
      ++i;
      continue;
    }
    if (r.type == Response::Type::BARRIER) {
      auto [handle, req] = take(r.tensor_names[0]);
      if (handle >= 0) {
        inflight_.erase(r.tensor_names[0]);
        MarkDone(handle, Status::OK());
      }
      ++i;
      continue;
    }

    ExecBatch batch;
    batch.id = next_batch_id_++;
    batch.type = r.type;

    auto append = [&](const Response& resp) {
      for (const auto& name : resp.tensor_names) {
        auto [handle, req] = take(name);
        if (handle < 0) continue;  // not ours?  (should not happen: SPMD)
        batch.names.push_back(name);
        batch.handles.push_back(handle);
        batch.shapes.push_back(req.shape);
        batch.dtype = req.dtype;
        batch.root_rank = req.root_rank;
        batch.wire = req.wire;
      }
      batch.first_dim_sizes.insert(batch.first_dim_sizes.end(),
                                   resp.first_dim_sizes.begin(),
                                   resp.first_dim_sizes.end());
    };
    append(r);

    if (r.type == Response::Type::ALLREDUCE && !batch.shapes.empty()) {
      int64_t bytes = 0;
      for (const auto& s : batch.shapes) {
        bytes += s.num_elements() * DataTypeSize(batch.dtype);
      }
      while (i + 1 < rs.size() &&
             rs[i + 1].type == Response::Type::ALLREDUCE) {
        // Peek the next response's dtype/bytes from our inflight table.
        const Response& nxt = rs[i + 1];
        auto it = inflight_.find(nxt.tensor_names[0]);
        if (it == inflight_.end()) break;
        const Request& req = it->second.second;
        int64_t add = req.shape.num_elements() * DataTypeSize(req.dtype);
        if (req.dtype != batch.dtype || req.wire != batch.wire ||
            bytes + add > opts_.fusion_threshold_bytes) {
          break;
        }
        ++i;
        append(nxt);
        bytes += add;
      }
    }

    if (!batch.names.empty()) {
      if (timeline_.Initialized()) {
        for (const auto& n : batch.names) {
          timeline_.ActivityStart(n, "QUEUE");
        }
      }
      executing_[batch.id] = batch;
      exec_queue_.push_back(std::move(batch));
      exec_cv_.notify_one();
    }
    ++i;
  }
}

int Engine::NextBatch(ExecBatch* out, double timeout_ms) {
  std::unique_lock<std::mutex> l(mu_);
  if (!WaitWithTimeout(exec_cv_, l, timeout_ms, [&] {
        return !exec_queue_.empty() || stopped_.load();
      })) {
    return 0;
  }
  if (!exec_queue_.empty()) {
    *out = std::move(exec_queue_.front());
    exec_queue_.pop_front();
    return 1;
  }
  return stopped_.load() ? -1 : 0;
}

void Engine::RequeueBatch(ExecBatch batch) {
  std::lock_guard<std::mutex> l(mu_);
  exec_queue_.push_front(std::move(batch));
  exec_cv_.notify_one();
}

void Engine::BatchActivity(int64_t batch_id, const std::string& activity) {
  std::lock_guard<std::mutex> l(mu_);
  if (!timeline_.Initialized()) return;
  auto it = executing_.find(batch_id);
  if (it == executing_.end()) return;
  for (const auto& n : it->second.names) {
    timeline_.ActivityEnd(n);
    timeline_.ActivityStart(n, activity);
  }
}

void Engine::TimelineInstant(const std::string& row,
                             const std::string& label) {
  std::lock_guard<std::mutex> l(mu_);
  if (!timeline_.Initialized()) return;
  timeline_.Instant(row, label);
}

void Engine::BatchDone(int64_t batch_id, const Status& status) {
  std::lock_guard<std::mutex> l(mu_);
  auto it = executing_.find(batch_id);
  if (it == executing_.end()) return;
  for (size_t k = 0; k < it->second.handles.size(); ++k) {
    if (timeline_.Initialized()) {
      timeline_.ActivityEnd(it->second.names[k]);
      timeline_.End(it->second.names[k], status.ok() ? "DONE" : "ERROR");
    }
    inflight_.erase(it->second.names[k]);
    MarkDone(it->second.handles[k], status);
  }
  executing_.erase(it);
}

void Engine::HandleDivergence(const std::vector<DivergenceEntry>& entries) {
  std::ostringstream msg;
  msg << "Collective schedule divergence detected (HVD_TPU_VERIFY_SCHEDULE)"
      << ": ranks submitted different collectives at sequence number "
      << (entries.empty() ? int64_t{0} : entries[0].seq)
      << ". First mismatched collective per rank:\n";
  for (const auto& e : entries) {
    msg << "  rank " << e.rank << ": " << e.desc << "\n";
  }
  msg << "Every rank must issue the same collectives in the same order; "
         "run `python -m horovod_tpu_torch.analysis.lint` on the training "
         "script to find rank-divergent call sites (README, \"Analysis "
         "tools and the port's pre-PR gate\").";
  std::string text = msg.str();
  std::fprintf(stderr, "ERROR: horovod_tpu %s\n", text.c_str());
  std::fflush(stderr);
  {
    std::lock_guard<std::mutex> l(mu_);
    divergence_ = entries;
    // Coordinated flush (the divergence tick broadcast cache_clear): a
    // diverged schedule's cached verdicts are meaningless on every rank.
    if (cache_.enabled()) cache_.Clear();
  }
  FailAllPending(Status::PreconditionError(text));
  stopped_.store(true);
  exec_cv_.notify_all();
}

void Engine::MonitorLoop() {
  for (;;) {
    {
      std::unique_lock<std::mutex> l(mu_);
      WaitWithTimeout(monitor_cv_, l, opts_.heartbeat_ms, [&] {
        return stopped_.load() || shutdown_requested_.load();
      });
    }
    if (stopped_.load() || shutdown_requested_.load()) return;
    if (opts_.elastic && control_->is_coordinator() && MaybeHandleJoin()) {
      // A relaunched rank was admitted: this engine just reconfigured
      // itself away; the Python layer re-forms it at the grown size.
      return;
    }
    if (opts_.elastic && control_->is_coordinator()) {
      // Stream the authoritative-only coordinator state to the standby as
      // a delta each monitor tick (docs/fault_tolerance.md "Coordinator
      // failover").  The epoch is the load-bearing part — promotion picks
      // max(local, replicated)+1 so a successor can never reuse one; the
      // rest keeps the standby's view aligned for observability.
      CoordState state;
      state.epoch = opts_.epoch;
      state.joins_admitted = joins_admitted_.load();
      if (coordinator_) state.verify_checked = coordinator_->verify_checked();
      state.verify_tick = verify_tick_.load();
      {
        std::lock_guard<std::mutex> l(mu_);
        if (cache_.enabled()) state.lru_order = cache_.LruOrder();
      }
      control_->SyncCoordState(state);
    }
    // Until this rank's first tick has come back the job is still in its
    // rendezvous: the coordinator acks each worker as it arrives but sends
    // nothing, heartbeats included, until the last one has, and a peer
    // can lag a whole interpreter boot behind the others.  Silence is
    // judged by the rendezvous budget then, by the heartbeat timeout
    // after.
    double timeout_s = opts_.heartbeat_timeout_ms / 1000.0;
    if (!first_tick_done_.load()) {
      timeout_s = std::max(timeout_s, wire::RendezvousBudgetSeconds());
    }
    if (!control_->HeartbeatTick(timeout_s)) {
      continue;
    }
    ReconfigInfo info;
    if (control_->GetReconfig(&info)) {
      // The cycle thread's blocked read demuxed a RECONFIG verdict and the
      // failure flag it raises woke us: shrink in place, don't abort.
      HandleReconfig(info);
      return;
    }
    PeerFailureReport report;
    control_->GetFailure(&report);
    HandlePeerFailure(std::move(report));
    return;
  }
}

void Engine::HandleTransportFailure(const char* what) {
  ReconfigInfo info;
  if (!shutdown_requested_.load() && control_->GetReconfig(&info)) {
    HandleReconfig(info);
    return;
  }
  PeerFailureReport report;
  if (!shutdown_requested_.load() && control_->GetFailure(&report)) {
    HandlePeerFailure(std::move(report));
    return;
  }
  // Transport failed without a structured cause (or during coordinated
  // teardown, where closing peers are expected): the pre-heartbeat generic
  // abort.
  FailAllPending(Status::Aborted(what));
  stopped_.store(true);
  exec_cv_.notify_all();
}

void Engine::HandlePeerFailure(PeerFailureReport report) {
  bool expected = false;
  if (!failure_handled_.compare_exchange_strong(expected, true)) return;
  // Elastic shrink decision (coordinator only — workers never observe a
  // non-coordinator peer directly; they receive the RECONFIG verdict).  A
  // shrink below the HVD_TPU_MIN_SIZE floor keeps the legacy
  // abort-and-restart path; a dead coordinator takes the failover branch
  // below (docs/fault_tolerance.md recovery-mode matrix).
  if (opts_.elastic && control_->is_coordinator() && report.failed_rank > 0 &&
      report.failed_rank < opts_.size &&
      opts_.size - 1 >= std::max(opts_.min_size, 1) &&
      !shutdown_requested_.load()) {
    ReconfigInfo info;
    info.epoch = opts_.epoch + 1;
    info.new_size = opts_.size - 1;
    info.failed_rank = report.failed_rank;
    info.cause = report.cause;
    info.new_ranks.resize(static_cast<size_t>(opts_.size));
    for (int r = 0; r < opts_.size; ++r) {
      info.new_ranks[static_cast<size_t>(r)] =
          r == report.failed_rank ? -1 : (r > report.failed_rank ? r - 1 : r);
    }
    {
      // Keep the failure observable (hvd.failure_report() names the dead
      // rank even when the job survives it).
      std::lock_guard<std::mutex> l(mu_);
      failure_ = report;
    }
    control_->BroadcastReconfig(info);
    ReconfigEndgame(info);
    return;
  }
  // Coordinator failover (docs/fault_tolerance.md "Coordinator failover"):
  // the COORDINATOR died and a standby was announced at rendezvous.  The
  // star topology means no survivor can broadcast a verdict (each worker
  // only holds a socket to the dead coordinator), so every survivor
  // independently synthesizes the IDENTICAL verdict from shared facts —
  // the STANDBY announcement and the deterministic rank remap — and
  // re-rendezvouses against the standby's pre-bound listener.  The epoch
  // base is max(local, replicated): a standby whose replicated view ran
  // ahead must never reuse an epoch across the succession.
  if (opts_.elastic && !control_->is_coordinator() &&
      report.failed_rank == 0 &&
      opts_.size - 1 >= std::max(opts_.min_size, 1) &&
      !shutdown_requested_.load()) {
    StandbyInfo standby;
    if (control_->GetStandby(&standby) && standby.standby_rank >= 1 &&
        standby.standby_rank < opts_.size && standby.port > 0) {
      int64_t epoch = opts_.epoch;
      CoordState replicated;
      if (control_->GetCoordState(&replicated) && replicated.epoch > epoch) {
        epoch = replicated.epoch;
      }
      ReconfigInfo info;
      info.epoch = epoch + 1;
      info.new_size = opts_.size - 1;
      info.failed_rank = 0;
      info.cause =
          report.cause.empty() ? "coordinator_failure" : report.cause;
      // Deterministic remap: the standby becomes rank 0 (the engine's
      // coordinator seat), everyone else fills 1..new_size-1 in old-rank
      // order.  With the default standby (lowest rank) this is exactly
      // the familiar r-1 shift.
      info.new_ranks.assign(static_cast<size_t>(opts_.size), -1);
      info.new_ranks[static_cast<size_t>(standby.standby_rank)] = 0;
      int32_t next = 1;
      for (int r = 1; r < opts_.size; ++r) {
        if (r == standby.standby_rank) continue;
        info.new_ranks[static_cast<size_t>(r)] = next++;
      }
      info.new_coord_rank = standby.standby_rank;
      info.new_coord_host = standby.host;
      info.new_coord_port = standby.port;
      {
        std::lock_guard<std::mutex> l(mu_);
        failure_ = report;
      }
      std::fprintf(stderr,
                   "NOTICE: horovod_tpu coordinator (rank 0) died (%s); "
                   "promoting standby rank %d at %s:%d, epoch %lld\n",
                   report.cause.c_str(), standby.standby_rank,
                   standby.host.c_str(), standby.port,
                   static_cast<long long>(info.epoch));
      std::fflush(stderr);
      if (timeline_.Initialized()) {
        timeline_.Instant("control_plane", "COORDINATOR_FAILOVER");
      }
      ReconfigEndgame(info);
      return;
    }
    // No standby was announced (non-elastic peers, bind failure): fall
    // through to the structured abort — never hang.
  }
  AbortEndgame(std::move(report));
}

void Engine::AbortEndgame(PeerFailureReport report) {
  {
    std::lock_guard<std::mutex> l(mu_);
    if (report.last_collective.empty() && !inflight_.empty()) {
      report.last_collective = inflight_.begin()->first;
    }
    failure_ = report;
  }
  std::ostringstream msg;
  msg << "Peer failure detected: rank " << report.failed_rank << " ("
      << report.cause << ") — " << report.detail << ".";
  if (!report.last_collective.empty()) {
    msg << " Pending collective at detection: '" << report.last_collective
        << "'.";
  }
  msg << " All pending collectives were aborted; hvd.failure_report() has "
         "the structured report.";
  std::string text = msg.str();
  std::fprintf(stderr, "ERROR: horovod_tpu %s\n", text.c_str());
  std::fflush(stderr);
  if (timeline_.Initialized()) {
    // Mark the coordination timeline: every peer-death shows PEER_FAILED;
    // heartbeat-detected ones get the extra HEARTBEAT_TIMEOUT instant.
    if (report.cause == "heartbeat_timeout") {
      timeline_.Instant("control_plane", "HEARTBEAT_TIMEOUT");
    }
    timeline_.Instant("control_plane", "PEER_FAILED");
  }
  if (control_->is_coordinator()) {
    // Coordinated abort: survivors must not ride out the stall window
    // waiting on a peer the coordinator already knows is dead.
    control_->AbortPeers(failure_);
  }
  FailAllPending(Status::PreconditionError(text));
  stopped_.store(true);
  exec_cv_.notify_all();
  cycle_cv_.notify_all();
  monitor_cv_.notify_all();
  if (opts_.abort_grace_ms >= 0) {
    // Restartable abort (the stall-escalation contract): give Python
    // abort_grace_ms to observe failure_report(), then exit with the
    // EX_TEMPFAIL code so the launcher's supervision relaunches from the
    // last checkpoint.  _Exit, not exit: a peer-dead job may have threads
    // wedged in blocking collectives, and atexit would hang on them.
    std::this_thread::sleep_for(std::chrono::duration<double, std::milli>(
        opts_.abort_grace_ms));
    std::fprintf(stderr,
                 "ERROR: horovod_tpu aborting after peer failure with "
                 "restartable exit code %d\n",
                 opts_.stall_abort_exit_code);
    std::fflush(stderr);
    std::_Exit(opts_.stall_abort_exit_code);
  }
}

void Engine::HandleReconfig(const ReconfigInfo& info) {
  bool expected = false;
  if (!failure_handled_.compare_exchange_strong(expected, true)) return;
  ReconfigEndgame(info);
}

void Engine::ReconfigEndgame(const ReconfigInfo& info) {
  int32_t new_rank = -1;
  if (opts_.rank >= 0 &&
      static_cast<size_t>(opts_.rank) < info.new_ranks.size()) {
    new_rank = info.new_ranks[static_cast<size_t>(opts_.rank)];
  }
  if (new_rank < 0) {
    // WE are the rank being removed (live but misbehaving — wire faults,
    // a partitioned half): the new membership excludes us, so take the
    // legacy restartable-exit path; the supervisor relaunches us and the
    // relaunch JOINs back in.
    PeerFailureReport report;
    report.failed_rank = opts_.rank;
    report.cause = info.cause.empty() ? "membership_reconfig" : info.cause;
    report.detail = "this rank was removed from the job by an elastic "
                    "reconfiguration (epoch " + std::to_string(info.epoch) +
                    "); exiting restartably to rejoin";
    AbortEndgame(std::move(report));
    return;
  }
  {
    std::lock_guard<std::mutex> l(mu_);
    resize_.present = true;
    resize_.epoch = info.epoch;
    resize_.old_rank = opts_.rank;
    resize_.new_rank = new_rank;
    resize_.old_size = opts_.size;
    resize_.new_size = info.new_size;
    resize_.failed_rank = info.failed_rank;
    resize_.cause = info.cause;
    resize_.new_coord_host = info.new_coord_host;
    resize_.new_coord_port = info.new_coord_port;
    // Coordinated flush, the PR-3 cache_clear semantics: the new
    // membership renegotiates everything from scratch — a cached verdict
    // sized for the old membership must never be served again.
    if (cache_.enabled()) cache_.Clear();
    pending_verify_.clear();
  }
  std::ostringstream msg;
  msg << "Membership changed (elastic reconfiguration): ";
  if (info.failed_rank >= 0) {
    msg << "rank " << info.failed_rank << " left (" << info.cause << ")";
  } else {
    msg << "a relaunched rank rejoined";
  }
  msg << "; new size " << info.new_size << ", epoch " << info.epoch
      << ", this rank is now rank " << new_rank
      << ". Pending collectives were aborted and must be reissued after "
         "reconfiguration; hvd.resize_event() has the structured event.";
  std::string text = msg.str();
  std::fprintf(stderr, "NOTICE: horovod_tpu %s\n", text.c_str());
  std::fflush(stderr);
  if (timeline_.Initialized()) {
    timeline_.Instant("control_plane", "RECONFIG");
  }
  FailAllPending(Status::PreconditionError(text));
  stopped_.store(true);
  exec_cv_.notify_all();
  cycle_cv_.notify_all();
  monitor_cv_.notify_all();
  AwaitResizeAckOrDie();
}

void Engine::AwaitResizeAckOrDie() {
  // Bounded hand-off to Python (HVD_TPU_RECONFIG_TIMEOUT_MS): the resize
  // event was published and this engine is stopped; if no one picks the
  // event up — the script is not elastic-aware, or is wedged — fall back
  // to the abort-and-restart path rather than idling forever (the PR-4
  // nothing-blocks-forever contract).  Runs on the cycle or monitor
  // thread; AckResize (or a deliberate Shutdown) releases it quickly, so
  // the engine destructor's joins stay fast.
  auto deadline =
      std::chrono::steady_clock::now() +
      std::chrono::duration<double, std::milli>(
          opts_.reconfig_timeout_ms > 0 ? opts_.reconfig_timeout_ms : 30000.0);
  while (std::chrono::steady_clock::now() < deadline) {
    if (resize_acked_.load() || shutdown_requested_.load()) return;
    std::this_thread::sleep_for(std::chrono::milliseconds(20));
  }
  std::fprintf(stderr,
               "ERROR: horovod_tpu elastic reconfiguration was not "
               "acknowledged within HVD_TPU_RECONFIG_TIMEOUT_MS; falling "
               "back to full restart with exit code %d\n",
               opts_.stall_abort_exit_code);
  std::fflush(stderr);
  std::_Exit(opts_.stall_abort_exit_code);
}

bool Engine::MaybeHandleJoin() {
  int joiner = control_->PollJoinRequest();
  if (joiner < 0) return false;
  bool expected = false;
  if (!failure_handled_.compare_exchange_strong(expected, true)) {
    return true;  // already aborting/reconfiguring: the joiner retries
  }
  // Grow reconfiguration: existing members keep their ranks, the joiner is
  // appended at new_size - 1 and admitted at this boundary (it learns its
  // identity from the JoinTicket, then rendezvous like any worker).
  ReconfigInfo info;
  info.epoch = opts_.epoch + 1;
  info.new_size = opts_.size + 1;
  info.failed_rank = -1;
  info.cause = "join";
  info.new_ranks.resize(static_cast<size_t>(opts_.size));
  for (int r = 0; r < opts_.size; ++r) {
    info.new_ranks[static_cast<size_t>(r)] = r;
  }
  std::fprintf(stderr,
               "NOTICE: horovod_tpu admitting rejoining rank (was rank %d) "
               "as rank %d at epoch %lld\n",
               joiner, info.new_size - 1,
               static_cast<long long>(info.epoch));
  std::fflush(stderr);
  JoinTicket ticket;
  ticket.epoch = info.epoch;
  ticket.new_size = info.new_size;
  ticket.assigned_rank = info.new_size - 1;
  joins_admitted_.fetch_add(1);
  control_->SendJoinTicket(ticket);
  control_->BroadcastReconfig(info);
  ReconfigEndgame(info);
  return true;
}

Engine::ResizeEventView Engine::ResizeEvent() {
  std::lock_guard<std::mutex> l(mu_);
  return resize_;
}

void Engine::AckResize() { resize_acked_.store(true); }

Engine::CoordStateView Engine::CoordStateReport() {
  CoordStateView out;
  if (control_ && control_->GetCoordState(&out.state)) out.present = true;
  return out;
}

void Engine::DetachListener() {
  if (control_) control_->CloseListener();
}

void Engine::FailUnscheduled(const Status& status) {
  std::lock_guard<std::mutex> l(mu_);
  // Tensors inside a dispatched batch (queued for or held by the executor)
  // complete normally; everything still waiting on negotiation aborts.
  std::unordered_set<std::string> scheduled;
  for (const auto& b : exec_queue_) {
    for (const auto& n : b.names) scheduled.insert(n);
  }
  for (const auto& [id, b] : executing_) {
    for (const auto& n : b.names) scheduled.insert(n);
  }
  // pending_enqueues_ handles are all present in inflight_ too; the
  // inflight_ sweep below marks them.
  pending_enqueues_.clear();
  bit_announced_.clear();
  for (auto it = inflight_.begin(); it != inflight_.end();) {
    if (scheduled.count(it->first) != 0) {
      ++it;
      continue;
    }
    MarkDone(it->second.first, status);
    it = inflight_.erase(it);
  }
}

void Engine::FailAllPending(const Status& status) {
  std::lock_guard<std::mutex> l(mu_);
  // Every caller stops the engine next: the first abort's status is what
  // later enqueues answer with (Enqueue).
  if (abort_status_.ok()) abort_status_ = status;
  for (auto& [handle, req] : pending_enqueues_) MarkDone(handle, status);
  pending_enqueues_.clear();
  for (auto& [name, hr] : inflight_) MarkDone(hr.first, status);
  inflight_.clear();
  bit_announced_.clear();
  for (auto& [id, batch] : executing_) {
    for (auto h : batch.handles) MarkDone(h, status);
  }
  executing_.clear();
  exec_queue_.clear();
}

void Engine::MarkDone(int64_t handle, const Status& status) {
  // mu_ held by callers.
  auto it = handles_.find(handle);
  if (it == handles_.end()) return;
  it->second.done = true;
  it->second.status = status;
  done_cv_.notify_all();
}

std::vector<StallEntry> Engine::StallReport() {
  std::lock_guard<std::mutex> l(mu_);
  return last_stall_;
}

Engine::CacheStatsView Engine::CacheStats() {
  std::lock_guard<std::mutex> l(mu_);
  CacheStatsView v;
  v.stats = cache_.stats;
  v.entries = cache_.size();
  v.capacity = cache_.capacity();
  return v;
}

Engine::ControlPlaneStatsView Engine::ControlPlaneStats() {
  ControlPlaneStatsView v;
  v.role = cp_role_;
  v.depth = cp_depth_;
  v.fanout = cp_fanout_;
  std::vector<long long> window;
  {
    std::lock_guard<std::mutex> l(mu_);
    v.ticks = tick_count_;
    window = tick_ring_;
  }
  if (control_) v.frames_rx = control_->FramesReceived();
  if (v.ticks > 0) {
    v.frames_per_tick =
        static_cast<double>(v.frames_rx) / static_cast<double>(v.ticks);
  }
  if (!window.empty()) {
    std::sort(window.begin(), window.end());
    auto at = [&](double q) {
      size_t idx = static_cast<size_t>(q * (window.size() - 1) + 0.5);
      return static_cast<double>(window[idx]) / 1000.0;
    };
    v.tick_p50_ms = at(0.50);
    v.tick_p99_ms = at(0.99);
  }
  return v;
}

void Engine::SubmitVerify(int64_t seq, uint64_t hash,
                          const std::string& desc) {
  if (!opts_.verify_schedule) return;
  std::lock_guard<std::mutex> l(mu_);
  if (stopped_.load() || shutdown_requested_.load()) return;
  pending_verify_.push_back(VerifyEntry{seq, hash, desc});
}

std::vector<DivergenceEntry> Engine::DivergenceReport() {
  std::lock_guard<std::mutex> l(mu_);
  return divergence_;
}

PeerFailureReport Engine::FailureReport() {
  std::lock_guard<std::mutex> l(mu_);
  return failure_;
}

bool Engine::ShardPutSend(int32_t target_rank, int64_t step,
                          const std::string& payload) {
  if (!control_ || stopped_.load()) return false;
  ShardPut shard;
  shard.owner_rank = opts_.rank;
  shard.target_rank = target_rank;
  shard.step = step;
  shard.epoch = opts_.epoch;
  shard.payload = payload;
  return control_->SendShard(shard);
}

bool Engine::ShardPoll(ShardPut* out) {
  return control_ && control_->PollShard(out);
}

void Engine::ShardRequeue(ShardPut&& shard) {
  if (control_) control_->RequeueShard(std::move(shard));
}

bool Engine::ShardAckPoll(ShardAck* out) {
  return control_ && control_->PollShardAck(out);
}

bool Engine::TicketRequestSend(int32_t dst_rank, int64_t step, int64_t nbytes,
                               const std::string& manifest) {
  if (!control_ || stopped_.load()) return false;
  TicketRequest req;
  req.src_rank = opts_.rank;
  req.dst_rank = dst_rank;
  req.step = step;
  req.epoch = opts_.epoch;
  req.nbytes = nbytes;
  req.manifest = manifest;
  return control_->RequestTicket(req);
}

bool Engine::TicketPoll(Ticket* out) {
  return control_ && control_->PollTicket(out);
}

void Engine::TicketRequeue(Ticket&& ticket) {
  if (control_) control_->RequeueTicket(std::move(ticket));
}

bool Engine::PollHandle(int64_t handle) {
  std::lock_guard<std::mutex> l(mu_);
  auto it = handles_.find(handle);
  return it == handles_.end() || it->second.done;
}

bool Engine::WaitHandle(int64_t handle, double timeout_ms) {
  std::unique_lock<std::mutex> l(mu_);
  return WaitWithTimeout(done_cv_, l, timeout_ms, [&] {
    auto it = handles_.find(handle);
    return it == handles_.end() || it->second.done;
  });
}

Status Engine::PeekHandle(int64_t handle) {
  std::lock_guard<std::mutex> l(mu_);
  auto it = handles_.find(handle);
  if (it == handles_.end()) {
    return Status::InvalidArgument("unknown handle");
  }
  return it->second.done ? it->second.status
                         : Status{StatusType::IN_PROGRESS, ""};
}

Status Engine::ReleaseHandle(int64_t handle) {
  std::lock_guard<std::mutex> l(mu_);
  auto it = handles_.find(handle);
  if (it == handles_.end()) {
    return Status::InvalidArgument("unknown handle");
  }
  Status s = it->second.done ? it->second.status
                             : Status{StatusType::IN_PROGRESS, ""};
  if (it->second.done) handles_.erase(it);
  return s;
}

}  // namespace hvd
