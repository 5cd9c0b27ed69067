// Chrome-tracing timeline writer (rank 0).
//
// Rebuild of the reference Timeline (reference horovod/common/timeline.{h,cc};
// doc docs/timeline.md): when HOROVOD_TIMELINE is set, rank 0 streams a
// chrome://tracing JSON array where each named tensor is a trace "process"
// (pid) whose rows show the negotiation phase (with per-rank ready ticks)
// and the execution activities.  Load the file in chrome://tracing or
// Perfetto.  Device-side timing belongs to the XLA/TPU profiler; this
// timeline covers the coordination plane.
#pragma once

#include <chrono>
#include <cstdio>
#include <mutex>
#include <string>
#include <unordered_map>

namespace hvd {

class Timeline {
 public:
  ~Timeline();
  void Initialize(const std::string& path);
  bool Initialized() const { return file_ != nullptr; }

  void NegotiateStart(const std::string& name, const std::string& op);
  void NegotiateRankReady(const std::string& name, int rank);
  void NegotiateEnd(const std::string& name);
  void ActivityStart(const std::string& name, const std::string& activity);
  void ActivityEnd(const std::string& name);
  // Instant marker on the named row — tags each dispatch cycle CACHE_HIT
  // vs NEGOTIATED (docs/response_cache.md), control-plane events
  // (COORDINATOR_FAILOVER etc.), and the schedule planner's OVERLAP_PLAN
  // decisions (ops/schedule_plan.py via Engine::TimelineInstant).
  void Instant(const std::string& name, const std::string& label);
  void End(const std::string& name, const std::string& result);

 private:
  int64_t PidFor(const std::string& name);
  int64_t NowMicros() const;
  void Emit(char phase, int64_t pid, const std::string& event_name,
            const std::string& args_state = "");

  std::mutex mu_;
  std::FILE* file_ = nullptr;
  std::unordered_map<std::string, int64_t> pids_;
  std::chrono::steady_clock::time_point origin_;
  int64_t next_pid_ = 1;
};

}  // namespace hvd
