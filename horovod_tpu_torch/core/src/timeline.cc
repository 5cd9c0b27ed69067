#include "timeline.h"

namespace hvd {

Timeline::~Timeline() {
  if (file_ != nullptr) {
    // Closing sentinel keeps the file strict JSON despite the streaming
    // trailing commas (chrome://tracing accepts either).
    std::fputs("{\"name\": \"end\", \"ph\": \"M\", \"pid\": 0, "
               "\"args\": {}}]\n",
               file_);
    std::fclose(file_);
  }
}

void Timeline::Initialize(const std::string& path) {
  std::lock_guard<std::mutex> l(mu_);
  if (file_ != nullptr) return;
  file_ = std::fopen(path.c_str(), "w");
  if (file_ == nullptr) return;
  origin_ = std::chrono::steady_clock::now();
  std::fputs("[\n", file_);
}

int64_t Timeline::NowMicros() const {
  return std::chrono::duration_cast<std::chrono::microseconds>(
             std::chrono::steady_clock::now() - origin_)
      .count();
}

int64_t Timeline::PidFor(const std::string& name) {
  auto it = pids_.find(name);
  if (it != pids_.end()) return it->second;
  int64_t pid = next_pid_++;
  pids_[name] = pid;
  // Metadata record naming the tensor's row, like the reference's
  // process_name metadata event (timeline.cc:50-68).
  std::fprintf(file_,
               "{\"name\": \"process_name\", \"ph\": \"M\", \"pid\": %lld, "
               "\"args\": {\"name\": \"%s\"}},\n",
               static_cast<long long>(pid), name.c_str());
  std::fprintf(file_,
               "{\"name\": \"process_sort_index\", \"ph\": \"M\", "
               "\"pid\": %lld, \"args\": {\"sort_index\": %lld}},\n",
               static_cast<long long>(pid), static_cast<long long>(pid));
  return pid;
}

void Timeline::Emit(char phase, int64_t pid, const std::string& event_name,
                    const std::string& args_state) {
  std::fprintf(file_, "{\"ph\": \"%c\", \"pid\": %lld, \"tid\": 0, "
                      "\"ts\": %lld",
               phase, static_cast<long long>(pid),
               static_cast<long long>(NowMicros()));
  if (!event_name.empty()) {
    std::fprintf(file_, ", \"name\": \"%s\"", event_name.c_str());
  }
  if (!args_state.empty()) {
    std::fprintf(file_, ", \"args\": {\"state\": \"%s\"}", args_state.c_str());
  }
  std::fputs("},\n", file_);
}

void Timeline::NegotiateStart(const std::string& name, const std::string& op) {
  std::lock_guard<std::mutex> l(mu_);
  if (file_ == nullptr) return;
  Emit('B', PidFor(name), "NEGOTIATE_" + op);
}

void Timeline::NegotiateRankReady(const std::string& name, int rank) {
  std::lock_guard<std::mutex> l(mu_);
  if (file_ == nullptr) return;
  int64_t pid = PidFor(name);
  // Instant tick marking this rank's announcement (reference
  // timeline.cc RecordNegotiateRankReady).
  std::fprintf(file_,
               "{\"ph\": \"i\", \"pid\": %lld, \"tid\": 0, \"ts\": %lld, "
               "\"name\": \"rank_%d_ready\", \"s\": \"p\"},\n",
               static_cast<long long>(pid),
               static_cast<long long>(NowMicros()), rank);
}

void Timeline::NegotiateEnd(const std::string& name) {
  std::lock_guard<std::mutex> l(mu_);
  if (file_ == nullptr) return;
  Emit('E', PidFor(name), "");
}

void Timeline::ActivityStart(const std::string& name,
                             const std::string& activity) {
  std::lock_guard<std::mutex> l(mu_);
  if (file_ == nullptr) return;
  Emit('B', PidFor(name), activity);
}

void Timeline::ActivityEnd(const std::string& name) {
  std::lock_guard<std::mutex> l(mu_);
  if (file_ == nullptr) return;
  Emit('E', PidFor(name), "");
}

void Timeline::Instant(const std::string& name, const std::string& label) {
  std::lock_guard<std::mutex> l(mu_);
  if (file_ == nullptr) return;
  std::fprintf(file_,
               "{\"ph\": \"i\", \"pid\": %lld, \"tid\": 0, \"ts\": %lld, "
               "\"name\": \"%s\", \"s\": \"p\"},\n",
               static_cast<long long>(PidFor(name)),
               static_cast<long long>(NowMicros()), label.c_str());
}

void Timeline::End(const std::string& name, const std::string& result) {
  std::lock_guard<std::mutex> l(mu_);
  if (file_ == nullptr) return;
  int64_t pid = PidFor(name);
  std::fprintf(file_,
               "{\"ph\": \"i\", \"pid\": %lld, \"tid\": 0, \"ts\": %lld, "
               "\"name\": \"%s\", \"s\": \"p\"},\n",
               static_cast<long long>(pid),
               static_cast<long long>(NowMicros()), result.c_str());
  std::fflush(file_);
}

}  // namespace hvd
