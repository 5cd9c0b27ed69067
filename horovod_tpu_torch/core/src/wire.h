// Shared low-level TCP wire helpers for the control plane.
//
// These grew up inside controller.cc's star transport; the hierarchical
// coordinator tree (tree.cc) speaks the identical hardened frame protocol
// from three more vantage points (tree root, aggregator relay, tree
// member), so the byte-moving primitives live here once instead of four
// times.  Everything above this layer — frame demux, handshakes, failure
// records — stays per-plane.
#pragma once

#include <unistd.h>

#include <atomic>
#include <cstddef>
#include <cstdint>
#include <cstdlib>
#include <string>

#include "controller.h"

namespace hvd {
namespace wire {

constexpr size_t kMaxFrameBytes = 64u << 20;  // 64 MiB sanity cap

// Full-buffer send/recv (EINTR-retrying, MSG_NOSIGNAL).
bool SendAll(int fd, const void* buf, size_t n);
bool RecvAll(int fd, void* buf, size_t n);

// Blocking read that stays interruptible: polls in bounded slices so a
// failure recorded by another thread breaks a read that would otherwise
// block on a dead peer forever.
enum class RecvResult { OK, CLOSED, FAILED, INTERRUPTED };
RecvResult RecvSome(int fd, void* buf, size_t n,
                    const std::atomic<bool>& stop, size_t* got_out);

// Advertised protocol version (HVD_TPU_WIRE_VERSION override for tests).
uint8_t WireVersionFromEnv();

// HVD_TPU_FAULT_WIRE_* chaos-injector grammar, shared with faults.py.
TcpControlPlane::WireFaultSpec ParseWireFaultEnv(int64_t plane_epoch);

// Rendezvous budget in seconds (HVD_TPU_CONNECT_TIMEOUT, default 300).
double RendezvousBudgetSeconds();

// Calling thread's consumed CPU time in microseconds.  Busy accounting
// (ControlPlane::BusyMicros, relay stats) uses THREAD CPU, not wall
// clock: the fleet simulator oversubscribes one host by hundreds of
// protocol processes, where wall-minus-poll-waits still counts scheduler
// preemption as "work" and inflates superlinearly with process count.
long long ThreadCpuMicros();

// Bounded exponential backoff with jitter — the C++ mirror of
// horovod_tpu/utils/backoff.py (one retry policy across the stack).
struct Backoff {
  double initial_s;
  double max_s;
  unsigned seed;
  double DelaySeconds(int attempt) {
    double base = initial_s;
    for (int k = 0; k < attempt && base < max_s; ++k) base *= 2.0;
    if (base > max_s) base = max_s;
    double u = static_cast<double>(rand_r(&seed)) / RAND_MAX;
    return base / 2.0 + u * (base / 2.0);
  }
  void Sleep(int attempt, double budget_left_s) {
    double d = DelaySeconds(attempt);
    if (d > budget_left_s) d = budget_left_s;
    if (d <= 0) return;
    ::usleep(static_cast<useconds_t>(d * 1e6));
  }
};

}  // namespace wire
}  // namespace hvd
