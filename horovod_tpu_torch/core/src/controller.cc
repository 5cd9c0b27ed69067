#include "controller.h"

#include "wire.h"

#include <arpa/inet.h>
#include <fcntl.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <poll.h>
#include <sys/socket.h>
#include <sys/time.h>
#include <unistd.h>

#include <chrono>
#include <cstdlib>

#include <algorithm>
#include <cerrno>
#include <cstring>
#include <sstream>

namespace hvd {

// ---------------------------------------------------------------------------
// TCP framing helpers
// ---------------------------------------------------------------------------

// Definitions for the shared helpers declared in wire.h (the tree planes
// in tree.cc speak the same frames from more vantage points).
namespace wire {

bool SendAll(int fd, const void* buf, size_t n) {
  const char* p = static_cast<const char*>(buf);
  while (n > 0) {
    ssize_t w = ::send(fd, p, n, MSG_NOSIGNAL);
    if (w < 0 && errno == EINTR) continue;
    if (w <= 0) return false;
    p += w;
    n -= static_cast<size_t>(w);
  }
  return true;
}

bool RecvAll(int fd, void* buf, size_t n) {
  char* p = static_cast<char*>(buf);
  while (n > 0) {
    ssize_t r = ::recv(fd, p, n, 0);
    if (r < 0 && errno == EINTR) continue;
    if (r <= 0) return false;
    p += r;
    n -= static_cast<size_t>(r);
  }
  return true;
}

// Blocking read that stays interruptible: polls in bounded slices so a
// failure recorded by the monitor thread (heartbeat timeout, send error)
// breaks a read that would otherwise block on a dead peer forever.
RecvResult RecvSome(int fd, void* buf, size_t n,
                    const std::atomic<bool>& stop, size_t* got_out) {
  char* p = static_cast<char*>(buf);
  size_t got = 0;
  while (got < n) {
    if (stop.load()) {
      *got_out = got;
      return RecvResult::INTERRUPTED;
    }
    pollfd pfd{fd, POLLIN, 0};
    int pr = ::poll(&pfd, 1, 200);
    if (pr < 0) {
      if (errno == EINTR) continue;
      *got_out = got;
      return RecvResult::FAILED;
    }
    if (pr == 0) continue;
    ssize_t r = ::recv(fd, p + got, n - got, 0);
    if (r < 0) {
      if (errno == EINTR || errno == EAGAIN || errno == EWOULDBLOCK) continue;
      *got_out = got;
      return RecvResult::FAILED;
    }
    if (r == 0) {
      *got_out = got;
      return RecvResult::CLOSED;
    }
    got += static_cast<size_t>(r);
  }
  *got_out = got;
  return RecvResult::OK;
}

// Advertised protocol version.  HVD_TPU_WIRE_VERSION exists so tests can
// provoke the handshake's skew rejection without a second build.
uint8_t WireVersionFromEnv() {
  const char* v = ::getenv("HVD_TPU_WIRE_VERSION");
  if (v != nullptr && *v != '\0') {
    int n = ::atoi(v);
    if (n > 0 && n < 256) return static_cast<uint8_t>(n);
  }
  return kWireVersion;
}

// HVD_TPU_FAULT_WIRE_* = "<rank>[:<frame>][@<epoch>]", gated on the
// restart-attempt counter exactly like faults.py's process-level injectors
// AND on the membership epoch (so an elastic shrink past the fault runs
// clean at the new epoch instead of re-tripping forever; faults.py parses
// the identical grammar).
TcpControlPlane::WireFaultSpec ParseWireFaultEnv(int64_t plane_epoch) {
  using Spec = TcpControlPlane::WireFaultSpec;
  Spec spec;
  const char* attempt = ::getenv("HVD_TPU_RESTART_ATTEMPT");
  const char* gate = ::getenv("HVD_TPU_FAULT_ON_ATTEMPT");
  long attempt_n = (attempt != nullptr && *attempt) ? ::atol(attempt) : 0;
  long gate_n = (gate != nullptr && *gate) ? ::atol(gate) : 0;
  if (attempt_n != gate_n) return spec;
  const struct {
    const char* env;
    Spec::Mode mode;
  } kinds[] = {
      {"HVD_TPU_FAULT_WIRE_DROP", Spec::Mode::DROP},
      {"HVD_TPU_FAULT_WIRE_CORRUPT", Spec::Mode::CORRUPT},
      {"HVD_TPU_FAULT_WIRE_PARTITION", Spec::Mode::PARTITION},
      {"HVD_TPU_FAULT_WIRE_HALFCLOSE", Spec::Mode::HALFCLOSE},
  };
  for (const auto& k : kinds) {
    const char* v = ::getenv(k.env);
    if (v == nullptr || *v == '\0') continue;
    spec.mode = k.mode;
    spec.rank = ::atoi(v);
    const char* colon = std::strchr(v, ':');
    spec.frame = colon != nullptr ? ::atoll(colon + 1) : 0;
    const char* at = std::strchr(v, '@');
    spec.epoch = at != nullptr ? ::atoll(at + 1) : 0;
    if (spec.epoch != plane_epoch) spec.mode = Spec::Mode::NONE;
    return spec;
  }
  return spec;
}

// Rendezvous budget, seconds.  Peers can lag the whole interpreter-boot
// cost behind each other (importing jax in a fresh child takes tens of
// seconds on a small loaded host), so both the worker's connect retry and
// the coordinator's accept wait share one generous, overridable deadline.
double RendezvousBudgetSeconds() {
  const char* v = ::getenv("HVD_TPU_CONNECT_TIMEOUT");
  if (v != nullptr && *v != '\0') {
    double d = ::atof(v);
    if (d > 0) return d;
  }
  return 300.0;
}

long long ThreadCpuMicros() {
  timespec ts;
  if (::clock_gettime(CLOCK_THREAD_CPUTIME_ID, &ts) != 0) return 0;
  return static_cast<long long>(ts.tv_sec) * 1000000LL + ts.tv_nsec / 1000;
}

}  // namespace wire

// Backoff replaces the old fixed 100 ms connect sleep: N workers
// restarting together decorrelate instead of hammering the coordinator in
// lockstep (struct now lives in wire.h for the tree planes).
using wire::Backoff;
using wire::kMaxFrameBytes;
using wire::ParseWireFaultEnv;
using wire::RecvResult;
using wire::RecvSome;
using wire::RecvAll;
using wire::RendezvousBudgetSeconds;
using wire::SendAll;
using wire::WireVersionFromEnv;

// ---------------------------------------------------------------------------
// TcpControlPlane
// ---------------------------------------------------------------------------

int TcpControlPlane::BindListener(int* port, std::string* err) {
  int fd = ::socket(AF_INET, SOCK_STREAM, 0);
  if (fd < 0) {
    *err = "socket() failed";
    return -1;
  }
  int one = 1;
  ::setsockopt(fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_addr.s_addr = htonl(INADDR_ANY);
  addr.sin_port = htons(static_cast<uint16_t>(*port));
  // Backlog sized for the failover window (every survivor's re-rendezvous
  // connect can park here before the promoted standby starts accepting) and
  // for the fleet simulator's thundering-herd rendezvous, where thousands of
  // protocol-only members connect in one burst.  The kernel clamps to
  // net.core.somaxconn, so the large ask is safe everywhere.
  if (::bind(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) != 0 ||
      ::listen(fd, 4096) != 0) {
    *err = "bind/listen failed on port " + std::to_string(*port);
    ::close(fd);
    return -1;
  }
  socklen_t alen = sizeof(addr);
  ::getsockname(fd, reinterpret_cast<sockaddr*>(&addr), &alen);
  *port = ntohs(addr.sin_port);
  return fd;
}

std::unique_ptr<TcpControlPlane> TcpControlPlane::MakeCoordinator(
    int port, int size, int64_t epoch, std::string* err, int bulk_port) {
  std::unique_ptr<TcpControlPlane> cp(new TcpControlPlane());
  cp->coordinator_ = true;
  cp->rank_ = 0;
  cp->size_ = size;
  cp->epoch_ = static_cast<uint16_t>(epoch & 0xFFFF);
  cp->wire_version_ = WireVersionFromEnv();
  cp->fault_ = ParseWireFaultEnv(epoch);
  cp->port_ = port;
  cp->listen_fd_ = BindListener(&cp->port_, err);
  if (cp->listen_fd_ < 0) return nullptr;
  int one = 1;
  cp->worker_fds_.assign(static_cast<size_t>(size > 0 ? size - 1 : 0), -1);
  // Bulk data plane endpoint table, indexed by rank ([0] = the
  // coordinator's own Python-side listener; workers advertise theirs in
  // HELLO).  Ticket issuance resolves dst endpoints from here.
  cp->peer_hosts_.assign(static_cast<size_t>(size > 0 ? size : 1),
                         "127.0.0.1");
  cp->bulk_ports_.assign(static_cast<size_t>(size > 0 ? size : 1), 0);
  cp->own_bulk_port_ = bulk_port;
  cp->bulk_ports_[0] = bulk_port;
  // Succession bookkeeping: each admitted worker's HELLO advertises its
  // pre-bound standby listen port (0 = none); its address comes from the
  // accepted connection itself.
  std::vector<int32_t> standby_ports(cp->worker_fds_.size(), 0);
  std::vector<std::string> peer_hosts(cp->worker_fds_.size());
  // Bounded accept: a worker that died pre-connect must surface as an error
  // here, not hang the coordinator forever (the silent-hang analog of the
  // reference's stall contract).  The listen fd is non-blocking because a
  // peer can connect and RST between poll() and accept(), in which case
  // Linux drops it from the queue and a blocking accept() would hang.
  int fl = ::fcntl(cp->listen_fd_, F_GETFL, 0);
  ::fcntl(cp->listen_fd_, F_SETFL, fl | O_NONBLOCK);
  auto deadline = std::chrono::steady_clock::now() +
                  std::chrono::duration<double>(RendezvousBudgetSeconds());
  int admitted = 0;
  while (admitted < size - 1) {
    pollfd pfd{cp->listen_fd_, POLLIN, 0};
    int fd = -1;
    for (;;) {
      auto left = std::chrono::duration_cast<std::chrono::milliseconds>(
          deadline - std::chrono::steady_clock::now());
      if (left.count() <= 0) {
        *err = "rendezvous timed out: " + std::to_string(admitted) + "/" +
               std::to_string(size - 1) +
               " workers connected (HVD_TPU_CONNECT_TIMEOUT to extend)";
        return nullptr;
      }
      int pr = ::poll(&pfd, 1,
                      static_cast<int>(std::min<long long>(left.count(),
                                                           1000)));
      if (pr < 0 && errno != EINTR) {
        *err = "poll() failed";
        return nullptr;
      }
      if (pr <= 0 || !(pfd.revents & POLLIN)) continue;
      fd = ::accept(cp->listen_fd_, nullptr, nullptr);
      if (fd >= 0) break;
      if (errno == EAGAIN || errno == EWOULDBLOCK || errno == ECONNABORTED ||
          errno == EINTR) {
        continue;  // aborted mid-handshake: keep waiting for a real peer
      }
      *err = "accept() failed";
      return nullptr;
    }
    ::setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
    // Bound the hello read by the remaining budget too: a peer that
    // connects but never speaks must not hang the quorum.
    auto hello_left = std::chrono::duration_cast<std::chrono::milliseconds>(
        deadline - std::chrono::steady_clock::now());
    if (hello_left.count() <= 0) {
      // SO_RCVTIMEO of zero would mean "no timeout" — fail instead.
      ::close(fd);
      *err = "rendezvous timed out awaiting hello (HVD_TPU_CONNECT_TIMEOUT "
             "to extend)";
      return nullptr;
    }
    timeval tv{};
    tv.tv_sec = static_cast<time_t>(hello_left.count() / 1000);
    tv.tv_usec = static_cast<suseconds_t>((hello_left.count() % 1000) * 1000);
    ::setsockopt(fd, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof(tv));
    // Hardened HELLO: magic + version handshake before the peer is
    // admitted, so a mixed-build worker (or a stray client) becomes a
    // structured connect error on BOTH sides, not a mid-job desync.
    char hdr_buf[kFrameHeaderBytes];
    FrameHeader hello_hdr;
    std::string hello;
    int32_t rank = -1;
    bool hello_ok = RecvAll(fd, hdr_buf, kFrameHeaderBytes);
    timeval zero{};
    ::setsockopt(fd, SOL_SOCKET, SO_RCVTIMEO, &zero, sizeof(zero));
    if (!hello_ok) {
      // The peer vanished before speaking — typically a MakeWorker retry
      // abandoning a connection it parked in our backlog while we were
      // busy admitting someone else.  Not fatal: keep waiting for a
      // peer that completes the handshake (the budget still bounds us).
      ::close(fd);
      continue;
    }
    DecodeFrameHeader(hdr_buf, &hello_hdr);
    if (hello_hdr.magic != kFrameMagic) {
      ::close(fd);  // not yet registered: the destructor can't release it
      *err = "bad hello: connecting peer did not speak the hardened frame "
             "protocol (corrupted stream or mixed-build peer)";
      return nullptr;
    }
    if (hello_hdr.type == static_cast<uint8_t>(FrameType::JOIN)) {
      // A relaunched rank knocking mid-rendezvous (elastic grow): it is
      // not part of THIS membership's quorum — turn it away politely and
      // keep waiting; the joiner retries until the running engine's
      // monitor thread can admit it at the next reconfiguration boundary.
      ::close(fd);
      continue;
    }
    if (hello_hdr.flags != cp->epoch_) {
      // Straggler from a pre-reconfiguration membership: its epoch-stamped
      // HELLO must not consume a rendezvous slot in the new one.
      std::fprintf(stderr,
                   "WARNING: horovod_tpu rejected a stale-epoch hello "
                   "(peer epoch %u, membership epoch %u)\n",
                   static_cast<unsigned>(hello_hdr.flags),
                   static_cast<unsigned>(cp->epoch_));
      ::close(fd);
      continue;
    }
    if (hello_hdr.version != cp->wire_version_) {
      std::string skew =
          "protocol version skew: coordinator speaks v" +
          std::to_string(cp->wire_version_) + " but a connecting worker "
          "speaks v" + std::to_string(hello_hdr.version) +
          " — all ranks must run the same horovod_tpu build";
      cp->SendTypedFrame(fd, FrameType::HELLO_ACK, skew, -1);
      ::close(fd);
      *err = skew;
      return nullptr;
    }
    // 12-byte HELLO {rank, standby_port, bulk_port}; the pre-data-plane
    // 8-byte form is still accepted (bulk_port = 0: no direct streams to
    // that peer, its transfers ride the coordinator relay).
    hello_ok = hello_hdr.type == static_cast<uint8_t>(FrameType::HELLO) &&
               (hello_hdr.payload_len == 8 || hello_hdr.payload_len == 12);
    if (hello_ok) {
      hello.resize(hello_hdr.payload_len);
      ::setsockopt(fd, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof(tv));
      hello_ok = RecvAll(fd, hello.data(), hello.size()) &&
                 Crc32(hello.data(), hello.size()) == hello_hdr.crc32;
      ::setsockopt(fd, SOL_SOCKET, SO_RCVTIMEO, &zero, sizeof(zero));
    }
    if (!hello_ok) {
      ::close(fd);
      *err = "bad hello (truncated or corrupt handshake frame)";
      return nullptr;
    }
    std::memcpy(&rank, hello.data(), 4);
    if (rank < 1 || rank >= size || cp->worker_fds_[rank - 1] != -1) {
      ::close(fd);
      *err = "bad hello rank " + std::to_string(rank);
      return nullptr;
    }
    int32_t standby_port = 0;
    std::memcpy(&standby_port, hello.data() + 4, 4);
    standby_ports[rank - 1] = standby_port;
    if (hello.size() >= 12) {
      int32_t bp = 0;
      std::memcpy(&bp, hello.data() + 8, 4);
      cp->bulk_ports_[rank] = bp;
    }
    sockaddr_in peer{};
    socklen_t plen = sizeof(peer);
    char host_buf[INET_ADDRSTRLEN] = "127.0.0.1";
    if (::getpeername(fd, reinterpret_cast<sockaddr*>(&peer), &plen) == 0) {
      ::inet_ntop(AF_INET, &peer.sin_addr, host_buf, sizeof(host_buf));
    }
    peer_hosts[rank - 1] = host_buf;
    cp->peer_hosts_[rank] = host_buf;
    // The address workers reach THIS host at (for tickets naming the
    // coordinator as dst): the local side of any accepted connection.
    sockaddr_in self{};
    socklen_t slen = sizeof(self);
    char self_buf[INET_ADDRSTRLEN];
    if (::getsockname(fd, reinterpret_cast<sockaddr*>(&self), &slen) == 0 &&
        ::inet_ntop(AF_INET, &self.sin_addr, self_buf, sizeof(self_buf))) {
      cp->peer_hosts_[0] = self_buf;
    }
    cp->worker_fds_[rank - 1] = fd;
    if (!cp->SendTypedFrame(fd, FrameType::HELLO_ACK, "", rank)) {
      *err = "hello ack send failed to rank " + std::to_string(rank);
      return nullptr;
    }
    ++admitted;
  }
  cp->last_rx_.assign(cp->worker_fds_.size(),
                      std::chrono::steady_clock::now());
  cp->failed_.store(false);  // handshake sends must not pre-arm a failure
  // Designate the standby coordinator — the lowest rank that pre-bound a
  // succession listener (HVD_TPU_STANDBY overrides the choice) — and
  // announce it to everyone so succession needs no out-of-band discovery
  // (docs/fault_tolerance.md "Coordinator failover").
  StandbyInfo standby;
  const char* pick = ::getenv("HVD_TPU_STANDBY");
  int want = (pick != nullptr && *pick != '\0') ? ::atoi(pick) : -1;
  for (size_t i = 0; i < standby_ports.size(); ++i) {
    if (standby_ports[i] <= 0) continue;
    int r = static_cast<int>(i) + 1;
    if (want >= 1 && r != want) continue;
    standby.standby_rank = r;
    standby.host = peer_hosts[i];
    standby.port = standby_ports[i];
    break;
  }
  if (standby.standby_rank >= 1) {
    std::string payload;
    Serialize(standby, &payload);
    for (size_t i = 0; i < cp->worker_fds_.size(); ++i) {
      if (cp->worker_fds_[i] < 0) continue;
      cp->SendTypedFrame(cp->worker_fds_[i], FrameType::STANDBY, payload,
                         static_cast<int>(i) + 1);
    }
    std::lock_guard<std::mutex> l(cp->state_mu_);
    cp->standby_ = standby;
    cp->has_standby_ = true;
  }
  cp->failed_.store(false);  // standby broadcast is best effort, too
  return cp;
}

std::unique_ptr<TcpControlPlane> TcpControlPlane::MakeWorker(
    const std::string& host, int port, int rank, int64_t epoch,
    std::string* err, bool standby, int bulk_port) {
  std::unique_ptr<TcpControlPlane> cp(new TcpControlPlane());
  cp->coordinator_ = false;
  cp->rank_ = rank;
  cp->own_bulk_port_ = bulk_port;
  cp->epoch_ = static_cast<uint16_t>(epoch & 0xFFFF);
  cp->wire_version_ = WireVersionFromEnv();
  cp->fault_ = ParseWireFaultEnv(epoch);
  if (standby) {
    // Pre-bind the succession listener BEFORE the handshake so its port
    // rides the HELLO: if this rank is later designated standby and the
    // coordinator dies, survivors connect here and park in the backlog
    // until the promoted plane starts accepting.  Failure to bind is not
    // fatal — the job just runs without this rank as a succession
    // candidate (port 0 in HELLO).
    std::string bind_err;
    int p = 0;
    int fd = BindListener(&p, &bind_err);
    if (fd >= 0) {
      cp->standby_listen_fd_ = fd;
      cp->standby_listen_port_ = p;
    } else {
      std::fprintf(stderr,
                   "WARNING: horovod_tpu rank %d could not pre-bind a "
                   "standby listener (%s); this rank is not a succession "
                   "candidate\n",
                   rank, bind_err.c_str());
    }
  }
  int one = 1;
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_port = htons(static_cast<uint16_t>(port));
  if (::inet_pton(AF_INET, host.c_str(), &addr.sin_addr) != 1) {
    *err = "bad coordinator address " + host;
    return nullptr;
  }
  // The coordinator may come up long after workers (each peer pays the full
  // interpreter/jax boot cost independently), and during an elastic
  // reconfiguration a worker can race the coordinator's teardown/re-bind
  // window — connecting to the OLD membership's dying listen socket, whose
  // backlog is flushed without ever answering.  So the WHOLE handshake
  // (connect + HELLO + HELLO_ACK, with a short per-attempt ack timeout)
  // retries on a fresh socket until the shared rendezvous budget runs out;
  // only a structured rejection (version/epoch skew, bad-rank verdicts) is
  // fatal immediately.
  auto deadline = std::chrono::steady_clock::now() +
                  std::chrono::duration<double>(RendezvousBudgetSeconds());
  Backoff backoff{0.02, 1.0, static_cast<unsigned>(rank + 1)};
  std::string soft_err;  // last retryable failure, reported at budget expiry
  for (int attempt = 0;; ++attempt) {
    double left = std::chrono::duration<double>(
        deadline - std::chrono::steady_clock::now()).count();
    if (left <= 0) {
      *err = "rendezvous with " + host + ":" + std::to_string(port) +
             " failed (HVD_TPU_CONNECT_TIMEOUT to extend)" +
             (soft_err.empty() ? "" : ": " + soft_err);
      return nullptr;
    }
    if (attempt > 0) backoff.Sleep(attempt - 1, left);
    cp->sock_ = ::socket(AF_INET, SOCK_STREAM, 0);
    if (cp->sock_ < 0) {
      *err = "socket() failed";
      return nullptr;
    }
    ::setsockopt(cp->sock_, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
    if (::connect(cp->sock_, reinterpret_cast<sockaddr*>(&addr),
                  sizeof(addr)) != 0) {
      ::close(cp->sock_);
      cp->sock_ = -1;
      soft_err = "connect refused/unreachable";
      continue;
    }
    std::string hello(12, '\0');
    int32_t r32 = rank;
    int32_t sp32 = cp->standby_listen_port_;
    int32_t bp32 = cp->own_bulk_port_;
    std::memcpy(hello.data(), &r32, 4);
    std::memcpy(hello.data() + 4, &sp32, 4);
    std::memcpy(hello.data() + 8, &bp32, 4);
    if (!cp->SendTypedFrame(cp->sock_, FrameType::HELLO, hello, 0)) {
      ::close(cp->sock_);
      cp->sock_ = -1;
      cp->failed_.store(false);  // handshake retry, not a peer failure
      cp->failure_ = PeerFailureReport{};
      soft_err = "hello send failed";
      continue;
    }
    // Await the HELLO_ACK: empty payload = admitted; non-empty = the
    // coordinator's structured rejection (version skew and friends).  The
    // wait is per-attempt (5 s, clamped to the budget): a connection
    // parked in a dead listener's backlog must recycle, not consume the
    // whole budget.
    long long ack_ms = std::min<long long>(
        static_cast<long long>(left * 1000), 5000);
    ack_ms = std::max<long long>(ack_ms, 100);
    timeval tv{};
    tv.tv_sec = static_cast<time_t>(ack_ms / 1000);
    tv.tv_usec = static_cast<suseconds_t>((ack_ms % 1000) * 1000);
    ::setsockopt(cp->sock_, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof(tv));
    char hdr_buf[kFrameHeaderBytes];
    FrameHeader ack;
    if (!RecvAll(cp->sock_, hdr_buf, kFrameHeaderBytes)) {
      ::close(cp->sock_);
      cp->sock_ = -1;
      soft_err = "no hello ack (dead, re-forming, or overloaded "
                 "coordinator)";
      continue;
    }
    DecodeFrameHeader(hdr_buf, &ack);
    if (ack.magic != kFrameMagic) {
      *err = "hello ack had a bad frame magic — corrupted stream or "
             "mixed-build coordinator";
      return nullptr;
    }
    std::string ack_body(ack.payload_len, '\0');
    if (ack.payload_len > kMaxFrameBytes ||
        (ack.payload_len > 0 &&
         !RecvAll(cp->sock_, ack_body.data(), ack_body.size()))) {
      ::close(cp->sock_);
      cp->sock_ = -1;
      soft_err = "truncated hello ack";
      continue;
    }
    if (ack.version != cp->wire_version_) {
      *err = "protocol version skew with the coordinator: this rank speaks "
             "v" + std::to_string(cp->wire_version_) +
             ", coordinator speaks v" + std::to_string(ack.version) +
             (ack_body.empty() ? "" : " (" + ack_body + ")");
      return nullptr;
    }
    if (ack.flags != cp->epoch_) {
      *err = "membership epoch skew with the coordinator: this rank speaks "
             "epoch " + std::to_string(cp->epoch_) + ", coordinator speaks "
             "epoch " + std::to_string(ack.flags) +
             " (an elastic reconfiguration happened; rejoin via JOIN)";
      return nullptr;
    }
    if (!ack_body.empty()) {
      *err = ack_body;  // coordinator's structured rejection
      return nullptr;
    }
    break;  // admitted
  }
  timeval zero{};
  ::setsockopt(cp->sock_, SOL_SOCKET, SO_RCVTIMEO, &zero, sizeof(zero));
  cp->last_rx_.assign(1, std::chrono::steady_clock::now());
  cp->failed_.store(false);
  return cp;
}

TcpControlPlane::~TcpControlPlane() {
  if (sock_ >= 0) ::close(sock_);
  for (int fd : worker_fds_)
    if (fd >= 0) ::close(fd);
  if (join_fd_ >= 0) ::close(join_fd_);
  if (listen_fd_ >= 0) ::close(listen_fd_);
  if (standby_listen_fd_ >= 0) ::close(standby_listen_fd_);
}

// ---------------------------------------------------------------------------
// Hardened frame I/O + liveness (docs/fault_tolerance.md)
// ---------------------------------------------------------------------------

void TcpControlPlane::NoteRx(int peer_rank) {
  int idx = PeerIndex(peer_rank);
  std::lock_guard<std::mutex> l(state_mu_);
  if (idx >= 0 && static_cast<size_t>(idx) < last_rx_.size()) {
    last_rx_[static_cast<size_t>(idx)] = std::chrono::steady_clock::now();
  }
}

double TcpControlPlane::SecondsSinceRx(int peer_rank) const {
  int idx = PeerIndex(peer_rank);
  std::lock_guard<std::mutex> l(state_mu_);
  if (idx < 0 || static_cast<size_t>(idx) >= last_rx_.size()) return 0;
  return std::chrono::duration<double>(
             std::chrono::steady_clock::now() -
             last_rx_[static_cast<size_t>(idx)])
      .count();
}

bool TcpControlPlane::PartitionActive() const {
  return fault_.mode == WireFaultSpec::Mode::PARTITION &&
         fault_.rank == rank_ && frames_sent_.load() >= fault_.frame;
}

void TcpControlPlane::RecordFailure(int peer_rank, const char* cause,
                                    std::string detail) {
  double silent = SecondsSinceRx(peer_rank);
  std::lock_guard<std::mutex> l(state_mu_);
  if (failed_.load()) return;  // first observation wins
  failure_.failed_rank = peer_rank;
  failure_.cause = cause;
  failure_.detail = std::move(detail);
  failure_.last_heard_us = static_cast<int64_t>(silent * 1e6);
  failed_.store(true);
}

void TcpControlPlane::RecordAbort(const PeerFailureReport& report) {
  std::lock_guard<std::mutex> l(state_mu_);
  if (failed_.load()) return;
  failure_ = report;
  if (failure_.detail.empty()) {
    failure_.detail = "abort broadcast by the coordinator";
  } else {
    failure_.detail += " (abort relayed by the coordinator)";
  }
  failed_.store(true);
}

void TcpControlPlane::RecordReconfig(const ReconfigInfo& info) {
  std::lock_guard<std::mutex> l(state_mu_);
  if (failed_.load()) return;  // a real failure verdict wins
  reconfig_ = info;
  // The failure record doubles as observability (hvd.failure_report()
  // still names the removed rank) and as the interrupt flag that breaks
  // blocked reads/polls; the engine consults GetReconfig FIRST.
  failure_.failed_rank = info.failed_rank;
  failure_.cause = info.cause.empty() ? "membership_reconfig" : info.cause;
  failure_.detail =
      "membership reconfiguration broadcast by the coordinator (epoch " +
      std::to_string(info.epoch) + ", new size " +
      std::to_string(info.new_size) + ")";
  reconfigured_.store(true);
  failed_.store(true);
}

bool TcpControlPlane::GetReconfig(ReconfigInfo* out) const {
  std::lock_guard<std::mutex> l(state_mu_);
  if (!reconfigured_.load()) return false;
  *out = reconfig_;
  return true;
}

bool TcpControlPlane::GetFailure(PeerFailureReport* out) const {
  std::lock_guard<std::mutex> l(state_mu_);
  if (!failed_.load()) return false;
  *out = failure_;
  return true;
}

bool TcpControlPlane::GetStandby(StandbyInfo* out) const {
  std::lock_guard<std::mutex> l(state_mu_);
  if (!has_standby_) return false;
  *out = standby_;
  return true;
}

bool TcpControlPlane::GetCoordState(CoordState* out) const {
  std::lock_guard<std::mutex> l(state_mu_);
  if (!has_coord_state_) return false;
  *out = coord_state_;
  return true;
}

void TcpControlPlane::SyncCoordState(const CoordState& state) {
  if (!coordinator_) return;
  int standby_rank;
  {
    std::lock_guard<std::mutex> l(state_mu_);
    if (!has_standby_) return;
    standby_rank = standby_.standby_rank;
    coord_state_ = state;  // the coordinator's own copy, for observability
    has_coord_state_ = true;
  }
  int idx = standby_rank - 1;
  if (idx < 0 || static_cast<size_t>(idx) >= worker_fds_.size()) return;
  int fd = worker_fds_[static_cast<size_t>(idx)];
  if (fd < 0) return;
  std::string payload;
  Serialize(state, &payload);
  // Best effort: a send failure here is a standby failure, recorded by
  // SendTypedFrame like any other peer death.
  SendTypedFrame(fd, FrameType::STATE, payload, standby_rank);
}

// Replicas a reader stopped polling must not balloon the host heap: past
// the cap the oldest entry is dropped (a newer shard supersedes it anyway).
constexpr size_t kShardInboxCap = 64;

bool TcpControlPlane::SendShard(const ShardPut& shard) {
  if (failed_.load()) return false;
  std::string payload;
  Serialize(shard, &payload);
  if (payload.size() > kMaxFrameBytes) return false;
  if (!coordinator_) {
    // Worker leg of the star: the coordinator relays to the target and
    // answers with the SHARD_ACK.
    return sock_ >= 0 &&
           SendTypedFrame(sock_, FrameType::SHARD_PUT, payload, 0);
  }
  // Coordinator-originated shard: deliver straight to the target (or into
  // its own inbox) and self-ack — the plane accepted it by definition.
  bool accepted = false;
  if (shard.target_rank == rank_) {
    std::lock_guard<std::mutex> l(state_mu_);
    shard_inbox_.push_back(shard);
    if (shard_inbox_.size() > kShardInboxCap) shard_inbox_.pop_front();
    accepted = true;
  } else {
    int idx = shard.target_rank - 1;
    if (idx < 0 || static_cast<size_t>(idx) >= worker_fds_.size()) {
      return false;
    }
    int fd = worker_fds_[static_cast<size_t>(idx)];
    if (fd < 0) return false;
    accepted =
        SendTypedFrame(fd, FrameType::SHARD_PUT, payload, shard.target_rank);
  }
  if (accepted) {
    ShardAck ack;
    ack.owner_rank = shard.owner_rank;
    ack.target_rank = shard.target_rank;
    ack.step = shard.step;
    ack.epoch = shard.epoch;
    std::lock_guard<std::mutex> l(state_mu_);
    shard_acks_.push_back(ack);
    if (shard_acks_.size() > kShardInboxCap) shard_acks_.pop_front();
  }
  return accepted;
}

bool TcpControlPlane::PollShard(ShardPut* out) {
  std::lock_guard<std::mutex> l(state_mu_);
  if (shard_inbox_.empty()) return false;
  *out = std::move(shard_inbox_.front());
  shard_inbox_.pop_front();
  return true;
}

void TcpControlPlane::RequeueShard(ShardPut&& shard) {
  std::lock_guard<std::mutex> l(state_mu_);
  shard_inbox_.push_front(std::move(shard));
}

bool TcpControlPlane::PollShardAck(ShardAck* out) {
  std::lock_guard<std::mutex> l(state_mu_);
  if (shard_acks_.empty()) return false;
  *out = shard_acks_.front();
  shard_acks_.pop_front();
  return true;
}

bool TcpControlPlane::RequestTicket(const TicketRequest& req) {
  if (failed_.load()) return false;
  if (coordinator_) {
    // The coordinator requesting a transfer authorizes itself: mint the
    // ticket straight into its own inbox, no wire round trip.
    IssueTicket(req);
    return true;
  }
  std::string payload;
  Serialize(req, &payload);
  return sock_ >= 0 &&
         SendTypedFrame(sock_, FrameType::TICKET_REQ, payload, 0);
}

bool TcpControlPlane::PollTicket(Ticket* out) {
  std::lock_guard<std::mutex> l(state_mu_);
  if (ticket_inbox_.empty()) return false;
  *out = std::move(ticket_inbox_.front());
  ticket_inbox_.pop_front();
  return true;
}

void TcpControlPlane::RequeueTicket(Ticket&& ticket) {
  std::lock_guard<std::mutex> l(state_mu_);
  ticket_inbox_.push_front(std::move(ticket));
}

void TcpControlPlane::IssueTicket(const TicketRequest& req) {
  Ticket t;
  t.transfer_id = next_transfer_id_.fetch_add(1);
  t.src_rank = req.src_rank;
  t.dst_rank = req.dst_rank;
  t.step = req.step;
  t.epoch = req.epoch;
  t.manifest = req.manifest;
  if (req.dst_rank >= 0 &&
      static_cast<size_t>(req.dst_rank) < bulk_ports_.size()) {
    t.dst_port = bulk_ports_[static_cast<size_t>(req.dst_rank)];
    t.dst_host = peer_hosts_[static_cast<size_t>(req.dst_rank)];
  }
  // dst_port stays 0 when the destination advertised no bulk listener:
  // the requester reads that as "no direct path, use the relay".
  t.token = BulkToken(t.transfer_id, t.epoch, t.src_rank, t.dst_rank);
  if (req.src_rank == rank_) {
    std::lock_guard<std::mutex> l(state_mu_);
    ticket_inbox_.push_back(std::move(t));
    if (ticket_inbox_.size() > kShardInboxCap) ticket_inbox_.pop_front();
    return;
  }
  int idx = req.src_rank - 1;
  if (idx < 0 || static_cast<size_t>(idx) >= worker_fds_.size()) return;
  int fd = worker_fds_[static_cast<size_t>(idx)];
  if (fd < 0) return;
  std::string payload;
  Serialize(t, &payload);
  SendTypedFrame(fd, FrameType::TICKET, payload, req.src_rank);
}

bool TcpControlPlane::HandleTicketFrame(FrameType t, const std::string& body,
                                        int from_rank) {
  if (t == FrameType::TICKET_REQ) {
    TicketRequest req;
    if (!Deserialize(body.data(), body.size(), &req)) {
      RecordFailure(from_rank, "frame_corrupt",
                    "undecodable TICKET_REQ frame from rank " +
                        std::to_string(from_rank));
      return false;
    }
    // Only the coordinator mints tickets; a TICKET_REQ that reaches a
    // worker (misrouted) is absorbed without effect.
    if (coordinator_) IssueTicket(req);
    return true;
  }
  Ticket ticket;
  if (!Deserialize(body.data(), body.size(), &ticket)) {
    RecordFailure(from_rank, "frame_corrupt",
                  "undecodable TICKET frame from rank " +
                      std::to_string(from_rank));
    return false;
  }
  std::lock_guard<std::mutex> l(state_mu_);
  ticket_inbox_.push_back(std::move(ticket));
  if (ticket_inbox_.size() > kShardInboxCap) ticket_inbox_.pop_front();
  return true;
}

bool TcpControlPlane::HandleShardFrame(FrameType t, const std::string& body,
                                       int from_rank) {
  if (t == FrameType::SHARD_ACK) {
    ShardAck ack;
    if (!Deserialize(body.data(), body.size(), &ack)) {
      RecordFailure(from_rank, "frame_corrupt",
                    "undecodable SHARD_ACK frame from rank " +
                        std::to_string(from_rank));
      return false;
    }
    std::lock_guard<std::mutex> l(state_mu_);
    shard_acks_.push_back(ack);
    if (shard_acks_.size() > kShardInboxCap) shard_acks_.pop_front();
    return true;
  }
  ShardPut shard;
  if (!Deserialize(body.data(), body.size(), &shard)) {
    RecordFailure(from_rank, "frame_corrupt",
                  "undecodable SHARD_PUT frame from rank " +
                      std::to_string(from_rank));
    return false;
  }
  ShardAck ack;
  ack.owner_rank = shard.owner_rank;
  ack.target_rank = shard.target_rank;
  ack.step = shard.step;
  ack.epoch = shard.epoch;
  bool accepted = false;
  if (coordinator_ && shard.target_rank != rank_) {
    // Relay leg of the star: forward to the target worker.  The ack means
    // "accepted by the control plane", not end-to-end delivery — a dead
    // target just loses its replica (the owner still has disk).
    int idx = shard.target_rank - 1;
    if (idx >= 0 && static_cast<size_t>(idx) < worker_fds_.size() &&
        worker_fds_[static_cast<size_t>(idx)] >= 0) {
      std::string payload;
      Serialize(shard, &payload);
      accepted = SendTypedFrame(worker_fds_[static_cast<size_t>(idx)],
                                FrameType::SHARD_PUT, payload,
                                shard.target_rank);
    }
  } else {
    std::lock_guard<std::mutex> l(state_mu_);
    shard_inbox_.push_back(std::move(shard));
    if (shard_inbox_.size() > kShardInboxCap) shard_inbox_.pop_front();
    accepted = true;
  }
  if (coordinator_ && accepted) {
    int oidx = from_rank - 1;
    if (oidx >= 0 && static_cast<size_t>(oidx) < worker_fds_.size() &&
        worker_fds_[static_cast<size_t>(oidx)] >= 0) {
      std::string payload;
      Serialize(ack, &payload);
      SendTypedFrame(worker_fds_[static_cast<size_t>(oidx)],
                     FrameType::SHARD_ACK, payload, from_rank);
    }
  }
  return true;
}

bool TcpControlPlane::SendTypedFrame(int fd, FrameType type,
                                     const std::string& payload,
                                     int peer_rank) {
  long long seq = frames_sent_.fetch_add(1);
  const bool faulty = fault_.mode != WireFaultSpec::Mode::NONE &&
                      fault_.rank == rank_ && seq >= fault_.frame;
  if (faulty) {
    switch (fault_.mode) {
      case WireFaultSpec::Mode::DROP:
      case WireFaultSpec::Mode::PARTITION:
        return true;  // the frame vanishes on the (simulated) wire
      case WireFaultSpec::Mode::HALFCLOSE:
        if (!halfclosed_.exchange(true)) {
          // Close our write side once: peers see a clean EOF mid-stream
          // while we keep reading — the classic half-open failure.
          if (sock_ >= 0) ::shutdown(sock_, SHUT_WR);
          for (int wfd : worker_fds_) {
            if (wfd >= 0) ::shutdown(wfd, SHUT_WR);
          }
        }
        return true;  // swallowed: the write side is gone
      default:
        break;
    }
  }
  FrameHeader h;
  h.version = wire_version_;
  h.type = static_cast<uint8_t>(type);
  h.flags = epoch_;  // every frame is stamped with the membership epoch
  h.payload_len = static_cast<uint32_t>(payload.size());
  h.crc32 = Crc32(payload.data(), payload.size());
  const std::string* body = &payload;
  std::string mangled;
  if (faulty && fault_.mode == WireFaultSpec::Mode::CORRUPT &&
      !corrupt_fired_.exchange(true)) {
    // Flip payload bits AFTER the checksum was computed: the receiver must
    // catch the mismatch, never deserialize the garbage.
    mangled = payload;
    if (mangled.empty()) {
      h.crc32 ^= 0xDEADBEEFu;  // empty payload: corrupt the checksum itself
    } else {
      mangled[mangled.size() / 2] =
          static_cast<char>(mangled[mangled.size() / 2] ^ 0x5A);
    }
    body = &mangled;
  }
  char hdr[kFrameHeaderBytes];
  EncodeFrameHeader(h, hdr);
  std::lock_guard<std::mutex> l(send_mu_);
  if (!SendAll(fd, hdr, kFrameHeaderBytes) ||
      !SendAll(fd, body->data(), body->size())) {
    RecordFailure(peer_rank, "connection_lost",
                  "control-plane send to rank " + std::to_string(peer_rank) +
                      " failed (" + std::strerror(errno) + ")");
    return false;
  }
  return true;
}

bool TcpControlPlane::RecvDataFrame(int fd, int peer_rank, FrameType expect,
                                    std::string* payload) {
  for (;;) {
    if (failed_.load()) return false;
    char hdr_buf[kFrameHeaderBytes];
    size_t got = 0;
    RecvResult rr = RecvSome(fd, hdr_buf, kFrameHeaderBytes, failed_, &got);
    if (rr == RecvResult::INTERRUPTED) return false;
    if (rr != RecvResult::OK) {
      RecordFailure(
          peer_rank, "connection_reset",
          rr == RecvResult::CLOSED
              ? (got == 0 ? "rank " + std::to_string(peer_rank) +
                                " closed the control-plane connection (EOF)"
                          : "control-plane stream from rank " +
                                std::to_string(peer_rank) +
                                " truncated mid-frame-header")
              : "control-plane recv from rank " + std::to_string(peer_rank) +
                    " failed (" + std::strerror(errno) + ")");
      return false;
    }
    FrameHeader h;
    DecodeFrameHeader(hdr_buf, &h);
    if (h.magic != kFrameMagic) {
      RecordFailure(peer_rank, "frame_desync",
                    "bad frame magic from rank " + std::to_string(peer_rank) +
                        " — corrupted stream or mixed-build peer");
      return false;
    }
    if (h.version != wire_version_) {
      RecordFailure(peer_rank, "version_skew",
                    "protocol version skew with rank " +
                        std::to_string(peer_rank) + ": local v" +
                        std::to_string(wire_version_) + ", peer v" +
                        std::to_string(h.version));
      return false;
    }
    if (h.flags != epoch_) {
      RecordFailure(peer_rank, "stale_epoch",
                    "frame from rank " + std::to_string(peer_rank) +
                        " stamped with membership epoch " +
                        std::to_string(h.flags) + " but this plane speaks "
                        "epoch " + std::to_string(epoch_) +
                        " (straggler from a pre-reconfiguration membership)");
      return false;
    }
    if (h.payload_len > kMaxFrameBytes) {
      RecordFailure(peer_rank, "frame_corrupt",
                    "absurd frame length from rank " +
                        std::to_string(peer_rank) + " (" +
                        std::to_string(h.payload_len) + " bytes)");
      return false;
    }
    std::string body(h.payload_len, '\0');
    if (h.payload_len > 0) {
      rr = RecvSome(fd, body.data(), body.size(), failed_, &got);
      if (rr == RecvResult::INTERRUPTED) return false;
      if (rr != RecvResult::OK) {
        RecordFailure(peer_rank, "connection_reset",
                      "control-plane stream from rank " +
                          std::to_string(peer_rank) +
                          " truncated mid-frame (got " + std::to_string(got) +
                          " of " + std::to_string(h.payload_len) + " bytes)");
        return false;
      }
    }
    if (Crc32(body.data(), body.size()) != h.crc32) {
      RecordFailure(peer_rank, "frame_corrupt",
                    "frame CRC mismatch from rank " +
                        std::to_string(peer_rank) +
                        " (wire corruption; frame type " +
                        std::to_string(h.type) + ", " +
                        std::to_string(h.payload_len) + " bytes)");
      return false;
    }
    if (PartitionActive()) continue;  // simulated partition: nothing lands
    NoteRx(peer_rank);
    frames_rx_.fetch_add(1, std::memory_order_relaxed);
    FrameType t = static_cast<FrameType>(h.type);
    if (t == FrameType::HEARTBEAT) continue;
    if (t == FrameType::STANDBY) {
      // Succession announcement: remember who the designated standby is
      // (and where it listens) and keep reading — this frame interleaves
      // with the response stream like a heartbeat.
      StandbyInfo info;
      if (Deserialize(body.data(), body.size(), &info)) {
        std::lock_guard<std::mutex> l(state_mu_);
        standby_ = info;
        has_standby_ = true;
      }
      continue;
    }
    if (t == FrameType::STATE) {
      // Coordinator-state replication delta (this rank is the standby):
      // newest frame wins; promotion reads it via GetCoordState.
      CoordState state;
      if (Deserialize(body.data(), body.size(), &state)) {
        std::lock_guard<std::mutex> l(state_mu_);
        coord_state_ = state;
        has_coord_state_ = true;
      }
      continue;
    }
    if (t == FrameType::SHARD_PUT || t == FrameType::SHARD_ACK) {
      // Peer-replicated checkpoint shards interleave with the response
      // stream like heartbeats; an undecodable one recorded a structured
      // frame_corrupt failure.
      if (!HandleShardFrame(t, body, peer_rank)) return false;
      continue;
    }
    if (t == FrameType::TICKET || t == FrameType::TICKET_REQ) {
      // Bulk-transfer tickets interleave the same way.
      if (!HandleTicketFrame(t, body, peer_rank)) return false;
      continue;
    }
    if (t == FrameType::ABORT) {
      PeerFailureReport report;
      if (Deserialize(body.data(), body.size(), &report)) {
        RecordAbort(report);
      } else {
        RecordFailure(peer_rank, "frame_corrupt",
                      "undecodable ABORT frame from rank " +
                          std::to_string(peer_rank));
      }
      return false;
    }
    if (t == FrameType::RECONFIG) {
      // Elastic membership change: the coordinator is reshaping the job
      // instead of tearing it down.  Recorded like a failure (the blocked
      // transport call returns false) but the engine consults GetReconfig
      // first and shrinks in place rather than exiting.
      ReconfigInfo info;
      if (Deserialize(body.data(), body.size(), &info)) {
        RecordReconfig(info);
      } else {
        RecordFailure(peer_rank, "frame_corrupt",
                      "undecodable RECONFIG frame from rank " +
                          std::to_string(peer_rank));
      }
      return false;
    }
    if (t != expect) {
      RecordFailure(peer_rank, "frame_desync",
                    "unexpected frame type " + std::to_string(h.type) +
                        " from rank " + std::to_string(peer_rank));
      return false;
    }
    *payload = std::move(body);
    return true;
  }
}

bool TcpControlPlane::HeartbeatTick(double timeout_s) {
  if (failed_.load()) return true;
  struct Peer {
    int fd;
    int rank;
  };
  std::vector<Peer> peers;
  if (coordinator_) {
    for (size_t i = 0; i < worker_fds_.size(); ++i) {
      peers.push_back({worker_fds_[i], static_cast<int>(i) + 1});
    }
  } else {
    peers.push_back({sock_, 0});
  }
  for (const Peer& p : peers) {
    if (p.fd < 0) continue;
    SendTypedFrame(p.fd, FrameType::HEARTBEAT, "", p.rank);
    if (failed_.load()) return true;
    if (SecondsSinceRx(p.rank) < timeout_s) continue;
    // Silent past the timeout — but only declare death if the silence is
    // real.  Bytes sitting unread in the socket buffer mean the peer is
    // alive and OUR cycle thread is just starved (TSAN/overload): skip.
    if (!PartitionActive()) {
      pollfd pfd{p.fd, POLLIN, 0};
      int pr = ::poll(&pfd, 1, 0);
      if (pr > 0 && (pfd.revents & POLLIN) != 0) {
        char probe;
        ssize_t r = ::recv(p.fd, &probe, 1, MSG_PEEK | MSG_DONTWAIT);
        if (r > 0) continue;  // frames pending: peer alive, reader starved
        if (r == 0) {
          RecordFailure(p.rank, "connection_reset",
                        "rank " + std::to_string(p.rank) +
                            " closed the control-plane connection (EOF)");
          return true;
        }
      }
    }
    RecordFailure(
        p.rank, "heartbeat_timeout",
        "no control-plane frames from rank " + std::to_string(p.rank) +
            " for " + std::to_string(timeout_s) +
            "s (HVD_TPU_HEARTBEAT_TIMEOUT_MS)");
    return true;
  }
  return failed_.load();
}

void TcpControlPlane::AbortPeers(const PeerFailureReport& report) {
  std::string payload;
  Serialize(report, &payload);
  if (coordinator_) {
    for (size_t i = 0; i < worker_fds_.size(); ++i) {
      if (worker_fds_[i] < 0) continue;
      // Best effort, the failed rank included: a half-open peer can still
      // read, and a dead one just errors the send (already recorded).
      SendTypedFrame(worker_fds_[i], FrameType::ABORT, payload,
                     static_cast<int>(i) + 1);
    }
  } else if (sock_ >= 0) {
    SendTypedFrame(sock_, FrameType::ABORT, payload, 0);
  }
}

void TcpControlPlane::BroadcastReconfig(const ReconfigInfo& info) {
  if (!coordinator_) return;
  std::string payload;
  Serialize(info, &payload);
  for (size_t i = 0; i < worker_fds_.size(); ++i) {
    if (worker_fds_[i] < 0) continue;
    // Best effort, the removed rank included: a live-but-misbehaving rank
    // learns it was expelled (new_ranks[r] == -1) and takes the legacy
    // restartable-exit path; a dead one just errors the send.
    SendTypedFrame(worker_fds_[i], FrameType::RECONFIG, payload,
                   static_cast<int>(i) + 1);
  }
}

int TcpControlPlane::PollJoinRequest() {
  if (!coordinator_) return -1;
  int lfd;
  {
    std::lock_guard<std::mutex> l(state_mu_);
    if (join_fd_ >= 0) return join_id_;  // parked, awaiting its ticket
    lfd = listen_fd_;
  }
  if (lfd < 0) return -1;
  pollfd pfd{lfd, POLLIN, 0};
  if (::poll(&pfd, 1, 0) <= 0 || (pfd.revents & POLLIN) == 0) return -1;
  int fd = ::accept(lfd, nullptr, nullptr);
  if (fd < 0) return -1;
  // Bounded read of the JOIN frame: a stray connection that never speaks
  // must not wedge the monitor thread.
  timeval tv{};
  tv.tv_sec = 1;
  ::setsockopt(fd, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof(tv));
  char hdr_buf[kFrameHeaderBytes];
  FrameHeader h;
  std::string body;
  if (!RecvAll(fd, hdr_buf, kFrameHeaderBytes)) {
    ::close(fd);
    return -1;
  }
  DecodeFrameHeader(hdr_buf, &h);
  if (h.magic != kFrameMagic ||
      h.type != static_cast<uint8_t>(FrameType::JOIN) ||
      h.payload_len != 4) {
    ::close(fd);  // not a joiner (port scanner, stale straggler): drop it
    return -1;
  }
  body.resize(4);
  if (!RecvAll(fd, body.data(), 4) || Crc32(body.data(), 4) != h.crc32) {
    ::close(fd);
    return -1;
  }
  int32_t id = -1;
  std::memcpy(&id, body.data(), 4);
  std::lock_guard<std::mutex> l(state_mu_);
  join_fd_ = fd;
  join_id_ = id;
  return id;
}

void TcpControlPlane::CloseListener() {
  std::lock_guard<std::mutex> l(state_mu_);
  if (listen_fd_ >= 0) {
    ::close(listen_fd_);
    listen_fd_ = -1;
  }
  // A promoted standby re-binds its succession listener's port as the new
  // coordinator's rendezvous socket, so it must be released here too.
  if (standby_listen_fd_ >= 0) {
    ::close(standby_listen_fd_);
    standby_listen_fd_ = -1;
  }
}

void TcpControlPlane::SendJoinTicket(const JoinTicket& ticket) {
  int fd;
  {
    std::lock_guard<std::mutex> l(state_mu_);
    fd = join_fd_;
    join_fd_ = -1;
    join_id_ = -1;
  }
  if (fd < 0) return;
  std::string payload;
  Serialize(ticket, &payload);
  SendTypedFrame(fd, FrameType::JOIN_ACK, payload, -1);
  ::close(fd);  // the joiner reconnects as a normal worker at the new epoch
}

bool TcpControlPlane::Exchange(const RequestList& send, ResponseList* recv) {
  std::string out;
  Serialize(send, &out);
  if (!SendTypedFrame(sock_, FrameType::REQUEST, out, 0)) return false;
  std::string in;
  if (!RecvDataFrame(sock_, 0, FrameType::RESPONSE, &in)) return false;
  if (!Deserialize(in.data(), in.size(), recv)) {
    RecordFailure(0, "frame_corrupt",
                  "ResponseList deserialization failed despite a valid "
                  "checksum (schema skew?)");
    return false;
  }
  return true;
}

namespace {
// Accumulates wall time minus declared waits into an atomic on scope exit —
// the "busy" component of a Gather/Broadcast that the fleet simulator
// composes into a modeled tick (poll() idle time is the members' think
// time, not coordinator work).
// Thread-CPU busy accounting: a blocking poll()/recv() consumes no CPU,
// so BusyMicros() reads as pure protocol work even when the host is
// oversubscribed (the fleet simulator runs hundreds of protocol
// processes on one core — wall-minus-waits there measures the scheduler,
// not the plane).
struct BusyScope {
  std::atomic<long long>& acc;
  long long c0 = wire::ThreadCpuMicros();
  ~BusyScope() {
    long long el = wire::ThreadCpuMicros() - c0;
    if (el > 0) acc.fetch_add(el, std::memory_order_relaxed);
  }
};
}  // namespace

bool TcpControlPlane::Gather(const RequestList& own,
                             std::vector<RequestList>* all) {
  BusyScope busy{busy_us_};
  // poll()-driven interleaved reads (round 5): the old loop recv'd
  // workers sequentially in fd order, so at large P a tick cost the SUM
  // of per-worker arrival latencies — measured past the 5 ms cycle
  // budget somewhere above ~128 workers (docs/benchmarks.md
  // control-plane scaling).  Draining whichever fd has bytes makes a
  // tick cost max(worker latency) + P * frame-copy instead: the
  // sequential-star analog of the reference's tree MPI_Gather
  // (reference operations.cc:1742-1850) without a protocol change.
  // HEARTBEAT frames interleave with the REQUEST stream and are consumed
  // here; every violation of the hardened framing becomes a structured
  // PeerFailureReport naming the worker.
  size_t n = worker_fds_.size();
  all->assign(n + 1, RequestList{});
  (*all)[0] = own;
  if (n == 0) return true;

  struct FrameState {
    FrameHeader hdr;
    char hdr_buf[kFrameHeaderBytes];
    size_t got = 0;          // bytes of the current stage received
    bool have_hdr = false;
    bool done = false;
    std::string buf;
  };
  std::vector<FrameState> st(n);
  std::vector<pollfd> pfds(n);
  std::vector<size_t> owner(n);  // pfds slot -> worker index
  size_t remaining = n;
  while (remaining > 0) {
    if (failed_.load()) return false;  // monitor thread saw a peer die
    nfds_t live = 0;
    for (size_t i = 0; i < n; ++i) {
      if (st[i].done) continue;
      pfds[live].fd = worker_fds_[i];
      pfds[live].events = POLLIN;
      pfds[live].revents = 0;
      owner[live] = i;
      ++live;
    }
    // Bounded poll so a failure recorded by the monitor thread (heartbeat
    // timeout on a silent-but-connected worker) interrupts the wait.
    int pr = ::poll(pfds.data(), live, 200);
    if (pr < 0) {
      if (errno == EINTR) continue;
      return false;
    }
    if (pr == 0) continue;
    for (nfds_t s = 0; s < live; ++s) {
      if ((pfds[s].revents & (POLLIN | POLLERR | POLLHUP | POLLNVAL)) == 0) {
        continue;
      }
      size_t i = owner[s];
      int wrank = static_cast<int>(i) + 1;
      if ((pfds[s].revents & POLLNVAL) != 0) {
        // The fd went invalid under us (closed mid-gather — e.g. a failover
        // or shutdown path tearing down the plane).  Without this branch
        // poll() returns instantly with POLLNVAL forever and the old
        // `revents & (POLLIN|POLLERR|POLLHUP)` mask skipped it: a 100% CPU
        // busy-spin that never finished the gather.  Fail structurally.
        RecordFailure(wrank, "connection_lost",
                      "control-plane socket for rank " +
                          std::to_string(wrank) +
                          " became invalid mid-gather (POLLNVAL)");
        return false;
      }
      FrameState& f = st[i];
      // Drain what is available without blocking; partial frames keep
      // their state until the fd is readable again.
      for (;;) {
        ssize_t r;
        if (!f.have_hdr) {
          r = ::recv(worker_fds_[i], f.hdr_buf + f.got,
                     kFrameHeaderBytes - f.got, MSG_DONTWAIT);
        } else {
          r = ::recv(worker_fds_[i], f.buf.data() + f.got,
                     f.hdr.payload_len - f.got, MSG_DONTWAIT);
        }
        if (r < 0) {
          if (errno == EINTR) continue;
          if (errno == EAGAIN || errno == EWOULDBLOCK) break;
          RecordFailure(wrank, "connection_reset",
                        "control-plane recv from rank " +
                            std::to_string(wrank) + " failed (" +
                            std::strerror(errno) + ")");
          return false;
        }
        if (r == 0) {  // peer closed — mid-frame close is a truncation
          RecordFailure(
              wrank, "connection_reset",
              f.got == 0 && !f.have_hdr
                  ? "rank " + std::to_string(wrank) +
                        " closed the control-plane connection (EOF)"
                  : "control-plane stream from rank " +
                        std::to_string(wrank) + " truncated mid-frame");
          return false;
        }
        f.got += static_cast<size_t>(r);
        if (!f.have_hdr) {
          if (f.got < kFrameHeaderBytes) continue;
          DecodeFrameHeader(f.hdr_buf, &f.hdr);
          if (f.hdr.magic != kFrameMagic) {
            RecordFailure(wrank, "frame_desync",
                          "bad frame magic from rank " +
                              std::to_string(wrank) +
                              " — corrupted stream or mixed-build peer");
            return false;
          }
          if (f.hdr.version != wire_version_) {
            RecordFailure(wrank, "version_skew",
                          "protocol version skew with rank " +
                              std::to_string(wrank) + ": local v" +
                              std::to_string(wire_version_) + ", peer v" +
                              std::to_string(f.hdr.version));
            return false;
          }
          if (f.hdr.flags != epoch_) {
            RecordFailure(wrank, "stale_epoch",
                          "frame from rank " + std::to_string(wrank) +
                              " stamped with membership epoch " +
                              std::to_string(f.hdr.flags) +
                              " but this plane speaks epoch " +
                              std::to_string(epoch_));
            return false;
          }
          if (f.hdr.payload_len > kMaxFrameBytes) {
            RecordFailure(wrank, "frame_corrupt",
                          "absurd frame length from rank " +
                              std::to_string(wrank) + " (" +
                              std::to_string(f.hdr.payload_len) + " bytes)");
            return false;
          }
          f.have_hdr = true;
          f.got = 0;
          f.buf.resize(f.hdr.payload_len);
          if (f.hdr.payload_len > 0) continue;
        } else if (f.got < f.hdr.payload_len) {
          continue;
        }
        // Full frame in hand: checksum, then demultiplex.
        if (Crc32(f.buf.data(), f.buf.size()) != f.hdr.crc32) {
          RecordFailure(wrank, "frame_corrupt",
                        "frame CRC mismatch from rank " +
                            std::to_string(wrank) +
                            " (wire corruption; frame type " +
                            std::to_string(f.hdr.type) + ", " +
                            std::to_string(f.hdr.payload_len) + " bytes)");
          return false;
        }
        FrameType t = static_cast<FrameType>(f.hdr.type);
        if (PartitionActive()) {  // simulated partition: nothing lands
          f = FrameState{};
          continue;
        }
        NoteRx(wrank);
        frames_rx_.fetch_add(1, std::memory_order_relaxed);
        if (t == FrameType::HEARTBEAT) {
          f = FrameState{};  // liveness only; keep draining this fd
          continue;
        }
        if (t == FrameType::SHARD_PUT || t == FrameType::SHARD_ACK) {
          // Checkpoint-shard relay (docs/fault_tolerance.md "Async &
          // peer-replicated checkpointing"): forward/accept and keep
          // draining — these interleave with REQUEST traffic.
          if (!HandleShardFrame(t, f.buf, wrank)) return false;
          f = FrameState{};
          continue;
        }
        if (t == FrameType::TICKET_REQ || t == FrameType::TICKET) {
          // Bulk-transfer ticket requests: issue and answer, keep draining.
          if (!HandleTicketFrame(t, f.buf, wrank)) return false;
          f = FrameState{};
          continue;
        }
        if (t != FrameType::REQUEST) {
          RecordFailure(wrank, "frame_desync",
                        "unexpected frame type " + std::to_string(f.hdr.type) +
                            " from rank " + std::to_string(wrank));
          return false;
        }
        if (!Deserialize(f.buf.data(), f.buf.size(), &(*all)[i + 1])) {
          RecordFailure(wrank, "frame_corrupt",
                        "RequestList deserialization from rank " +
                            std::to_string(wrank) +
                            " failed despite a valid checksum (schema "
                            "skew?)");
          return false;
        }
        f.done = true;
        --remaining;
        break;
      }
    }
  }
  return true;
}

bool TcpControlPlane::Broadcast(const ResponseList& out) {
  BusyScope busy{busy_us_};
  std::string payload;
  Serialize(out, &payload);
  for (size_t i = 0; i < worker_fds_.size(); ++i) {
    if (!SendTypedFrame(worker_fds_[i], FrameType::RESPONSE, payload,
                        static_cast<int>(i) + 1)) {
      return false;
    }
  }
  return true;
}

// ---------------------------------------------------------------------------
// ResponseCache (docs/response_cache.md)
// ---------------------------------------------------------------------------

void ResponseCache::SetCapacity(size_t capacity) {
  capacity_ = capacity;
  slots_.assign(capacity, Entry{});
  by_name_.clear();
  lru_.clear();
  free_.clear();
  free_.reserve(capacity);
  // Lowest position on top so fresh entries fill bits 0, 1, 2, ... — keeps
  // the wire bit vector as short as the working set.
  for (size_t i = capacity; i > 0; --i) {
    free_.push_back(static_cast<int32_t>(i - 1));
  }
}

uint64_t ResponseCache::Signature(const Request& req) {
  // FNV-1a, the PR-2 schedule-verifier hash (analysis/schedule.py).
  uint64_t h = 0xCBF29CE484222325ull;
  auto mix = [&h](const void* p, size_t n) {
    const unsigned char* b = static_cast<const unsigned char*>(p);
    for (size_t i = 0; i < n; ++i) {
      h = (h ^ b[i]) * 0x100000001B3ull;
    }
  };
  int8_t op = static_cast<int8_t>(req.op);
  int8_t dtype = static_cast<int8_t>(req.dtype);
  int8_t wire = static_cast<int8_t>(req.wire);
  mix(&op, 1);
  mix(&dtype, 1);
  mix(&wire, 1);
  mix(&req.root_rank, sizeof(req.root_rank));
  mix(req.name.data(), req.name.size());
  for (int64_t d : req.shape.dims) mix(&d, sizeof(d));
  return h;
}

ResponseCache::Lookup ResponseCache::Find(const Request& req,
                                          int32_t* bit) const {
  auto it = by_name_.find(req.name);
  if (it == by_name_.end()) return Lookup::MISS;
  const Entry& e = slots_[static_cast<size_t>(it->second)];
  if (e.signature != Signature(req)) return Lookup::STALE;
  *bit = it->second;
  return Lookup::HIT;
}

void ResponseCache::EvictSlot(int32_t bit) {
  Entry& e = slots_[static_cast<size_t>(bit)];
  if (!e.used) return;
  by_name_.erase(e.name);
  lru_.erase(e.lru_it);
  e = Entry{};
  stats.evictions++;
}

void ResponseCache::Store(int32_t bit, const std::string& name,
                          const Response& resp, uint64_t signature) {
  if (bit < 0 || static_cast<size_t>(bit) >= capacity_) return;
  Entry& e = slots_[static_cast<size_t>(bit)];
  if (e.used && e.name != name) {
    EvictSlot(bit);  // broadcast-driven eviction: same victim on every rank
  }
  if (!e.used) {
    // Claim the slot (it may come off the free list or from an eviction).
    auto fit = std::find(free_.begin(), free_.end(), bit);
    if (fit != free_.end()) free_.erase(fit);
    by_name_[name] = bit;
    lru_.push_front(bit);
    e.used = true;
    e.name = name;
    e.lru_it = lru_.begin();
  } else {
    lru_.splice(lru_.begin(), lru_, e.lru_it);
  }
  e.signature = signature;
  e.response = resp;
}

void ResponseCache::Erase(const std::string& name) {
  auto it = by_name_.find(name);
  if (it == by_name_.end()) return;
  int32_t bit = it->second;
  Entry& e = slots_[static_cast<size_t>(bit)];
  lru_.erase(e.lru_it);
  by_name_.erase(it);
  e = Entry{};
  free_.push_back(bit);
}

void ResponseCache::Clear() {
  size_t cap = capacity_;
  Stats keep = stats;
  SetCapacity(cap);
  stats = keep;
}

bool ResponseCache::Has(int32_t bit) const {
  return bit >= 0 && static_cast<size_t>(bit) < capacity_ &&
         slots_[static_cast<size_t>(bit)].used;
}

const Response& ResponseCache::At(int32_t bit) const {
  return slots_[static_cast<size_t>(bit)].response;
}

const std::string& ResponseCache::NameAt(int32_t bit) const {
  return slots_[static_cast<size_t>(bit)].name;
}

int32_t ResponseCache::BitOf(const std::string& name) const {
  auto it = by_name_.find(name);
  return it == by_name_.end() ? -1 : it->second;
}

void ResponseCache::Touch(int32_t bit) {
  Entry& e = slots_[static_cast<size_t>(bit)];
  if (e.used) lru_.splice(lru_.begin(), lru_, e.lru_it);
}

int32_t ResponseCache::AssignSlot(const std::string& name,
                                  const std::set<int32_t>& pinned) {
  auto it = by_name_.find(name);
  if (it != by_name_.end()) return it->second;  // overwrite in place
  if (!free_.empty()) {
    int32_t bit = free_.back();
    // Don't pop: Store() claims it (this keeps AssignSlot/Store idempotent
    // between the coordinator's decision and its own dispatch replay).
    // Reserve it by a provisional Store with an empty response so the next
    // AssignSlot in the same tick picks a different slot.
    Store(bit, name, Response{}, 0);
    return bit;
  }
  // LRU victim, oldest first, skipping pinned bits (in-flight bit
  // announcements from earlier ticks must stay resolvable).
  for (auto rit = lru_.rbegin(); rit != lru_.rend(); ++rit) {
    if (pinned.count(*rit) != 0) continue;
    int32_t bit = *rit;
    EvictSlot(bit);
    free_.push_back(bit);
    Store(bit, name, Response{}, 0);
    return bit;
  }
  return -1;  // everything pinned: skip caching this response
}

std::vector<int32_t> ResponseCache::LruOrder() const {
  return std::vector<int32_t>(lru_.begin(), lru_.end());
}

void ResponseCache::SetLruOrder(const std::vector<int32_t>& order) {
  // Restore the replicated recency order onto whatever is occupied locally:
  // mentioned bits move to the front in the given order; occupied bits the
  // snapshot missed (races between snapshot and store) keep their relative
  // order at the back.
  for (auto rit = order.rbegin(); rit != order.rend(); ++rit) {
    int32_t bit = *rit;
    if (bit < 0 || static_cast<size_t>(bit) >= capacity_) continue;
    Entry& e = slots_[static_cast<size_t>(bit)];
    if (e.used) lru_.splice(lru_.begin(), lru_, e.lru_it);
  }
}

// ---------------------------------------------------------------------------
// Coordinator negotiation (reference IncrementTensorCount +
// ConstructMPIResponse, operations.cc:282-307, 315-517)
// ---------------------------------------------------------------------------

Coordinator::Coordinator(int size, double stall_warning_seconds,
                         bool stall_check)
    : size_(size),
      stall_seconds_(stall_warning_seconds),
      stall_check_(stall_check),
      last_stall_warn_(std::chrono::steady_clock::now()),
      verify_streams_(static_cast<size_t>(size)) {}

void Coordinator::Ingest(const Request& req) {
  auto it = table_.find(req.name);
  if (it == table_.end()) {
    TensorRecord rec;
    rec.first = req;
    rec.ready.assign(static_cast<size_t>(size_), false);
    rec.first_dim_sizes.assign(static_cast<size_t>(size_), 0);
    rec.first_seen = std::chrono::steady_clock::now();
    it = table_.emplace(req.name, std::move(rec)).first;
    fifo_.push_back(req.name);
    if (timeline_ != nullptr) {
      timeline_->NegotiateStart(req.name, OpTypeName(req.op));
    }
  }
  TensorRecord& rec = it->second;
  if (req.rank < 0 || req.rank >= size_) return;
  if (rec.ready[static_cast<size_t>(req.rank)]) {
    rec.error = "Duplicate request for tensor " + req.name + " from rank " +
                std::to_string(req.rank) + " before completion.";
    return;
  }
  rec.ready[static_cast<size_t>(req.rank)] = true;
  rec.ready_count++;
  if (timeline_ != nullptr) {
    timeline_->NegotiateRankReady(req.name, req.rank);
  }
  if (!req.shape.dims.empty()) {
    rec.first_dim_sizes[static_cast<size_t>(req.rank)] = req.shape.dims[0];
  }
  // Cross-rank consistency checks — these become coordinated ERROR responses
  // on every rank instead of hangs (reference operations.cc:360-460).
  std::ostringstream err;
  if (req.op != rec.first.op) {
    err << "Mismatched collective ops for tensor " << req.name << ": rank "
        << req.rank << " requested " << OpTypeName(req.op) << " but rank "
        << rec.first.rank << " requested " << OpTypeName(rec.first.op) << ".";
  } else if (req.dtype != rec.first.dtype) {
    err << "Mismatched dtypes for tensor " << req.name << ": rank "
        << req.rank << " sent " << DataTypeName(req.dtype) << " but rank "
        << rec.first.rank << " sent " << DataTypeName(rec.first.dtype) << ".";
  } else if (req.wire != rec.first.wire) {
    err << "Mismatched wire formats for tensor " << req.name << ": rank "
        << req.rank << " sent " << WireFormatName(req.wire) << " but rank "
        << rec.first.rank << " sent " << WireFormatName(rec.first.wire)
        << ".";
  } else if (req.op == OpType::BROADCAST &&
             req.root_rank != rec.first.root_rank) {
    err << "Mismatched root ranks for broadcast " << req.name << ": rank "
        << req.rank << " used root " << req.root_rank << " but rank "
        << rec.first.rank << " used root " << rec.first.root_rank << ".";
  } else if ((req.op == OpType::ALLREDUCE || req.op == OpType::BROADCAST) &&
             req.shape != rec.first.shape) {
    err << "Mismatched shapes for " << OpTypeName(req.op) << " " << req.name
        << ": rank " << req.rank << " sent " << req.shape.DebugString()
        << " but rank " << rec.first.rank << " sent "
        << rec.first.shape.DebugString() << ".";
  } else if ((req.op == OpType::ALLGATHER || req.op == OpType::ALLTOALL) &&
             (req.shape.dims.size() != rec.first.shape.dims.size() ||
              !std::equal(req.shape.dims.begin() + (req.shape.dims.empty() ? 0 : 1),
                          req.shape.dims.end(),
                          rec.first.shape.dims.begin() + (rec.first.shape.dims.empty() ? 0 : 1)))) {
    err << "Mismatched trailing shapes for " << OpTypeName(req.op) << " "
        << req.name
        << " (only dim 0 may differ): rank " << req.rank << " sent "
        << req.shape.DebugString() << " but rank " << rec.first.rank
        << " sent " << rec.first.shape.DebugString() << ".";
  }
  std::string e = err.str();
  if (!e.empty() && rec.error.empty()) rec.error = e;
}

Response Coordinator::Finalize(const std::string& name) {
  TensorRecord& rec = table_.at(name);
  if (timeline_ != nullptr) timeline_->NegotiateEnd(name);
  Response resp;
  resp.tensor_names.push_back(name);
  if (!rec.error.empty()) {
    resp.type = Response::Type::ERROR;
    resp.error_reason = rec.error;
  } else {
    switch (rec.first.op) {
      case OpType::ALLREDUCE: resp.type = Response::Type::ALLREDUCE; break;
      case OpType::ALLGATHER:
        resp.type = Response::Type::ALLGATHER;
        resp.first_dim_sizes = rec.first_dim_sizes;
        break;
      case OpType::BROADCAST: resp.type = Response::Type::BROADCAST; break;
      case OpType::ALLTOALL:
        // Executors ragged-gather alltoall payloads exactly like allgather;
        // the per-rank dim-0 sizes locate each rank's block in the concat.
        resp.type = Response::Type::ALLTOALL;
        resp.first_dim_sizes = rec.first_dim_sizes;
        break;
      case OpType::BARRIER: resp.type = Response::Type::BARRIER; break;
    }
  }
  return resp;
}

void Coordinator::IngestVerify(int rank,
                               const std::vector<VerifyEntry>& entries) {
  if (rank < 0 || rank >= size_) return;
  auto& stream = verify_streams_[static_cast<size_t>(rank)];
  for (const auto& e : entries) {
    if (e.seq < verify_checked_) continue;  // already matched and pruned
    stream.push_back(e);
  }
}

std::vector<DivergenceEntry> Coordinator::CheckDivergence() {
  if (!divergence_.empty()) return divergence_;  // sticky
  for (;;) {
    // One seq per pass: compare only when EVERY rank has reported it.
    for (const auto& stream : verify_streams_) {
      if (stream.empty() || stream.front().seq != verify_checked_) {
        return {};
      }
    }
    const uint64_t h0 = verify_streams_[0].front().hash;
    bool match = true;
    for (const auto& stream : verify_streams_) {
      if (stream.front().hash != h0) match = false;
    }
    if (!match) {
      for (int r = 0; r < size_; ++r) {
        const VerifyEntry& e = verify_streams_[static_cast<size_t>(r)].front();
        DivergenceEntry d;
        d.rank = r;
        d.seq = e.seq;
        d.hash = e.hash;
        d.desc = e.desc;
        divergence_.push_back(std::move(d));
      }
      return divergence_;
    }
    for (auto& stream : verify_streams_) stream.pop_front();
    ++verify_checked_;
  }
}

ResponseList Coordinator::Tick(const std::vector<RequestList>& gathered) {
  ResponseList out;
  // 1. Coordinated invalidation FIRST: a rank that saw its local signature
  // change sent the name here (plus a full Request below).  The entry must
  // die on every rank in this same tick, and any other rank's in-flight bit
  // announcement for it converts back to a full re-announcement (the
  // announcing rank replays it from bit_announced_ on dispatch).
  if (cache_ != nullptr && cache_->enabled()) {
    for (const auto& list : gathered) {
      for (const auto& name : list.cache_invalidate) {
        int32_t bit = cache_->BitOf(name);
        if (bit < 0) continue;  // another rank already invalidated it
        cache_->Erase(name);
        pending_bits_.erase(bit);
        out.cache_invalidate.push_back(name);
      }
    }
  }
  for (size_t rank = 0; rank < gathered.size(); ++rank) {
    const auto& list = gathered[rank];
    if (list.shutdown) out.shutdown = true;
    // 2. Bit-vector intersection: count which ranks re-announced each
    // cached entry.  Bits whose entry died this tick are dropped — the
    // announcing rank re-queues the full Request when the invalidation
    // broadcast reaches it.
    if (cache_ != nullptr && cache_->enabled()) {
      for (int32_t bit : list.cache_hits) {
        if (!cache_->Has(bit)) continue;
        BitRecord& rec = pending_bits_[bit];
        if (rec.ready.empty()) {
          rec.ready.assign(static_cast<size_t>(size_), false);
          rec.first_seen = std::chrono::steady_clock::now();
        }
        if (rank < rec.ready.size() && !rec.ready[rank]) {
          rec.ready[rank] = true;
          rec.ready_count++;
        }
      }
    }
    for (const auto& req : list.requests) {
      if (cache_ != nullptr && cache_->enabled()) {
        int32_t bit = cache_->BitOf(req.name);
        if (bit >= 0) {
          // Full metadata for a name still in cache: the sender either
          // flagged it stale (already flushed above, so BitOf misses) or
          // runs with a different/disabled cache capacity.  Either way the
          // entry cannot be served coherently any more — flush it on every
          // rank and fall back to full negotiation, instead of deadlocking
          // this request against the other ranks' bit announcements.
          cache_->Erase(req.name);
          pending_bits_.erase(bit);
          out.cache_invalidate.push_back(req.name);
        }
      }
      Ingest(req);
    }
    if (!list.verify.empty()) {
      IngestVerify(static_cast<int>(rank), list.verify);
    }
  }
  // 3. Emit fully-intersected cached entries before the negotiated ones —
  // they are the latency-sensitive steady state, and the response is just
  // the bit (every rank expands it from its replica, no re-validation).
  for (auto it = pending_bits_.begin(); it != pending_bits_.end();) {
    if (it->second.ready_count >= size_) {
      Response resp;
      resp.cache_bit = it->first;
      cache_->Touch(it->first);
      out.responses.push_back(std::move(resp));
      it = pending_bits_.erase(it);
    } else {
      ++it;
    }
  }
  // Emit ready tensors in first-announcement order; unready tensors remain.
  // IMPORTANT: even errored tensors wait for ALL ranks to announce — if the
  // ERROR response fired early, ranks that enqueue late would miss it and
  // hang forever waiting for peers that already errored out (the reference
  // likewise constructs responses only once the count completes,
  // operations.cc:315-517).
  std::vector<std::string> remaining;
  remaining.reserve(fifo_.size());
  // Bits still partially announced are pinned: the LRU victim scan must not
  // evict an entry some rank already committed to by bit.
  std::set<int32_t> pinned;
  for (const auto& [bit, rec] : pending_bits_) pinned.insert(bit);
  for (const auto& name : fifo_) {
    auto it = table_.find(name);
    if (it == table_.end()) continue;
    TensorRecord& rec = it->second;
    if (rec.ready_count >= size_) {
      Response resp = Finalize(name);
      // 4. Freshly negotiated success → pick the replica slot every rank
      // stores it into (cache-populate path; errors are never cached).
      if (cache_ != nullptr && cache_->enabled() &&
          resp.type != Response::Type::ERROR) {
        resp.store_bit = cache_->AssignSlot(name, pinned);
      }
      out.responses.push_back(std::move(resp));
      table_.erase(it);
    } else {
      remaining.push_back(name);
    }
  }
  fifo_ = std::move(remaining);
  return out;
}

std::vector<StallEntry> Coordinator::StalledTensors() const {
  std::vector<StallEntry> out;
  if (!stall_check_ || (table_.empty() && pending_bits_.empty())) return out;
  auto now = std::chrono::steady_clock::now();
  for (const auto& name : fifo_) {
    auto it = table_.find(name);
    if (it == table_.end()) continue;
    const TensorRecord& rec = it->second;
    double waited =
        std::chrono::duration<double>(now - rec.first_seen).count();
    if (waited < stall_seconds_) continue;
    StallEntry e;
    e.name = name;
    e.waited_seconds = waited;
    for (int r = 0; r < size_; ++r) {
      if (!rec.ready[static_cast<size_t>(r)]) e.missing_ranks.push_back(r);
    }
    out.push_back(std::move(e));
  }
  // Cache-hit announcements waiting on missing ranks stall exactly like
  // full requests; resolve the bit back to its tensor name for the report.
  for (const auto& [bit, rec] : pending_bits_) {
    double waited =
        std::chrono::duration<double>(now - rec.first_seen).count();
    if (waited < stall_seconds_) continue;
    StallEntry e;
    e.name = (cache_ != nullptr && cache_->Has(bit))
                 ? cache_->NameAt(bit)
                 : "<cache bit " + std::to_string(bit) + ">";
    e.waited_seconds = waited;
    for (int r = 0; r < size_; ++r) {
      if (static_cast<size_t>(r) >= rec.ready.size() ||
          !rec.ready[static_cast<size_t>(r)]) {
        e.missing_ranks.push_back(r);
      }
    }
    out.push_back(std::move(e));
  }
  return out;
}

double Coordinator::OldestPendingSeconds() const {
  if (table_.empty() && pending_bits_.empty()) return 0;
  auto now = std::chrono::steady_clock::now();
  double oldest = 0;
  for (const auto& [name, rec] : table_) {
    double waited =
        std::chrono::duration<double>(now - rec.first_seen).count();
    if (waited > oldest) oldest = waited;
  }
  for (const auto& [bit, rec] : pending_bits_) {
    double waited =
        std::chrono::duration<double>(now - rec.first_seen).count();
    if (waited > oldest) oldest = waited;
  }
  return oldest;
}

std::string Coordinator::CheckStalled() {
  if (!stall_check_ || (table_.empty() && pending_bits_.empty())) return "";
  auto now = std::chrono::steady_clock::now();
  if (std::chrono::duration<double>(now - last_stall_warn_).count() <
      stall_seconds_) {
    return "";
  }
  std::vector<StallEntry> stalled = StalledTensors();
  if (stalled.empty()) return "";
  std::ostringstream msg;
  msg << "One or more tensors were submitted to be reduced, gathered or "
         "broadcasted by subset of ranks and are waiting for remainder of "
         "ranks for more than " << static_cast<int>(stall_seconds_)
      << " seconds. This may indicate that different ranks are trying to "
         "submit different tensors or that only subset of ranks is "
         "submitting tensors, which will cause deadlock.\n";
  for (const auto& e : stalled) {
    msg << "Stalled op: " << e.name << " [missing ranks:";
    for (int r : e.missing_ranks) msg << " " << r;
    msg << "]\n";
  }
  last_stall_warn_ = now;
  return msg.str();
}

}  // namespace hvd
