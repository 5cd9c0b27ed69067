// Hierarchical coordinator tree (tree.h) — topology planning, associative
// request combining, the root/member planes, and the relay aggregator
// process.  Wire protocol and hardening are identical to controller.cc's
// star transport (hardened frames, epoch stamps, structured failures);
// only the fan-in shape changes.
#include "tree.h"

#include <arpa/inet.h>
#include <fcntl.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <poll.h>
#include <sys/socket.h>
#include <unistd.h>

#include <algorithm>
#include <cerrno>
#include <cstdio>
#include <cstring>
#include <set>

#include "wire.h"

namespace hvd {

namespace {

using Clock = std::chrono::steady_clock;

long long MsSince(Clock::time_point t) {
  return std::chrono::duration_cast<std::chrono::milliseconds>(Clock::now() -
                                                               t)
      .count();
}

long long EnvLL(const char* name, long long dflt) {
  const char* v = ::getenv(name);
  if (v == nullptr || *v == '\0') return dflt;
  return ::atoll(v);
}

// AGG_STATE sentinel seq: "the primary exited cleanly — stand down".  Real
// seqs start at 1, so negatives are free for control.
constexpr int64_t kShutdownSeq = -2;

// Busy-time accounting (the controller.cc twin): wall time minus declared
// poll waits, accumulated on scope exit.  The fleet simulator composes
// these per-tier busy numbers into a modeled critical-path tick — on a
// single host, wall-clock at 4096 ranks would measure the scheduler, not
// the protocol.
// Thread-CPU busy accounting (see controller.cc's BusyScope): blocking
// waits consume no CPU, so the fleet simulator's per-tier numbers stay
// honest even with hundreds of protocol processes on one core.
struct BusyScope {
  std::atomic<long long>& acc;
  long long c0 = wire::ThreadCpuMicros();
  ~BusyScope() {
    long long el = wire::ThreadCpuMicros() - c0;
    if (el > 0) acc.fetch_add(el, std::memory_order_relaxed);
  }
};

// Single-threaded sibling (the relay is one thread; no atomics needed).
struct PlainBusy {
  long long& acc;
  long long c0 = wire::ThreadCpuMicros();
  ~PlainBusy() {
    long long el = wire::ThreadCpuMicros() - c0;
    if (el > 0) acc += el;
  }
};

bool SendFrame(int fd, FrameType type, const std::string& payload,
               uint16_t epoch, uint8_t version, std::mutex* mu) {
  if (fd < 0) return false;
  FrameHeader h;
  h.version = version;
  h.type = static_cast<uint8_t>(type);
  h.flags = epoch;
  h.payload_len = static_cast<uint32_t>(payload.size());
  h.crc32 = Crc32(payload.data(), payload.size());
  char hdr[kFrameHeaderBytes];
  EncodeFrameHeader(h, hdr);
  std::unique_lock<std::mutex> l;
  if (mu != nullptr) l = std::unique_lock<std::mutex>(*mu);
  return wire::SendAll(fd, hdr, kFrameHeaderBytes) &&
         wire::SendAll(fd, payload.data(), payload.size());
}

// Incremental hardened-frame reader: MSG_DONTWAIT drains that keep state
// across poll iterations (and across Gather/Exchange calls — a heartbeat
// can be half-read when a call returns).  Validation mirrors the star's
// Gather state machine: magic, version, epoch, length cap, CRC.
struct FrameReader {
  FrameHeader hdr{};
  char hdr_buf[kFrameHeaderBytes];
  size_t got = 0;
  bool have_hdr = false;
  std::string body;

  enum class St { READY, AGAIN, CLOSED, BAD };

  void Reset() {
    got = 0;
    have_hdr = false;
    body.clear();
  }

  St Drain(int fd, uint16_t epoch, uint8_t version, std::string* why) {
    for (;;) {
      if (!have_hdr) {
        ssize_t r =
            ::recv(fd, hdr_buf + got, kFrameHeaderBytes - got, MSG_DONTWAIT);
        if (r < 0) {
          if (errno == EINTR) continue;
          if (errno == EAGAIN || errno == EWOULDBLOCK) return St::AGAIN;
          *why = std::strerror(errno);
          return St::BAD;
        }
        if (r == 0) return St::CLOSED;
        got += static_cast<size_t>(r);
        if (got < kFrameHeaderBytes) continue;
        DecodeFrameHeader(hdr_buf, &hdr);
        if (hdr.magic != kFrameMagic) {
          *why = "bad frame magic (corrupted stream or mixed-build peer)";
          return St::BAD;
        }
        if (hdr.version != version) {
          *why = "protocol version skew (local v" + std::to_string(version) +
                 ", peer v" + std::to_string(hdr.version) + ")";
          return St::BAD;
        }
        if (hdr.flags != epoch) {
          *why = "stale membership epoch " + std::to_string(hdr.flags);
          return St::BAD;
        }
        if (hdr.payload_len > wire::kMaxFrameBytes) {
          *why = "absurd frame length " + std::to_string(hdr.payload_len);
          return St::BAD;
        }
        have_hdr = true;
        got = 0;
        body.assign(hdr.payload_len, '\0');
        if (hdr.payload_len > 0) continue;
      } else if (got < hdr.payload_len) {
        ssize_t r = ::recv(fd, &body[0] + got, hdr.payload_len - got,
                           MSG_DONTWAIT);
        if (r < 0) {
          if (errno == EINTR) continue;
          if (errno == EAGAIN || errno == EWOULDBLOCK) return St::AGAIN;
          *why = std::strerror(errno);
          return St::BAD;
        }
        if (r == 0) {
          *why = "stream truncated mid-frame";
          return St::BAD;
        }
        got += static_cast<size_t>(r);
        if (got < hdr.payload_len) continue;
      }
      if (Crc32(body.data(), body.size()) != hdr.crc32) {
        *why = "frame CRC mismatch (wire corruption)";
        return St::BAD;
      }
      return St::READY;
    }
  }
};

// One connect + HELLO + HELLO_ACK attempt.  Returns the connected fd,
// -1 on a retryable failure (refused, no ack), -2 on a structured
// rejection (version/epoch skew — retrying cannot help).
int ConnectHello(const TreeEndpoint& ep, int wire_rank, uint16_t epoch,
                 uint8_t version, long long ack_wait_ms, std::string* why) {
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_port = htons(static_cast<uint16_t>(ep.port));
  if (::inet_pton(AF_INET, ep.host.c_str(), &addr.sin_addr) != 1) {
    *why = "bad aggregator address " + ep.host;
    return -2;
  }
  int fd = ::socket(AF_INET, SOCK_STREAM, 0);
  if (fd < 0) {
    *why = "socket() failed";
    return -1;
  }
  int one = 1;
  ::setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
  if (::connect(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) != 0) {
    ::close(fd);
    *why = "connect refused/unreachable";
    return -1;
  }
  std::string hello(12, '\0');
  int32_t r32 = wire_rank;
  std::memcpy(&hello[0], &r32, 4);  // standby/bulk port fields stay 0
  if (!SendFrame(fd, FrameType::HELLO, hello, epoch, version, nullptr)) {
    ::close(fd);
    *why = "hello send failed";
    return -1;
  }
  timeval tv{};
  tv.tv_sec = static_cast<time_t>(ack_wait_ms / 1000);
  tv.tv_usec = static_cast<suseconds_t>((ack_wait_ms % 1000) * 1000);
  ::setsockopt(fd, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof(tv));
  char hdr_buf[kFrameHeaderBytes];
  if (!wire::RecvAll(fd, hdr_buf, kFrameHeaderBytes)) {
    ::close(fd);
    *why = "no hello ack (dead or promoting aggregator)";
    return -1;
  }
  FrameHeader ack;
  DecodeFrameHeader(hdr_buf, &ack);
  if (ack.magic != kFrameMagic) {
    ::close(fd);
    *why = "hello ack had a bad frame magic";
    return -2;
  }
  std::string ack_body(ack.payload_len, '\0');
  if (ack.payload_len > wire::kMaxFrameBytes ||
      (ack.payload_len > 0 &&
       !wire::RecvAll(fd, &ack_body[0], ack_body.size()))) {
    ::close(fd);
    *why = "truncated hello ack";
    return -1;
  }
  if (ack.version != version || ack.flags != epoch) {
    ::close(fd);
    *why = "version/epoch skew with the aggregator" +
           (ack_body.empty() ? std::string() : " (" + ack_body + ")");
    return -2;
  }
  if (!ack_body.empty()) {
    ::close(fd);
    *why = ack_body;
    return -2;
  }
  timeval zero{};
  ::setsockopt(fd, SOL_SOCKET, SO_RCVTIMEO, &zero, sizeof(zero));
  return fd;
}

// Accept one pending connection (non-blocking listener) and complete the
// HELLO handshake, bounded by wait_ms.  Returns the admitted fd with
// *wire_rank_out set; -1 when nothing usable was pending (garbage and
// skewed peers are answered/closed here).
int AcceptHello(int listen_fd, uint16_t epoch, uint8_t version,
                long long wait_ms, int* wire_rank_out) {
  int fd = ::accept(listen_fd, nullptr, nullptr);
  if (fd < 0) return -1;
  int one = 1;
  ::setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
  timeval tv{};
  tv.tv_sec = static_cast<time_t>(wait_ms / 1000);
  tv.tv_usec = static_cast<suseconds_t>((wait_ms % 1000) * 1000);
  ::setsockopt(fd, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof(tv));
  char hdr_buf[kFrameHeaderBytes];
  if (!wire::RecvAll(fd, hdr_buf, kFrameHeaderBytes)) {
    ::close(fd);
    return -1;
  }
  FrameHeader h;
  DecodeFrameHeader(hdr_buf, &h);
  if (h.magic != kFrameMagic ||
      h.type != static_cast<uint8_t>(FrameType::HELLO) ||
      (h.payload_len != 8 && h.payload_len != 12)) {
    ::close(fd);
    return -1;
  }
  if (h.version != version) {
    SendFrame(fd, FrameType::HELLO_ACK,
              "protocol version skew: this tier speaks v" +
                  std::to_string(version) + ", peer speaks v" +
                  std::to_string(h.version),
              epoch, version, nullptr);
    ::close(fd);
    return -1;
  }
  if (h.flags != epoch) {
    std::fprintf(stderr,
                 "WARNING: horovod_tpu tree tier rejected a stale-epoch "
                 "hello (peer epoch %u, membership epoch %u)\n",
                 static_cast<unsigned>(h.flags),
                 static_cast<unsigned>(epoch));
    ::close(fd);
    return -1;
  }
  std::string body(h.payload_len, '\0');
  if (!wire::RecvAll(fd, &body[0], body.size()) ||
      Crc32(body.data(), body.size()) != h.crc32) {
    ::close(fd);
    return -1;
  }
  int32_t wr = 0;
  std::memcpy(&wr, body.data(), 4);
  if (!SendFrame(fd, FrameType::HELLO_ACK, "", epoch, version, nullptr)) {
    ::close(fd);
    return -1;
  }
  timeval zero{};
  ::setsockopt(fd, SOL_SOCKET, SO_RCVTIMEO, &zero, sizeof(zero));
  *wire_rank_out = wr;
  return fd;
}

void SetNonBlocking(int fd) {
  int fl = ::fcntl(fd, F_GETFL, 0);
  ::fcntl(fd, F_SETFL, fl | O_NONBLOCK);
}

}  // namespace

// ---------------------------------------------------------------------------
// Topology
// ---------------------------------------------------------------------------

TreePlan PlanTree(int size, int fanout, int threshold, int enable) {
  TreePlan p;
  p.size = size < 1 ? 1 : size;
  // Star below the threshold (bit-for-bit the existing plane): a tree
  // needs at least rank 0 + two workers to aggregate anything, a sane
  // fanout, and the operator's opt-in.
  if (enable == 0 || fanout < 2 || p.size < 3 || p.size < threshold) {
    return p;
  }
  p.fanout = fanout;
  p.num_groups = (p.size - 2) / fanout + 1;  // ceil((size-1)/fanout)
  p.depth = 2;
  p.active = true;
  return p;
}

int TreeGroupOf(int rank, const TreePlan& plan) {
  if (!plan.active || rank < 1) return -1;
  return (rank - 1) / plan.fanout;
}

std::vector<int> TreeMembersOf(int group, const TreePlan& plan) {
  std::vector<int> out;
  if (!plan.active || group < 0 || group >= plan.num_groups) return out;
  int lo = group * plan.fanout + 1;
  int hi = std::min(plan.size - 1, (group + 1) * plan.fanout);
  for (int r = lo; r <= hi; ++r) out.push_back(r);
  return out;
}

bool ParseAggMap(const char* spec, int num_groups,
                 std::vector<std::pair<TreeEndpoint, TreeEndpoint>>* out) {
  out->assign(static_cast<size_t>(num_groups < 0 ? 0 : num_groups), {});
  if (spec == nullptr || *spec == '\0' || num_groups <= 0) return false;
  std::vector<bool> seen(static_cast<size_t>(num_groups), false);
  std::string s(spec);
  size_t pos = 0;
  auto parse_ep = [](const std::string& tok, TreeEndpoint* ep) {
    size_t c = tok.rfind(':');
    if (c == std::string::npos || c == 0 || c + 1 >= tok.size()) return false;
    ep->host = tok.substr(0, c);
    ep->port = ::atoi(tok.c_str() + c + 1);
    return ep->port > 0;
  };
  while (pos < s.size()) {
    size_t comma = s.find(',', pos);
    std::string entry =
        s.substr(pos, comma == std::string::npos ? std::string::npos
                                                 : comma - pos);
    pos = comma == std::string::npos ? s.size() : comma + 1;
    if (entry.empty()) continue;
    size_t eq = entry.find('=');
    if (eq == std::string::npos) return false;
    int g = ::atoi(entry.substr(0, eq).c_str());
    if (g < 0 || g >= num_groups) return false;
    std::string eps = entry.substr(eq + 1);
    size_t bar = eps.find('|');
    TreeEndpoint primary, standby;
    if (!parse_ep(bar == std::string::npos ? eps : eps.substr(0, bar),
                  &primary)) {
      return false;
    }
    if (bar != std::string::npos &&
        !parse_ep(eps.substr(bar + 1), &standby)) {
      return false;
    }
    (*out)[static_cast<size_t>(g)] = {primary, standby};
    seen[static_cast<size_t>(g)] = true;
  }
  for (bool b : seen) {
    if (!b) return false;  // every group needs an endpoint
  }
  return true;
}

// ---------------------------------------------------------------------------
// Associative combining
// ---------------------------------------------------------------------------

AggRequestList CombineMemberRequests(int32_t agg_id, int64_t seq,
                                     const std::vector<int>& members,
                                     const std::vector<RequestList>& lists) {
  AggRequestList agg;
  agg.agg_id = agg_id;
  agg.seq = seq;
  agg.members.reserve(members.size());
  for (int m : members) agg.members.push_back(static_cast<int32_t>(m));
  if (lists.empty()) return agg;
  // Bits announced by EVERY member move up as one shared vector: the warm
  // steady state (all ranks re-announcing the whole working set) combines
  // to hits_all = everything, residual bits = none.  Probe that case with
  // plain vector equality first — it is every tick of a stable training
  // step, and the set-based intersection below allocates per member.
  bool identical = true;
  for (size_t i = 1; i < lists.size() && identical; ++i) {
    identical = lists[i].cache_hits == lists[0].cache_hits;
  }
  std::set<int32_t> common;
  if (identical) {
    common.insert(lists[0].cache_hits.begin(), lists[0].cache_hits.end());
  } else {
    common.insert(lists[0].cache_hits.begin(), lists[0].cache_hits.end());
    for (size_t i = 1; i < lists.size() && !common.empty(); ++i) {
      std::set<int32_t> have(lists[i].cache_hits.begin(),
                             lists[i].cache_hits.end());
      for (auto it = common.begin(); it != common.end();) {
        if (have.count(*it) == 0) {
          it = common.erase(it);
        } else {
          ++it;
        }
      }
    }
  }
  // Verifier streams fold to one copy when identical across the group —
  // the schedule-agreement common case.  Any difference (a rank lagging
  // an interval boundary) keeps per-member streams in the residual so the
  // root's divergence check sees exactly what the star would.
  bool fold = true;
  for (size_t i = 1; i < lists.size() && fold; ++i) {
    const auto& a = lists[0].verify;
    const auto& b = lists[i].verify;
    if (a.size() != b.size()) {
      fold = false;
      break;
    }
    for (size_t k = 0; k < a.size(); ++k) {
      if (a[k].seq != b[k].seq || a[k].hash != b[k].hash ||
          a[k].desc != b[k].desc) {
        fold = false;
        break;
      }
    }
  }
  agg.verify_folded = fold;
  if (fold) agg.verify_all = lists[0].verify;
  agg.hits_all.assign(common.begin(), common.end());  // ascending
  agg.residual.resize(lists.size());
  for (size_t i = 0; i < lists.size(); ++i) {
    RequestList r = lists[i];
    if (identical) {
      r.cache_hits.clear();  // every bit went up in hits_all
    } else if (!common.empty()) {
      std::vector<int32_t> rest;
      rest.reserve(r.cache_hits.size());
      for (int32_t b : r.cache_hits) {
        if (common.count(b) == 0) rest.push_back(b);
      }
      r.cache_hits = std::move(rest);
    }
    if (fold) r.verify.clear();
    agg.residual[i] = std::move(r);
  }
  return agg;
}

bool ExpandAggregate(AggRequestList* agg, const TreePlan& plan,
                     std::vector<RequestList>* all, std::string* why) {
  if (agg->agg_id < 0 || agg->agg_id >= plan.num_groups) {
    *why = "aggregate names unknown group " + std::to_string(agg->agg_id);
    return false;
  }
  std::vector<int> expect = TreeMembersOf(agg->agg_id, plan);
  if (agg->members.size() != expect.size() ||
      agg->residual.size() != expect.size()) {
    *why = "aggregate member set disagrees with the topology plan (group " +
           std::to_string(agg->agg_id) + ")";
    return false;
  }
  for (size_t i = 0; i < expect.size(); ++i) {
    if (agg->members[i] != expect[i]) {
      *why = "aggregate member set disagrees with the topology plan (group " +
             std::to_string(agg->agg_id) + ")";
      return false;
    }
  }
  for (size_t i = 0; i < expect.size(); ++i) {
    RequestList r = std::move(agg->residual[i]);
    if (!agg->hits_all.empty()) {
      if (r.cache_hits.empty()) {
        // Steady-state fast path (every bit was common): the member's
        // announcement IS hits_all.  This branch runs P times per tick at
        // fleet scale, so it must not allocate a set per member.
        r.cache_hits = agg->hits_all;
      } else {
        // Merged ascending-unique bits — the wire's bit-vector encoding
        // already canonicalizes order, so this is byte-equivalent to what
        // the member would have sent the star coordinator.
        std::set<int32_t> bits(r.cache_hits.begin(), r.cache_hits.end());
        bits.insert(agg->hits_all.begin(), agg->hits_all.end());
        r.cache_hits.assign(bits.begin(), bits.end());
      }
    }
    if (agg->verify_folded) r.verify = agg->verify_all;
    (*all)[static_cast<size_t>(expect[i])] = std::move(r);
  }
  return true;
}

// ---------------------------------------------------------------------------
// TreeRootPlane
// ---------------------------------------------------------------------------

struct TreeRootPlane::Reader {
  FrameReader fr;
};

std::unique_ptr<TreeRootPlane> TreeRootPlane::Make(int port, int size,
                                                   int64_t epoch,
                                                   const TreePlan& plan,
                                                   std::string* err) {
  if (!plan.active || plan.num_groups < 1) {
    *err = "tree plan is not active";
    return nullptr;
  }
  std::unique_ptr<TreeRootPlane> cp(new TreeRootPlane());
  cp->plan_ = plan;
  cp->size_ = size;
  cp->epoch_ = static_cast<uint16_t>(epoch & 0xFFFF);
  cp->wire_version_ = wire::WireVersionFromEnv();
  cp->detach_timeout_ms_ = EnvLL("HVD_TPU_TREE_DETACH_TIMEOUT_MS", 10000);
  cp->port_ = port;
  cp->listen_fd_ = TcpControlPlane::BindListener(&cp->port_, err);
  if (cp->listen_fd_ < 0) return nullptr;
  SetNonBlocking(cp->listen_fd_);
  size_t n = static_cast<size_t>(plan.num_groups);
  cp->relay_fds_.assign(n, -1);
  cp->detached_.assign(n, false);
  cp->detached_since_.assign(n, Clock::now());
  cp->last_rx_.assign(n, Clock::now());
  for (size_t g = 0; g < n; ++g) {
    cp->readers_.push_back(std::unique_ptr<Reader>(new Reader()));
  }
  // Bounded relay rendezvous: each group's primary aggregator HELLOs with
  // its negative wire rank.  A worker knocking here is a misconfiguration
  // (tree-mode workers attach to relays) and is turned away.
  auto deadline = Clock::now() + std::chrono::duration<double>(
                                     wire::RendezvousBudgetSeconds());
  int admitted = 0;
  while (admitted < plan.num_groups) {
    if (Clock::now() >= deadline) {
      *err = "tree rendezvous timed out: " + std::to_string(admitted) + "/" +
             std::to_string(plan.num_groups) +
             " aggregators connected (HVD_TPU_CONNECT_TIMEOUT to extend)";
      return nullptr;
    }
    pollfd pfd{cp->listen_fd_, POLLIN, 0};
    int pr = ::poll(&pfd, 1, 200);
    if (pr < 0 && errno != EINTR) {
      *err = "poll() failed";
      return nullptr;
    }
    if (pr <= 0 || (pfd.revents & POLLIN) == 0) continue;
    int wr = 0;
    int fd = AcceptHello(cp->listen_fd_, cp->epoch_, cp->wire_version_, 2000,
                         &wr);
    if (fd < 0) continue;
    if (wr >= 0) {
      std::fprintf(stderr,
                   "WARNING: horovod_tpu tree root turned away a "
                   "positive-rank hello (rank %d) — workers attach to "
                   "their group's aggregator, not the root\n",
                   wr);
      ::close(fd);
      continue;
    }
    int g = AggIdFromWireRank(wr);
    if (g < 0 || g >= plan.num_groups) {
      ::close(fd);
      continue;
    }
    size_t gi = static_cast<size_t>(g);
    if (cp->relay_fds_[gi] >= 0) {
      ::shutdown(cp->relay_fds_[gi], SHUT_RDWR);
      cp->dead_fds_.push_back(cp->relay_fds_[gi]);
    } else {
      ++admitted;
    }
    cp->relay_fds_[gi] = fd;
    cp->last_rx_[gi] = Clock::now();
  }
  return cp;
}

TreeRootPlane::~TreeRootPlane() {
  for (int fd : relay_fds_) {
    if (fd >= 0) ::close(fd);
  }
  for (int fd : dead_fds_) ::close(fd);
  if (listen_fd_ >= 0) ::close(listen_fd_);
}

void TreeRootPlane::RecordFailure(int peer_rank, const char* cause,
                                  std::string detail) {
  std::lock_guard<std::mutex> l(state_mu_);
  if (failed_.load()) return;  // first observation wins
  failure_.failed_rank = peer_rank;
  failure_.cause = cause;
  failure_.detail = std::move(detail);
  failed_.store(true);
}

void TreeRootPlane::RecordAbort(const PeerFailureReport& report) {
  std::lock_guard<std::mutex> l(state_mu_);
  if (failed_.load()) return;
  failure_ = report;
  if (failure_.detail.empty()) {
    failure_.detail = "abort relayed up the coordinator tree";
  } else {
    failure_.detail += " (relayed up the coordinator tree)";
  }
  failed_.store(true);
}

bool TreeRootPlane::GetFailure(PeerFailureReport* out) const {
  std::lock_guard<std::mutex> l(state_mu_);
  if (!failed_.load()) return false;
  *out = failure_;
  return true;
}

void TreeRootPlane::Detach(int agg_id) {
  std::lock_guard<std::mutex> l(state_mu_);
  size_t g = static_cast<size_t>(agg_id);
  if (detached_[g]) return;
  detached_[g] = true;
  detached_since_[g] = Clock::now();
  // Shut down (don't close): a SIGSTOPped stale primary waking later must
  // see its sends fail, and the monitor thread may be mid-send on this fd
  // — closing would race an fd-number reuse.  The fd is reclaimed when
  // the standby's re-HELLO replaces it (or at destruction).
  if (relay_fds_[g] >= 0) ::shutdown(relay_fds_[g], SHUT_RDWR);
}

bool TreeRootPlane::SendToRelay(int agg_id, FrameType type,
                                const std::string& payload) {
  int fd;
  {
    std::lock_guard<std::mutex> l(state_mu_);
    size_t g = static_cast<size_t>(agg_id);
    if (detached_[g]) return false;
    fd = relay_fds_[g];
  }
  if (!SendFrame(fd, type, payload, epoch_, wire_version_, &send_mu_)) {
    Detach(agg_id);
    return false;
  }
  return true;
}

void TreeRootPlane::PollRelayHello() {
  int wr = 0;
  int fd = AcceptHello(listen_fd_, epoch_, wire_version_, 1000, &wr);
  if (fd < 0) return;
  if (wr >= 0) {
    ::close(fd);
    return;
  }
  int g = AggIdFromWireRank(wr);
  if (g < 0 || g >= plan_.num_groups) {
    ::close(fd);
    return;
  }
  size_t gi = static_cast<size_t>(g);
  std::lock_guard<std::mutex> l(state_mu_);
  if (relay_fds_[gi] >= 0) {
    ::shutdown(relay_fds_[gi], SHUT_RDWR);
    dead_fds_.push_back(relay_fds_[gi]);
  }
  relay_fds_[gi] = fd;
  detached_[gi] = false;
  last_rx_[gi] = Clock::now();
  readers_[gi]->fr.Reset();
}

bool TreeRootPlane::Gather(const RequestList& own,
                           std::vector<RequestList>* all) {
  BusyScope busy{busy_us_};
  all->assign(static_cast<size_t>(size_), RequestList{});
  (*all)[0] = own;
  int n = plan_.num_groups;
  std::vector<bool> have(static_cast<size_t>(n), false);
  int remaining = n;
  std::vector<pollfd> pfds;
  std::vector<int> owner;  // poll slot -> agg_id; -1 = listener
  while (remaining > 0) {
    if (failed_.load()) return false;
    pfds.clear();
    owner.clear();
    {
      std::lock_guard<std::mutex> l(state_mu_);
      for (int g = 0; g < n; ++g) {
        size_t gi = static_cast<size_t>(g);
        if (detached_[gi] || relay_fds_[gi] < 0) {
          if (MsSince(detached_since_[gi]) > detach_timeout_ms_) {
            // No standby re-attached within the budget: the whole subtree
            // is unreachable.  failed_rank -1: infrastructure, not a
            // collective member.
            failure_.failed_rank = -1;
            failure_.cause = "aggregator_lost";
            failure_.detail =
                "aggregator group " + std::to_string(g) +
                " detached and no standby re-attached within " +
                std::to_string(detach_timeout_ms_) +
                " ms (HVD_TPU_TREE_DETACH_TIMEOUT_MS)";
            failed_.store(true);
            return false;
          }
          continue;
        }
        pfds.push_back({relay_fds_[gi], POLLIN, 0});
        owner.push_back(g);
      }
    }
    if (listen_fd_ >= 0) {
      pfds.push_back({listen_fd_, POLLIN, 0});
      owner.push_back(-1);
    }
    int pr = ::poll(pfds.data(), static_cast<nfds_t>(pfds.size()), 200);
    if (pr < 0) {
      if (errno == EINTR) continue;
      RecordFailure(-1, "connection_lost", "poll() failed in tree gather");
      return false;
    }
    if (pr == 0) continue;
    for (size_t s = 0; s < pfds.size(); ++s) {
      if ((pfds[s].revents & (POLLIN | POLLERR | POLLHUP | POLLNVAL)) == 0) {
        continue;
      }
      int g = owner[s];
      if (g < 0) {
        PollRelayHello();
        continue;
      }
      size_t gi = static_cast<size_t>(g);
      FrameReader& fr = readers_[gi]->fr;
      bool drained = false;
      while (!drained) {
        std::string why;
        FrameReader::St st = fr.Drain(pfds[s].fd, epoch_, wire_version_, &why);
        switch (st) {
          case FrameReader::St::AGAIN:
            drained = true;
            break;
          case FrameReader::St::CLOSED:
          case FrameReader::St::BAD:
            // Relay EOF or a corrupted relay stream: detach and wait for
            // the standby's re-HELLO (the detach budget above escalates).
            Detach(g);
            fr.Reset();
            drained = true;
            break;
          case FrameReader::St::READY: {
            frames_rx_.fetch_add(1, std::memory_order_relaxed);
            {
              std::lock_guard<std::mutex> l(state_mu_);
              last_rx_[gi] = Clock::now();
            }
            FrameType t = static_cast<FrameType>(fr.hdr.type);
            if (t == FrameType::HEARTBEAT) {
              hb_frames_rx_.fetch_add(1, std::memory_order_relaxed);
              fr.Reset();
              break;
            }
            if (t == FrameType::ABORT) {
              PeerFailureReport report;
              if (Deserialize(fr.body.data(), fr.body.size(), &report)) {
                RecordAbort(report);
              } else {
                RecordFailure(RelayWireRank(g), "frame_corrupt",
                              "undecodable ABORT from aggregator group " +
                                  std::to_string(g));
              }
              return false;
            }
            if (t != FrameType::AGG_REQUEST) {
              RecordFailure(RelayWireRank(g), "frame_desync",
                            "unexpected frame type " +
                                std::to_string(fr.hdr.type) +
                                " from aggregator group " +
                                std::to_string(g));
              return false;
            }
            agg_frames_rx_.fetch_add(1, std::memory_order_relaxed);
            AggRequestList agg;
            bool ok = Deserialize(fr.body.data(), fr.body.size(), &agg);
            fr.Reset();
            if (!ok) {
              RecordFailure(RelayWireRank(g), "frame_corrupt",
                            "undecodable AGG_REQUEST from aggregator "
                            "group " +
                                std::to_string(g));
              return false;
            }
            if (agg.seq <= last_seq_) {
              // Promotion catch-up: a standby that replaced a primary
              // which died between the root's broadcast and its fan-out.
              // Lockstep bounds the lag to exactly one round, so the one
              // stored response is always the right replay.
              SendToRelay(g, FrameType::RESPONSE, last_response_);
              break;
            }
            if (agg.seq != last_seq_ + 1) {
              RecordFailure(RelayWireRank(g), "frame_desync",
                            "aggregator group " + std::to_string(g) +
                                " skipped to seq " +
                                std::to_string(agg.seq) + " (expected " +
                                std::to_string(last_seq_ + 1) + ")");
              return false;
            }
            std::string why2;
            if (!ExpandAggregate(&agg, plan_, all, &why2)) {
              RecordFailure(RelayWireRank(g), "frame_corrupt", why2);
              return false;
            }
            if (!have[gi]) {
              have[gi] = true;
              --remaining;
            }
            break;
          }
        }
      }
    }
  }
  return true;
}

bool TreeRootPlane::Broadcast(const ResponseList& out) {
  BusyScope busy{busy_us_};
  std::string payload;
  Serialize(out, &payload);
  // Record BEFORE any send: replay must always have the authoritative
  // bytes, even if every relay send fails mid-loop.
  last_seq_ += 1;
  last_response_ = payload;
  for (int g = 0; g < plan_.num_groups; ++g) {
    // Best effort: a dead relay detaches here and its standby picks the
    // response up via the seq-replay path.
    SendToRelay(g, FrameType::RESPONSE, payload);
  }
  return true;
}

bool TreeRootPlane::HeartbeatTick(double timeout_s) {
  if (failed_.load()) return true;
  for (int g = 0; g < plan_.num_groups; ++g) {
    SendToRelay(g, FrameType::HEARTBEAT, "");
    bool silent;
    {
      std::lock_guard<std::mutex> l(state_mu_);
      size_t gi = static_cast<size_t>(g);
      silent = !detached_[gi] &&
               std::chrono::duration<double>(Clock::now() - last_rx_[gi])
                       .count() > timeout_s;
    }
    // Relay silence (SIGSTOP, partition) is a DETACH, not a job failure:
    // shutting the fd down forces its members onto the standby, and the
    // gather's detach budget escalates only if no standby ever shows.
    if (silent) Detach(g);
  }
  return failed_.load();
}

void TreeRootPlane::AbortPeers(const PeerFailureReport& report) {
  std::string payload;
  Serialize(report, &payload);
  for (int g = 0; g < plan_.num_groups; ++g) {
    SendToRelay(g, FrameType::ABORT, payload);
  }
}

void TreeRootPlane::BroadcastReconfig(const ReconfigInfo& info) {
  std::string payload;
  Serialize(info, &payload);
  for (int g = 0; g < plan_.num_groups; ++g) {
    SendToRelay(g, FrameType::RECONFIG, payload);
  }
}

void TreeRootPlane::CloseListener() {
  std::lock_guard<std::mutex> l(state_mu_);
  if (listen_fd_ >= 0) {
    ::close(listen_fd_);
    listen_fd_ = -1;
  }
}

// ---------------------------------------------------------------------------
// TreeMemberPlane
// ---------------------------------------------------------------------------

struct TreeMemberPlane::Reader {
  FrameReader fr;
};

std::unique_ptr<TreeMemberPlane> TreeMemberPlane::Make(
    const TreeEndpoint& primary, const TreeEndpoint& standby, int rank,
    int64_t epoch, long long exchange_timeout_ms, std::string* err) {
  std::unique_ptr<TreeMemberPlane> cp(new TreeMemberPlane());
  cp->rank_ = rank;
  cp->primary_ = primary;
  cp->standby_ = standby;
  cp->epoch_ = static_cast<uint16_t>(epoch & 0xFFFF);
  cp->wire_version_ = wire::WireVersionFromEnv();
  cp->exchange_timeout_ms_ =
      exchange_timeout_ms > 100 ? exchange_timeout_ms : 100;
  cp->reattach_budget_ms_ = EnvLL("HVD_TPU_TREE_REATTACH_BUDGET_MS", 30000);
  cp->reader_.reset(new Reader());
  // Initial attach targets the PRIMARY only: the standby parks
  // pre-promotion knocks, so alternating from the start would wedge the
  // rendezvous (member waiting on a parked standby connection, primary
  // waiting on the member).
  auto deadline = Clock::now() + std::chrono::duration<double>(
                                     wire::RendezvousBudgetSeconds());
  wire::Backoff backoff{0.02, 1.0, static_cast<unsigned>(rank + 1)};
  std::string why;
  for (int attempt = 0;; ++attempt) {
    double left =
        std::chrono::duration<double>(deadline - Clock::now()).count();
    if (left <= 0) {
      *err = "rendezvous with aggregator " + primary.host + ":" +
             std::to_string(primary.port) +
             " failed (HVD_TPU_CONNECT_TIMEOUT to extend)" +
             (why.empty() ? "" : ": " + why);
      return nullptr;
    }
    if (attempt > 0) backoff.Sleep(attempt - 1, left);
    int fd = ConnectHello(primary, rank, cp->epoch_, cp->wire_version_, 5000,
                          &why);
    if (fd == -2) {
      *err = why;
      return nullptr;
    }
    if (fd >= 0) {
      cp->sock_ = fd;
      break;
    }
  }
  cp->last_rx_ = Clock::now();
  return cp;
}

TreeMemberPlane::~TreeMemberPlane() {
  if (sock_ >= 0) ::close(sock_);
  for (int fd : dead_fds_) ::close(fd);
}

void TreeMemberPlane::RecordFailure(int peer_rank, const char* cause,
                                    std::string detail) {
  std::lock_guard<std::mutex> l(state_mu_);
  if (failed_.load()) return;
  failure_.failed_rank = peer_rank;
  failure_.cause = cause;
  failure_.detail = std::move(detail);
  failure_.last_heard_us = static_cast<int64_t>(
      std::chrono::duration<double>(Clock::now() - last_rx_).count() * 1e6);
  failed_.store(true);
}

void TreeMemberPlane::RecordAbort(const PeerFailureReport& report) {
  std::lock_guard<std::mutex> l(state_mu_);
  if (failed_.load()) return;
  failure_ = report;
  if (failure_.detail.empty()) {
    failure_.detail = "abort relayed down the coordinator tree";
  } else {
    failure_.detail += " (relayed down the coordinator tree)";
  }
  failed_.store(true);
}

bool TreeMemberPlane::GetFailure(PeerFailureReport* out) const {
  std::lock_guard<std::mutex> l(state_mu_);
  if (!failed_.load()) return false;
  *out = failure_;
  return true;
}

bool TreeMemberPlane::GetReconfig(ReconfigInfo* out) const {
  std::lock_guard<std::mutex> l(state_mu_);
  if (!reconfigured_.load()) return false;
  *out = reconfig_;
  return true;
}

void TreeMemberPlane::CloseSock() {
  std::lock_guard<std::mutex> l(state_mu_);
  if (sock_ >= 0) {
    // Shutdown + park (close at destruction): the monitor thread may be
    // mid-send on this fd, and closing would race an fd-number reuse.
    ::shutdown(sock_, SHUT_RDWR);
    dead_fds_.push_back(sock_);
    sock_ = -1;
  }
  reader_->fr.Reset();
}

bool TreeMemberPlane::AttachOnce(const TreeEndpoint& ep, std::string* why) {
  int fd = ConnectHello(ep, rank_, epoch_, wire_version_, 2000, why);
  if (fd < 0) return false;
  std::lock_guard<std::mutex> l(state_mu_);
  sock_ = fd;
  last_rx_ = Clock::now();
  reader_->fr.Reset();
  return true;
}

bool TreeMemberPlane::Exchange(const RequestList& send, ResponseList* recv) {
  if (failed_.load()) return false;
  BusyScope busy{busy_us_};
  int64_t seq = last_seq_ + 1;
  std::string payload(8, '\0');
  std::memcpy(&payload[0], &seq, 8);
  {
    std::string body;
    Serialize(send, &body);
    payload += body;
  }
  auto deadline =
      Clock::now() + std::chrono::milliseconds(reattach_budget_ms_);
  wire::Backoff backoff{0.02, 0.5, static_cast<unsigned>(rank_ + 1)};
  int attempt = 0;
  std::string why;
  for (;;) {
    if (failed_.load()) return false;
    double left =
        std::chrono::duration<double>(deadline - Clock::now()).count();
    if (left <= 0) {
      RecordFailure(-1, "aggregator_lost",
                    "aggregator unreachable for " +
                        std::to_string(reattach_budget_ms_) +
                        " ms across both endpoints "
                        "(HVD_TPU_TREE_REATTACH_BUDGET_MS)" +
                        (why.empty() ? "" : ": " + why));
      return false;
    }
    int fd;
    {
      std::lock_guard<std::mutex> l(state_mu_);
      fd = sock_;
    }
    if (fd < 0) {
      // Alternate endpoints: after a relay death the standby answers at
      // the OTHER address; while the primary is merely slow, the cycle
      // comes back around to it.
      bool try_standby = standby_.port > 0 && !on_standby_;
      on_standby_ = try_standby;
      backoff.Sleep(attempt++, left);
      if (!AttachOnce(try_standby ? standby_ : primary_, &why)) continue;
      std::lock_guard<std::mutex> l(state_mu_);
      fd = sock_;
    }
    if (!SendFrame(fd, FrameType::REQUEST, payload, epoch_, wire_version_,
                   &send_mu_)) {
      CloseSock();
      continue;
    }
    // Await the matching RESPONSE, demultiplexing heartbeats; a timeout
    // means the relay is dead or promoting — reattach and resend the SAME
    // seq (the relay's replay path makes the resend idempotent).
    long long wait_ms = exchange_timeout_ms_;
    if (wait_ms > static_cast<long long>(left * 1000)) {
      wait_ms = static_cast<long long>(left * 1000);
    }
    auto resp_deadline = Clock::now() + std::chrono::milliseconds(wait_ms);
    bool reattach = false;
    while (!reattach) {
      if (failed_.load()) return false;
      long long slice = std::chrono::duration_cast<std::chrono::milliseconds>(
                            resp_deadline - Clock::now())
                            .count();
      if (slice <= 0) {
        CloseSock();
        why = "no response within the exchange timeout";
        reattach = true;
        break;
      }
      if (slice > 100) slice = 100;
      pollfd pfd{fd, POLLIN, 0};
      int pr = ::poll(&pfd, 1, static_cast<int>(slice));
      if (pr < 0 && errno != EINTR) {
        CloseSock();
        reattach = true;
        break;
      }
      if (pr <= 0) continue;
      for (;;) {
        FrameReader& fr = reader_->fr;
        std::string dwhy;
        FrameReader::St st = fr.Drain(fd, epoch_, wire_version_, &dwhy);
        if (st == FrameReader::St::AGAIN) break;
        if (st == FrameReader::St::CLOSED || st == FrameReader::St::BAD) {
          CloseSock();
          why = dwhy.empty() ? "aggregator closed the connection" : dwhy;
          reattach = true;
          break;
        }
        frames_rx_.fetch_add(1, std::memory_order_relaxed);
        {
          std::lock_guard<std::mutex> l(state_mu_);
          last_rx_ = Clock::now();
        }
        FrameType t = static_cast<FrameType>(fr.hdr.type);
        if (t == FrameType::HEARTBEAT) {
          fr.Reset();
          continue;
        }
        if (t == FrameType::ABORT) {
          PeerFailureReport report;
          if (Deserialize(fr.body.data(), fr.body.size(), &report)) {
            RecordAbort(report);
          } else {
            RecordFailure(-1, "frame_corrupt",
                          "undecodable ABORT frame from the aggregator");
          }
          return false;
        }
        if (t == FrameType::RECONFIG) {
          ReconfigInfo info;
          if (Deserialize(fr.body.data(), fr.body.size(), &info)) {
            std::lock_guard<std::mutex> l(state_mu_);
            reconfig_ = info;
            failure_.failed_rank = info.failed_rank;
            failure_.cause =
                info.cause.empty() ? "membership_reconfig" : info.cause;
            failure_.detail = "membership reconfiguration relayed down the "
                              "coordinator tree";
            reconfigured_.store(true);
            failed_.store(true);
          } else {
            RecordFailure(-1, "frame_corrupt",
                          "undecodable RECONFIG frame from the aggregator");
          }
          return false;
        }
        if (t != FrameType::RESPONSE) {
          RecordFailure(-1, "frame_desync",
                        "unexpected frame type " + std::to_string(fr.hdr.type) +
                            " from the aggregator");
          return false;
        }
        bool ok = Deserialize(fr.body.data(), fr.body.size(), recv);
        fr.Reset();
        if (!ok) {
          RecordFailure(-1, "frame_corrupt",
                        "ResponseList deserialization failed despite a "
                        "valid checksum (schema skew?)");
          return false;
        }
        last_seq_ = seq;
        return true;
      }
    }
  }
}

bool TreeMemberPlane::HeartbeatTick(double timeout_s) {
  if (failed_.load()) return true;
  int fd;
  {
    std::lock_guard<std::mutex> l(state_mu_);
    fd = sock_;
  }
  if (fd < 0) return failed_.load();  // Exchange is mid-reattach
  SendFrame(fd, FrameType::HEARTBEAT, "", epoch_, wire_version_, &send_mu_);
  double silent;
  {
    std::lock_guard<std::mutex> l(state_mu_);
    silent = std::chrono::duration<double>(Clock::now() - last_rx_).count();
  }
  if (silent < timeout_s) return failed_.load();
  // Silent past the timeout.  Bytes parked in the receive buffer (the
  // engine idle between collectives never drains them) mean the relay is
  // alive — check before acting, like the star's MSG_PEEK probe.
  pollfd pfd{fd, POLLIN, 0};
  if (::poll(&pfd, 1, 0) > 0 && (pfd.revents & POLLIN) != 0) {
    char probe;
    if (::recv(fd, &probe, 1, MSG_PEEK | MSG_DONTWAIT) > 0) {
      std::lock_guard<std::mutex> l(state_mu_);
      last_rx_ = Clock::now();
      return failed_.load();
    }
  }
  // Truly silent: wake any blocked Exchange into its reattach loop rather
  // than declaring a job failure — the standby may be mid-promotion.
  ::shutdown(fd, SHUT_RDWR);
  return failed_.load();
}

void TreeMemberPlane::AbortPeers(const PeerFailureReport& report) {
  int fd;
  {
    std::lock_guard<std::mutex> l(state_mu_);
    fd = sock_;
  }
  if (fd < 0) return;
  std::string payload;
  Serialize(report, &payload);
  // Best effort; the relay forwards it up to the root and across to the
  // group's other members.
  SendFrame(fd, FrameType::ABORT, payload, epoch_, wire_version_, &send_mu_);
}

// ---------------------------------------------------------------------------
// RunRelay — the aggregator process (primary or standby)
// ---------------------------------------------------------------------------

namespace {

class Relay {
 public:
  explicit Relay(const RelayOptions& o) : opt_(o) {}
  int Run();

 private:
  static constexpr int kPromote = 100;  // StandbyLoop -> PrimaryLoop

  bool ConnectParent(double budget_s, std::string* why);
  void ConnectPeer();
  int StandbyLoop();
  int PrimaryLoop();
  void ResetRound();
  void SendHeartbeatsIfDue();
  void AbortDown(const PeerFailureReport& report);
  void AbortUpDown(const PeerFailureReport& report);
  void SendShutdownSentinel();
  void ParkMemberFd(size_t i);
  bool OnMemberFrame(size_t i, FrameReader& fr, int* exit_code);
  bool OnParentFrame(FrameReader& fr, int* exit_code);
  int64_t round_seq() const { return last_seq_ + 1; }

  RelayOptions opt_;
  TreePlan plan_;
  std::vector<int> members_;
  std::vector<int> mfd_;
  std::vector<FrameReader> mrd_;
  std::vector<Clock::time_point> m_detach_since_;
  std::vector<bool> m_ever_attached_;
  std::vector<bool> m_eof_;  // closed after the shutdown round: clean
  std::vector<int> dead_fds_;
  int listen_fd_ = -1;
  int parent_fd_ = -1;
  FrameReader prd_;
  int peer_fd_ = -1;  // state stream (primary: to standby; standby: from)
  FrameReader xrd_;
  uint16_t epoch16_ = 0;
  uint8_t version_ = kWireVersion;
  long long promote_silence_ms_ = 1000;
  int64_t last_seq_ = 0;
  std::string last_response_;
  bool shutdown_round_ = false;
  bool shutdown_done_ = false;
  // Round state.
  std::vector<bool> have_;
  std::vector<RequestList> reqs_;
  int have_count_ = 0;
  bool agg_sent_ = false;
  Clock::time_point first_req_time_;
  Clock::time_point last_hb_;
  Clock::time_point start_;
  // Busy accounting for the fleet simulator (stats_path): µs spent
  // processing events (poll waits excluded) and completed rounds.
  long long busy_us_ = 0;
  long long rounds_ = 0;
};

bool Relay::ConnectParent(double budget_s, std::string* why) {
  auto deadline = Clock::now() + std::chrono::duration<double>(budget_s);
  wire::Backoff backoff{0.02, 1.0,
                        static_cast<unsigned>(opt_.agg_id + 101)};
  TreeEndpoint parent{opt_.parent_host, opt_.parent_port};
  for (int attempt = 0;; ++attempt) {
    double left =
        std::chrono::duration<double>(deadline - Clock::now()).count();
    if (left <= 0) {
      if (why->empty()) *why = "rendezvous budget exhausted";
      return false;
    }
    if (attempt > 0) backoff.Sleep(attempt - 1, left);
    int fd = ConnectHello(parent, RelayWireRank(opt_.agg_id), epoch16_,
                          version_, 5000, why);
    if (fd == -2) return false;
    if (fd >= 0) {
      parent_fd_ = fd;
      prd_.Reset();
      return true;
    }
  }
}

void Relay::ConnectPeer() {
  if (opt_.standby || opt_.peer_port <= 0) return;
  // Best effort with a short budget: a job without a live standby still
  // runs, it just loses mid-tree failover for this group.
  TreeEndpoint peer{opt_.peer_host, opt_.peer_port};
  auto deadline = Clock::now() + std::chrono::seconds(5);
  wire::Backoff backoff{0.02, 0.5,
                        static_cast<unsigned>(opt_.agg_id + 201)};
  std::string why;
  for (int attempt = 0; Clock::now() < deadline; ++attempt) {
    if (attempt > 0) backoff.Sleep(attempt - 1, 1.0);
    int fd = ConnectHello(peer, RelayWireRank(opt_.agg_id), epoch16_,
                          version_, 1000, &why);
    if (fd == -2) break;
    if (fd >= 0) {
      peer_fd_ = fd;
      xrd_.Reset();
      return;
    }
  }
  std::fprintf(stderr,
               "WARNING: horovod_tpu aggregator %d could not reach its "
               "standby (%s) — mid-tree failover disabled for this group\n",
               opt_.agg_id, why.c_str());
}

void Relay::ResetRound() {
  have_.assign(members_.size(), false);
  reqs_.assign(members_.size(), RequestList{});
  have_count_ = 0;
  agg_sent_ = false;
  shutdown_round_ = false;
}

void Relay::ParkMemberFd(size_t i) {
  if (mfd_[i] >= 0) {
    ::shutdown(mfd_[i], SHUT_RDWR);
    dead_fds_.push_back(mfd_[i]);
    mfd_[i] = -1;
  }
  mrd_[i].Reset();
  m_detach_since_[i] = Clock::now();
}

void Relay::SendHeartbeatsIfDue() {
  if (MsSince(last_hb_) < opt_.heartbeat_ms) return;
  last_hb_ = Clock::now();
  // Heartbeat fan-in contract: ONE frame up per interval regardless of
  // fanout — the root's liveness cost is O(num_groups), not O(P).
  if (parent_fd_ >= 0) {
    SendFrame(parent_fd_, FrameType::HEARTBEAT, "", epoch16_, version_,
              nullptr);
  }
  for (size_t i = 0; i < mfd_.size(); ++i) {
    if (mfd_[i] >= 0) {
      SendFrame(mfd_[i], FrameType::HEARTBEAT, "", epoch16_, version_,
                nullptr);
    }
  }
  if (peer_fd_ >= 0) {
    SendFrame(peer_fd_, FrameType::HEARTBEAT, "", epoch16_, version_,
              nullptr);
  }
}

void Relay::AbortDown(const PeerFailureReport& report) {
  std::string payload;
  Serialize(report, &payload);
  for (size_t i = 0; i < mfd_.size(); ++i) {
    if (mfd_[i] >= 0) {
      SendFrame(mfd_[i], FrameType::ABORT, payload, epoch16_, version_,
                nullptr);
    }
  }
}

void Relay::AbortUpDown(const PeerFailureReport& report) {
  std::string payload;
  Serialize(report, &payload);
  if (parent_fd_ >= 0) {
    SendFrame(parent_fd_, FrameType::ABORT, payload, epoch16_, version_,
              nullptr);
  }
  AbortDown(report);
}

void Relay::SendShutdownSentinel() {
  if (peer_fd_ < 0) return;
  AggState st;
  st.seq = kShutdownSeq;
  std::string payload;
  Serialize(st, &payload);
  SendFrame(peer_fd_, FrameType::AGG_STATE, payload, epoch16_, version_,
            nullptr);
}

// Handles one complete frame from member slot `i`.  Returns false when the
// relay must exit (with *exit_code set).
bool Relay::OnMemberFrame(size_t i, FrameReader& fr, int* exit_code) {
  FrameType t = static_cast<FrameType>(fr.hdr.type);
  if (t == FrameType::HEARTBEAT) {
    // Absorbed: members' liveness never rides up the tree per-member.
    fr.Reset();
    return true;
  }
  if (t == FrameType::ABORT) {
    PeerFailureReport report;
    if (!Deserialize(fr.body.data(), fr.body.size(), &report)) {
      report.failed_rank = members_[i];
      report.cause = "frame_corrupt";
      report.detail = "undecodable member ABORT";
    }
    AbortUpDown(report);
    *exit_code = 1;
    return false;
  }
  if (t != FrameType::REQUEST || fr.body.size() < 8) {
    PeerFailureReport report;
    report.failed_rank = members_[i];
    report.cause = "frame_desync";
    report.detail = "unexpected frame type " + std::to_string(fr.hdr.type) +
                    " from rank " + std::to_string(members_[i]);
    AbortUpDown(report);
    *exit_code = 1;
    return false;
  }
  int64_t seq = 0;
  std::memcpy(&seq, fr.body.data(), 8);
  if (seq == last_seq_ && !last_response_.empty()) {
    // The member never saw the round it already contributed to (it
    // reattached, possibly to a freshly promoted us): replay.
    SendFrame(mfd_[i], FrameType::RESPONSE, last_response_, epoch16_,
              version_, nullptr);
    fr.Reset();
    return true;
  }
  RequestList rl;
  bool ok =
      Deserialize(fr.body.data() + 8, fr.body.size() - 8, &rl);
  fr.Reset();
  if (!ok || seq != round_seq()) {
    PeerFailureReport report;
    report.failed_rank = members_[i];
    report.cause = ok ? "frame_desync" : "frame_corrupt";
    report.detail =
        ok ? "rank " + std::to_string(members_[i]) + " skipped to seq " +
                 std::to_string(seq) + " (expected " +
                 std::to_string(round_seq()) + ")"
           : "undecodable RequestList from rank " +
                 std::to_string(members_[i]);
    AbortUpDown(report);
    *exit_code = 1;
    return false;
  }
  if (rl.shutdown) shutdown_round_ = true;
  if (!have_[i]) {
    have_[i] = true;
    if (++have_count_ == 1) first_req_time_ = Clock::now();
  }
  reqs_[i] = std::move(rl);
  if (have_count_ == static_cast<int>(members_.size()) && !agg_sent_) {
    AggRequestList agg = CombineMemberRequests(
        static_cast<int32_t>(opt_.agg_id), round_seq(), members_, reqs_);
    std::string payload;
    Serialize(agg, &payload);
    if (!SendFrame(parent_fd_, FrameType::AGG_REQUEST, payload, epoch16_,
                   version_, nullptr)) {
      PeerFailureReport report;
      report.failed_rank = 0;
      report.cause = "connection_lost";
      report.detail = "aggregator " + std::to_string(opt_.agg_id) +
                      " lost its uplink to the coordinator";
      AbortDown(report);
      *exit_code = 1;
      return false;
    }
    agg_sent_ = true;
  }
  return true;
}

bool Relay::OnParentFrame(FrameReader& fr, int* exit_code) {
  FrameType t = static_cast<FrameType>(fr.hdr.type);
  if (t == FrameType::HEARTBEAT) {
    fr.Reset();
    return true;
  }
  if (t == FrameType::RESPONSE) {
    // This round's verdict (or a replay of it after our promotion —
    // either way it answers round_seq()).  Replicate to the standby
    // BEFORE fanning out: response-stream continuity is load-bearing.
    last_seq_ = round_seq();
    last_response_ = fr.body;
    fr.Reset();
    if (peer_fd_ >= 0) {
      AggState st;
      st.seq = last_seq_;
      st.response = last_response_;
      std::string payload;
      Serialize(st, &payload);
      if (!SendFrame(peer_fd_, FrameType::AGG_STATE, payload, epoch16_,
                     version_, nullptr)) {
        ::close(peer_fd_);
        peer_fd_ = -1;  // standby died; keep serving without failover
      }
    }
    for (size_t i = 0; i < mfd_.size(); ++i) {
      if (mfd_[i] < 0) continue;
      if (!SendFrame(mfd_[i], FrameType::RESPONSE, last_response_, epoch16_,
                     version_, nullptr)) {
        ParkMemberFd(i);  // it will re-knock and take the replay path
      }
    }
    if (shutdown_round_) shutdown_done_ = true;
    ++rounds_;
    ResetRound();
    return true;
  }
  if (t == FrameType::ABORT || t == FrameType::RECONFIG) {
    // Forward the verdict down verbatim and exit: an abort is terminal;
    // a reconfiguration re-forms the job as a star (tree mode's elastic
    // fallback, docs/fault_tolerance.md).
    for (size_t i = 0; i < mfd_.size(); ++i) {
      if (mfd_[i] >= 0) {
        SendFrame(mfd_[i], t, fr.body, epoch16_, version_, nullptr);
      }
    }
    SendShutdownSentinel();
    *exit_code = t == FrameType::RECONFIG ? 0 : 1;
    return false;
  }
  PeerFailureReport report;
  report.failed_rank = 0;
  report.cause = "frame_desync";
  report.detail = "unexpected frame type " + std::to_string(fr.hdr.type) +
                  " from the coordinator";
  AbortDown(report);
  *exit_code = 1;
  return false;
}

int Relay::PrimaryLoop() {
  ResetRound();
  last_hb_ = Clock::now();
  int exit_code = 0;
  std::vector<pollfd> pfds;
  std::vector<int> owner;  // >=0 member slot; -1 listener; -2 parent; -3 peer
  double rendezvous_s = wire::RendezvousBudgetSeconds();
  for (;;) {
    SendHeartbeatsIfDue();
    // Member-attachment stalls: a member that never attached (rendezvous
    // budget) or detached and never re-knocked (member timeout) wedges
    // the whole subtree — escalate instead of hanging.
    if (!shutdown_done_) {
      for (size_t i = 0; i < mfd_.size(); ++i) {
        if (mfd_[i] >= 0 || m_eof_[i]) continue;
        long long limit_ms =
            m_ever_attached_[i]
                ? opt_.member_timeout_ms
                : static_cast<long long>(rendezvous_s * 1000);
        if (MsSince(m_detach_since_[i]) > limit_ms) {
          PeerFailureReport report;
          report.failed_rank = members_[i];
          report.cause = m_ever_attached_[i] ? "member_lost"
                                             : "heartbeat_timeout";
          report.detail =
              "rank " + std::to_string(members_[i]) +
              (m_ever_attached_[i]
                   ? " detached from aggregator " +
                         std::to_string(opt_.agg_id) +
                         " and never re-attached"
                   : " never attached to aggregator " +
                         std::to_string(opt_.agg_id));
          AbortUpDown(report);
          return 1;
        }
      }
      // Partial-round stall: some members contributed, others stayed
      // silent (SIGSTOP leaves the socket attached — no EOF ever comes).
      // Per the star's semantics a silent member is a lost member.
      if (have_count_ > 0 &&
          have_count_ < static_cast<int>(members_.size()) && !agg_sent_ &&
          MsSince(first_req_time_) > opt_.member_timeout_ms) {
        int missing = -1;
        for (size_t i = 0; i < have_.size(); ++i) {
          if (!have_[i]) {
            missing = members_[i];
            break;
          }
        }
        PeerFailureReport report;
        report.failed_rank = missing;
        report.cause = "member_lost";
        report.detail = "rank " + std::to_string(missing) +
                        " went silent mid-round at aggregator " +
                        std::to_string(opt_.agg_id) + " (" +
                        std::to_string(have_count_) + "/" +
                        std::to_string(members_.size()) +
                        " requests gathered)";
        AbortUpDown(report);
        return 1;
      }
    }
    pfds.clear();
    owner.clear();
    pfds.push_back({listen_fd_, POLLIN, 0});
    owner.push_back(-1);
    if (parent_fd_ >= 0) {
      pfds.push_back({parent_fd_, POLLIN, 0});
      owner.push_back(-2);
    }
    if (peer_fd_ >= 0) {
      pfds.push_back({peer_fd_, POLLIN, 0});
      owner.push_back(-3);
    }
    for (size_t i = 0; i < mfd_.size(); ++i) {
      if (mfd_[i] >= 0) {
        pfds.push_back({mfd_[i], POLLIN, 0});
        owner.push_back(static_cast<int>(i));
      }
    }
    int pr = ::poll(pfds.data(), static_cast<nfds_t>(pfds.size()), 50);
    if (pr < 0 && errno != EINTR) return 1;
    if (pr <= 0) continue;
    PlainBusy pb{busy_us_};  // event processing only — the poll wait is out
    for (size_t s = 0; s < pfds.size(); ++s) {
      if ((pfds[s].revents & (POLLIN | POLLERR | POLLHUP | POLLNVAL)) == 0) {
        continue;
      }
      int who = owner[s];
      if (who == -1) {
        int wr = 0;
        int fd = AcceptHello(listen_fd_, epoch16_, version_, 1000, &wr);
        if (fd < 0) continue;
        if (wr < 0) {
          ::close(fd);  // no standby-of-standby: nothing speaks state to us
          continue;
        }
        int idx = members_.empty() ? -1 : wr - members_[0];
        if (idx < 0 || idx >= static_cast<int>(members_.size()) ||
            members_[static_cast<size_t>(idx)] != wr) {
          ::close(fd);  // not one of ours
          continue;
        }
        size_t i = static_cast<size_t>(idx);
        ParkMemberFd(i);
        mfd_[i] = fd;
        m_ever_attached_[i] = true;
        m_eof_[i] = false;
        continue;
      }
      if (who == -2) {
        bool drained = false;
        while (!drained) {
          std::string why;
          FrameReader::St st =
              prd_.Drain(parent_fd_, epoch16_, version_, &why);
          if (st == FrameReader::St::AGAIN) {
            drained = true;
          } else if (st == FrameReader::St::READY) {
            if (!OnParentFrame(prd_, &exit_code)) return exit_code;
          } else {
            // Parent EOF/corrupt.  After the shutdown round (or before
            // any work with every member already gone) this is the
            // normal teardown; mid-job it means the coordinator died —
            // terminal in tree mode (root failover is star-only).
            bool members_gone = true;
            for (size_t i = 0; i < mfd_.size(); ++i) {
              if (!m_eof_[i]) members_gone = false;
            }
            if (shutdown_done_ || members_gone) {
              SendShutdownSentinel();
              return 0;
            }
            PeerFailureReport report;
            report.failed_rank = 0;
            report.cause = "connection_reset";
            report.detail =
                "the coordinator closed aggregator " +
                std::to_string(opt_.agg_id) + "'s uplink" +
                (why.empty() ? "" : " (" + why + ")");
            AbortDown(report);
            SendShutdownSentinel();
            return 1;
          }
        }
        continue;
      }
      if (who == -3) {
        bool drained = false;
        while (!drained) {
          std::string why;
          FrameReader::St st = xrd_.Drain(peer_fd_, epoch16_, version_, &why);
          if (st == FrameReader::St::AGAIN) {
            drained = true;
          } else if (st == FrameReader::St::READY) {
            xrd_.Reset();  // heartbeats from the standby: liveness only
          } else {
            ::close(peer_fd_);  // standby died: keep serving, no failover
            peer_fd_ = -1;
            drained = true;
          }
        }
        continue;
      }
      size_t i = static_cast<size_t>(who);
      bool drained = false;
      while (!drained && mfd_[i] >= 0) {
        std::string why;
        FrameReader::St st = mrd_[i].Drain(mfd_[i], epoch16_, version_, &why);
        if (st == FrameReader::St::AGAIN) {
          drained = true;
        } else if (st == FrameReader::St::READY) {
          if (!OnMemberFrame(i, mrd_[i], &exit_code)) return exit_code;
        } else {
          if (shutdown_done_) {
            // Clean teardown: the member processed the shutdown response
            // and closed.  When the whole group is gone, stand down (and
            // tell the standby to as well).
            dead_fds_.push_back(mfd_[i]);
            mfd_[i] = -1;
            m_eof_[i] = true;
            bool all_gone = true;
            for (size_t k = 0; k < m_eof_.size(); ++k) {
              if (!m_eof_[k]) all_gone = false;
            }
            if (all_gone) {
              SendShutdownSentinel();
              return 0;
            }
          } else {
            // Mid-job EOF: usually a member reattaching after ITS timeout
            // (it will re-knock this listener or the standby's); real
            // death surfaces as no re-knock within member_timeout_ms.
            ParkMemberFd(i);
          }
          drained = true;
        }
      }
    }
  }
}

int Relay::StandbyLoop() {
  promote_silence_ms_ = EnvLL("HVD_TPU_TREE_PROMOTE_SILENCE_MS", 1000);
  auto last_state_rx = Clock::now();
  bool knock = false;
  for (;;) {
    std::vector<pollfd> pfds;
    pfds.push_back({listen_fd_, POLLIN, 0});
    if (peer_fd_ >= 0) pfds.push_back({peer_fd_, POLLIN, 0});
    int pr = ::poll(pfds.data(), static_cast<nfds_t>(pfds.size()), 100);
    if (pr < 0 && errno != EINTR) return 1;
    bool promote = false;
    if (pr > 0 && (pfds[0].revents & POLLIN) != 0) {
      int wr = 0;
      int fd = AcceptHello(listen_fd_, epoch16_, version_, 1000, &wr);
      if (fd >= 0) {
        if (wr < 0) {
          // The primary's state stream.
          if (peer_fd_ >= 0) {
            ::shutdown(peer_fd_, SHUT_RDWR);
            dead_fds_.push_back(peer_fd_);
          }
          peer_fd_ = fd;
          xrd_.Reset();
          last_state_rx = Clock::now();
        } else {
          // A member knocking here means it gave up on the primary.  Park
          // the connection un-read (PrimaryLoop's readers drain the bytes
          // after promotion) and treat the knock as promotion evidence.
          int idx = members_.empty() ? -1 : wr - members_[0];
          if (idx >= 0 && idx < static_cast<int>(members_.size()) &&
              members_[static_cast<size_t>(idx)] == wr) {
            size_t i = static_cast<size_t>(idx);
            ParkMemberFd(i);
            mfd_[i] = fd;
            m_ever_attached_[i] = true;
            knock = true;
          } else {
            ::close(fd);
          }
        }
      }
    }
    if (peer_fd_ >= 0 && pfds.size() > 1 &&
        (pfds[1].revents & (POLLIN | POLLERR | POLLHUP)) != 0) {
      bool drained = false;
      while (!drained && !promote) {
        std::string why;
        FrameReader::St st = xrd_.Drain(peer_fd_, epoch16_, version_, &why);
        if (st == FrameReader::St::AGAIN) {
          drained = true;
        } else if (st == FrameReader::St::READY) {
          FrameType t = static_cast<FrameType>(xrd_.hdr.type);
          if (t == FrameType::AGG_STATE) {
            AggState st2;
            if (Deserialize(xrd_.body.data(), xrd_.body.size(), &st2)) {
              if (st2.seq == kShutdownSeq) return 0;  // clean stand-down
              last_seq_ = st2.seq;
              last_response_ = st2.response;
            }
          }
          // AGG_STATE and HEARTBEAT both prove the primary lives.
          last_state_rx = Clock::now();
          xrd_.Reset();
        } else {
          promote = true;  // EOF/corrupt state stream: the primary is gone
        }
      }
    }
    // SIGSTOP/partition promotion: a member gave up on the primary AND the
    // primary's state stream has gone silent.  Both conditions guard
    // against split-brain — a slow-but-alive primary keeps heartbeating
    // this stream, so a member knock alone never promotes.
    if (!promote && knock &&
        MsSince(last_state_rx) > promote_silence_ms_) {
      promote = true;
    }
    if (promote) {
      if (peer_fd_ >= 0) {
        ::shutdown(peer_fd_, SHUT_RDWR);
        dead_fds_.push_back(peer_fd_);
        peer_fd_ = -1;
      }
      std::string why;
      if (!ConnectParent(10.0, &why)) {
        // Root unreachable at promotion — most commonly the job tore down
        // with the primary; nothing to serve.
        PeerFailureReport report;
        report.failed_rank = 0;
        report.cause = "connection_lost";
        report.detail = "promoted standby aggregator " +
                        std::to_string(opt_.agg_id) +
                        " could not reach the coordinator: " + why;
        AbortDown(report);
        return 1;
      }
      return kPromote;
    }
  }
}

int Relay::Run() {
  plan_ = PlanTree(opt_.size, opt_.fanout, opt_.threshold, 1);
  if (!plan_.active || opt_.agg_id < 0 || opt_.agg_id >= plan_.num_groups) {
    std::fprintf(stderr,
                 "horovod_tpu relay: invalid topology (size=%d fanout=%d "
                 "agg_id=%d)\n",
                 opt_.size, opt_.fanout, opt_.agg_id);
    return 2;
  }
  epoch16_ = static_cast<uint16_t>(opt_.epoch & 0xFFFF);
  version_ = wire::WireVersionFromEnv();
  start_ = Clock::now();
  members_ = TreeMembersOf(opt_.agg_id, plan_);
  mfd_.assign(members_.size(), -1);
  mrd_.assign(members_.size(), FrameReader{});
  m_detach_since_.assign(members_.size(), Clock::now());
  m_ever_attached_.assign(members_.size(), false);
  m_eof_.assign(members_.size(), false);
  int lp = opt_.listen_port;
  std::string err;
  listen_fd_ = TcpControlPlane::BindListener(&lp, &err);
  if (listen_fd_ < 0) {
    std::fprintf(stderr, "horovod_tpu relay %d: %s\n", opt_.agg_id,
                 err.c_str());
    return 2;
  }
  SetNonBlocking(listen_fd_);
  int rc;
  if (opt_.standby) {
    rc = StandbyLoop();
    if (rc != kPromote) return rc;
  } else {
    std::string why;
    if (!ConnectParent(wire::RendezvousBudgetSeconds(), &why)) {
      std::fprintf(stderr,
                   "horovod_tpu relay %d: cannot reach the coordinator at "
                   "%s:%d: %s\n",
                   opt_.agg_id, opt_.parent_host.c_str(), opt_.parent_port,
                   why.c_str());
      return 1;
    }
    ConnectPeer();
  }
  rc = PrimaryLoop();
  if (!opt_.stats_path.empty()) {
    std::FILE* f = std::fopen(opt_.stats_path.c_str(), "a");
    if (f != nullptr) {
      std::fprintf(f,
                   "{\"agg_id\": %d, \"busy_us\": %lld, \"rounds\": %lld}\n",
                   opt_.agg_id, busy_us_, rounds_);
      std::fclose(f);
    }
  }
  for (size_t i = 0; i < mfd_.size(); ++i) {
    if (mfd_[i] >= 0) ::close(mfd_[i]);
  }
  for (int fd : dead_fds_) ::close(fd);
  if (parent_fd_ >= 0) ::close(parent_fd_);
  if (peer_fd_ >= 0) ::close(peer_fd_);
  if (listen_fd_ >= 0) ::close(listen_fd_);
  return rc;
}

}  // namespace

int RunRelay(const RelayOptions& opt) {
  Relay relay(opt);
  return relay.Run();
}

}  // namespace hvd
