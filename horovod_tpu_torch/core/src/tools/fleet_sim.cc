// Deviceless fleet simulator (docs/benchmarks.md "Control-plane scaling",
// docs/fault_tolerance.md "Mid-tree aggregator death").
//
// Proves the hierarchical coordinator tree at fleet scale without a fleet:
// the REAL TreeRootPlane + Coordinator + ResponseCache run in this
// process; the relay aggregators are REAL RunRelay children (forked, so
// they are honest SIGKILL/SIGSTOP targets); only the workers are scripted
// — a single-threaded mux drives P-1 protocol-only members through the
// exact member wire protocol (HELLO handshake, [seq][RequestList] REQUEST,
// RESPONSE, heartbeat demux, endpoint-alternating reattach).
//
// MEASUREMENT METHODOLOGY (1-core honesty): this host runs everything, so
// wall-clock per tick measures the Linux scheduler, not the protocol.
// Each tier instead reports BUSY time — wall minus poll()/recv() waits —
// and the simulator composes the modeled critical-path tick a real fleet
// would traverse:
//
//   modeled_tick = root busy/tick + relay busy/round + member busy/tick
//
// (network latency excluded; it is topology-independent per hop and the
// tree adds exactly one hop).  MTTR, by contrast, IS wall-clock: SIGKILL
// recovery is EOF-driven end to end, so the elapsed time from kill() to
// the next completed root tick is the honest number even on one core.
//
//   make -C horovod_tpu/core fleet_sim
//   ./fleet_sim --p 4096 --fanout 64 --ticks 50
//   ./fleet_sim --p 512 --topology star --ticks 50
//   ./fleet_sim --p 64 --fanout 8 --chaos kill     (aggregator failover)
//   ./fleet_sim --p 64 --fanout 8 --chaos stop     (subtree partition)
//
// Output: one JSON line.  Driven by bench.py's control_plane phase and
// tests/test_tree.py; star_bench --sweep forks it per configuration.

#include <arpa/inet.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <poll.h>
#include <signal.h>
#include <sys/resource.h>
#include <sys/socket.h>
#include <sys/stat.h>
#include <sys/types.h>
#include <sys/wait.h>
#include <unistd.h>

#include <atomic>
#include <chrono>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

#include "controller.h"
#include "message.h"
#include "tree.h"
#include "wire.h"

namespace {

using Clock = std::chrono::steady_clock;
using hvd::FrameHeader;
using hvd::FrameType;
using hvd::RequestList;
using hvd::ResponseList;

double MsBetween(Clock::time_point a, Clock::time_point b) {
  return std::chrono::duration<double, std::milli>(b - a).count();
}

// --------------------------------------------------------------------------
// Scripted-member wire helpers.  Blocking (the mux is a serial script);
// the real planes keep their own incremental readers — these exist only so
// the simulator's members speak the identical frame bytes.
// --------------------------------------------------------------------------

bool SendFrame(int fd, FrameType type, const std::string& payload,
               uint16_t epoch, uint8_t version) {
  FrameHeader h;
  h.version = version;
  h.type = static_cast<uint8_t>(type);
  h.flags = epoch;
  h.payload_len = static_cast<uint32_t>(payload.size());
  h.crc32 = hvd::Crc32(payload.data(), payload.size());
  char hdr[hvd::kFrameHeaderBytes];
  hvd::EncodeFrameHeader(h, hdr);
  return hvd::wire::SendAll(fd, hdr, hvd::kFrameHeaderBytes) &&
         hvd::wire::SendAll(fd, payload.data(), payload.size());
}

enum class Rx { OK, CLOSED, TIMEOUT, BAD };

// One blocking frame read bounded by the fd's SO_RCVTIMEO.
Rx RecvFrame(int fd, uint8_t* type_out, std::string* payload_out) {
  char hdr_buf[hvd::kFrameHeaderBytes];
  size_t got = 0;
  while (got < hvd::kFrameHeaderBytes) {
    ssize_t r = ::recv(fd, hdr_buf + got, hvd::kFrameHeaderBytes - got, 0);
    if (r == 0) return Rx::CLOSED;
    if (r < 0) {
      if (errno == EINTR) continue;
      if (errno == EAGAIN || errno == EWOULDBLOCK) return Rx::TIMEOUT;
      return Rx::BAD;
    }
    got += static_cast<size_t>(r);
  }
  FrameHeader h;
  hvd::DecodeFrameHeader(hdr_buf, &h);
  if (h.magic != hvd::kFrameMagic ||
      h.payload_len > hvd::wire::kMaxFrameBytes) {
    return Rx::BAD;
  }
  payload_out->assign(h.payload_len, '\0');
  if (h.payload_len > 0 &&
      !hvd::wire::RecvAll(fd, &(*payload_out)[0], payload_out->size())) {
    return Rx::BAD;
  }
  if (hvd::Crc32(payload_out->data(), payload_out->size()) != h.crc32) {
    return Rx::BAD;
  }
  *type_out = h.type;
  return Rx::OK;
}

void SetRecvTimeoutMs(int fd, long long ms) {
  timeval tv{};
  tv.tv_sec = static_cast<time_t>(ms / 1000);
  tv.tv_usec = static_cast<suseconds_t>((ms % 1000) * 1000);
  ::setsockopt(fd, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof(tv));
}

// Connect + HELLO + HELLO_ACK as rank `rank`; -1 on any failure.
int ConnectHello(const std::string& host, int port, int rank,
                 long long ack_wait_ms) {
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_port = htons(static_cast<uint16_t>(port));
  if (::inet_pton(AF_INET, host.c_str(), &addr.sin_addr) != 1) return -1;
  int fd = ::socket(AF_INET, SOCK_STREAM, 0);
  if (fd < 0) return -1;
  int one = 1;
  ::setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
  if (::connect(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) != 0) {
    ::close(fd);
    return -1;
  }
  std::string hello(12, '\0');
  int32_t r32 = rank;
  std::memcpy(&hello[0], &r32, 4);
  if (!SendFrame(fd, FrameType::HELLO, hello, 0,
                 hvd::wire::WireVersionFromEnv())) {
    ::close(fd);
    return -1;
  }
  SetRecvTimeoutMs(fd, ack_wait_ms);
  uint8_t t = 0;
  std::string body;
  if (RecvFrame(fd, &t, &body) != Rx::OK ||
      t != static_cast<uint8_t>(FrameType::HELLO_ACK) || !body.empty()) {
    ::close(fd);
    return -1;
  }
  return fd;
}

// --------------------------------------------------------------------------
// Workloads: one warm-up tick of full requests (negotiates + populates the
// response cache), then warm all-bits ticks — the steady state a stable
// training step settles into (docs/response_cache.md).
// --------------------------------------------------------------------------

std::string BitName(int i) { return "grad/bit_" + std::to_string(i); }

RequestList FullRequests(int rank, int bits) {
  RequestList rl;
  for (int i = 0; i < bits; ++i) {
    hvd::Request r;
    r.rank = rank;
    r.name = BitName(i);
    r.shape.dims = {1024, 1024};
    rl.requests.push_back(std::move(r));
  }
  return rl;
}

RequestList BitRequests(int bits) {
  RequestList rl;
  for (int i = 0; i < bits; ++i) rl.cache_hits.push_back(i);
  return rl;
}

// --------------------------------------------------------------------------
// Configuration + per-run state
// --------------------------------------------------------------------------

struct Config {
  int p = 64;
  int ticks = 20;
  int fanout = 0;
  int bits = 8;
  std::string topology;   // "", "tree", "star"
  std::string chaos;      // "", "kill", "stop"
  int standby = 1;
  long long recv_timeout_ms = 0;  // 0 = auto
  std::string stats_dir;
};

struct Member {
  int rank = 0;
  int group = -1;
  int fd = -1;
  bool on_standby = false;
};

struct MuxShared {
  // Written by main (root) thread, read by the mux thread.
  std::atomic<bool> fail{false};
  // Designated-member busy time (member 0's serialize/send/recv/parse µs,
  // excluding waits) accumulated over the timed ticks.
  std::atomic<long long> member_busy_us{0};
  std::atomic<long long> reattaches{0};
};

int64_t g_epoch = 0;
uint16_t Epoch16() { return static_cast<uint16_t>(g_epoch & 0xFFFF); }

// Reserve n distinct free ports.  All reservation sockets are held open
// until every port is picked — releasing them one at a time lets the
// kernel hand the same port out twice (observed at 128 relay children).
std::vector<int> ReservePorts(int n) {
  std::vector<int> ports(static_cast<size_t>(n));
  std::vector<int> fds(static_cast<size_t>(n));
  for (int i = 0; i < n; ++i) {
    std::string err;
    fds[static_cast<size_t>(i)] =
        hvd::TcpControlPlane::BindListener(&ports[static_cast<size_t>(i)],
                                           &err);
    if (fds[static_cast<size_t>(i)] < 0) {
      std::fprintf(stderr, "fleet_sim: port reservation failed: %s\n",
                   err.c_str());
      std::exit(2);
    }
  }
  for (int fd : fds) ::close(fd);
  return ports;
}

void RaiseFdLimit() {
  rlimit rl{};
  if (::getrlimit(RLIMIT_NOFILE, &rl) == 0) {
    rlim_t want = 16384;
    if (rl.rlim_max != RLIM_INFINITY && want > rl.rlim_max) {
      want = rl.rlim_max;
    }
    if (rl.rlim_cur < want) {
      rl.rlim_cur = want;
      ::setrlimit(RLIMIT_NOFILE, &rl);
    }
  }
}

// --------------------------------------------------------------------------
// The member mux: P-1 scripted members on one thread.  Member 0 (global
// rank 1) is the designated busy-measurement member; the others only move
// bytes (shared pre-serialized payload, responses drained unparsed) so a
// 4095-member tick stays cheap enough to run on one core.
// --------------------------------------------------------------------------

struct MuxArgs {
  const Config* cfg;
  const hvd::TreePlan* plan;  // nullptr in star mode
  std::vector<std::pair<hvd::TreeEndpoint, hvd::TreeEndpoint>> agg_eps;
  std::string star_host;
  int star_port = 0;
  MuxShared* shared;
};

bool AttachMember(const MuxArgs& a, Member* m, bool alternate) {
  long long deadline_ms = 30000;
  auto t0 = Clock::now();
  while (MsBetween(t0, Clock::now()) < static_cast<double>(deadline_ms)) {
    std::string host;
    int port;
    if (a.plan != nullptr) {
      if (alternate) m->on_standby = !m->on_standby;
      const auto& eps = a.agg_eps[static_cast<size_t>(m->group)];
      const hvd::TreeEndpoint& ep =
          (m->on_standby && eps.second.port > 0) ? eps.second : eps.first;
      host = ep.host;
      port = ep.port;
    } else {
      host = a.star_host;
      port = a.star_port;
    }
    int fd = ConnectHello(host, port, m->rank, 10000);
    if (fd >= 0) {
      long long rto = a.cfg->recv_timeout_ms;
      SetRecvTimeoutMs(fd, rto);
      m->fd = fd;
      return true;
    }
    alternate = a.plan != nullptr;  // keep cycling endpoints on retry
    ::usleep(20000);
  }
  return false;
}

// Reattach a tree member (alternating endpoints) and resend the SAME seq
// payload — the relay replays its stored response if this round was
// already answered, so the response stream never skips or duplicates.
bool ReattachResend(const MuxArgs& a, Member* m, const std::string& payload) {
  a.shared->reattaches.fetch_add(1, std::memory_order_relaxed);
  for (int attempt = 0; attempt < 8; ++attempt) {
    if (m->fd >= 0) {
      ::close(m->fd);
      m->fd = -1;
    }
    if (!AttachMember(a, m, /*alternate=*/true)) return false;
    if (SendFrame(m->fd, FrameType::REQUEST, payload, Epoch16(),
                  hvd::wire::WireVersionFromEnv())) {
      return true;
    }
  }
  return false;
}

void RunMux(MuxArgs a) {
  const Config& cfg = *a.cfg;
  int nm = cfg.p - 1;
  std::vector<Member> members(static_cast<size_t>(nm));
  for (int i = 0; i < nm; ++i) {
    members[static_cast<size_t>(i)].rank = i + 1;
    if (a.plan != nullptr) {
      members[static_cast<size_t>(i)].group =
          hvd::TreeGroupOf(i + 1, *a.plan);
    }
  }
  for (auto& m : members) {
    if (!AttachMember(a, &m, false)) {
      std::fprintf(stderr, "fleet_sim: member %d could not attach\n", m.rank);
      a.shared->fail.store(true);
      return;
    }
  }
  uint8_t version = hvd::wire::WireVersionFromEnv();
  std::string resp;
  for (int t = 0; t < cfg.ticks; ++t) {
    bool warm = t == 0;
    bool last = t == cfg.ticks - 1;
    int64_t seq = t + 1;
    // Shared payload for the non-designated members (bit ticks carry no
    // rank-dependent bytes); the designated member always serializes its
    // own so its busy number reflects a real member's CPU cost.
    std::string shared_payload;
    if (!warm) {
      RequestList rl = BitRequests(cfg.bits);
      rl.shutdown = last;
      std::string body;
      hvd::Serialize(rl, &body);
      if (a.plan != nullptr) {
        shared_payload.assign(8, '\0');
        std::memcpy(&shared_payload[0], &seq, 8);
        shared_payload += body;
      } else {
        shared_payload = body;
      }
    }
    for (int i = 0; i < nm; ++i) {
      Member& m = members[static_cast<size_t>(i)];
      std::string payload;
      bool designated = i == 0;
      long long b0 = hvd::wire::ThreadCpuMicros();
      if (warm || designated) {
        RequestList rl = warm ? FullRequests(m.rank, cfg.bits)
                              : BitRequests(cfg.bits);
        rl.shutdown = last;
        std::string body;
        hvd::Serialize(rl, &body);
        if (a.plan != nullptr) {
          payload.assign(8, '\0');
          std::memcpy(&payload[0], &seq, 8);
          payload += body;
        } else {
          payload = body;
        }
      } else {
        payload = shared_payload;
      }
      bool ok = SendFrame(m.fd, FrameType::REQUEST, payload, Epoch16(),
                          version);
      if (designated && !warm) {
        a.shared->member_busy_us.fetch_add(
            hvd::wire::ThreadCpuMicros() - b0, std::memory_order_relaxed);
      }
      if (!ok) {
        if (a.plan == nullptr ||
            (::close(m.fd), m.fd = -1,
             !AttachMember(a, &m, true) ||
                 !SendFrame(m.fd, FrameType::REQUEST, payload, Epoch16(),
                            version))) {
          std::fprintf(stderr, "fleet_sim: member %d send failed\n", m.rank);
          a.shared->fail.store(true);
          return;
        }
      }
    }
    // Response phase, event-driven: poll across every pending member so a
    // dead aggregator is discovered by ALL its members promptly (a serial
    // per-member wait would head-of-line block — the promoted standby
    // cannot form its aggregate until every group member has resent).
    auto build_payload = [&](const Member& m) -> std::string {
      if (!warm) return shared_payload;
      RequestList rl = FullRequests(m.rank, cfg.bits);
      rl.shutdown = last;
      std::string body;
      hvd::Serialize(rl, &body);
      if (a.plan == nullptr) return body;
      std::string p(8, '\0');
      std::memcpy(&p[0], &seq, 8);
      return p + body;
    };
    std::vector<char> got(static_cast<size_t>(nm), 0);
    // Any frame (heartbeats included) proves the aggregator lives; only
    // true silence past recv_timeout_ms triggers a reattach — that is the
    // SIGSTOP/partition path, where no EOF ever arrives.
    std::vector<Clock::time_point> last_act(static_cast<size_t>(nm),
                                            Clock::now());
    int pending = nm;
    auto phase_start = Clock::now();
    std::vector<pollfd> pfds;
    std::vector<int> who;
    while (pending > 0) {
      if (MsBetween(phase_start, Clock::now()) > 120000.0) {
        std::fprintf(stderr, "fleet_sim: tick %d response phase hung\n", t);
        a.shared->fail.store(true);
        return;
      }
      pfds.clear();
      who.clear();
      for (int i = 0; i < nm; ++i) {
        if (got[static_cast<size_t>(i)] == 0 &&
            members[static_cast<size_t>(i)].fd >= 0) {
          pfds.push_back({members[static_cast<size_t>(i)].fd, POLLIN, 0});
          who.push_back(i);
        }
      }
      int pr = ::poll(pfds.data(), static_cast<nfds_t>(pfds.size()), 100);
      if (pr < 0 && errno != EINTR) {
        a.shared->fail.store(true);
        return;
      }
      for (size_t s = 0; pr > 0 && s < pfds.size(); ++s) {
        if ((pfds[s].revents & (POLLIN | POLLERR | POLLHUP | POLLNVAL)) ==
            0) {
          continue;
        }
        int i = who[s];
        Member& m = members[static_cast<size_t>(i)];
        bool designated = i == 0;
        uint8_t ft = 0;
        Rx rx = RecvFrame(m.fd, &ft, &resp);
        if (rx == Rx::OK) {
          last_act[static_cast<size_t>(i)] = Clock::now();
          if (ft == static_cast<uint8_t>(FrameType::RESPONSE)) {
            got[static_cast<size_t>(i)] = 1;
            --pending;
            if (designated && !warm) {
              // Parse cost only (the recv wait is the relay/root's
              // latency, not member CPU): deserialize the verdict like a
              // real member's dispatch would.
              long long p0 = hvd::wire::ThreadCpuMicros();
              ResponseList rl;
              hvd::Deserialize(resp.data(), resp.size(), &rl);
              a.shared->member_busy_us.fetch_add(
                  hvd::wire::ThreadCpuMicros() - p0,
                  std::memory_order_relaxed);
            }
          } else if (ft == static_cast<uint8_t>(FrameType::ABORT)) {
            std::fprintf(stderr, "fleet_sim: member %d received ABORT\n",
                         m.rank);
            a.shared->fail.store(true);
            return;
          }
          // HEARTBEAT/chatter: activity recorded above, nothing else.
        } else {
          if (a.plan == nullptr) {
            std::fprintf(stderr, "fleet_sim: member %d lost the star plane\n",
                         m.rank);
            a.shared->fail.store(true);
            return;
          }
          if (!ReattachResend(a, &m, build_payload(m))) {
            a.shared->fail.store(true);
            return;
          }
          last_act[static_cast<size_t>(i)] = Clock::now();
        }
      }
      if (a.plan != nullptr) {
        for (int i = 0; i < nm; ++i) {
          if (got[static_cast<size_t>(i)] != 0) continue;
          if (MsBetween(last_act[static_cast<size_t>(i)], Clock::now()) >
              static_cast<double>(cfg.recv_timeout_ms)) {
            Member& m = members[static_cast<size_t>(i)];
            if (!ReattachResend(a, &m, build_payload(m))) {
              a.shared->fail.store(true);
              return;
            }
            last_act[static_cast<size_t>(i)] = Clock::now();
          }
        }
      }
    }
  }
  for (auto& m : members) {
    if (m.fd >= 0) ::close(m.fd);
  }
}

// --------------------------------------------------------------------------
// Root driver: the engine's coordinator cycle (Gather -> Tick ->
// Broadcast) against the REAL plane, with response-cache Store mimicry on
// the warm tick (what Engine::DispatchResponses does on rank 0).
// --------------------------------------------------------------------------

struct RootResult {
  bool ok = false;
  long long busy_us_timed = 0;   // plane busy + Tick CPU, ticks 1..T-1
  long long frames_rx = 0;
  long long agg_frames = 0;
  long long hb_frames = 0;
  double mttr_ms = -1;
};

}  // namespace

int main(int argc, char** argv) {
  Config cfg;
  for (int i = 1; i < argc; ++i) {
    std::string f = argv[i];
    auto next = [&]() -> const char* {
      return i + 1 < argc ? argv[++i] : "";
    };
    if (f == "--p") cfg.p = std::atoi(next());
    else if (f == "--ticks") cfg.ticks = std::atoi(next());
    else if (f == "--fanout") cfg.fanout = std::atoi(next());
    else if (f == "--bits") cfg.bits = std::atoi(next());
    else if (f == "--topology") cfg.topology = next();
    else if (f == "--chaos") cfg.chaos = next();
    else if (f == "--standby") cfg.standby = std::atoi(next());
    else if (f == "--recv-timeout-ms") cfg.recv_timeout_ms = std::atoll(next());
    else if (f == "--stats-dir") cfg.stats_dir = next();
    else {
      std::fprintf(stderr,
                   "usage: fleet_sim --p N --ticks T [--fanout F] "
                   "[--topology tree|star] [--bits B] [--chaos kill|stop] "
                   "[--standby 0|1] [--recv-timeout-ms MS]\n");
      return 2;
    }
  }
  bool tree = cfg.topology != "star" && cfg.fanout >= 2;
  if (cfg.topology == "tree" && cfg.fanout < 2) {
    std::fprintf(stderr, "fleet_sim: --topology tree needs --fanout >= 2\n");
    return 2;
  }
  if (cfg.p < 3 || cfg.ticks < 2 || cfg.bits < 1) {
    std::fprintf(stderr, "fleet_sim: need --p >= 3, --ticks >= 2\n");
    return 2;
  }
  if (!cfg.chaos.empty() && (!tree || cfg.standby == 0)) {
    std::fprintf(stderr, "fleet_sim: --chaos needs the tree + standbys\n");
    return 2;
  }
  if (cfg.recv_timeout_ms <= 0) {
    cfg.recv_timeout_ms = cfg.chaos == "stop" ? 700 : 10000;
  }
  RaiseFdLimit();
  ::signal(SIGPIPE, SIG_IGN);

  hvd::TreePlan plan =
      hvd::PlanTree(cfg.p, tree ? cfg.fanout : 0, 0, tree ? 1 : 0);
  if (tree && !plan.active) {
    std::fprintf(stderr, "fleet_sim: tree plan inactive at p=%d fanout=%d\n",
                 cfg.p, cfg.fanout);
    return 2;
  }

  if (cfg.stats_dir.empty()) {
    char tmpl[] = "/tmp/fleet_sim.XXXXXX";
    char* d = ::mkdtemp(tmpl);
    if (d == nullptr) {
      std::fprintf(stderr, "fleet_sim: mkdtemp failed\n");
      return 2;
    }
    cfg.stats_dir = d;
  }

  int nports = 1;
  if (tree) nports += plan.num_groups * (cfg.standby != 0 ? 2 : 1);
  std::vector<int> ports = ReservePorts(nports);
  int root_port = ports[0];
  std::vector<std::pair<hvd::TreeEndpoint, hvd::TreeEndpoint>> agg_eps;
  std::vector<pid_t> primaries, standbys;
  if (tree) {
    agg_eps.resize(static_cast<size_t>(plan.num_groups));
    size_t pi = 1;
    for (int g = 0; g < plan.num_groups; ++g) {
      agg_eps[static_cast<size_t>(g)].first = {"127.0.0.1", ports[pi++]};
      if (cfg.standby != 0) {
        agg_eps[static_cast<size_t>(g)].second = {"127.0.0.1", ports[pi++]};
      }
    }
    // Standbys first (they park and wait), then primaries.
    for (int g = 0; g < plan.num_groups; ++g) {
      const auto& eps = agg_eps[static_cast<size_t>(g)];
      if (cfg.standby != 0) {
        pid_t pid = ::fork();
        if (pid == 0) {
          hvd::RelayOptions opt;
          opt.agg_id = g;
          opt.parent_host = "127.0.0.1";
          opt.parent_port = root_port;
          opt.listen_port = eps.second.port;
          opt.size = cfg.p;
          opt.fanout = cfg.fanout;
          opt.epoch = g_epoch;
          opt.standby = true;
          opt.member_timeout_ms = 30000;
          opt.stats_path = cfg.stats_dir + "/standby" + std::to_string(g) +
                           ".json";
          std::_Exit(hvd::RunRelay(opt));
        }
        standbys.push_back(pid);
      }
      pid_t pid = ::fork();
      if (pid == 0) {
        hvd::RelayOptions opt;
        opt.agg_id = g;
        opt.parent_host = "127.0.0.1";
        opt.parent_port = root_port;
        opt.listen_port = eps.first.port;
        opt.size = cfg.p;
        opt.fanout = cfg.fanout;
        opt.epoch = g_epoch;
        if (cfg.standby != 0) {
          opt.peer_host = "127.0.0.1";
          opt.peer_port = eps.second.port;
        }
        opt.member_timeout_ms = 30000;
        opt.stats_path = cfg.stats_dir + "/agg" + std::to_string(g) + ".json";
        std::_Exit(hvd::RunRelay(opt));
      }
      primaries.push_back(pid);
    }
  }

  // Bring up the plane.  Star mode: MakeCoordinator blocks until all
  // members HELLO, so the mux thread must already be running.
  MuxShared shared;
  MuxArgs margs;
  margs.cfg = &cfg;
  margs.plan = tree ? &plan : nullptr;
  margs.agg_eps = agg_eps;
  margs.star_host = "127.0.0.1";
  margs.star_port = root_port;
  margs.shared = &shared;

  std::unique_ptr<hvd::ControlPlane> plane;
  hvd::TreeRootPlane* tree_plane = nullptr;
  std::thread mux;
  if (tree) {
    std::string err;
    auto tp = hvd::TreeRootPlane::Make(root_port, cfg.p, g_epoch, plan, &err);
    if (!tp) {
      std::fprintf(stderr, "fleet_sim: root plane: %s\n", err.c_str());
      for (pid_t pid : primaries) ::kill(pid, SIGKILL);
      for (pid_t pid : standbys) ::kill(pid, SIGKILL);
      return 1;
    }
    tree_plane = tp.get();
    plane = std::move(tp);
    mux = std::thread(RunMux, margs);
  } else {
    mux = std::thread(RunMux, margs);
    std::string err;
    auto sp = hvd::TcpControlPlane::MakeCoordinator(root_port, cfg.p, g_epoch,
                                                    &err);
    if (!sp) {
      std::fprintf(stderr, "fleet_sim: star plane: %s\n", err.c_str());
      shared.fail.store(true);
      mux.join();
      return 1;
    }
    plane = std::move(sp);
  }

  // Root-side heartbeat monitor (the engine's MonitorLoop analog): keeps
  // the liveness machinery honest — SIGSTOP detection on the root side is
  // timer-driven, not EOF-driven.
  std::atomic<bool> stop_monitor{false};
  std::thread monitor([&]() {
    while (!stop_monitor.load()) {
      plane->HeartbeatTick(10.0);
      ::usleep(100000);
    }
  });

  // The engine's coordinator negotiation stack, for real.
  hvd::ResponseCache cache;
  cache.SetCapacity(static_cast<size_t>(cfg.bits) + 8);
  hvd::Coordinator coordinator(cfg.p, 60.0, false);
  coordinator.SetResponseCache(&cache);

  RootResult rr;
  long long tick_cpu_us = 0;
  long long busy_after_warm = 0;
  long long tick_cpu_after_warm = 0;
  int kill_tick = cfg.chaos.empty() ? -1 : cfg.ticks / 2;
  bool root_failed = false;
  std::vector<hvd::RequestList> all;
  for (int t = 0; t < cfg.ticks && !root_failed; ++t) {
    bool warm = t == 0;
    RequestList own = warm ? FullRequests(0, cfg.bits) : BitRequests(cfg.bits);
    auto tick_start = Clock::now();
    if (!plane->Gather(own, &all)) {
      hvd::PeerFailureReport r;
      plane->GetFailure(&r);
      std::fprintf(stderr, "fleet_sim: root gather failed at tick %d: %s %s\n",
                   t, r.cause.c_str(), r.detail.c_str());
      root_failed = true;
      break;
    }
    long long c0 = hvd::wire::ThreadCpuMicros();
    ResponseList out = coordinator.Tick(all);
    if (warm) {
      // Engine::DispatchResponses' rank-0 half: store freshly negotiated
      // single-name verdicts into their assigned slots so the bit ticks
      // have a warm authoritative cache.
      for (const auto& r : out.responses) {
        if (r.store_bit >= 0 && r.tensor_names.size() == 1) {
          hvd::Request req;
          req.name = r.tensor_names[0];
          req.shape.dims = {1024, 1024};
          hvd::Response clean = r;
          clean.cache_bit = -1;
          clean.store_bit = -1;
          cache.Store(r.store_bit, r.tensor_names[0], clean,
                      hvd::ResponseCache::Signature(req));
        }
      }
    }
    tick_cpu_us += hvd::wire::ThreadCpuMicros() - c0;
    if (!plane->Broadcast(out)) {
      std::fprintf(stderr, "fleet_sim: root broadcast failed at tick %d\n", t);
      root_failed = true;
      break;
    }
    if (warm) {
      busy_after_warm = plane->BusyMicros() + tick_cpu_us;
      tick_cpu_after_warm = tick_cpu_us;
      // Sanity: the scripted members announce bits 0..B-1, so slot
      // assignment must have run 0..B-1 in FIFO order.
      for (int i = 0; i < cfg.bits; ++i) {
        if (cache.BitOf(BitName(i)) != i) {
          std::fprintf(stderr, "fleet_sim: cache slot drift (bit %d)\n", i);
          root_failed = true;
        }
      }
    }
    if (t == kill_tick) {
      pid_t target = primaries[0];
      auto k0 = Clock::now();
      ::kill(target, cfg.chaos == "stop" ? SIGSTOP : SIGKILL);
      // MTTR: kill() -> the next fully completed negotiation round.
      RequestList own2 = BitRequests(cfg.bits);
      if (!plane->Gather(own2, &all)) {
        hvd::PeerFailureReport r;
        plane->GetFailure(&r);
        std::fprintf(stderr, "fleet_sim: recovery gather failed: %s %s\n",
                     r.cause.c_str(), r.detail.c_str());
        root_failed = true;
        break;
      }
      ResponseList out2 = coordinator.Tick(all);
      if (!plane->Broadcast(out2)) {
        root_failed = true;
        break;
      }
      rr.mttr_ms = MsBetween(k0, Clock::now());
      ++t;  // the recovery round consumed one scripted tick
    }
    (void)tick_start;
  }
  rr.busy_us_timed = plane->BusyMicros() + tick_cpu_us - busy_after_warm;
  rr.frames_rx = plane->FramesReceived();
  if (tree_plane != nullptr) {
    rr.agg_frames = tree_plane->AggFramesReceived();
    rr.hb_frames = tree_plane->HeartbeatFramesReceived();
  }
  rr.ok = !root_failed;

  mux.join();
  stop_monitor.store(true);
  monitor.join();
  bool mux_ok = !shared.fail.load();
  plane.reset();  // closes relay uplinks -> clean relay teardown

  // Reap children; in chaos mode the group-0 primary died by design.
  bool relays_ok = true;
  long long relay_busy_us = 0, relay_rounds = 0;
  if (tree) {
    for (size_t g = 0; g < primaries.size(); ++g) {
      if (!cfg.chaos.empty() && g == 0) {
        ::kill(primaries[g], SIGKILL);  // no-op after SIGKILL chaos
      }
      int st = 0;
      ::waitpid(primaries[g], &st, 0);
      bool chaos_target = !cfg.chaos.empty() && g == 0;
      if (!chaos_target && !(WIFEXITED(st) && WEXITSTATUS(st) == 0)) {
        std::fprintf(stderr, "fleet_sim: relay %zu exited abnormally\n", g);
        relays_ok = false;
      }
    }
    for (pid_t pid : standbys) {
      int st = 0;
      ::waitpid(pid, &st, 0);
    }
    // Compose the relay tier's busy-per-round from the stats the children
    // appended (primaries; a promoted standby reports the same way).
    int counted = 0;
    for (int g = 0; g < plan.num_groups; ++g) {
      for (const char* kind : {"agg", "standby"}) {
        std::string path =
            cfg.stats_dir + "/" + kind + std::to_string(g) + ".json";
        std::FILE* f = std::fopen(path.c_str(), "r");
        if (f == nullptr) continue;
        char line[256];
        while (std::fgets(line, sizeof(line), f) != nullptr) {
          int agg_id = 0;
          long long busy = 0, rounds = 0;
          if (std::sscanf(line,
                          "{\"agg_id\": %d, \"busy_us\": %lld, "
                          "\"rounds\": %lld}",
                          &agg_id, &busy, &rounds) == 3 &&
              rounds > 0) {
            relay_busy_us += busy;
            relay_rounds += rounds;
            ++counted;
          }
        }
        std::fclose(f);
      }
    }
    if (counted == 0) relays_ok = relays_ok && plan.num_groups == 0;
  }

  int timed_ticks = cfg.ticks - 1;
  double root_busy_per_tick =
      static_cast<double>(rr.busy_us_timed) / timed_ticks;
  double root_tick_cpu_per_tick =
      static_cast<double>(tick_cpu_us - tick_cpu_after_warm) / timed_ticks;
  double relay_busy_per_round =
      relay_rounds > 0
          ? static_cast<double>(relay_busy_us) / static_cast<double>(relay_rounds)
          : 0.0;
  double member_busy_per_tick =
      static_cast<double>(shared.member_busy_us.load()) / timed_ticks;
  double modeled_tick_us =
      root_busy_per_tick + relay_busy_per_round + member_busy_per_tick;
  double agg_frames_per_tick =
      tree ? static_cast<double>(rr.agg_frames) / cfg.ticks : 0.0;

  std::printf(
      "{\"p\": %d, \"topology\": \"%s\", \"fanout\": %d, \"num_groups\": %d, "
      "\"depth\": %d, \"ticks\": %d, \"bits\": %d, "
      "\"root_busy_us_per_tick\": %.1f, \"root_tick_cpu_us\": %.1f, "
      "\"relay_busy_us_per_round\": %.1f, "
      "\"member_busy_us_per_tick\": %.1f, \"modeled_tick_us\": %.1f, "
      "\"agg_frames_per_tick\": %.2f, \"hb_frames_total\": %lld, "
      "\"frames_rx_total\": %lld, \"reattaches\": %lld, \"mttr_ms\": %.1f, "
      "\"ok\": %s}\n",
      cfg.p, tree ? "tree" : "star", tree ? plan.fanout : 0,
      tree ? plan.num_groups : 0, tree ? plan.depth : 1, cfg.ticks, cfg.bits,
      root_busy_per_tick, root_tick_cpu_per_tick, relay_busy_per_round,
      member_busy_per_tick,
      modeled_tick_us, agg_frames_per_tick, rr.hb_frames, rr.frames_rx,
      shared.reattaches.load(), rr.mttr_ms,
      (rr.ok && mux_ok && relays_ok) ? "true" : "false");
  return (rr.ok && mux_ok && relays_ok) ? 0 : 1;
}
