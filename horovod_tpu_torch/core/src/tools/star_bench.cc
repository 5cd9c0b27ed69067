// Isolated control-plane star benchmark (VERDICT r4 item 4).
//
// Measures the coordinator's REAL per-tick cost at width P on loopback —
// the exact TcpControlPlane::Gather/Broadcast code the engine runs, with
// no JAX or device work in the loop.  The reference's demonstrated scale
// is 512 workers (reference README.md:45-51, MPI_Gather/Bcast control
// plane); this harness answers whether the rank-0 TCP star's tick fits
// the 5 ms HOROVOD_CYCLE_TIME budget there, and is the measurement
// behind the poll()-interleaved Gather (controller.cc).
//
//   make -C horovod_tpu/core star_bench
//   ./star_bench <P> <ticks> [payload_names]
//
// Output: one JSON line {p, ticks, tick_us, per_worker_us}.
// Driven by examples/control_plane_benchmark.py --star.
//
// Crossover mode (VERDICT Missing #2, docs/benchmarks.md):
//
//   ./star_bench --sweep [--ticks N]
//
// runs ./fleet_sim (same build dir, FLEET_SIM_BIN overrides) at
// {64,256,512,1024,4096} ranks under BOTH topologies and prints the
// star-vs-tree crossover table from the simulator's modeled per-tick
// busy composition.  Delegating both columns to fleet_sim keeps the
// comparison apples-to-apples: one busy model (thread-CPU), one member
// workload, one host.  The legacy positional mode above stays the
// wall-clock in-process star measurement it always was.

#include <chrono>
#include <cstdio>
#include <cstdlib>
#include <unistd.h>
#include <string>
#include <thread>
#include <vector>

#include "controller.h"
#include "message.h"

namespace {

hvd::RequestList MakeReq(int rank, int names) {
  hvd::RequestList rl;
  for (int i = 0; i < names; ++i) {
    hvd::Request r;
    r.rank = rank;
    r.name = "grad/layer_" + std::to_string(i) + "/kernel";
    r.shape.dims = {1024, 1024};
    rl.requests.push_back(std::move(r));
  }
  return rl;
}

// --- --sweep mode -----------------------------------------------------

// Pull `"key": <number>` out of a fleet_sim JSON result line.  fleet_sim
// emits flat one-line JSON with no nesting, so a substring probe is
// enough — no parser dependency for a bench binary.
bool JsonNumber(const std::string& line, const char* key, double* out) {
  std::string needle = std::string("\"") + key + "\":";
  size_t at = line.find(needle);
  if (at == std::string::npos) return false;
  *out = std::atof(line.c_str() + at + needle.size());
  return true;
}

struct SweepRow {
  int p = 0;
  int fanout = 0;       // 0 = star
  double tick_us = -1;  // modeled_tick_us; <0 = run failed
  double groups = 0;
  double depth = 0;
};

// Run one fleet_sim config via popen and harvest its JSON result line.
SweepRow RunSim(const std::string& bin, int p, int fanout, int ticks) {
  SweepRow row;
  row.p = p;
  row.fanout = fanout;
  char cmd[512];
  if (fanout > 0) {
    std::snprintf(cmd, sizeof(cmd), "%s --p %d --fanout %d --ticks %d 2>&1",
                  bin.c_str(), p, fanout, ticks);
  } else {
    std::snprintf(cmd, sizeof(cmd),
                  "%s --p %d --topology star --ticks %d 2>&1", bin.c_str(), p,
                  ticks);
  }
  std::fprintf(stderr, "[sweep] %s\n", cmd);
  FILE* f = ::popen(cmd, "r");
  if (!f) return row;
  std::string result_line;
  char buf[4096];
  while (std::fgets(buf, sizeof(buf), f)) {
    std::string line(buf);
    // The result is the last line carrying modeled_tick_us; relay chatter
    // and mux warnings land on the same stream under 2>&1.
    if (line.find("modeled_tick_us") != std::string::npos) result_line = line;
  }
  int rc = ::pclose(f);
  if (rc == 0 && result_line.find("\"ok\": true") != std::string::npos) {
    JsonNumber(result_line, "modeled_tick_us", &row.tick_us);
    JsonNumber(result_line, "num_groups", &row.groups);
    JsonNumber(result_line, "depth", &row.depth);
  }
  return row;
}

int RunSweep(int ticks) {
  const char* env_bin = std::getenv("FLEET_SIM_BIN");
  std::string bin = env_bin && *env_bin ? env_bin : "./fleet_sim";
  // Tree fanout per width: measured minima from the fanout sweep — root
  // cost is per-aggregate-frame, so wider groups win as P grows
  // (docs/benchmarks.md records the underlying sweep).
  struct {
    int p;
    int fanout;
  } const kConfigs[] = {{64, 8}, {256, 16}, {512, 16}, {1024, 32},
                        {4096, 128}};
  std::printf("| ranks | star tick (us) | tree tick (us) | tree layout "
              "| winner |\n");
  std::printf("|---|---|---|---|---|\n");
  bool all_ok = true;
  for (const auto& c : kConfigs) {
    SweepRow star = RunSim(bin, c.p, 0, ticks);
    SweepRow tree = RunSim(bin, c.p, c.fanout, ticks);
    if (star.tick_us < 0 || tree.tick_us < 0) all_ok = false;
    const char* winner = "-";
    if (star.tick_us >= 0 && tree.tick_us >= 0) {
      winner = tree.tick_us < star.tick_us ? "tree" : "star";
    }
    std::printf("| %d | %.1f | %.1f | fanout=%d groups=%.0f depth=%.0f "
                "| %s |\n",
                c.p, star.tick_us, tree.tick_us, c.fanout, tree.groups,
                tree.depth, winner);
    std::fflush(stdout);
  }
  return all_ok ? 0 : 1;
}

}  // namespace

int main(int argc, char** argv) {
  if (argc > 1 && std::string(argv[1]) == "--sweep") {
    int ticks = 12;
    for (int i = 2; i + 1 < argc; i += 2) {
      if (std::string(argv[i]) == "--ticks") ticks = std::atoi(argv[i + 1]);
    }
    return RunSweep(ticks);
  }
  int p = argc > 1 ? std::atoi(argv[1]) : 64;
  int ticks = argc > 2 ? std::atoi(argv[2]) : 200;
  int names = argc > 3 ? std::atoi(argv[3]) : 1;
  if (p < 2 || ticks < 2) {  // tick 0 is warmup; >=1 timed tick needed
    std::fprintf(stderr, "usage: star_bench <P>=2.. <ticks>=2.. [names]\n");
    return 2;
  }

  // MakeCoordinator blocks until all workers connect, so the worker
  // threads must exist first: reserve a free port up front (workers retry
  // connecting inside MakeWorker's rendezvous budget).  Ask the OS via
  // bind(0)+getsockname — a pid-derived guess collides when two benches
  // (or a bench and a test suite) share a machine.  The reserving socket
  // is closed before MakeCoordinator re-binds the port; the workers'
  // connect-retry loop absorbs that instant.
  int port = 0;
  std::string bind_err;
  int reserve_fd = hvd::TcpControlPlane::BindListener(&port, &bind_err);
  if (reserve_fd < 0) {
    std::fprintf(stderr, "port reservation failed: %s\n", bind_err.c_str());
    return 2;
  }
  ::close(reserve_fd);

  std::vector<std::thread> workers;
  workers.reserve(static_cast<size_t>(p - 1));
  for (int rank = 1; rank < p; ++rank) {
    workers.emplace_back([rank, port, ticks, names]() {
      std::string werr;
      auto w = hvd::TcpControlPlane::MakeWorker("127.0.0.1", port, rank,
                                                /*epoch=*/0, &werr);
      if (!w) {
        std::fprintf(stderr, "worker %d: %s\n", rank, werr.c_str());
        std::exit(1);
      }
      hvd::RequestList req = MakeReq(rank, names);
      hvd::ResponseList resp;
      for (int t = 0; t < ticks; ++t) {
        if (!w->Exchange(req, &resp)) {
          std::fprintf(stderr, "worker %d: exchange failed\n", rank);
          std::exit(1);
        }
      }
    });
  }

  std::string err;
  auto coord = hvd::TcpControlPlane::MakeCoordinator(port, p, /*epoch=*/0,
                                                     &err);
  if (!coord) {
    std::fprintf(stderr, "coordinator: %s\n", err.c_str());
    // exit(), not return: worker threads are joinable, and destroying
    // them would std::terminate with a core dump instead of this message.
    std::exit(1);
  }

  hvd::RequestList own = MakeReq(0, names);
  hvd::ResponseList verdict;  // a typical small verdict frame
  {
    hvd::Response r;
    r.type = hvd::Response::Type::ALLREDUCE;
    for (int i = 0; i < names; ++i)
      r.tensor_names.push_back("grad/layer_" + std::to_string(i) +
                               "/kernel");
    verdict.responses.push_back(std::move(r));
  }

  std::vector<hvd::RequestList> all;
  // Warmup tick: absorbs connect/first-allocation noise.
  if (!coord->Gather(own, &all) || !coord->Broadcast(verdict)) {
    std::fprintf(stderr, "coordinator tick failed\n");
    std::exit(1);  // see the bind-failure note: joinable threads live
  }
  auto t0 = std::chrono::steady_clock::now();
  for (int t = 1; t < ticks; ++t) {
    if (!coord->Gather(own, &all) || !coord->Broadcast(verdict)) {
      std::fprintf(stderr, "coordinator tick failed\n");
      std::exit(1);  // see the bind-failure note
    }
  }
  auto t1 = std::chrono::steady_clock::now();
  for (auto& w : workers) w.join();

  double us = std::chrono::duration<double, std::micro>(t1 - t0).count() /
              (ticks - 1);
  std::printf("{\"p\": %d, \"ticks\": %d, \"tick_us\": %.1f, "
              "\"per_worker_us\": %.2f}\n",
              p, ticks, us, us / (p - 1));
  return 0;
}
