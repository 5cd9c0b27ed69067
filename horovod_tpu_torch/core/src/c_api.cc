// C ABI for the Python binding (ctypes).
//
// The analog of the reference's C API surface (reference
// horovod/common/operations.h:68-118 + the per-framework shims); loaded by
// horovod_tpu/core/engine.py with ctypes instead of a pybind11 module (the
// image has no pybind11; the surface is small and stable enough for a plain
// C ABI).
#include <cstdlib>
#include <cstring>
#include <string>

#include "engine.h"
#include "half.h"
#include "message.h"
#include "tree.h"

using hvd::DataType;
using hvd::Engine;
using hvd::EngineOptions;
using hvd::ExecBatch;
using hvd::OpType;
using hvd::Status;
using hvd::TensorShape;

namespace {

void CopyErr(const std::string& msg, char* err, int errlen) {
  if (err == nullptr || errlen <= 0) return;
  std::snprintf(err, static_cast<size_t>(errlen), "%s", msg.c_str());
}

struct Writer {
  std::string buf;
  void u8(uint8_t v) { buf.push_back(static_cast<char>(v)); }
  void i32(int32_t v) { buf.append(reinterpret_cast<char*>(&v), 4); }
  void i64(int64_t v) { buf.append(reinterpret_cast<char*>(&v), 8); }
  void str(const std::string& s) {
    i32(static_cast<int32_t>(s.size()));
    buf.append(s);
  }
};

// Heartbeat/elastic knobs ride the environment (like HVD_TPU_CONNECT_TIMEOUT
// in controller.cc) rather than widening the create ABI: they are pure
// control-plane tuning, documented in utils/env.py.
double EnvMs(const char* horovod_name, const char* hvd_tpu_name,
             double fallback) {
  const char* v = std::getenv(horovod_name);
  if (v == nullptr || *v == '\0') v = std::getenv(hvd_tpu_name);
  if (v == nullptr || *v == '\0') return fallback;
  return std::atof(v);
}

bool EnvFlag(const char* horovod_name, const char* hvd_tpu_name) {
  const char* v = std::getenv(horovod_name);
  if (v == nullptr || *v == '\0') v = std::getenv(hvd_tpu_name);
  if (v == nullptr || *v == '\0') return false;
  return std::strcmp(v, "0") != 0 && std::strcmp(v, "false") != 0 &&
         std::strcmp(v, "False") != 0;
}

// The canonical ResponseList (shared by the RESPONSE golden frame and the
// AGG_STATE golden frame's embedded response bytes).
hvd::ResponseList GoldenResponseList() {
  hvd::ResponseList rl;
  hvd::Response a;
  a.cache_bit = 5;  // cache hit: nothing else serialized
  hvd::Response b;
  b.type = hvd::Response::Type::ALLGATHER;
  b.tensor_names = {"metrics.gather", "agg.y"};
  b.first_dim_sizes = {3, 5};
  b.store_bit = 2;
  hvd::Response c;
  c.type = hvd::Response::Type::ERROR;
  c.tensor_names = {"grad/dense/kernel:0"};
  c.error_reason = "peer failure: rank 2";
  rl.responses = {a, b, c};
  hvd::DivergenceEntry de;
  de.rank = 1;
  de.seq = 9;
  de.hash = 0xDEADBEEF12345678ull;
  de.desc = "allreduce step.9";
  rl.divergence = {de};
  rl.cache_invalidate = {"stale.tensor"};
  return rl;
}

// Canonical golden wire samples — the byte-for-byte conformance anchor
// between this file's serializers (message.cc) and the Python protocol
// mirror (horovod_tpu/analysis/protocol/wire.py golden_frames()).  Both
// sides hard-code the SAME field values; tests/golden/frames/ holds the
// framed bytes and tests/test_protocol_model.py pins all three against
// each other.  Change a value here only together with its Python twin
// and regenerated fixtures.
std::string GoldenFrame(int frame_type) {
  using hvd::FrameType;
  std::string payload;
  int64_t epoch = 0;
  switch (static_cast<FrameType>(frame_type)) {
    case FrameType::HELLO: {
      Writer w;
      w.i32(3);      // rank
      w.i32(18443);  // standby_listen_port
      w.i32(19001);  // bulk_listen_port
      payload = w.buf;
      break;
    }
    case FrameType::HELLO_ACK:
      break;  // empty = accepted
    case FrameType::REQUEST: {
      hvd::RequestList rl;
      hvd::Request r1;
      r1.rank = 1;
      r1.op = hvd::OpType::ALLREDUCE;
      r1.dtype = DataType::FLOAT32;
      r1.root_rank = -1;
      r1.wire = hvd::WireFormat::NATIVE;
      r1.name = "grad/dense/kernel:0";
      r1.shape.dims = {4, 8};
      hvd::Request r2;
      r2.rank = 1;
      r2.op = hvd::OpType::ALLGATHER;
      r2.dtype = DataType::INT64;
      r2.root_rank = 0;
      r2.wire = hvd::WireFormat::INT8;
      r2.name = "metrics.gather";
      r2.shape.dims = {3};
      rl.requests = {r1, r2};
      hvd::VerifyEntry ve;
      ve.seq = 7;
      ve.hash = 0x1234567890ABCDEFull;
      ve.desc = "allreduce grad/dense/kernel:0";
      rl.verify = {ve};
      rl.cache_hits = {0, 3, 9};
      rl.cache_invalidate = {"stale.tensor"};
      hvd::Serialize(rl, &payload);
      epoch = 2;
      break;
    }
    case FrameType::RESPONSE: {
      hvd::Serialize(GoldenResponseList(), &payload);
      epoch = 2;
      break;
    }
    case FrameType::HEARTBEAT:
      epoch = 2;
      break;  // empty liveness frame
    case FrameType::ABORT: {
      hvd::PeerFailureReport pf;
      pf.failed_rank = 2;
      pf.cause = "heartbeat_timeout";
      pf.detail = "silence 11000 ms";
      pf.last_heard_us = 11000000;
      pf.last_collective = "allreduce grad/dense/kernel:0";
      hvd::Serialize(pf, &payload);
      epoch = 2;
      break;
    }
    case FrameType::RECONFIG: {
      hvd::ReconfigInfo ri;
      ri.epoch = 3;
      ri.new_size = 3;
      ri.failed_rank = 1;
      ri.cause = "connection_reset";
      ri.new_ranks = {0, -1, 1, 2};
      hvd::Serialize(ri, &payload);
      epoch = 3;
      break;
    }
    case FrameType::JOIN: {
      Writer w;
      w.i32(2);  // id
      payload = w.buf;
      break;
    }
    case FrameType::JOIN_ACK: {
      hvd::JoinTicket jt;
      jt.epoch = 4;
      jt.new_size = 4;
      jt.assigned_rank = 3;
      hvd::Serialize(jt, &payload);
      break;
    }
    case FrameType::STANDBY: {
      hvd::StandbyInfo si;
      si.standby_rank = 1;
      si.host = "127.0.0.1";
      si.port = 23456;
      hvd::Serialize(si, &payload);
      break;
    }
    case FrameType::STATE: {
      hvd::CoordState cs;
      cs.epoch = 3;
      cs.joins_admitted = 1;
      cs.verify_checked = 42;
      cs.verify_tick = 7;
      cs.lru_order = {2, 0, 1};
      hvd::Serialize(cs, &payload);
      epoch = 3;
      break;
    }
    case FrameType::SHARD_PUT: {
      hvd::ShardPut sp;
      sp.owner_rank = 1;
      sp.target_rank = 2;
      sp.step = 10;
      sp.epoch = 3;
      sp.payload = std::string("\x00\x01\x02\x03shard-bytes", 15);
      hvd::Serialize(sp, &payload);
      epoch = 3;
      break;
    }
    case FrameType::SHARD_ACK: {
      hvd::ShardAck sa;
      sa.owner_rank = 1;
      sa.target_rank = 2;
      sa.step = 10;
      sa.epoch = 3;
      hvd::Serialize(sa, &payload);
      epoch = 3;
      break;
    }
    case FrameType::TICKET_REQ: {
      hvd::TicketRequest tr;
      tr.src_rank = 1;
      tr.dst_rank = 2;
      tr.step = 10;
      tr.epoch = 3;
      tr.nbytes = 4096;
      tr.manifest = "{\"cut\":2}";
      hvd::Serialize(tr, &payload);
      epoch = 3;
      break;
    }
    case FrameType::TICKET: {
      hvd::Ticket t;
      t.transfer_id = 99;
      t.token = hvd::BulkToken(99, 3, 1, 2);
      t.src_rank = 1;
      t.dst_rank = 2;
      t.dst_host = "127.0.0.1";
      t.dst_port = 20001;
      t.step = 10;
      t.epoch = 3;
      t.manifest = "{\"cut\":2}";
      hvd::Serialize(t, &payload);
      epoch = 3;
      break;
    }
    case FrameType::AGG_REQUEST: {
      hvd::AggRequestList al;
      al.agg_id = 1;
      al.seq = 5;
      al.members = {3, 4};
      al.hits_all = {1, 2};
      al.verify_folded = true;
      hvd::VerifyEntry ve;
      ve.seq = 5;
      ve.hash = 0x0123456789ABCDEFull;
      ve.desc = "fold";
      al.verify_all = {ve};
      hvd::RequestList res0;
      hvd::Request r;
      r.rank = 3;
      r.op = hvd::OpType::ALLREDUCE;
      r.dtype = DataType::FLOAT32;
      r.root_rank = -1;
      r.wire = hvd::WireFormat::NATIVE;
      r.name = "grad/dense/kernel:0";
      r.shape.dims = {4, 8};
      res0.requests = {r};
      al.residual = {res0, hvd::RequestList()};
      hvd::Serialize(al, &payload);
      epoch = 2;
      break;
    }
    case FrameType::AGG_STATE: {
      hvd::AggState as;
      as.seq = 5;
      hvd::Serialize(GoldenResponseList(), &as.response);
      hvd::Serialize(as, &payload);
      epoch = 2;
      break;
    }
    default:
      return std::string();  // unknown type: caller sees 0 bytes
  }
  hvd::FrameHeader h;
  h.type = static_cast<uint8_t>(frame_type);
  h.flags = static_cast<uint16_t>(epoch & 0xFFFF);
  h.payload_len = static_cast<uint32_t>(payload.size());
  h.crc32 = hvd::Crc32(payload.data(), payload.size());
  char hdr[hvd::kFrameHeaderBytes];
  hvd::EncodeFrameHeader(h, hdr);
  return std::string(hdr, hvd::kFrameHeaderBytes) + payload;
}

}  // namespace

extern "C" {

void* hvd_create(int rank, int size, double cycle_ms,
                 long long fusion_threshold, long long cache_capacity,
                 double stall_seconds, int stall_check,
                 double stall_abort_seconds, int stall_abort_exit_code,
                 int verify_schedule, int verify_interval_ticks,
                 long long epoch, const char* timeline_path,
                 const char* coord_host, int coord_port, int bulk_port) {
  EngineOptions opts;
  opts.rank = rank;
  opts.size = size;
  opts.epoch = epoch;
  opts.bulk_listen_port = bulk_port;
  opts.cycle_time_ms = cycle_ms;
  opts.fusion_threshold_bytes = fusion_threshold;
  opts.cache_capacity = cache_capacity >= 0 ? cache_capacity : 0;
  opts.stall_warning_seconds = stall_seconds;
  opts.stall_check = stall_check != 0;
  opts.stall_abort_seconds = stall_abort_seconds;
  if (stall_abort_exit_code > 0) {
    opts.stall_abort_exit_code = stall_abort_exit_code;
  }
  opts.verify_schedule = verify_schedule != 0;
  if (verify_interval_ticks > 0) {
    opts.verify_interval_ticks = verify_interval_ticks;
  }
  if (timeline_path != nullptr) opts.timeline_path = timeline_path;
  if (coord_host != nullptr) opts.coordinator_host = coord_host;
  opts.coordinator_port = coord_port;
  opts.heartbeat_ms = EnvMs("HOROVOD_HEARTBEAT_MS", "HVD_TPU_HEARTBEAT_MS",
                            opts.heartbeat_ms);
  opts.heartbeat_timeout_ms =
      EnvMs("HOROVOD_HEARTBEAT_TIMEOUT_MS", "HVD_TPU_HEARTBEAT_TIMEOUT_MS",
            opts.heartbeat_timeout_ms);
  opts.abort_grace_ms = EnvMs("HOROVOD_ABORT_GRACE_MS",
                              "HVD_TPU_ABORT_GRACE_MS", opts.abort_grace_ms);
  // In-place elastic recovery (docs/fault_tolerance.md "In-place
  // recovery"): mode switch, shrink floor, and the bounded reconfiguration
  // hand-off — all pure control-plane tuning, documented in utils/env.py.
  opts.elastic = EnvFlag("HOROVOD_ELASTIC", "HVD_TPU_ELASTIC");
  opts.min_size = static_cast<int>(
      EnvMs("HOROVOD_MIN_SIZE", "HVD_TPU_MIN_SIZE", 1));
  opts.reconfig_timeout_ms =
      EnvMs("HOROVOD_RECONFIG_TIMEOUT_MS", "HVD_TPU_RECONFIG_TIMEOUT_MS",
            opts.reconfig_timeout_ms);
  // Hierarchical coordinator tree (tree.h; docs/benchmarks.md
  // "Control-plane scaling").  Pure control-plane topology tuning — rides
  // the environment like the heartbeat knobs; documented in utils/env.py.
  opts.tree_enable =
      EnvFlag("HOROVOD_TREE_ENABLE", "HVD_TPU_TREE_ENABLE") ? 1 : 0;
  // Defaults mirror utils/env.py tree_fanout()/tree_threshold() — the plan
  // must be the same pure function of the same knobs on every rank AND in
  // the launcher that places the relay sidecars.
  opts.tree_fanout = static_cast<int>(
      EnvMs("HOROVOD_TREE_FANOUT", "HVD_TPU_TREE_FANOUT", 64));
  opts.tree_threshold = static_cast<int>(
      EnvMs("HOROVOD_TREE_THRESHOLD", "HVD_TPU_TREE_THRESHOLD", 256));
  opts.tree_exchange_timeout_ms = static_cast<long long>(
      EnvMs("HOROVOD_TREE_EXCHANGE_TIMEOUT_MS",
            "HVD_TPU_TREE_EXCHANGE_TIMEOUT_MS",
            static_cast<double>(opts.tree_exchange_timeout_ms)));
  return new Engine(std::move(opts));
}

int hvd_start(void* e, int* bound_port, char* err, int errlen) {
  Status s = static_cast<Engine*>(e)->Start(bound_port);
  if (!s.ok()) {
    CopyErr(s.reason, err, errlen);
    return static_cast<int>(s.type);
  }
  return 0;
}

void hvd_shutdown(void* e) { static_cast<Engine*>(e)->Shutdown(); }

void hvd_destroy(void* e) { delete static_cast<Engine*>(e); }

long long hvd_enqueue(void* e, const char* name, int op, int dtype,
                      const long long* dims, int ndims, int root_rank,
                      int wire, char* err, int errlen) {
  TensorShape shape;
  shape.dims.assign(dims, dims + ndims);
  Status s;
  int64_t h = static_cast<Engine*>(e)->Enqueue(
      name, static_cast<OpType>(op), static_cast<DataType>(dtype), shape,
      root_rank, static_cast<hvd::WireFormat>(wire), &s);
  if (h < 0) CopyErr(s.reason, err, errlen);
  return h;
}

// Returns >0 (bytes written), 0 (timeout), -1 (engine stopped), or
// -needed-1 when buflen is too small (caller retries with a larger buffer).
int hvd_next_batch(void* e, char* buf, int buflen, double timeout_ms) {
  ExecBatch b;
  int r = static_cast<Engine*>(e)->NextBatch(&b, timeout_ms);
  if (r <= 0) return r;
  Writer w;
  w.i64(b.id);
  w.u8(static_cast<uint8_t>(b.type));
  w.u8(static_cast<uint8_t>(b.dtype));
  w.i32(b.root_rank);
  w.u8(static_cast<uint8_t>(b.wire));
  w.i32(static_cast<int32_t>(b.names.size()));
  for (size_t i = 0; i < b.names.size(); ++i) {
    w.str(b.names[i]);
    w.i64(b.handles[i]);
    w.i32(static_cast<int32_t>(b.shapes[i].dims.size()));
    for (auto d : b.shapes[i].dims) w.i64(d);
  }
  w.i32(static_cast<int32_t>(b.first_dim_sizes.size()));
  for (auto d : b.first_dim_sizes) w.i64(d);
  if (static_cast<int>(w.buf.size()) > buflen) {
    // Put the batch back; the caller grows its buffer to -ret-1 and retries.
    int needed = static_cast<int>(w.buf.size());
    static_cast<Engine*>(e)->RequeueBatch(std::move(b));
    return -needed - 1;
  }
  std::memcpy(buf, w.buf.data(), w.buf.size());
  return static_cast<int>(w.buf.size());
}

void hvd_batch_activity(void* e, long long batch_id, const char* activity) {
  static_cast<Engine*>(e)->BatchActivity(batch_id,
                                         activity ? activity : "");
}

// Instant marker on a named timeline row (no batch needed) — the
// OVERLAP_PLAN schedule-planner instants ride the same surface as the
// dispatch loop's CACHE_HIT/NEGOTIATED markers.
void hvd_timeline_instant(void* e, const char* row, const char* label) {
  static_cast<Engine*>(e)->TimelineInstant(row ? row : "",
                                           label ? label : "");
}

void hvd_batch_done(void* e, long long batch_id, int status,
                    const char* reason) {
  Status s;
  s.type = static_cast<hvd::StatusType>(status);
  if (reason != nullptr) s.reason = reason;
  static_cast<Engine*>(e)->BatchDone(batch_id, s);
}

// Serialized stall report: i32 count, then per entry {str name,
// i32 n_missing, i32 ranks...}.  Returns bytes written, or -needed-1 when
// buflen is too small (caller grows and retries — hvd_next_batch's
// convention).
int hvd_stall_report(void* e, char* buf, int buflen) {
  auto entries = static_cast<Engine*>(e)->StallReport();
  Writer w;
  w.i32(static_cast<int32_t>(entries.size()));
  for (const auto& entry : entries) {
    w.str(entry.name);
    w.i32(static_cast<int32_t>(entry.missing_ranks.size()));
    for (int r : entry.missing_ranks) w.i32(r);
  }
  if (static_cast<int>(w.buf.size()) > buflen) {
    return -static_cast<int>(w.buf.size()) - 1;
  }
  std::memcpy(buf, w.buf.data(), w.buf.size());
  return static_cast<int>(w.buf.size());
}

// Response-cache counters (docs/response_cache.md): fills out[0..5] with
// hits, misses, evictions, bypassed ticks, current entries, capacity.
void hvd_cache_stats(void* e, long long* out) {
  auto v = static_cast<Engine*>(e)->CacheStats();
  out[0] = static_cast<long long>(v.stats.hits);
  out[1] = static_cast<long long>(v.stats.misses);
  out[2] = static_cast<long long>(v.stats.evictions);
  out[3] = static_cast<long long>(v.stats.bypassed_ticks);
  out[4] = static_cast<long long>(v.entries);
  out[5] = static_cast<long long>(v.capacity);
}

// Control-plane observability (docs/benchmarks.md "Control-plane
// scaling"): fills out[0..7] with {role, depth, fanout, tick_p50_ms,
// tick_p99_ms, frames_per_tick, ticks, frames_rx}.  Role codes:
// 0 loopback, 1 star coordinator, 2 star worker, 3 tree root,
// 4 tree member.
void hvd_control_plane_stats(void* e, double* out) {
  auto v = static_cast<Engine*>(e)->ControlPlaneStats();
  out[0] = static_cast<double>(v.role);
  out[1] = static_cast<double>(v.depth);
  out[2] = static_cast<double>(v.fanout);
  out[3] = v.tick_p50_ms;
  out[4] = v.tick_p99_ms;
  out[5] = v.frames_per_tick;
  out[6] = static_cast<double>(v.ticks);
  out[7] = static_cast<double>(v.frames_rx);
}

// Topology plan introspection (tree.py mirrors this for the launcher; the
// parity is pinned by tests/test_tree.py): fills out[0..3] with {active,
// fanout, num_groups, depth} for the given knobs.
void hvd_tree_plan(int size, int fanout, int threshold, int enable,
                   int* out) {
  hvd::TreePlan p = hvd::PlanTree(size, fanout, threshold, enable);
  out[0] = p.active ? 1 : 0;
  out[1] = p.fanout;
  out[2] = p.num_groups;
  out[3] = p.depth;
}

// Run an aggregator relay (python -m horovod_tpu.relay sidecar).  BLOCKS
// until the relay exits; returns its exit code (0 clean shutdown,
// 1 escalated failure, 2 invalid configuration).
int hvd_relay_run(int agg_id, const char* parent_host, int parent_port,
                  int listen_port, int size, int fanout, int threshold,
                  long long epoch, int standby, const char* peer_host,
                  int peer_port, long long member_timeout_ms) {
  hvd::RelayOptions opt;
  opt.agg_id = agg_id;
  if (parent_host != nullptr && *parent_host != '\0') {
    opt.parent_host = parent_host;
  }
  opt.parent_port = parent_port;
  opt.listen_port = listen_port;
  opt.size = size;
  opt.fanout = fanout;
  opt.threshold = threshold;
  opt.epoch = epoch;
  opt.standby = standby != 0;
  if (peer_host != nullptr) opt.peer_host = peer_host;
  opt.peer_port = peer_port;
  if (member_timeout_ms > 0) opt.member_timeout_ms = member_timeout_ms;
  opt.heartbeat_ms = static_cast<long long>(
      EnvMs("HOROVOD_HEARTBEAT_MS", "HVD_TPU_HEARTBEAT_MS", 250.0));
  return hvd::RunRelay(opt);
}

// Schedule-verifier intake (analysis/schedule.py): one call per collective
// submission with the rank's sequence number, rolling hash, and a
// description used in the divergence report.
void hvd_verify_submit(void* e, long long seq, unsigned long long hash,
                       const char* desc) {
  static_cast<Engine*>(e)->SubmitVerify(seq, hash, desc ? desc : "");
}

// Serialized divergence report: i32 count, then per entry {i32 rank,
// i64 seq, i64 hash, str desc}.  Returns bytes written, or -needed-1 when
// buflen is too small (hvd_next_batch's grow-and-retry convention).
int hvd_divergence_report(void* e, char* buf, int buflen) {
  auto entries = static_cast<Engine*>(e)->DivergenceReport();
  Writer w;
  w.i32(static_cast<int32_t>(entries.size()));
  for (const auto& entry : entries) {
    w.i32(entry.rank);
    w.i64(static_cast<int64_t>(entry.seq));
    w.i64(static_cast<int64_t>(entry.hash));
    w.str(entry.desc);
  }
  if (static_cast<int>(w.buf.size()) > buflen) {
    return -static_cast<int>(w.buf.size()) - 1;
  }
  std::memcpy(buf, w.buf.data(), w.buf.size());
  return static_cast<int>(w.buf.size());
}

// Serialized peer-failure report (docs/fault_tolerance.md): i32 present
// (0 = no failure), then {i32 failed_rank, str cause, str detail,
// i64 last_heard_us, str last_collective}.  Returns bytes written, or
// -needed-1 when buflen is too small (hvd_next_batch's grow-and-retry
// convention).
int hvd_failure_report(void* e, char* buf, int buflen) {
  hvd::PeerFailureReport r = static_cast<Engine*>(e)->FailureReport();
  Writer w;
  if (r.failed_rank < 0 && r.cause.empty()) {
    w.i32(0);
  } else {
    w.i32(1);
    w.i32(r.failed_rank);
    w.str(r.cause);
    w.str(r.detail);
    w.i64(r.last_heard_us);
    w.str(r.last_collective);
  }
  if (static_cast<int>(w.buf.size()) > buflen) {
    return -static_cast<int>(w.buf.size()) - 1;
  }
  std::memcpy(buf, w.buf.data(), w.buf.size());
  return static_cast<int>(w.buf.size());
}

// Serialized elastic resize event (docs/fault_tolerance.md "In-place
// recovery"): i32 present (0 = none), then {i64 epoch, i32 old_rank,
// i32 new_rank, i32 old_size, i32 new_size, i32 failed_rank, str cause,
// str new_coord_host, i32 new_coord_port} — the last two name the NEW
// membership's coordinator endpoint after a failover (empty host = the
// coordinator did not move).  Returns bytes written, or -needed-1 when
// buflen is too small (hvd_next_batch's grow-and-retry convention).
int hvd_resize_event(void* e, char* buf, int buflen) {
  auto v = static_cast<Engine*>(e)->ResizeEvent();
  Writer w;
  if (!v.present) {
    w.i32(0);
  } else {
    w.i32(1);
    w.i64(v.epoch);
    w.i32(v.old_rank);
    w.i32(v.new_rank);
    w.i32(v.old_size);
    w.i32(v.new_size);
    w.i32(v.failed_rank);
    w.str(v.cause);
    w.str(v.new_coord_host);
    w.i32(v.new_coord_port);
  }
  if (static_cast<int>(w.buf.size()) > buflen) {
    return -static_cast<int>(w.buf.size()) - 1;
  }
  std::memcpy(buf, w.buf.data(), w.buf.size());
  return static_cast<int>(w.buf.size());
}

// Serialized coordinator-state replica (docs/fault_tolerance.md
// "Coordinator failover"): i32 present (0 = this rank has seen no STATE
// delta), then {i64 epoch, i64 joins_admitted, i64 verify_checked,
// i64 verify_tick, i32 n_lru, i32 bits...}.  Present on the coordinator
// (its own emission) and on the designated standby (the replicated copy);
// lets tests assert replication reached the standby before a kill.
// Returns bytes written, or -needed-1 (grow-and-retry convention).
int hvd_coord_state(void* e, char* buf, int buflen) {
  auto v = static_cast<Engine*>(e)->CoordStateReport();
  Writer w;
  if (!v.present) {
    w.i32(0);
  } else {
    w.i32(1);
    w.i64(v.state.epoch);
    w.i64(v.state.joins_admitted);
    w.i64(v.state.verify_checked);
    w.i64(v.state.verify_tick);
    w.i32(static_cast<int32_t>(v.state.lru_order.size()));
    for (int32_t bit : v.state.lru_order) w.i32(bit);
  }
  if (static_cast<int>(w.buf.size()) > buflen) {
    return -static_cast<int>(w.buf.size()) - 1;
  }
  std::memcpy(buf, w.buf.data(), w.buf.size());
  return static_cast<int>(w.buf.size());
}

// Async peer-replicated checkpointing (docs/fault_tolerance.md "Async &
// peer-replicated checkpointing").  hvd_shard_put pushes `len` opaque
// bytes toward target_rank's host memory over the control plane (relayed
// through the coordinator); returns 1 on acceptance, 0 when the plane has
// no peers or the send failed.
int hvd_shard_put(void* e, int target_rank, long long step, const char* buf,
                  long long len) {
  if (buf == nullptr || len < 0) return 0;
  std::string payload(buf, static_cast<size_t>(len));
  return static_cast<Engine*>(e)->ShardPutSend(target_rank, step, payload)
             ? 1
             : 0;
}

// Pop the next shard a peer replicated into this rank's inbox, serialized
// as {i32 owner_rank, i64 step, i64 epoch, i64 payload_len, payload}.
// Returns bytes written, 0 when the inbox is empty, or -needed-1 when
// buflen is too small (grow-and-retry convention — the shard stays queued).
int hvd_shard_poll(void* e, char* buf, int buflen) {
  auto* eng = static_cast<Engine*>(e);
  hvd::ShardPut shard;
  if (!eng->ShardPoll(&shard)) return 0;
  Writer w;
  w.i32(shard.owner_rank);
  w.i64(shard.step);
  w.i64(shard.epoch);
  w.i64(static_cast<int64_t>(shard.payload.size()));
  w.buf.append(shard.payload);
  if (static_cast<int>(w.buf.size()) > buflen) {
    int needed = static_cast<int>(w.buf.size());
    // Hand the shard back; the caller grows its buffer and retries.
    eng->ShardRequeue(std::move(shard));
    return -needed - 1;
  }
  std::memcpy(buf, w.buf.data(), w.buf.size());
  return static_cast<int>(w.buf.size());
}

// Pop the next control-plane ack for a shard this rank pushed: fills
// out[0..3] = {owner_rank, target_rank, step, epoch}.  Returns 1, or 0
// when no ack is queued.
int hvd_shard_ack_poll(void* e, long long* out) {
  hvd::ShardAck ack;
  if (!static_cast<Engine*>(e)->ShardAckPoll(&ack)) return 0;
  out[0] = ack.owner_rank;
  out[1] = ack.target_rank;
  out[2] = ack.step;
  out[3] = ack.epoch;
  return 1;
}

// Bulk data plane (docs/fault_tolerance.md "Bulk data plane").
// hvd_ticket_request asks the coordinator to authorize a direct stream of
// `nbytes` to dst_rank (manifest: opaque shard-set description echoed back
// in the ticket).  Returns 1 when the request was sent/self-issued, 0 when
// the plane has no peers or the send failed.
int hvd_ticket_request(void* e, int dst_rank, long long step,
                       long long nbytes, const char* manifest) {
  std::string m = manifest != nullptr ? manifest : "";
  return static_cast<Engine*>(e)->TicketRequestSend(dst_rank, step, nbytes, m)
             ? 1
             : 0;
}

// Pop the next issued ticket, serialized as {i64 transfer_id, i64 token,
// i32 src_rank, i32 dst_rank, i32 dst_port, i64 step, i64 epoch,
// str dst_host, str manifest}.  Returns bytes written, 0 when none is
// queued, or -needed-1 when buflen is too small (grow-and-retry — the
// ticket stays queued).
// Deterministic transfer token (message.cc BulkToken), exported so the
// Python data plane's mirror implementation can be pinned bit-for-bit by
// tests — receiver-side stream validation depends on exact parity.
unsigned long long hvd_bulk_token(long long transfer_id, long long epoch,
                                  int src_rank, int dst_rank) {
  return hvd::BulkToken(transfer_id, epoch, src_rank, dst_rank);
}

int hvd_ticket_poll(void* e, char* buf, int buflen) {
  auto* eng = static_cast<Engine*>(e);
  hvd::Ticket t;
  if (!eng->TicketPoll(&t)) return 0;
  Writer w;
  w.i64(t.transfer_id);
  w.i64(static_cast<int64_t>(t.token));
  w.i32(t.src_rank);
  w.i32(t.dst_rank);
  w.i32(t.dst_port);
  w.i64(t.step);
  w.i64(t.epoch);
  w.str(t.dst_host);
  w.str(t.manifest);
  if (static_cast<int>(w.buf.size()) > buflen) {
    int needed = static_cast<int>(w.buf.size());
    eng->TicketRequeue(std::move(t));
    return -needed - 1;
  }
  std::memcpy(buf, w.buf.data(), w.buf.size());
  return static_cast<int>(w.buf.size());
}

// Python acknowledges the resize: the stopped engine may be destroyed and
// re-formed under the new membership; the reconfig-timeout fallback exit
// stands down.
void hvd_resize_ack(void* e) { static_cast<Engine*>(e)->AckResize(); }

// Coordinator, reconfiguration hand-off: free the listen port for the new
// membership while the old engine's peer sockets stay open (stragglers
// must be able to read the RECONFIG broadcast without being RST).
void hvd_detach_listener(void* e) {
  static_cast<Engine*>(e)->DetachListener();
}

int hvd_poll(void* e, long long handle) {
  return static_cast<Engine*>(e)->PollHandle(handle) ? 1 : 0;
}

int hvd_wait(void* e, long long handle, double timeout_ms) {
  return static_cast<Engine*>(e)->WaitHandle(handle, timeout_ms) ? 1 : 0;
}

int hvd_handle_status(void* e, long long handle, char* reason, int rlen) {
  Status s = static_cast<Engine*>(e)->PeekHandle(handle);
  CopyErr(s.reason, reason, rlen);
  return static_cast<int>(s.type);
}

int hvd_release(void* e, long long handle, char* reason, int rlen) {
  Status s = static_cast<Engine*>(e)->ReleaseHandle(handle);
  CopyErr(s.reason, reason, rlen);
  return static_cast<int>(s.type);
}

// Golden wire vector for one FrameType (1..17): the complete framed bytes
// (FrameHeader + payload) with the canonical field values hard-coded
// above.  Conformance hook for horovod_tpu/analysis/protocol/wire.py and
// the tests/golden/frames/ fixtures — NOT used by the runtime.  Returns
// bytes written, 0 for an unknown type, or -needed-1 when buflen is too
// small (hvd_next_batch's grow-and-retry convention).
int hvd_frame_golden(int frame_type, char* buf, int buflen) {
  std::string framed = GoldenFrame(frame_type);
  if (framed.empty()) return 0;
  if (static_cast<int>(framed.size()) > buflen) {
    return -static_cast<int>(framed.size()) - 1;
  }
  std::memcpy(buf, framed.data(), framed.size());
  return static_cast<int>(framed.size());
}

// fp16/bf16 host converters (half.h) for the torch/numpy staging paths.
void hvd_half_to_float(const unsigned short* src, float* dst, long long n) {
  hvd::HalfToFloat(src, dst, static_cast<size_t>(n));
}
void hvd_float_to_half(const float* src, unsigned short* dst, long long n) {
  hvd::FloatToHalf(src, dst, static_cast<size_t>(n));
}
void hvd_bf16_to_float(const unsigned short* src, float* dst, long long n) {
  hvd::BFloat16ToFloat(src, dst, static_cast<size_t>(n));
}
void hvd_float_to_bf16(const float* src, unsigned short* dst, long long n) {
  hvd::FloatToBFloat16(src, dst, static_cast<size_t>(n));
}

}  // extern "C"
