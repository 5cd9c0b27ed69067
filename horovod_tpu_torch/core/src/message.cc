#include "message.h"

#include <algorithm>
#include <cstring>

namespace hvd {

const char* OpTypeName(OpType t) {
  switch (t) {
    case OpType::ALLREDUCE: return "ALLREDUCE";
    case OpType::ALLGATHER: return "ALLGATHER";
    case OpType::BROADCAST: return "BROADCAST";
    case OpType::ALLTOALL: return "ALLTOALL";
    case OpType::BARRIER: return "BARRIER";
  }
  return "?";
}

const char* WireFormatName(WireFormat w) {
  switch (w) {
    case WireFormat::NATIVE: return "native";
    case WireFormat::INT8: return "int8";
  }
  return "?";
}

namespace {

constexpr size_t kMaxString = 1 << 20;   // sanity bound on names/reasons
constexpr size_t kMaxVector = 1 << 20;   // sanity bound on element counts

struct Writer {
  std::string* out;
  void u8(uint8_t v) { out->push_back(static_cast<char>(v)); }
  void i32(int32_t v) { raw(&v, 4); }
  void i64(int64_t v) { raw(&v, 8); }
  void u64(uint64_t v) { raw(&v, 8); }
  void raw(const void* p, size_t n) {
    out->append(reinterpret_cast<const char*>(p), n);
  }
  void str(const std::string& s) {
    i32(static_cast<int32_t>(s.size()));
    raw(s.data(), s.size());
  }
};

struct Reader {
  const char* p;
  size_t left;
  bool fail = false;

  bool take(void* dst, size_t n) {
    if (left < n) { fail = true; return false; }
    std::memcpy(dst, p, n);
    p += n;
    left -= n;
    return true;
  }
  uint8_t u8() { uint8_t v = 0; take(&v, 1); return v; }
  int32_t i32() { int32_t v = 0; take(&v, 4); return v; }
  int64_t i64() { int64_t v = 0; take(&v, 8); return v; }
  uint64_t u64() { uint64_t v = 0; take(&v, 8); return v; }
  std::string str() {
    int32_t n = i32();
    if (fail || n < 0 || static_cast<size_t>(n) > kMaxString ||
        static_cast<size_t>(n) > left) {
      fail = true;
      return {};
    }
    std::string s(p, static_cast<size_t>(n));
    p += n;
    left -= n;
    return s;
  }
};

}  // namespace

void Serialize(const RequestList& in, std::string* out) {
  Writer w{out};
  w.i32(static_cast<int32_t>(in.requests.size()));
  for (const auto& r : in.requests) {
    w.i32(r.rank);
    w.u8(static_cast<uint8_t>(r.op));
    w.u8(static_cast<uint8_t>(r.dtype));
    w.i32(r.root_rank);
    w.u8(static_cast<uint8_t>(r.wire));
    w.str(r.name);
    w.i32(static_cast<int32_t>(r.shape.dims.size()));
    for (auto d : r.shape.dims) w.i64(d);
  }
  w.u8(in.shutdown ? 1 : 0);
  w.i32(static_cast<int32_t>(in.verify.size()));
  for (const auto& v : in.verify) {
    w.i64(v.seq);
    w.u64(v.hash);
    w.str(v.desc);
  }
  // Cache hits as a bit vector: byte count, then one bit per cache slot up
  // to the highest announced position — a warm steady-state cycle costs
  // ceil(max_bit/8) bytes instead of per-tensor Request metadata.
  int32_t max_bit = -1;
  for (auto b : in.cache_hits) max_bit = std::max(max_bit, b);
  int32_t nbytes = (max_bit + 8) / 8;  // 0 when no hits
  w.i32(nbytes);
  if (nbytes > 0) {
    std::string bits(static_cast<size_t>(nbytes), '\0');
    for (auto b : in.cache_hits) {
      if (b >= 0) bits[static_cast<size_t>(b) / 8] |= static_cast<char>(1 << (b % 8));
    }
    w.raw(bits.data(), bits.size());
  }
  w.i32(static_cast<int32_t>(in.cache_invalidate.size()));
  for (const auto& s : in.cache_invalidate) w.str(s);
}

bool Deserialize(const char* data, size_t len, RequestList* out) {
  Reader r{data, len};
  int32_t n = r.i32();
  if (r.fail || n < 0 || static_cast<size_t>(n) > kMaxVector) return false;
  out->requests.clear();
  out->requests.reserve(n);
  for (int32_t i = 0; i < n; ++i) {
    Request q;
    q.rank = r.i32();
    q.op = static_cast<OpType>(r.u8());
    q.dtype = static_cast<DataType>(r.u8());
    q.root_rank = r.i32();
    q.wire = static_cast<WireFormat>(r.u8());
    q.name = r.str();
    int32_t nd = r.i32();
    if (r.fail || nd < 0 || static_cast<size_t>(nd) > kMaxVector) return false;
    q.shape.dims.resize(nd);
    for (int32_t d = 0; d < nd; ++d) q.shape.dims[d] = r.i64();
    if (r.fail) return false;
    out->requests.push_back(std::move(q));
  }
  out->shutdown = r.u8() != 0;
  int32_t nv = r.i32();
  if (r.fail || nv < 0 || static_cast<size_t>(nv) > kMaxVector) return false;
  out->verify.clear();
  out->verify.reserve(nv);
  for (int32_t i = 0; i < nv; ++i) {
    VerifyEntry v;
    v.seq = r.i64();
    v.hash = r.u64();
    v.desc = r.str();
    if (r.fail) return false;
    out->verify.push_back(std::move(v));
  }
  int32_t nbytes = r.i32();
  if (r.fail || nbytes < 0 || static_cast<size_t>(nbytes) > kMaxVector) {
    return false;
  }
  out->cache_hits.clear();
  for (int32_t byte = 0; byte < nbytes; ++byte) {
    uint8_t v = r.u8();
    for (int bit = 0; bit < 8; ++bit) {
      if (v & (1u << bit)) out->cache_hits.push_back(byte * 8 + bit);
    }
  }
  int32_t ninv = r.i32();
  if (r.fail || ninv < 0 || static_cast<size_t>(ninv) > kMaxVector) return false;
  out->cache_invalidate.clear();
  out->cache_invalidate.reserve(ninv);
  for (int32_t i = 0; i < ninv; ++i) {
    out->cache_invalidate.push_back(r.str());
    if (r.fail) return false;
  }
  return !r.fail;
}

void Serialize(const ResponseList& in, std::string* out) {
  Writer w{out};
  w.i32(static_cast<int32_t>(in.responses.size()));
  for (const auto& resp : in.responses) {
    // Cache-hit responses are just the bit: every rank expands names/type/
    // sizes from its replica (docs/response_cache.md wire format).
    w.i32(resp.cache_bit);
    if (resp.cache_bit >= 0) continue;
    w.u8(static_cast<uint8_t>(resp.type));
    w.str(resp.error_reason);
    w.i32(static_cast<int32_t>(resp.tensor_names.size()));
    for (const auto& s : resp.tensor_names) w.str(s);
    w.i32(static_cast<int32_t>(resp.first_dim_sizes.size()));
    for (auto d : resp.first_dim_sizes) w.i64(d);
    w.i32(resp.store_bit);
  }
  w.i32(static_cast<int32_t>(in.cache_invalidate.size()));
  for (const auto& s : in.cache_invalidate) w.str(s);
  w.u8(in.cache_clear ? 1 : 0);
  w.u8(in.shutdown ? 1 : 0);
  w.i32(static_cast<int32_t>(in.divergence.size()));
  for (const auto& d : in.divergence) {
    w.i32(d.rank);
    w.i64(d.seq);
    w.u64(d.hash);
    w.str(d.desc);
  }
}

bool Deserialize(const char* data, size_t len, ResponseList* out) {
  Reader r{data, len};
  int32_t n = r.i32();
  if (r.fail || n < 0 || static_cast<size_t>(n) > kMaxVector) return false;
  out->responses.clear();
  out->responses.reserve(n);
  for (int32_t i = 0; i < n; ++i) {
    Response resp;
    resp.cache_bit = r.i32();
    if (r.fail) return false;
    if (resp.cache_bit >= 0) {
      out->responses.push_back(std::move(resp));
      continue;
    }
    resp.type = static_cast<Response::Type>(r.u8());
    resp.error_reason = r.str();
    int32_t nn = r.i32();
    if (r.fail || nn < 0 || static_cast<size_t>(nn) > kMaxVector) return false;
    resp.tensor_names.reserve(nn);
    for (int32_t k = 0; k < nn; ++k) resp.tensor_names.push_back(r.str());
    int32_t ns = r.i32();
    if (r.fail || ns < 0 || static_cast<size_t>(ns) > kMaxVector) return false;
    resp.first_dim_sizes.resize(ns);
    for (int32_t k = 0; k < ns; ++k) resp.first_dim_sizes[k] = r.i64();
    resp.store_bit = r.i32();
    if (r.fail) return false;
    out->responses.push_back(std::move(resp));
  }
  int32_t ninv = r.i32();
  if (r.fail || ninv < 0 || static_cast<size_t>(ninv) > kMaxVector) return false;
  out->cache_invalidate.clear();
  out->cache_invalidate.reserve(ninv);
  for (int32_t i = 0; i < ninv; ++i) {
    out->cache_invalidate.push_back(r.str());
    if (r.fail) return false;
  }
  out->cache_clear = r.u8() != 0;
  out->shutdown = r.u8() != 0;
  int32_t nd = r.i32();
  if (r.fail || nd < 0 || static_cast<size_t>(nd) > kMaxVector) return false;
  out->divergence.clear();
  out->divergence.reserve(nd);
  for (int32_t i = 0; i < nd; ++i) {
    DivergenceEntry d;
    d.rank = r.i32();
    d.seq = r.i64();
    d.hash = r.u64();
    d.desc = r.str();
    if (r.fail) return false;
    out->divergence.push_back(std::move(d));
  }
  return !r.fail;
}

// ---------------------------------------------------------------------------
// Hardened framing: header codec + CRC32 + PeerFailureReport
// ---------------------------------------------------------------------------

void EncodeFrameHeader(const FrameHeader& h, char out[]) {
  std::memcpy(out + 0, &h.magic, 4);
  out[4] = static_cast<char>(h.version);
  out[5] = static_cast<char>(h.type);
  std::memcpy(out + 6, &h.flags, 2);
  std::memcpy(out + 8, &h.payload_len, 4);
  std::memcpy(out + 12, &h.crc32, 4);
}

void DecodeFrameHeader(const char in[], FrameHeader* h) {
  std::memcpy(&h->magic, in + 0, 4);
  h->version = static_cast<uint8_t>(in[4]);
  h->type = static_cast<uint8_t>(in[5]);
  std::memcpy(&h->flags, in + 6, 2);
  std::memcpy(&h->payload_len, in + 8, 4);
  std::memcpy(&h->crc32, in + 12, 4);
}

namespace {

struct Crc32Table {
  uint32_t t[256];
  Crc32Table() {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k) {
        c = (c & 1u) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
      }
      t[i] = c;
    }
  }
};

}  // namespace

uint32_t Crc32(const void* data, size_t len) {
  static const Crc32Table table;
  const unsigned char* p = static_cast<const unsigned char*>(data);
  uint32_t c = 0xFFFFFFFFu;
  for (size_t i = 0; i < len; ++i) {
    c = table.t[(c ^ p[i]) & 0xFFu] ^ (c >> 8);
  }
  return c ^ 0xFFFFFFFFu;
}

void Serialize(const PeerFailureReport& in, std::string* out) {
  Writer w{out};
  w.i32(in.failed_rank);
  w.str(in.cause);
  w.str(in.detail);
  w.i64(in.last_heard_us);
  w.str(in.last_collective);
}

bool Deserialize(const char* data, size_t len, PeerFailureReport* out) {
  Reader r{data, len};
  out->failed_rank = r.i32();
  out->cause = r.str();
  out->detail = r.str();
  out->last_heard_us = r.i64();
  out->last_collective = r.str();
  return !r.fail;
}

void Serialize(const ReconfigInfo& in, std::string* out) {
  Writer w{out};
  w.i64(in.epoch);
  w.i32(in.new_size);
  w.i32(in.failed_rank);
  w.str(in.cause);
  w.i32(static_cast<int32_t>(in.new_ranks.size()));
  for (int32_t r : in.new_ranks) w.i32(r);
  w.i32(in.new_coord_rank);
  w.str(in.new_coord_host);
  w.i32(in.new_coord_port);
}

bool Deserialize(const char* data, size_t len, ReconfigInfo* out) {
  Reader r{data, len};
  out->epoch = r.i64();
  out->new_size = r.i32();
  out->failed_rank = r.i32();
  out->cause = r.str();
  int32_t n = r.i32();
  if (r.fail || n < 0 || static_cast<size_t>(n) > kMaxVector) return false;
  out->new_ranks.resize(n);
  for (int32_t i = 0; i < n; ++i) out->new_ranks[i] = r.i32();
  out->new_coord_rank = r.i32();
  out->new_coord_host = r.str();
  out->new_coord_port = r.i32();
  return !r.fail;
}

void Serialize(const JoinTicket& in, std::string* out) {
  Writer w{out};
  w.i64(in.epoch);
  w.i32(in.new_size);
  w.i32(in.assigned_rank);
}

bool Deserialize(const char* data, size_t len, JoinTicket* out) {
  Reader r{data, len};
  out->epoch = r.i64();
  out->new_size = r.i32();
  out->assigned_rank = r.i32();
  return !r.fail;
}

void Serialize(const StandbyInfo& in, std::string* out) {
  Writer w{out};
  w.i32(in.standby_rank);
  w.str(in.host);
  w.i32(in.port);
}

bool Deserialize(const char* data, size_t len, StandbyInfo* out) {
  Reader r{data, len};
  out->standby_rank = r.i32();
  out->host = r.str();
  out->port = r.i32();
  return !r.fail;
}

void Serialize(const CoordState& in, std::string* out) {
  Writer w{out};
  w.i64(in.epoch);
  w.i64(in.joins_admitted);
  w.i64(in.verify_checked);
  w.i64(in.verify_tick);
  w.i32(static_cast<int32_t>(in.lru_order.size()));
  for (int32_t b : in.lru_order) w.i32(b);
}

bool Deserialize(const char* data, size_t len, CoordState* out) {
  Reader r{data, len};
  out->epoch = r.i64();
  out->joins_admitted = r.i64();
  out->verify_checked = r.i64();
  out->verify_tick = r.i64();
  int32_t n = r.i32();
  if (r.fail || n < 0 || static_cast<size_t>(n) > kMaxVector) return false;
  out->lru_order.resize(n);
  for (int32_t i = 0; i < n; ++i) out->lru_order[i] = r.i32();
  return !r.fail;
}

void Serialize(const ShardPut& in, std::string* out) {
  Writer w{out};
  w.i32(in.owner_rank);
  w.i32(in.target_rank);
  w.i64(in.step);
  w.i64(in.epoch);
  // Shard payloads are checkpoint-sized: length-prefixed raw bytes bounded
  // by what the frame actually carries, not the kMaxString name bound.
  w.i64(static_cast<int64_t>(in.payload.size()));
  w.raw(in.payload.data(), in.payload.size());
}

bool Deserialize(const char* data, size_t len, ShardPut* out) {
  Reader r{data, len};
  out->owner_rank = r.i32();
  out->target_rank = r.i32();
  out->step = r.i64();
  out->epoch = r.i64();
  int64_t n = r.i64();
  if (r.fail || n < 0 || static_cast<size_t>(n) > r.left) return false;
  out->payload.assign(r.p, static_cast<size_t>(n));
  return true;
}

void Serialize(const ShardAck& in, std::string* out) {
  Writer w{out};
  w.i32(in.owner_rank);
  w.i32(in.target_rank);
  w.i64(in.step);
  w.i64(in.epoch);
}

bool Deserialize(const char* data, size_t len, ShardAck* out) {
  Reader r{data, len};
  out->owner_rank = r.i32();
  out->target_rank = r.i32();
  out->step = r.i64();
  out->epoch = r.i64();
  return !r.fail;
}

void Serialize(const TicketRequest& in, std::string* out) {
  Writer w{out};
  w.i32(in.src_rank);
  w.i32(in.dst_rank);
  w.i64(in.step);
  w.i64(in.epoch);
  w.i64(in.nbytes);
  w.str(in.manifest);
}

bool Deserialize(const char* data, size_t len, TicketRequest* out) {
  Reader r{data, len};
  out->src_rank = r.i32();
  out->dst_rank = r.i32();
  out->step = r.i64();
  out->epoch = r.i64();
  out->nbytes = r.i64();
  out->manifest = r.str();
  return !r.fail;
}

void Serialize(const Ticket& in, std::string* out) {
  Writer w{out};
  w.i64(in.transfer_id);
  w.u64(in.token);
  w.i32(in.src_rank);
  w.i32(in.dst_rank);
  w.str(in.dst_host);
  w.i32(in.dst_port);
  w.i64(in.step);
  w.i64(in.epoch);
  w.str(in.manifest);
}

bool Deserialize(const char* data, size_t len, Ticket* out) {
  Reader r{data, len};
  out->transfer_id = r.i64();
  out->token = r.u64();
  out->src_rank = r.i32();
  out->dst_rank = r.i32();
  out->dst_host = r.str();
  out->dst_port = r.i32();
  out->step = r.i64();
  out->epoch = r.i64();
  out->manifest = r.str();
  return !r.fail;
}

void Serialize(const AggRequestList& in, std::string* out) {
  Writer w{out};
  w.i32(in.agg_id);
  w.i64(in.seq);
  w.i32(static_cast<int32_t>(in.members.size()));
  for (int32_t m : in.members) w.i32(m);
  // Subtree-intersected cache bits, encoded like RequestList.cache_hits.
  int32_t max_bit = -1;
  for (auto b : in.hits_all) max_bit = std::max(max_bit, b);
  int32_t nbytes = (max_bit + 8) / 8;
  w.i32(nbytes);
  if (nbytes > 0) {
    std::string bits(static_cast<size_t>(nbytes), '\0');
    for (auto b : in.hits_all) {
      if (b >= 0) {
        bits[static_cast<size_t>(b) / 8] |= static_cast<char>(1 << (b % 8));
      }
    }
    w.raw(bits.data(), bits.size());
  }
  w.u8(in.verify_folded ? 1 : 0);
  if (in.verify_folded) {
    w.i32(static_cast<int32_t>(in.verify_all.size()));
    for (const auto& v : in.verify_all) {
      w.i64(v.seq);
      w.u64(v.hash);
      w.str(v.desc);
    }
  }
  // Per-member residuals as nested length-prefixed RequestList blobs.
  for (size_t i = 0; i < in.members.size(); ++i) {
    std::string blob;
    if (i < in.residual.size()) Serialize(in.residual[i], &blob);
    else Serialize(RequestList{}, &blob);
    w.str(blob);
  }
}

bool Deserialize(const char* data, size_t len, AggRequestList* out) {
  Reader r{data, len};
  out->agg_id = r.i32();
  out->seq = r.i64();
  int32_t n = r.i32();
  if (r.fail || n < 0 || static_cast<size_t>(n) > kMaxVector) return false;
  out->members.resize(n);
  for (int32_t i = 0; i < n; ++i) out->members[i] = r.i32();
  int32_t nbytes = r.i32();
  if (r.fail || nbytes < 0 || static_cast<size_t>(nbytes) > kMaxVector) {
    return false;
  }
  out->hits_all.clear();
  for (int32_t byte = 0; byte < nbytes; ++byte) {
    uint8_t v = r.u8();
    for (int bit = 0; bit < 8; ++bit) {
      if (v & (1u << bit)) out->hits_all.push_back(byte * 8 + bit);
    }
  }
  out->verify_folded = r.u8() != 0;
  out->verify_all.clear();
  if (out->verify_folded) {
    int32_t nv = r.i32();
    if (r.fail || nv < 0 || static_cast<size_t>(nv) > kMaxVector) return false;
    out->verify_all.reserve(nv);
    for (int32_t i = 0; i < nv; ++i) {
      VerifyEntry v;
      v.seq = r.i64();
      v.hash = r.u64();
      v.desc = r.str();
      if (r.fail) return false;
      out->verify_all.push_back(std::move(v));
    }
  }
  out->residual.assign(static_cast<size_t>(n), RequestList{});
  for (int32_t i = 0; i < n; ++i) {
    std::string blob = r.str();
    if (r.fail) return false;
    if (!Deserialize(blob.data(), blob.size(), &out->residual[i])) {
      return false;
    }
  }
  return !r.fail;
}

void Serialize(const AggState& in, std::string* out) {
  Writer w{out};
  w.i64(in.seq);
  w.i64(static_cast<int64_t>(in.response.size()));
  w.raw(in.response.data(), in.response.size());
}

bool Deserialize(const char* data, size_t len, AggState* out) {
  Reader r{data, len};
  out->seq = r.i64();
  int64_t n = r.i64();
  if (r.fail || n < 0 || static_cast<size_t>(n) > r.left) return false;
  out->response.assign(r.p, static_cast<size_t>(n));
  return true;
}

uint64_t BulkToken(int64_t transfer_id, int64_t epoch, int32_t src_rank,
                   int32_t dst_rank) {
  // splitmix64-style avalanche over the public tuple; NOT a secret — it
  // guards against stream misdelivery and stale/forged transfer ids, the
  // same threat model as the CRC-framed control plane.
  uint64_t x = static_cast<uint64_t>(transfer_id) * 0x9E3779B97F4A7C15ULL;
  x ^= static_cast<uint64_t>(epoch) + 0xBF58476D1CE4E5B9ULL +
       (static_cast<uint64_t>(static_cast<uint32_t>(src_rank)) << 32) +
       static_cast<uint64_t>(static_cast<uint32_t>(dst_rank));
  x ^= x >> 30;
  x *= 0xBF58476D1CE4E5B9ULL;
  x ^= x >> 27;
  x *= 0x94D049BB133111EBULL;
  x ^= x >> 31;
  return x;
}

}  // namespace hvd
