// PsService client — trainer-side stub talking to every server of the fleet.
//
// Reference analogue: paddle/fluid/distributed/ps/service/brpc_ps_client.h
// (BrpcPsClient: per-server channels, key partitioning by hash, request
// fan-out with region reassembly). Sparse keys route by server_of(key);
// dense tables split into one contiguous chunk per server; requests to the
// involved servers run on parallel threads and results scatter back into
// the caller's buffers in original key order.
//
// C ABI (ctypes): ps_client_create("ip:port,ip:port,...") + verbs below.
// Every call returns 0 on success, -1 on a transport/servers error.

#include <algorithm>
#include <atomic>
#include <cstdlib>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include "ps_net.h"

namespace ps {
namespace {

struct Conn {
  std::string host;
  int port = 0;
  int fd = -1;
  std::mutex mu;  // one in-flight request per server connection

  bool ensure() {
    if (fd >= 0) return true;
    fd = connect_to(host, port);
    return fd >= 0;
  }

  void drop() {
    if (fd >= 0) ::close(fd);
    fd = -1;
  }
};

struct Client {
  std::vector<std::unique_ptr<Conn>> conns;

  int n_servers() const { return static_cast<int>(conns.size()); }

  // Commands safe to resend after a mid-request transport failure: the
  // server may or may not have executed the first copy, so only
  // side-effect-free (or overwrite-semantics) verbs retry. PUSH_* would
  // double-apply gradients and BARRIER would double-count an arrival.
  static bool idempotent(uint32_t cmd) {
    switch (cmd) {
      case CMD_PING:
      case CMD_CREATE_SPARSE:
      case CMD_CREATE_DENSE:
      case CMD_PULL_SPARSE:
      case CMD_PULL_DENSE:
      case CMD_SET_DENSE:
      case CMD_STAT:
      case CMD_SET_LR:
      case CMD_SET_CTR:
      case CMD_CTR_STATS:
      case CMD_SAVE:
      case CMD_LOAD:
      case CMD_KV_PUT:    // overwrite semantics
      case CMD_KV_GET:
      case CMD_KV_DEL:
      case CMD_KV_LEASE:  // a re-lease is a refresh
      case CMD_KV_ALIVE:
        return true;
      default:
        return false;
    }
  }

  // one framed request/response on server i
  bool request(int i, Header& h, const void* payload,
               std::vector<char>* resp_payload, int64_t* resp_n = nullptr) {
    Conn& c = *conns[i];
    std::lock_guard<std::mutex> lk(c.mu);
    const int max_attempts = idempotent(h.cmd) ? 2 : 1;
    for (int attempt = 0; attempt < max_attempts; ++attempt) {
      if (!c.ensure()) return false;
      h.magic = kMagic;
      bool ok = write_full(c.fd, &h, sizeof(h)) &&
                (h.nbytes == 0 ||
                 write_full(c.fd, payload, static_cast<size_t>(h.nbytes)));
      Header rh{};
      ok = ok && read_full(c.fd, &rh, sizeof(rh)) && rh.magic == kMagic;
      if (!ok) {
        c.drop();  // stale connection (server restart) — retry once fresh
        continue;
      }
      if (resp_payload) resp_payload->resize(static_cast<size_t>(rh.nbytes));
      if (rh.nbytes > 0) {
        std::vector<char> sink;
        std::vector<char>* dst = resp_payload ? resp_payload : &sink;
        if (!resp_payload) sink.resize(static_cast<size_t>(rh.nbytes));
        if (!read_full(c.fd, dst->data(), static_cast<size_t>(rh.nbytes))) {
          c.drop();
          continue;
        }
      }
      if (resp_n) *resp_n = rh.n;
      return rh.flags == kStatusOk;
    }
    return false;
  }

  // broadcast the same request to all servers (create/save/load/lr/stop)
  bool broadcast(Header h, const void* payload) {
    if (n_servers() == 1) {
      Header hi = h;
      return request(0, hi, payload, nullptr);
    }
    std::atomic<bool> ok{true};
    std::vector<std::thread> ts;
    for (int i = 0; i < n_servers(); ++i) {
      ts.emplace_back([&, i] {
        Header hi = h;
        if (!request(i, hi, payload, nullptr)) ok.store(false);
      });
    }
    for (auto& t : ts) t.join();
    return ok.load();
  }

  // run `work(i)` for each involved server — inline when there is only one
  // (the per-minibatch hot path should not pay thread create/join), fanned
  // out on threads otherwise so per-server RPC latencies overlap
  template <typename W>
  bool fan_out(const std::vector<int>& servers, W work) {
    if (servers.size() == 1) return work(servers[0]);
    std::atomic<bool> ok{true};
    std::vector<std::thread> ts;
    ts.reserve(servers.size());
    for (int s : servers)
      ts.emplace_back([&, s] {
        if (!work(s)) ok.store(false);
      });
    for (auto& t : ts) t.join();
    return ok.load();
  }
};

// dense chunk [start, end) owned by server i
inline void dense_chunk(int64_t len, int n_servers, int i, int64_t* start,
                        int64_t* end) {
  *start = len * i / n_servers;
  *end = len * (i + 1) / n_servers;
}

// -- pipelined sparse transfer (reference: the async Communicator's
// batched, overlapped push/pull — ps/service/communicator/communicator.h).
// One server's batch splits into kChunkKeys-key chunks; a sender thread
// streams the chunk requests while the calling thread consumes the
// responses in order, so serialization, kernel copies, and the server's
// table work overlap instead of running strictly request-by-request. Row
// payloads ride scatter-gather iovecs straight from/to the caller's
// buffers (no gather/scatter copy). Also avoids the pipelining deadlock:
// requests and responses move on independent threads, so a full socket
// buffer in one direction can't wedge the other.
constexpr int64_t kChunkKeys = 8192;
constexpr int kIovBatch = 512;  // rows per sendmsg/recvmsg (< IOV_MAX)

// receive `m` rows into out[idx[j]*emb_dim], batched readv
inline bool recv_rows(int fd, float* out, const int64_t* idx, int64_t m,
                      int emb_dim) {
  const size_t row = sizeof(float) * static_cast<size_t>(emb_dim);
  std::vector<struct iovec> iov(kIovBatch);
  int64_t j = 0;
  while (j < m) {
    int cnt = static_cast<int>(std::min<int64_t>(m - j, kIovBatch));
    for (int k = 0; k < cnt; ++k) {
      iov[k].iov_base = out + idx[j + k] * emb_dim;
      iov[k].iov_len = row;
    }
    if (!readv_full(fd, iov.data(), cnt)) return false;
    j += cnt;
  }
  return true;
}

struct PullPlan {
  const int64_t* keys;
  const std::vector<int64_t>* idx;  // original positions for this server
  uint32_t table_id;
  int emb_dim;
  bool create;
};

// one pull attempt over an (already ensured) connection; caller holds mu
inline bool pull_attempt(Conn& c, const PullPlan& p, float* out) {
  const int64_t total = static_cast<int64_t>(p.idx->size());
  const int64_t nchunks = (total + kChunkKeys - 1) / kChunkKeys;
  std::atomic<bool> send_ok{true};
  std::thread sender([&] {
    std::vector<int64_t> sk;
    for (int64_t ci = 0; ci < nchunks; ++ci) {
      const int64_t b = ci * kChunkKeys;
      const int64_t e = std::min(total, b + kChunkKeys);
      sk.resize(static_cast<size_t>(e - b));
      for (int64_t j = b; j < e; ++j) sk[j - b] = p.keys[(*p.idx)[j]];
      Header h{kMagic, CMD_PULL_SPARSE, p.table_id,
               p.create ? kFlagCreate : 0u, e - b,
               static_cast<int64_t>(sk.size() * sizeof(int64_t))};
      if (!write_full(c.fd, &h, sizeof(h)) ||
          !write_full(c.fd, sk.data(), sk.size() * sizeof(int64_t))) {
        send_ok.store(false);
        return;
      }
    }
  });
  bool ok = true;
  for (int64_t ci = 0; ci < nchunks && ok; ++ci) {
    const int64_t b = ci * kChunkKeys;
    const int64_t e = std::min(total, b + kChunkKeys);
    Header rh{};
    ok = read_full(c.fd, &rh, sizeof(rh)) && rh.magic == kMagic &&
         rh.flags == kStatusOk &&
         rh.nbytes == (e - b) * static_cast<int64_t>(sizeof(float)) *
                          p.emb_dim &&
         recv_rows(c.fd, out, p.idx->data() + b, e - b, p.emb_dim);
  }
  // receiver aborted mid-stream (bad header / desync): the server keeps
  // streaming replies and eventually blocks, which would wedge the sender
  // in write_full forever — kill the socket so sender.join() returns
  if (!ok) ::shutdown(c.fd, SHUT_RDWR);
  sender.join();
  return ok && send_ok.load();
}

// pipelined pull for one server, with the idempotent-retry contract
inline bool pull_server(Client* c, int s, const PullPlan& p, float* out) {
  Conn& conn = *c->conns[s];
  std::lock_guard<std::mutex> lk(conn.mu);
  for (int attempt = 0; attempt < 2; ++attempt) {
    if (!conn.ensure()) return false;
    if (pull_attempt(conn, p, out)) return true;
    conn.drop();  // stale connection (server restart) — retry once fresh
  }
  return false;
}

// pipelined push for one server: chunk frames are written as ONE
// scatter-gather sendmsg (header + keys + rows straight from the caller's
// grads); a reader thread drains the per-chunk ack headers. PUSH is not
// idempotent, so a transport failure is final (single attempt).
inline bool push_server(Client* c, int s, uint32_t table_id,
                        const int64_t* keys, const std::vector<int64_t>& idx,
                        int emb_dim, const float* grads, bool raw) {
  Conn& conn = *c->conns[s];
  std::lock_guard<std::mutex> lk(conn.mu);
  if (!conn.ensure()) return false;
  const int64_t total = static_cast<int64_t>(idx.size());
  const int64_t nchunks = (total + kChunkKeys - 1) / kChunkKeys;
  const size_t row = sizeof(float) * static_cast<size_t>(emb_dim);
  std::atomic<bool> acks_ok{true};
  std::thread reader([&] {
    for (int64_t ci = 0; ci < nchunks; ++ci) {
      Header rh{};
      if (!read_full(conn.fd, &rh, sizeof(rh)) || rh.magic != kMagic ||
          rh.flags != kStatusOk || rh.nbytes != 0) {
        acks_ok.store(false);
        return;
      }
    }
  });
  bool ok = true;
  std::vector<int64_t> sk;
  std::vector<struct iovec> iov;
  for (int64_t ci = 0; ci < nchunks && ok; ++ci) {
    const int64_t b = ci * kChunkKeys;
    const int64_t e = std::min(total, b + kChunkKeys);
    const int64_t m = e - b;
    sk.resize(static_cast<size_t>(m));
    for (int64_t j = b; j < e; ++j) sk[j - b] = keys[idx[j]];
    Header h{kMagic, CMD_PUSH_SPARSE, table_id, raw ? kFlagRaw : 0u, m,
             static_cast<int64_t>(m * sizeof(int64_t) + m * row)};
    iov.resize(2);
    iov[0] = {&h, sizeof(h)};
    iov[1] = {sk.data(), static_cast<size_t>(m) * sizeof(int64_t)};
    ok = writev_full(conn.fd, iov.data(), 2);
    int64_t j = b;
    while (ok && j < e) {
      int cnt = static_cast<int>(std::min<int64_t>(e - j, kIovBatch));
      iov.resize(static_cast<size_t>(cnt));
      for (int k = 0; k < cnt; ++k) {
        iov[k].iov_base =
            const_cast<float*>(grads + idx[j + k] * emb_dim);
        iov[k].iov_len = row;
      }
      ok = writev_full(conn.fd, iov.data(), cnt);
      j += cnt;
    }
  }
  if (!ok) ::shutdown(conn.fd, SHUT_RDWR);  // unstick the ack reader
  reader.join();
  ok = ok && acks_ok.load();
  if (!ok) conn.drop();
  return ok;
}

}  // namespace
}  // namespace ps

extern "C" {

void* ps_client_create(const char* endpoints_csv) {
  auto* c = new ps::Client();
  for (auto& ep : ps::parse_endpoints(endpoints_csv)) {
    auto conn = std::make_unique<ps::Conn>();
    conn->host = ep.first;
    conn->port = ep.second;
    c->conns.push_back(std::move(conn));
  }
  if (c->conns.empty()) {
    delete c;
    return nullptr;
  }
  return c;
}

void ps_client_destroy(void* h) {
  auto* c = static_cast<ps::Client*>(h);
  for (auto& conn : c->conns) conn->drop();
  delete c;
}

int ps_client_n_servers(void* h) {
  return static_cast<ps::Client*>(h)->n_servers();
}

int ps_client_ping(void* h) {
  ps::Header hd{0, ps::CMD_PING, 0, 0, 0, 0};
  return static_cast<ps::Client*>(h)->broadcast(hd, nullptr) ? 0 : -1;
}

int ps_client_create_sparse(void* h, uint32_t table_id, int dim,
                            int shard_num, int opt, float lr, float range,
                            uint64_t seed) {
  char payload[28];
  std::memcpy(payload, &dim, 4);
  std::memcpy(payload + 4, &shard_num, 4);
  std::memcpy(payload + 8, &opt, 4);
  std::memcpy(payload + 12, &lr, 4);
  std::memcpy(payload + 16, &range, 4);
  std::memcpy(payload + 20, &seed, 8);
  ps::Header hd{0, ps::CMD_CREATE_SPARSE, table_id, 0, 0, 28};
  return static_cast<ps::Client*>(h)->broadcast(hd, payload) ? 0 : -1;
}

// init != nullptr seeds every server's chunk from the trainer-0 values
int ps_client_create_dense(void* h, uint32_t table_id, int64_t len, int opt,
                           float lr, const float* init) {
  auto* c = static_cast<ps::Client*>(h);
  std::atomic<bool> ok{true};
  std::vector<std::thread> ts;
  for (int i = 0; i < c->n_servers(); ++i) {
    ts.emplace_back([&, i] {
      int64_t s, e;
      ps::dense_chunk(len, c->n_servers(), i, &s, &e);
      int64_t chunk = e - s;
      std::vector<char> payload(16 + (init ? sizeof(float) * chunk : 0));
      std::memcpy(payload.data(), &opt, 4);
      std::memcpy(payload.data() + 4, &lr, 4);
      std::memcpy(payload.data() + 8, &chunk, 8);
      if (init)
        std::memcpy(payload.data() + 16, init + s, sizeof(float) * chunk);
      ps::Header hd{0, ps::CMD_CREATE_DENSE, table_id, 0, chunk,
                    static_cast<int64_t>(payload.size())};
      if (!c->request(i, hd, payload.data(), nullptr)) ok.store(false);
    });
  }
  for (auto& t : ts) t.join();
  return ok.load() ? 0 : -1;
}

int ps_client_pull_sparse(void* h, uint32_t table_id, const int64_t* keys,
                          int64_t n, int emb_dim, float* out, int create) {
  auto* c = static_cast<ps::Client*>(h);
  const int S = c->n_servers();
  // partition original positions by owning server
  std::vector<std::vector<int64_t>> pos(S);
  std::vector<int> involved;
  for (int64_t i = 0; i < n; ++i)
    pos[ps::server_of(keys[i], S)].push_back(i);
  for (int s = 0; s < S; ++s)
    if (!pos[s].empty()) involved.push_back(s);
  bool ok = c->fan_out(involved, [&](int s) {
    ps::PullPlan p{keys, &pos[s], table_id, emb_dim, create != 0};
    return ps::pull_server(c, s, p, out);
  });
  return ok ? 0 : -1;
}

int ps_client_push_sparse(void* h, uint32_t table_id, const int64_t* keys,
                          int64_t n, int emb_dim, const float* grads,
                          int raw) {
  auto* c = static_cast<ps::Client*>(h);
  const int S = c->n_servers();
  std::vector<std::vector<int64_t>> pos(S);
  std::vector<int> involved;
  for (int64_t i = 0; i < n; ++i)
    pos[ps::server_of(keys[i], S)].push_back(i);
  for (int s = 0; s < S; ++s)
    if (!pos[s].empty()) involved.push_back(s);
  bool ok = c->fan_out(involved, [&](int s) {
    return ps::push_server(c, s, table_id, keys, pos[s], emb_dim, grads,
                           raw != 0);
  });
  return ok ? 0 : -1;
}

static std::vector<int> all_servers(ps::Client* c) {
  std::vector<int> v(c->n_servers());
  for (int i = 0; i < c->n_servers(); ++i) v[i] = i;
  return v;
}

int ps_client_pull_dense(void* h, uint32_t table_id, float* out,
                         int64_t len) {
  auto* c = static_cast<ps::Client*>(h);
  bool ok = c->fan_out(all_servers(c), [&](int i) {
    int64_t s, e;
    ps::dense_chunk(len, c->n_servers(), i, &s, &e);
    if (e == s) return true;
    ps::Header hd{0, ps::CMD_PULL_DENSE, table_id, 0, 0, 0};
    std::vector<char> resp;
    if (!c->request(i, hd, nullptr, &resp) ||
        resp.size() != sizeof(float) * static_cast<size_t>(e - s))
      return false;
    std::memcpy(out + s, resp.data(), resp.size());
    return true;
  });
  return ok ? 0 : -1;
}

static int dense_scatter(void* h, uint32_t table_id, const float* vals,
                         int64_t len, ps::Cmd cmd) {
  auto* c = static_cast<ps::Client*>(h);
  bool ok = c->fan_out(all_servers(c), [&](int i) {
    int64_t s, e;
    ps::dense_chunk(len, c->n_servers(), i, &s, &e);
    if (e == s) return true;
    ps::Header hd{0, static_cast<uint32_t>(cmd), table_id, 0, e - s,
                  static_cast<int64_t>(sizeof(float) * (e - s))};
    return c->request(i, hd, vals + s, nullptr);
  });
  return ok ? 0 : -1;
}

int ps_client_push_dense(void* h, uint32_t table_id, const float* grads,
                         int64_t len) {
  return dense_scatter(h, table_id, grads, len, ps::CMD_PUSH_DENSE);
}

int ps_client_set_dense(void* h, uint32_t table_id, const float* vals,
                        int64_t len) {
  return dense_scatter(h, table_id, vals, len, ps::CMD_SET_DENSE);
}

// fused push+pull: grads out, updated values back, ONE round trip per
// server chunk (reference: the communicator's batched dense sync)
int ps_client_push_pull_dense(void* h, uint32_t table_id,
                              const float* grads, float* out, int64_t len) {
  auto* c = static_cast<ps::Client*>(h);
  bool ok = c->fan_out(all_servers(c), [&](int i) {
    int64_t s, e;
    ps::dense_chunk(len, c->n_servers(), i, &s, &e);
    if (e == s) return true;
    ps::Header hd{0, ps::CMD_PUSH_PULL_DENSE, table_id, 0, e - s,
                  static_cast<int64_t>(sizeof(float) * (e - s))};
    std::vector<char> resp;
    if (!c->request(i, hd, grads + s, &resp) ||
        resp.size() != sizeof(float) * static_cast<size_t>(e - s))
      return false;
    std::memcpy(out + s, resp.data(), resp.size());
    return true;
  });
  return ok ? 0 : -1;
}

// global barrier across trainers, coordinated by server 0 (reference:
// BarrierTable lives on one server)
int ps_client_barrier(void* h, int trainer_id) {
  ps::Header hd{0, ps::CMD_BARRIER, 0, 0, trainer_id, 0};
  return static_cast<ps::Client*>(h)->request(0, hd, nullptr, nullptr) ? 0
                                                                       : -1;
}

int ps_client_save(void* h, const char* dirname) {
  ps::Header hd{0, ps::CMD_SAVE, 0, 0, 0,
                static_cast<int64_t>(std::strlen(dirname))};
  return static_cast<ps::Client*>(h)->broadcast(hd, dirname) ? 0 : -1;
}

int ps_client_load(void* h, const char* dirname) {
  ps::Header hd{0, ps::CMD_LOAD, 0, 0, 0,
                static_cast<int64_t>(std::strlen(dirname))};
  return static_cast<ps::Client*>(h)->broadcast(hd, dirname) ? 0 : -1;
}

// table_id 0 = every table on the fleet; nonzero = that table only
int64_t ps_client_stat(void* h, uint32_t table_id) {
  auto* c = static_cast<ps::Client*>(h);
  int64_t total = 0;
  for (int i = 0; i < c->n_servers(); ++i) {
    ps::Header hd{0, ps::CMD_STAT, table_id, 0, 0, 0};
    int64_t n = 0;
    if (!c->request(i, hd, nullptr, nullptr, &n)) return -1;
    total += n;
  }
  return total;
}

int ps_client_set_lr(void* h, uint32_t table_id, float lr) {
  ps::Header hd{0, ps::CMD_SET_LR, table_id, 0, 0, 4};
  return static_cast<ps::Client*>(h)->broadcast(hd, &lr) ? 0 : -1;
}

// -- CTR accessor (reference: ctr_accessor.h via BrpcPsClient push) --------
int ps_client_set_ctr(void* h, uint32_t table_id, float show_coeff,
                      float click_coeff, float decay_rate,
                      float delete_threshold, float delete_after_unseen) {
  float cfg[5] = {show_coeff, click_coeff, decay_rate, delete_threshold,
                  delete_after_unseen};
  ps::Header hd{0, ps::CMD_SET_CTR, table_id, 0, 0, sizeof(cfg)};
  return static_cast<ps::Client*>(h)->broadcast(hd, cfg) ? 0 : -1;
}

int ps_client_push_ctr(void* h, uint32_t table_id, const int64_t* keys,
                       int64_t n, int emb_dim, const float* shows,
                       const float* clicks, const float* grads) {
  auto* c = static_cast<ps::Client*>(h);
  const int S = c->n_servers();
  std::vector<std::vector<int64_t>> pos(S);
  std::vector<int> involved;
  for (int64_t i = 0; i < n; ++i)
    pos[ps::server_of(keys[i], S)].push_back(i);
  for (int s = 0; s < S; ++s)
    if (!pos[s].empty()) involved.push_back(s);
  bool ok = c->fan_out(involved, [&](int s) {
    const auto& ps_idx = pos[s];
    const size_t m = ps_idx.size();
    std::vector<char> payload(m * sizeof(int64_t) + 2 * m * sizeof(float) +
                              m * sizeof(float) * emb_dim);
    int64_t* sk = reinterpret_cast<int64_t*>(payload.data());
    float* sshow =
        reinterpret_cast<float*>(payload.data() + m * sizeof(int64_t));
    float* sclick = sshow + m;
    float* sg = sclick + m;
    for (size_t j = 0; j < m; ++j) {
      sk[j] = keys[ps_idx[j]];
      sshow[j] = shows[ps_idx[j]];
      sclick[j] = clicks[ps_idx[j]];
      std::memcpy(sg + j * emb_dim, grads + ps_idx[j] * emb_dim,
                  sizeof(float) * emb_dim);
    }
    ps::Header hd{0, ps::CMD_PUSH_CTR, table_id, 0,
                  static_cast<int64_t>(m),
                  static_cast<int64_t>(payload.size())};
    return c->request(s, hd, payload.data(), nullptr);
  });
  return ok ? 0 : -1;
}

// decay + eviction pass on every server; returns total evicted (or -1)
int64_t ps_client_shrink(void* h, uint32_t table_id) {
  auto* c = static_cast<ps::Client*>(h);
  int64_t total = 0;
  for (int i = 0; i < c->n_servers(); ++i) {
    ps::Header hd{0, ps::CMD_SHRINK, table_id, 0, 0, 0};
    std::vector<char> resp;
    if (!c->request(i, hd, nullptr, &resp) || resp.size() < sizeof(int64_t))
      return -1;
    int64_t e;
    std::memcpy(&e, resp.data(), sizeof(e));
    total += e;
  }
  return total;
}

int ps_client_ctr_stats(void* h, uint32_t table_id, int64_t key,
                        float* out4) {
  auto* c = static_cast<ps::Client*>(h);
  int s = ps::server_of(key, c->n_servers());
  ps::Header hd{0, ps::CMD_CTR_STATS, table_id, 0, 1, sizeof(key)};
  std::vector<char> resp;
  if (!c->request(s, hd, &key, &resp) || resp.size() < 4 * sizeof(float))
    return -1;
  std::memcpy(out4, resp.data(), 4 * sizeof(float));
  return 0;
}

// -- KV / lease verbs (the etcd replacement: elastic membership + launch
// master endpoint discovery). All route to server 0 — the KV master.
static int kv_keyed_put(void* h, uint32_t cmd, int64_t n, const char* key,
                        const char* val, int64_t val_len) {
  auto* c = static_cast<ps::Client*>(h);
  int32_t klen = static_cast<int32_t>(std::strlen(key));
  std::vector<char> payload(4 + klen + val_len);
  std::memcpy(payload.data(), &klen, 4);
  std::memcpy(payload.data() + 4, key, klen);
  if (val_len > 0) std::memcpy(payload.data() + 4 + klen, val, val_len);
  ps::Header hd{0, cmd, 0, 0, n, static_cast<int64_t>(payload.size())};
  return c->request(0, hd, payload.data(), nullptr) ? 0 : -1;
}

int ps_client_kv_put(void* h, const char* key, const char* val,
                     int64_t val_len) {
  return kv_keyed_put(h, ps::CMD_KV_PUT, 0, key, val, val_len);
}

int ps_client_kv_lease(void* h, const char* key, const char* val,
                       int64_t val_len, int64_t ttl_ms) {
  return kv_keyed_put(h, ps::CMD_KV_LEASE, ttl_ms, key, val, val_len);
}

// returns value length (copied into out, up to cap), -1 absent/expired,
// -2 transport error, -3 value larger than cap
int64_t ps_client_kv_get(void* h, const char* key, char* out, int64_t cap) {
  auto* c = static_cast<ps::Client*>(h);
  ps::Header hd{0, ps::CMD_KV_GET, 0, 0, 0,
                static_cast<int64_t>(std::strlen(key))};
  std::vector<char> resp;
  int64_t n = 0;
  if (!c->request(0, hd, key, &resp, &n)) return -2;
  if (n < 0) return -1;
  if (static_cast<int64_t>(resp.size()) > cap) return -3;
  std::memcpy(out, resp.data(), resp.size());
  return static_cast<int64_t>(resp.size());
}

int ps_client_kv_del(void* h, const char* key) {
  auto* c = static_cast<ps::Client*>(h);
  ps::Header hd{0, ps::CMD_KV_DEL, 0, 0, 0,
                static_cast<int64_t>(std::strlen(key))};
  return c->request(0, hd, key, nullptr) ? 0 : -1;
}

// unexpired keys with prefix: key\0value\0... copied into out (up to
// cap); returns byte length, -2 transport error, -3 overflow
int64_t ps_client_kv_alive(void* h, const char* prefix, char* out,
                           int64_t cap) {
  auto* c = static_cast<ps::Client*>(h);
  ps::Header hd{0, ps::CMD_KV_ALIVE, 0, 0, 0,
                static_cast<int64_t>(std::strlen(prefix))};
  std::vector<char> resp;
  if (!c->request(0, hd, prefix, &resp)) return -2;
  if (static_cast<int64_t>(resp.size()) > cap) return -3;
  if (!resp.empty()) std::memcpy(out, resp.data(), resp.size());
  return static_cast<int64_t>(resp.size());
}

int ps_client_stop_servers(void* h) {
  ps::Header hd{0, ps::CMD_STOP, 0, 0, 0, 0};
  return static_cast<ps::Client*>(h)->broadcast(hd, nullptr) ? 0 : -1;
}

}  // extern "C"
