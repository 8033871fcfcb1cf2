// PsService server — one process of the sharded parameter-server fleet.
//
// Reference analogue: paddle/fluid/distributed/ps/service/brpc_ps_server.h
// (BrpcPsServer/BrpcPsService dispatching pull/push/barrier/save/load RPCs
// onto table shards) and ps/service/server.cc. This implementation serves
// the same verbs over the dependency-free framed-TCP protocol in ps_net.h:
// thread-per-connection (trainer connections are long-lived and few), with
// table-level shard mutexes providing the concurrency contract brpc gets
// from its task queues.
//
// Each server process owns:
//   - the subset of sparse keys hashing to it (server_of(key) == server_id);
//   - one contiguous chunk of every dense table (client splits by range).
//
// C ABI (ctypes): ps_server_create / ps_server_port / ps_server_wait /
// ps_server_stop / ps_server_destroy.

#include <atomic>
#include <chrono>
#include <condition_variable>
#include <map>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include "ps_dense_table.h"
#include "ps_net.h"
#include "ps_sparse_table.h"

namespace ps {
namespace {

bool save_dense(DenseTable& t, const std::string& path) {
  std::lock_guard<std::mutex> lk(t.mu);
  FILE* f = std::fopen(path.c_str(), "wb");
  if (!f) return false;
  int64_t len = static_cast<int64_t>(t.data.size());
  int32_t has_m = t.m1.empty() ? 0 : 1;
  bool ok = std::fwrite(&len, sizeof(len), 1, f) == 1 &&
            std::fwrite(&has_m, sizeof(has_m), 1, f) == 1 &&
            std::fwrite(&t.beta1_pow, sizeof(double), 1, f) == 1 &&
            std::fwrite(&t.beta2_pow, sizeof(double), 1, f) == 1 &&
            std::fwrite(t.data.data(), sizeof(float), len, f) ==
                static_cast<size_t>(len);
  if (has_m)
    ok = ok &&
         std::fwrite(t.m1.data(), sizeof(float), len, f) ==
             static_cast<size_t>(len) &&
         std::fwrite(t.m2.data(), sizeof(float), len, f) ==
             static_cast<size_t>(len);
  return (std::fclose(f) == 0) && ok;
}

bool load_dense(DenseTable& t, const std::string& path) {
  std::lock_guard<std::mutex> lk(t.mu);
  FILE* f = std::fopen(path.c_str(), "rb");
  if (!f) return false;
  int64_t len = 0;
  int32_t has_m = 0;
  bool ok = std::fread(&len, sizeof(len), 1, f) == 1 &&
            len == static_cast<int64_t>(t.data.size()) &&
            std::fread(&has_m, sizeof(has_m), 1, f) == 1 &&
            std::fread(&t.beta1_pow, sizeof(double), 1, f) == 1 &&
            std::fread(&t.beta2_pow, sizeof(double), 1, f) == 1 &&
            std::fread(t.data.data(), sizeof(float), len, f) ==
                static_cast<size_t>(len);
  if (ok && has_m) {
    if (t.m1.empty()) t.m1.resize(len);
    if (t.m2.empty()) t.m2.resize(len);
    ok = std::fread(t.m1.data(), sizeof(float), len, f) ==
             static_cast<size_t>(len) &&
         std::fread(t.m2.data(), sizeof(float), len, f) ==
             static_cast<size_t>(len);
  }
  std::fclose(f);
  return ok;
}

struct Server {
  int listen_fd = -1;
  int port = 0;
  int server_id = 0;
  int n_servers = 1;
  int n_trainers = 1;
  std::atomic<bool> running{true};

  std::mutex tables_mu;
  std::map<uint32_t, std::unique_ptr<SparseTable>> sparse;
  std::map<uint32_t, std::unique_ptr<DenseTable>> dense;

  // barrier state (reference: BarrierTable) — generation-counted so
  // consecutive barriers can't confuse stragglers
  std::mutex bar_mu;
  std::condition_variable bar_cv;
  int bar_count = 0;
  uint64_t bar_gen = 0;

  std::thread accept_thread;
  std::mutex conns_mu;
  std::vector<std::thread> conns;
  std::vector<int> conn_fds;  // live connection sockets, for stop() wakeup

  // wait() support
  std::mutex stop_mu;
  std::condition_variable stop_cv;

  // KV / lease store (the etcd replacement for elastic membership and
  // launch-master endpoint discovery). deadline_ms < 0 = plain put (no
  // expiry); leases expire by steady-clock comparison at read time.
  std::mutex kv_mu;
  struct KvEntry {
    std::string value;
    double deadline_ms = -1.0;
  };
  std::map<std::string, KvEntry> kv;

  static double now_ms() {
    return std::chrono::duration<double, std::milli>(
               std::chrono::steady_clock::now().time_since_epoch())
        .count();
  }

  SparseTable* get_sparse(uint32_t id) {
    std::lock_guard<std::mutex> lk(tables_mu);
    auto it = sparse.find(id);
    return it == sparse.end() ? nullptr : it->second.get();
  }

  DenseTable* get_dense(uint32_t id) {
    std::lock_guard<std::mutex> lk(tables_mu);
    auto it = dense.find(id);
    return it == dense.end() ? nullptr : it->second.get();
  }

  void reply(int fd, const Header& req, uint32_t status, const void* payload,
             int64_t nbytes, int64_t n = 0) {
    Header h{kMagic, req.cmd, req.table_id, status, n, nbytes};
    if (!write_full(fd, &h, sizeof(h))) return;
    if (nbytes > 0) write_full(fd, payload, static_cast<size_t>(nbytes));
  }

  void handle_conn(int fd) {
    std::vector<char> buf;
    while (running.load()) {
      Header h{};
      if (!read_full(fd, &h, sizeof(h)) || h.magic != kMagic) break;
      buf.resize(static_cast<size_t>(h.nbytes));
      if (h.nbytes > 0 && !read_full(fd, buf.data(), buf.size())) break;
      if (!dispatch(fd, h, buf)) break;
    }
    {
      std::lock_guard<std::mutex> lk(conns_mu);
      for (auto it = conn_fds.begin(); it != conn_fds.end(); ++it)
        if (*it == fd) {
          conn_fds.erase(it);
          break;
        }
    }
    ::close(fd);
  }

  // unblock every handler thread parked in recv() so destroy can join —
  // without this, a client that never closes its socket would wedge
  // shutdown (threads block in read_full until the peer closes)
  void shutdown_conns() {
    std::lock_guard<std::mutex> lk(conns_mu);
    for (int fd : conn_fds) ::shutdown(fd, SHUT_RDWR);
  }

  bool dispatch(int fd, const Header& h, std::vector<char>& payload) {
    switch (h.cmd) {
      case CMD_PING: {
        reply(fd, h, kStatusOk, nullptr, 0);
        return true;
      }
      case CMD_CREATE_SPARSE: {
        // payload: i32 dim, i32 shard_num, i32 opt, f32 lr, f32 range, u64 seed
        if (payload.size() < 3 * 4 + 2 * 4 + 8) {
          reply(fd, h, kStatusErr, nullptr, 0);
          return true;
        }
        const char* p = payload.data();
        int32_t dim, shard_num, opt;
        float lr, range;
        uint64_t seed;
        std::memcpy(&dim, p, 4);
        std::memcpy(&shard_num, p + 4, 4);
        std::memcpy(&opt, p + 8, 4);
        std::memcpy(&lr, p + 12, 4);
        std::memcpy(&range, p + 16, 4);
        std::memcpy(&seed, p + 20, 8);
        std::lock_guard<std::mutex> lk(tables_mu);
        if (!sparse.count(h.table_id)) {
          sparse.emplace(h.table_id,
                         std::make_unique<SparseTable>(dim, shard_num, opt, lr,
                                                       range, seed));
        }
        reply(fd, h, kStatusOk, nullptr, 0);
        return true;
      }
      case CMD_CREATE_DENSE: {
        // payload: i32 opt, f32 lr, i64 len, [f32 init[len]]
        if (payload.size() < 16) {
          reply(fd, h, kStatusErr, nullptr, 0);
          return true;
        }
        const char* p = payload.data();
        int32_t opt;
        float lr;
        int64_t len;
        std::memcpy(&opt, p, 4);
        std::memcpy(&lr, p + 4, 4);
        std::memcpy(&len, p + 8, 8);
        const float* init = nullptr;
        if (payload.size() >= 16 + sizeof(float) * static_cast<size_t>(len))
          init = reinterpret_cast<const float*>(p + 16);
        std::lock_guard<std::mutex> lk(tables_mu);
        if (!dense.count(h.table_id)) {
          dense.emplace(h.table_id,
                        std::make_unique<DenseTable>(opt, lr, len, init));
        }
        reply(fd, h, kStatusOk, nullptr, 0);
        return true;
      }
      case CMD_PULL_SPARSE: {
        SparseTable* t = get_sparse(h.table_id);
        const int64_t n = h.n;
        if (!t || payload.size() < sizeof(int64_t) * static_cast<size_t>(n)) {
          reply(fd, h, kStatusErr, nullptr, 0);
          return true;
        }
        // per-thread reusable buffer: chunked pipelined pulls hit this
        // per chunk — a fresh vector would memset MBs on every request
        static thread_local std::vector<float> out;
        const size_t need = static_cast<size_t>(n) * t->emb_dim;
        if (out.size() < need) out.resize(need);
        t->pull(reinterpret_cast<const int64_t*>(payload.data()), n,
                out.data(), (h.flags & kFlagCreate) != 0);
        reply(fd, h, kStatusOk, out.data(),
              static_cast<int64_t>(need * sizeof(float)), n);
        return true;
      }
      case CMD_PUSH_SPARSE: {
        SparseTable* t = get_sparse(h.table_id);
        const int64_t n = h.n;
        if (!t ||
            payload.size() < n * (sizeof(int64_t) +
                                  sizeof(float) * static_cast<size_t>(
                                                      t ? t->emb_dim : 0))) {
          reply(fd, h, kStatusErr, nullptr, 0);
          return true;
        }
        const int64_t* keys = reinterpret_cast<const int64_t*>(payload.data());
        const float* grads = reinterpret_cast<const float*>(
            payload.data() + sizeof(int64_t) * static_cast<size_t>(n));
        t->push(keys, n, grads, (h.flags & kFlagRaw) != 0);
        reply(fd, h, kStatusOk, nullptr, 0);
        return true;
      }
      case CMD_SET_CTR: {
        // payload: f32 show_coeff, click_coeff, decay, threshold, unseen
        SparseTable* t = get_sparse(h.table_id);
        if (!t || payload.size() < 5 * sizeof(float)) {
          reply(fd, h, kStatusErr, nullptr, 0);
          return true;
        }
        const float* p = reinterpret_cast<const float*>(payload.data());
        t->ctr.enabled = true;
        t->ctr.show_coeff = p[0];
        t->ctr.click_coeff = p[1];
        t->ctr.decay_rate = p[2];
        t->ctr.delete_threshold = p[3];
        t->ctr.delete_after_unseen_days = p[4];
        reply(fd, h, kStatusOk, nullptr, 0);
        return true;
      }
      case CMD_PUSH_CTR: {
        // payload: i64 keys[n], f32 shows[n], f32 clicks[n], f32 grads[n*dim]
        SparseTable* t = get_sparse(h.table_id);
        const int64_t n = h.n;
        if (!t || payload.size() <
                      static_cast<size_t>(n) *
                          (sizeof(int64_t) + 2 * sizeof(float) +
                           sizeof(float) * t->emb_dim)) {
          reply(fd, h, kStatusErr, nullptr, 0);
          return true;
        }
        const char* p = payload.data();
        const int64_t* keys = reinterpret_cast<const int64_t*>(p);
        const float* shows =
            reinterpret_cast<const float*>(p + sizeof(int64_t) * n);
        const float* clicks = shows + n;
        const float* grads = clicks + n;
        t->push_ctr(keys, n, shows, clicks, grads);
        reply(fd, h, kStatusOk, nullptr, 0);
        return true;
      }
      case CMD_SHRINK: {
        SparseTable* t = get_sparse(h.table_id);
        if (!t) {
          reply(fd, h, kStatusErr, nullptr, 0);
          return true;
        }
        int64_t evicted = t->shrink();
        reply(fd, h, kStatusOk, &evicted, sizeof(evicted));
        return true;
      }
      case CMD_CTR_STATS: {
        SparseTable* t = get_sparse(h.table_id);
        if (!t || payload.size() < sizeof(int64_t)) {
          reply(fd, h, kStatusErr, nullptr, 0);
          return true;
        }
        int64_t key;
        std::memcpy(&key, payload.data(), sizeof(key));
        float out[4] = {0, 0, 0, 0};
        if (!t->ctr_stats(key, out)) {
          reply(fd, h, kStatusErr, nullptr, 0);
          return true;
        }
        reply(fd, h, kStatusOk, out, sizeof(out));
        return true;
      }
      case CMD_PULL_DENSE: {
        DenseTable* t = get_dense(h.table_id);
        if (!t) {
          reply(fd, h, kStatusErr, nullptr, 0);
          return true;
        }
        std::vector<float> out(t->data.size());
        t->pull(out.data());
        reply(fd, h, kStatusOk, out.data(),
              static_cast<int64_t>(out.size() * sizeof(float)),
              static_cast<int64_t>(out.size()));
        return true;
      }
      case CMD_PUSH_DENSE: {
        DenseTable* t = get_dense(h.table_id);
        if (!t || payload.size() < sizeof(float) * t->data.size()) {
          reply(fd, h, kStatusErr, nullptr, 0);
          return true;
        }
        t->push(reinterpret_cast<const float*>(payload.data()));
        reply(fd, h, kStatusOk, nullptr, 0);
        return true;
      }
      case CMD_PUSH_PULL_DENSE: {
        // fused round trip (the reference communicator's batched
        // send_and_recv): apply this trainer's grads, reply the updated
        // chunk — halves the per-step round trips of push-then-pull
        DenseTable* t = get_dense(h.table_id);
        if (!t || payload.size() < sizeof(float) * t->data.size()) {
          reply(fd, h, kStatusErr, nullptr, 0);
          return true;
        }
        t->push(reinterpret_cast<const float*>(payload.data()));
        std::vector<float> out(t->data.size());
        t->pull(out.data());
        reply(fd, h, kStatusOk, out.data(),
              static_cast<int64_t>(out.size() * sizeof(float)),
              static_cast<int64_t>(out.size()));
        return true;
      }
      case CMD_SET_DENSE: {
        DenseTable* t = get_dense(h.table_id);
        if (!t || payload.size() < sizeof(float) * t->data.size()) {
          reply(fd, h, kStatusErr, nullptr, 0);
          return true;
        }
        t->set(reinterpret_cast<const float*>(payload.data()));
        reply(fd, h, kStatusOk, nullptr, 0);
        return true;
      }
      case CMD_BARRIER: {
        uint64_t gen;
        {
          std::unique_lock<std::mutex> lk(bar_mu);
          gen = bar_gen;
          if (++bar_count >= n_trainers) {
            bar_count = 0;
            ++bar_gen;
            bar_cv.notify_all();
          } else {
            bar_cv.wait(lk, [&] {
              return bar_gen != gen || !running.load();
            });
          }
        }
        reply(fd, h, kStatusOk, nullptr, 0);
        return true;
      }
      case CMD_SAVE:
      case CMD_LOAD: {
        std::string dir(payload.data(), payload.size());
        bool ok = true;
        std::lock_guard<std::mutex> lk(tables_mu);
        for (auto& kv : sparse) {
          std::string path = dir + "/sparse_" + std::to_string(kv.first) +
                             ".part" + std::to_string(server_id);
          ok = (h.cmd == CMD_SAVE) ? (ok && kv.second->save(path.c_str()))
                                   : (ok && kv.second->load(path.c_str()));
        }
        // dense tables (values + adam moments) checkpoint too — they ARE
        // the model in DenseTableHandle mode
        for (auto& kv : dense) {
          std::string path = dir + "/dense_" + std::to_string(kv.first) +
                             ".part" + std::to_string(server_id);
          ok = (h.cmd == CMD_SAVE) ? (ok && save_dense(*kv.second, path))
                                   : (ok && load_dense(*kv.second, path));
        }
        reply(fd, h, ok ? kStatusOk : kStatusErr, nullptr, 0);
        return true;
      }
      case CMD_STAT: {
        // table_id 0 → whole fleet; nonzero → that sparse table only
        int64_t total = 0;
        {
          std::lock_guard<std::mutex> lk(tables_mu);
          for (auto& kv : sparse)
            if (h.table_id == 0 || kv.first == h.table_id)
              total += kv.second->size();
        }
        reply(fd, h, kStatusOk, nullptr, 0, total);
        return true;
      }
      case CMD_SET_LR: {
        if (payload.size() < 4) {
          reply(fd, h, kStatusErr, nullptr, 0);
          return true;
        }
        float lr;
        std::memcpy(&lr, payload.data(), 4);
        std::lock_guard<std::mutex> lk(tables_mu);
        for (auto& kv : sparse)
          if (h.table_id == 0 || kv.first == h.table_id)
            kv.second->lr = lr;
        for (auto& kv : dense)
          if (h.table_id == 0 || kv.first == h.table_id)
            kv.second->lr = lr;
        reply(fd, h, kStatusOk, nullptr, 0);
        return true;
      }
      case CMD_KV_PUT:
      case CMD_KV_LEASE: {
        // payload: i32 klen, key[klen], value[rest]
        if (payload.size() < 4) {
          reply(fd, h, kStatusErr, nullptr, 0);
          return true;
        }
        int32_t klen;
        std::memcpy(&klen, payload.data(), 4);
        if (klen < 0 || payload.size() < 4 + static_cast<size_t>(klen)) {
          reply(fd, h, kStatusErr, nullptr, 0);
          return true;
        }
        std::string key(payload.data() + 4, static_cast<size_t>(klen));
        std::string val(payload.data() + 4 + klen,
                        payload.size() - 4 - klen);
        {
          // never hold kv_mu across the reply socket write: a stalled
          // client would block every other node's heartbeat past its TTL
          std::lock_guard<std::mutex> lk(kv_mu);
          KvEntry& e = kv[key];
          e.value = std::move(val);
          e.deadline_ms = h.cmd == CMD_KV_LEASE
                              ? now_ms() + static_cast<double>(h.n)
                              : -1.0;
        }
        reply(fd, h, kStatusOk, nullptr, 0);
        return true;
      }
      case CMD_KV_GET: {
        std::string key(payload.data(), payload.size());
        std::string val;
        bool found = false;
        {
          std::lock_guard<std::mutex> lk(kv_mu);
          auto it = kv.find(key);
          if (it != kv.end() && !(it->second.deadline_ms >= 0 &&
                                  now_ms() > it->second.deadline_ms)) {
            val = it->second.value;  // copy; reply happens unlocked
            found = true;
          }
        }
        if (!found) {
          reply(fd, h, kStatusOk, nullptr, 0, /*n=*/-1);  // absent/expired
        } else {
          reply(fd, h, kStatusOk, val.data(),
                static_cast<int64_t>(val.size()), 1);
        }
        return true;
      }
      case CMD_KV_DEL: {
        std::string key(payload.data(), payload.size());
        {
          std::lock_guard<std::mutex> lk(kv_mu);
          kv.erase(key);
        }
        reply(fd, h, kStatusOk, nullptr, 0);
        return true;
      }
      case CMD_KV_ALIVE: {
        // every unexpired key with the prefix: key\0value\0 pairs
        std::string prefix(payload.data(), payload.size());
        std::string out;
        int64_t count = 0;
        {
          std::lock_guard<std::mutex> lk(kv_mu);
          double now = now_ms();
          for (auto it = kv.begin(); it != kv.end();) {
            if (it->second.deadline_ms >= 0 &&
                now > it->second.deadline_ms) {
              it = kv.erase(it);  // lazy expiry compaction
              continue;
            }
            if (it->first.compare(0, prefix.size(), prefix) == 0) {
              out += it->first;
              out.push_back('\0');
              out += it->second.value;
              out.push_back('\0');
              ++count;
            }
            ++it;
          }
        }
        reply(fd, h, kStatusOk, out.data(),
              static_cast<int64_t>(out.size()), count);
        return true;
      }
      case CMD_STOP: {
        reply(fd, h, kStatusOk, nullptr, 0);
        running.store(false);
        {
          std::lock_guard<std::mutex> lk(bar_mu);
          bar_cv.notify_all();
        }
        stop_cv.notify_all();
        // poke the accept loop out of ::accept
        int fd2 = connect_to("127.0.0.1", port);
        if (fd2 >= 0) ::close(fd2);
        return false;
      }
      default:
        reply(fd, h, kStatusErr, nullptr, 0);
        return true;
    }
  }

  void accept_loop() {
    while (running.load()) {
      int fd = ::accept(listen_fd, nullptr, nullptr);
      if (fd < 0) {
        if (!running.load()) break;
        continue;
      }
      if (!running.load()) {
        ::close(fd);
        break;
      }
      int one = 1;
      ::setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
      set_bulk_buffers(fd);
      std::lock_guard<std::mutex> lk(conns_mu);
      conn_fds.push_back(fd);
      conns.emplace_back([this, fd] { handle_conn(fd); });
    }
    ::close(listen_fd);
  }
};

}  // namespace
}  // namespace ps

extern "C" {

void* ps_server_create(int port, int server_id, int n_servers,
                       int n_trainers) {
  auto* s = new ps::Server();
  s->server_id = server_id;
  s->n_servers = n_servers;
  s->n_trainers = n_trainers;
  s->listen_fd = ::socket(AF_INET, SOCK_STREAM, 0);
  if (s->listen_fd < 0) {
    delete s;
    return nullptr;
  }
  int one = 1;
  ::setsockopt(s->listen_fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_addr.s_addr = htonl(INADDR_ANY);
  addr.sin_port = htons(static_cast<uint16_t>(port));
  if (::bind(s->listen_fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) !=
          0 ||
      ::listen(s->listen_fd, 64) != 0) {
    ::close(s->listen_fd);
    delete s;
    return nullptr;
  }
  socklen_t alen = sizeof(addr);
  ::getsockname(s->listen_fd, reinterpret_cast<sockaddr*>(&addr), &alen);
  s->port = ntohs(addr.sin_port);
  s->accept_thread = std::thread([s] { s->accept_loop(); });
  return s;
}

int ps_server_port(void* h) { return static_cast<ps::Server*>(h)->port; }

// block until a CMD_STOP arrives (fleet.run_server())
void ps_server_wait(void* h) {
  auto* s = static_cast<ps::Server*>(h);
  std::unique_lock<std::mutex> lk(s->stop_mu);
  s->stop_cv.wait(lk, [&] { return !s->running.load(); });
}

void ps_server_stop(void* h) {
  auto* s = static_cast<ps::Server*>(h);
  s->running.store(false);
  s->stop_cv.notify_all();
  {
    std::lock_guard<std::mutex> lk(s->bar_mu);
    s->bar_cv.notify_all();
  }
  int fd = ps::connect_to("127.0.0.1", s->port);
  if (fd >= 0) ::close(fd);
}

void ps_server_destroy(void* h) {
  auto* s = static_cast<ps::Server*>(h);
  ps_server_stop(h);
  s->shutdown_conns();
  if (s->accept_thread.joinable()) s->accept_thread.join();
  // handler threads may still be erasing from conn_fds — join them without
  // holding conns_mu (they take it on exit), then delete
  std::vector<std::thread> conns;
  {
    std::lock_guard<std::mutex> lk(s->conns_mu);
    conns.swap(s->conns);
  }
  for (auto& t : conns)
    if (t.joinable()) t.join();
  delete s;
}

}  // extern "C"
