// Wire protocol + socket helpers shared by the PsService server and client.
//
// Reference analogue: the brpc transport under
// paddle/fluid/distributed/ps/service/brpc_ps_server.h /
// brpc_ps_client.h. This framework replaces brpc with a dependency-free
// length-prefixed binary protocol over TCP (localhost or DCN): every
// request is one framed message and gets exactly one framed response on the
// same connection (connections are per-client-thread serialized).
#pragma once

#include <arpa/inet.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sys/socket.h>
#include <sys/uio.h>
#include <unistd.h>

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <string>
#include <utility>
#include <vector>

namespace ps {

constexpr uint32_t kMagic = 0x50535631;  // "PSV1"

enum Cmd : uint32_t {
  CMD_PING = 1,
  CMD_CREATE_SPARSE = 2,
  CMD_CREATE_DENSE = 3,
  CMD_PULL_SPARSE = 4,
  CMD_PUSH_SPARSE = 5,
  CMD_PULL_DENSE = 6,
  CMD_PUSH_DENSE = 7,
  CMD_BARRIER = 8,
  CMD_SAVE = 9,
  CMD_LOAD = 10,
  CMD_STAT = 11,
  CMD_SET_LR = 12,
  CMD_STOP = 13,
  CMD_SET_DENSE = 14,
  CMD_SET_CTR = 15,    // configure the CTR accessor on a sparse table
  CMD_PUSH_CTR = 16,   // push with show/click counts (ctr_accessor Update)
  CMD_SHRINK = 17,     // decay + score-based eviction pass
  CMD_CTR_STATS = 18,  // show/click/unseen/score for one key (tests)
  CMD_PUSH_PULL_DENSE = 19,  // fused: apply grads, reply updated values
                             // (one round trip instead of push+pull)
  // KV / lease service (reference: the etcd the elastic manager and the
  // launch master keep membership + endpoint discovery in —
  // fleet/elastic/manager.py:130, launch/controllers/master.py)
  CMD_KV_PUT = 20,    // payload: i32 klen, key, value
  CMD_KV_GET = 21,    // payload: key; resp: value (n = -1 when absent)
  CMD_KV_DEL = 22,    // payload: key
  CMD_KV_LEASE = 23,  // n = ttl_ms; payload: i32 klen, key, value
  CMD_KV_ALIVE = 24,  // payload: prefix; resp: key\0value\0... unexpired
};

// flags bits
constexpr uint32_t kFlagCreate = 1u;  // PULL_SPARSE: create-on-miss
constexpr uint32_t kFlagRaw = 2u;     // PUSH_SPARSE: raw delta add (geo)

struct Header {
  uint32_t magic;
  uint32_t cmd;
  uint32_t table_id;
  uint32_t flags;
  int64_t n;       // element count / trainer id (BARRIER)
  int64_t nbytes;  // payload bytes following this header
};

// status returned in response Header.flags
constexpr uint32_t kStatusOk = 0;
constexpr uint32_t kStatusErr = 1;

inline bool read_full(int fd, void* buf, size_t len) {
  char* p = static_cast<char*>(buf);
  while (len > 0) {
    ssize_t r = ::recv(fd, p, len, 0);
    if (r <= 0) {
      if (r < 0 && (errno == EINTR)) continue;
      return false;
    }
    p += r;
    len -= static_cast<size_t>(r);
  }
  return true;
}

inline bool write_full(int fd, const void* buf, size_t len) {
  const char* p = static_cast<const char*>(buf);
  while (len > 0) {
    ssize_t r = ::send(fd, p, len, MSG_NOSIGNAL);
    if (r <= 0) {
      if (r < 0 && (errno == EINTR)) continue;
      return false;
    }
    p += r;
    len -= static_cast<size_t>(r);
  }
  return true;
}

// scatter-gather socket IO: rows move straight between the caller's
// strided buffers and the kernel, skipping the gather/scatter memcpy a
// contiguous payload would need (sendmsg/recvmsg keep MSG_NOSIGNAL /
// partial-transfer handling uniform with write_full/read_full)
// MB-scale embedding rows stream through these sockets: default ~208KB
// buffers force a scheduler round trip per fraction of a chunk, which on
// a small host dominates the wire cost. 4MB buffers let a whole pipeline
// chunk sit in flight.
inline void set_bulk_buffers(int fd) {
  int sz = 4 * 1024 * 1024;
  if (const char* env = std::getenv("PS_SOCKBUF")) sz = std::atoi(env);
  if (sz <= 0) return;  // PS_SOCKBUF=0: kernel defaults
  ::setsockopt(fd, SOL_SOCKET, SO_SNDBUF, &sz, sizeof(sz));
  ::setsockopt(fd, SOL_SOCKET, SO_RCVBUF, &sz, sizeof(sz));
}

inline bool writev_full(int fd, struct iovec* iov, int cnt) {
  while (cnt > 0) {
    struct msghdr mh {};
    mh.msg_iov = iov;
    mh.msg_iovlen = static_cast<size_t>(cnt);
    ssize_t w = ::sendmsg(fd, &mh, MSG_NOSIGNAL);
    if (w <= 0) {
      if (w < 0 && errno == EINTR) continue;
      return false;
    }
    while (w > 0 && cnt > 0) {
      if (static_cast<size_t>(w) >= iov->iov_len) {
        w -= static_cast<ssize_t>(iov->iov_len);
        ++iov;
        --cnt;
      } else {
        iov->iov_base = static_cast<char*>(iov->iov_base) + w;
        iov->iov_len -= static_cast<size_t>(w);
        w = 0;
      }
    }
  }
  return true;
}

inline bool readv_full(int fd, struct iovec* iov, int cnt) {
  while (cnt > 0) {
    struct msghdr mh {};
    mh.msg_iov = iov;
    mh.msg_iovlen = static_cast<size_t>(cnt);
    ssize_t r = ::recvmsg(fd, &mh, 0);
    if (r <= 0) {
      if (r < 0 && errno == EINTR) continue;
      return false;
    }
    while (r > 0 && cnt > 0) {
      if (static_cast<size_t>(r) >= iov->iov_len) {
        r -= static_cast<ssize_t>(iov->iov_len);
        ++iov;
        --cnt;
      } else {
        iov->iov_base = static_cast<char*>(iov->iov_base) + r;
        iov->iov_len -= static_cast<size_t>(r);
        r = 0;
      }
    }
  }
  return true;
}

inline int connect_to(const std::string& host, int port) {
  int fd = ::socket(AF_INET, SOCK_STREAM, 0);
  if (fd < 0) return -1;
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_port = htons(static_cast<uint16_t>(port));
  if (::inet_pton(AF_INET, host.c_str(), &addr.sin_addr) != 1) {
    ::close(fd);
    return -1;
  }
  if (::connect(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) != 0) {
    ::close(fd);
    return -1;
  }
  int one = 1;
  ::setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
  set_bulk_buffers(fd);
  return fd;
}

// "host:port,host:port,..." → endpoint list (shared by the PS client and
// the FleetExecutor MessageBus so the two transports cannot drift)
inline std::vector<std::pair<std::string, int>> parse_endpoints(
    const char* csv) {
  std::vector<std::pair<std::string, int>> peers;
  std::string s(csv);
  size_t pos = 0;
  while (pos < s.size()) {
    size_t comma = s.find(',', pos);
    if (comma == std::string::npos) comma = s.size();
    std::string ep = s.substr(pos, comma - pos);
    pos = comma + 1;
    size_t colon = ep.rfind(':');
    if (colon == std::string::npos) continue;
    peers.emplace_back(ep.substr(0, colon),
                       std::atoi(ep.c_str() + colon + 1));
  }
  return peers;
}

// key → owning server. Distinct finalizer from SparseTable::shard_of so
// server routing and in-server shard routing stay decorrelated.
inline int server_of(int64_t key, int n_servers) {
  uint64_t x = static_cast<uint64_t>(key) + 0x9E3779B97F4A7C15ULL;
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ULL;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBULL;
  x ^= x >> 31;
  return static_cast<int>(x % static_cast<uint64_t>(n_servers));
}

}  // namespace ps
