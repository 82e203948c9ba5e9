// Native object store sidecar: a host-side TCP object transport (the port's
// own copy of chainermn_tpu/native/objstore.cc; the wire protocol is the
// same, so a client of either package talks to a server of the other).
//
// The byte-moving half of ChainerMN's pickle-over-MPI object path
// (chunked raw sends after a typed header), without MPI. One process (the
// store host, normally rank 0) runs a TCP server holding a key->bytes map;
// every process connects as a client. Frames carry raw bytes end to end
// with a CRC32 integrity check per frame; the sequencing and garbage
// collection of the object collectives live in Python
// (chainermn_torch/communicators/_object_comm.py, KVObjectComm).
//
// Protocol (all integers little-endian):
//   request:  [op:u8][klen:u32][key][vlen:u64][value][crc:u32]
//             crc = CRC32(key || value)
//   response: [status:u8][vlen:u64][value][crc:u32]
//   ops: 1=PUT  2=GET(blocking; vlen carries timeout_ms as the "value")
//        3=DEL_PREFIX  4=DIR(list keys with prefix, '\n'-joined)  5=PING
//   status: 0=ok 1=timeout 2=bad-frame
//
// Concurrency: thread-per-connection (obj traffic is low-rate control
// plane; simplicity beats epoll here). GET parks on a condition variable
// until the key exists — the blocking-get semantics the object comm's
// sequencing layer expects.

#include <arpa/inet.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sys/socket.h>
#include <unistd.h>

#include <cerrno>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <map>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

// ---- CRC32 (IEEE 802.3 polynomial, table-driven) -------------------------
uint32_t kCrcTable[256];
struct CrcInit {
  CrcInit() {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k) c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
      kCrcTable[i] = c;
    }
  }
} crc_init_once;

uint32_t Crc32(const uint8_t* data, size_t n, uint32_t crc = 0) {
  crc = ~crc;
  for (size_t i = 0; i < n; ++i)
    crc = kCrcTable[(crc ^ data[i]) & 0xFF] ^ (crc >> 8);
  return ~crc;
}

// ---- wire helpers --------------------------------------------------------
bool ReadN(int fd, void* buf, size_t n) {
  auto* p = static_cast<uint8_t*>(buf);
  while (n) {
    ssize_t r = ::recv(fd, p, n, 0);
    if (r <= 0) return false;
    p += r;
    n -= static_cast<size_t>(r);
  }
  return true;
}

bool WriteN(int fd, const void* buf, size_t n) {
  const auto* p = static_cast<const uint8_t*>(buf);
  while (n) {
    ssize_t r = ::send(fd, p, n, MSG_NOSIGNAL);
    if (r <= 0) return false;
    p += r;
    n -= static_cast<size_t>(r);
  }
  return true;
}

bool SendResponse(int fd, uint8_t status, const std::string& value) {
  uint64_t vlen = value.size();
  uint32_t crc = Crc32(reinterpret_cast<const uint8_t*>(value.data()),
                       value.size());
  std::vector<uint8_t> hdr(1 + 8);
  hdr[0] = status;
  std::memcpy(&hdr[1], &vlen, 8);
  if (!WriteN(fd, hdr.data(), hdr.size())) return false;
  if (!value.empty() && !WriteN(fd, value.data(), value.size())) return false;
  return WriteN(fd, &crc, 4);
}

// ---- store ---------------------------------------------------------------
struct Store {
  std::map<std::string, std::string> kv;
  std::mutex m;
  std::condition_variable cv;
  int listen_fd = -1;
  uint16_t port = 0;
  std::thread accept_thread;
  std::vector<std::thread> conns;
  std::vector<int> conn_fds;  // so shutdown can unblock recv()-parked threads
  bool shutting_down = false;
};

// The listener is unauthenticated; any stray connection (port scan, health
// probe speaking HTTP) gets parsed as a frame header. Cap lengths BEFORE
// allocating so garbage headers can't trigger multi-GB allocations, and
// treat anything over the cap as an unrecoverable framing error (the stream
// can't be resynced, so the connection is dropped).
constexpr uint32_t kMaxKeyLen = 1u << 16;        // 64 KiB
constexpr uint64_t kMaxValueLen = 1ull << 31;    // 2 GiB

void ServeConnLoop(Store* s, int fd) {
  for (;;) {
    uint8_t op;
    uint32_t klen;
    uint64_t vlen;
    if (!ReadN(fd, &op, 1) || !ReadN(fd, &klen, 4)) break;
    if (klen > kMaxKeyLen) break;
    std::string key(klen, '\0');
    if (klen && !ReadN(fd, key.data(), klen)) break;
    if (!ReadN(fd, &vlen, 8)) break;
    if (vlen > kMaxValueLen) break;
    std::string value(vlen, '\0');
    if (vlen && !ReadN(fd, value.data(), vlen)) break;
    uint32_t crc;
    if (!ReadN(fd, &crc, 4)) break;
    uint32_t want = Crc32(reinterpret_cast<const uint8_t*>(key.data()),
                          key.size());
    want = Crc32(reinterpret_cast<const uint8_t*>(value.data()), value.size(),
                 want);
    if (crc != want) {
      SendResponse(fd, 2, "");
      continue;
    }
    switch (op) {
      case 1: {  // PUT
        {
          std::lock_guard<std::mutex> lk(s->m);
          s->kv[key] = std::move(value);
        }
        s->cv.notify_all();
        if (!SendResponse(fd, 0, "")) goto done;
        break;
      }
      case 2: {  // GET (blocking; value field = decimal timeout_ms)
        long timeout_ms = 600000;
        if (!value.empty()) {
          // strtol, not stol: non-numeric input from a stray connection must
          // not throw. Garbage keeps the default timeout.
          char* end = nullptr;
          errno = 0;
          long parsed = ::strtol(value.c_str(), &end, 10);
          if (errno == 0 && end && *end == '\0' && parsed >= 0)
            timeout_ms = parsed;
        }
        std::unique_lock<std::mutex> lk(s->m);
        bool ok = s->cv.wait_for(
            lk, std::chrono::milliseconds(timeout_ms), [&] {
              return s->shutting_down || s->kv.count(key) > 0;
            });
        std::string out;
        uint8_t status = 1;
        if (ok && !s->shutting_down) {
          out = s->kv[key];
          status = 0;
        }
        lk.unlock();
        if (!SendResponse(fd, status, out)) goto done;
        break;
      }
      case 3: {  // DEL_PREFIX
        {
          std::lock_guard<std::mutex> lk(s->m);
          auto it = s->kv.lower_bound(key);
          while (it != s->kv.end() && it->first.compare(0, key.size(), key) == 0)
            it = s->kv.erase(it);
        }
        if (!SendResponse(fd, 0, "")) goto done;
        break;
      }
      case 4: {  // DIR
        std::string out;
        {
          std::lock_guard<std::mutex> lk(s->m);
          auto it = s->kv.lower_bound(key);
          for (; it != s->kv.end() &&
                 it->first.compare(0, key.size(), key) == 0;
               ++it) {
            out += it->first;
            out += '\n';
          }
        }
        if (!SendResponse(fd, 0, out)) goto done;
        break;
      }
      case 5: {  // PING
        if (!SendResponse(fd, 0, "pong")) goto done;
        break;
      }
      default:
        SendResponse(fd, 2, "");
    }
  }
done:
  return;
}

void ServeConn(Store* s, int fd) {
  int one = 1;
  ::setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
  // A throwing handler (bad_alloc on a huge-but-under-cap value, etc.) must
  // kill only this connection, never the store-host process — every rank's
  // blocking gets hang if the store dies.
  try {
    ServeConnLoop(s, fd);
  } catch (...) {
  }
  // Drop our fd from the shutdown list before closing it: the number can be
  // recycled by the OS, and objstore_server_stop must not shutdown() an
  // unrelated live socket (e.g. a torch.distributed connection).
  {
    std::lock_guard<std::mutex> lk(s->m);
    for (auto it = s->conn_fds.begin(); it != s->conn_fds.end(); ++it) {
      if (*it == fd) {
        s->conn_fds.erase(it);
        break;
      }
    }
  }
  ::close(fd);
}

}  // namespace

extern "C" {

// Start a server on `port` (0 = ephemeral). Returns handle, or 0 on error.
// `out_port` receives the bound port.
void* objstore_server_start(uint16_t port, uint16_t* out_port) {
  int fd = ::socket(AF_INET, SOCK_STREAM, 0);
  if (fd < 0) return nullptr;
  int one = 1;
  ::setsockopt(fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_addr.s_addr = htonl(INADDR_ANY);
  addr.sin_port = htons(port);
  if (::bind(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) != 0 ||
      ::listen(fd, 128) != 0) {
    ::close(fd);
    return nullptr;
  }
  socklen_t alen = sizeof(addr);
  ::getsockname(fd, reinterpret_cast<sockaddr*>(&addr), &alen);
  auto* s = new Store;
  s->listen_fd = fd;
  s->port = ntohs(addr.sin_port);
  if (out_port) *out_port = s->port;
  s->accept_thread = std::thread([s] {
    for (;;) {
      int cfd = ::accept(s->listen_fd, nullptr, nullptr);
      if (cfd < 0) break;  // listen_fd closed => shutdown
      std::lock_guard<std::mutex> lk(s->m);
      if (s->shutting_down) {
        ::close(cfd);
        break;
      }
      s->conn_fds.push_back(cfd);
      s->conns.emplace_back(ServeConn, s, cfd);
    }
  });
  return s;
}

void objstore_server_stop(void* handle) {
  auto* s = static_cast<Store*>(handle);
  if (!s) return;
  {
    std::lock_guard<std::mutex> lk(s->m);
    s->shutting_down = true;
    for (int fd : s->conn_fds) ::shutdown(fd, SHUT_RDWR);
  }
  s->cv.notify_all();
  ::shutdown(s->listen_fd, SHUT_RDWR);
  ::close(s->listen_fd);
  if (s->accept_thread.joinable()) s->accept_thread.join();
  for (auto& t : s->conns)
    if (t.joinable()) t.join();
  delete s;
}

// ---- client --------------------------------------------------------------

struct Client {
  int fd;
  std::mutex m;
};

void* objstore_client_connect(const char* host, uint16_t port) {
  int fd = ::socket(AF_INET, SOCK_STREAM, 0);
  if (fd < 0) return nullptr;
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_port = htons(port);
  if (::inet_pton(AF_INET, host, &addr.sin_addr) != 1) {
    ::close(fd);
    return nullptr;
  }
  if (::connect(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) != 0) {
    ::close(fd);
    return nullptr;
  }
  int one = 1;
  ::setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
  auto* c = new Client;
  c->fd = fd;
  return c;
}

namespace {
// Send one request and read the response. Returns status (<0 = transport
// error); on success *out/*out_len hold a malloc'd payload copy.
int Roundtrip(Client* c, uint8_t op, const char* key, uint32_t klen,
              const uint8_t* val, uint64_t vlen, uint8_t** out,
              uint64_t* out_len) {
  std::lock_guard<std::mutex> lk(c->m);
  uint32_t crc = Crc32(reinterpret_cast<const uint8_t*>(key), klen);
  crc = Crc32(val, vlen, crc);
  if (!WriteN(c->fd, &op, 1) || !WriteN(c->fd, &klen, 4) ||
      (klen && !WriteN(c->fd, key, klen)) || !WriteN(c->fd, &vlen, 8) ||
      (vlen && !WriteN(c->fd, val, vlen)) || !WriteN(c->fd, &crc, 4))
    return -1;
  uint8_t status;
  uint64_t rlen;
  if (!ReadN(c->fd, &status, 1) || !ReadN(c->fd, &rlen, 8)) return -1;
  uint8_t* buf = nullptr;
  if (rlen) {
    buf = static_cast<uint8_t*>(::malloc(rlen));
    if (!buf || !ReadN(c->fd, buf, rlen)) {
      ::free(buf);
      return -1;
    }
  }
  uint32_t rcrc;
  if (!ReadN(c->fd, &rcrc, 4)) {
    ::free(buf);
    return -1;
  }
  if (rcrc != Crc32(buf, rlen)) {
    ::free(buf);
    return -2;  // corrupted response
  }
  if (out) {
    *out = buf;
    *out_len = rlen;
  } else {
    ::free(buf);
  }
  return status;
}
}  // namespace

int objstore_put(void* handle, const char* key, uint32_t klen,
                 const uint8_t* val, uint64_t vlen) {
  return Roundtrip(static_cast<Client*>(handle), 1, key, klen, val, vlen,
                   nullptr, nullptr);
}

// Blocking get; on status 0, *out is malloc'd (caller frees via
// objstore_free) and *out_len set.
int objstore_get(void* handle, const char* key, uint32_t klen,
                 long timeout_ms, uint8_t** out, uint64_t* out_len) {
  std::string t = std::to_string(timeout_ms);
  return Roundtrip(static_cast<Client*>(handle), 2, key, klen,
                   reinterpret_cast<const uint8_t*>(t.data()), t.size(), out,
                   out_len);
}

int objstore_del_prefix(void* handle, const char* key, uint32_t klen) {
  return Roundtrip(static_cast<Client*>(handle), 3, key, klen, nullptr, 0,
                   nullptr, nullptr);
}

// '\n'-joined key list with the given prefix (malloc'd; caller frees).
int objstore_dir(void* handle, const char* key, uint32_t klen, uint8_t** out,
                 uint64_t* out_len) {
  return Roundtrip(static_cast<Client*>(handle), 4, key, klen, nullptr, 0,
                   out, out_len);
}

int objstore_ping(void* handle) {
  uint8_t* out = nullptr;
  uint64_t n = 0;
  int st = Roundtrip(static_cast<Client*>(handle), 5, "", 0, nullptr, 0, &out,
                     &n);
  ::free(out);
  return st;
}

void objstore_client_close(void* handle) {
  auto* c = static_cast<Client*>(handle);
  if (!c) return;
  ::close(c->fd);
  delete c;
}

void objstore_free(uint8_t* buf) { ::free(buf); }

uint32_t objstore_crc32(const uint8_t* data, uint64_t n) {
  return Crc32(data, n);
}

}  // extern "C"
