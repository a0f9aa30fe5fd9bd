// TCPStore: the control-plane KV store of the port's launcher and
// elastic layer (counterpart of paddle_tpu/core/native/tcp_store.cc,
// copied as it is: host C++ with no device code). The master listens;
// clients set / get / wait / add. Built with the host C++ compiler by
// paddle_tpu_torch/_build.py (`load_host`) at first use and bound with
// ctypes through its C ABI (paddle_tpu_torch/distributed/tcp_store.py).
//
// Protocol (binary, length-prefixed):
//   request : u8 op | u32 klen | key bytes | u32 vlen | val bytes
//   ops     : 1=SET  2=GET(wait, vlen=timeout_ms)  3=ADD(val=i64 delta)
//   reply   : u32 len | payload   (GET: value or len=0xFFFFFFFF on timeout;
//             ADD: 8-byte new value; SET: len=0)
#include <arpa/inet.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sys/socket.h>
#include <unistd.h>

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

struct Store {
  std::map<std::string, std::string> kv;
  std::map<std::string, int64_t> counters;
  std::mutex mu;
  std::condition_variable cv;
};

struct Server {
  int listen_fd = -1;
  int port = 0;
  Store store;
  std::thread accept_thread;
  std::mutex conn_mu;
  std::condition_variable conn_cv;
  std::vector<int> conn_fds;
  int active_handlers = 0;
  bool stopping = false;
};

bool read_full(int fd, void* buf, size_t n) {
  char* p = static_cast<char*>(buf);
  while (n > 0) {
    ssize_t r = ::recv(fd, p, n, 0);
    if (r <= 0) return false;
    p += r;
    n -= static_cast<size_t>(r);
  }
  return true;
}

bool write_full(int fd, const void* buf, size_t n) {
  const char* p = static_cast<const char*>(buf);
  while (n > 0) {
    ssize_t w = ::send(fd, p, n, 0);
    if (w <= 0) return false;
    p += w;
    n -= static_cast<size_t>(w);
  }
  return true;
}

constexpr uint32_t kMaxLen = 16u << 20;  // 16 MB: reject garbage frames

void serve_conn(Server* srv, int fd) {
  for (;;) {
    uint8_t op;
    uint32_t klen, vlen;
    if (!read_full(fd, &op, 1) || !read_full(fd, &klen, 4)) break;
    if (klen > kMaxLen) break;  // stray/hostile connection: drop it
    std::string key(klen, '\0');
    if (klen && !read_full(fd, key.data(), klen)) break;
    if (!read_full(fd, &vlen, 4)) break;
    if (vlen > kMaxLen) break;
    std::string val(vlen, '\0');
    if (vlen && !read_full(fd, val.data(), vlen)) break;

    if (op == 1) {  // SET
      {
        std::lock_guard<std::mutex> g(srv->store.mu);
        srv->store.kv[key] = val;
      }
      srv->store.cv.notify_all();
      uint32_t zero = 0;
      if (!write_full(fd, &zero, 4)) break;
    } else if (op == 2) {  // GET with wait; val carries timeout_ms as text
      long timeout_ms = 30000;
      if (!val.empty()) {
        errno = 0;
        char* endp = nullptr;
        long parsed = std::strtol(val.c_str(), &endp, 10);
        if (errno == 0 && endp && *endp == '\0') timeout_ms = parsed;
      }
      std::unique_lock<std::mutex> lk(srv->store.mu);
      bool ok = srv->store.cv.wait_for(
          lk, std::chrono::milliseconds(timeout_ms),
          [&] { return srv->stopping || srv->store.kv.count(key) > 0; });
      if (srv->stopping) ok = false;
      if (!ok) {
        lk.unlock();
        uint32_t miss = 0xFFFFFFFFu;
        if (!write_full(fd, &miss, 4)) break;
        continue;
      }
      std::string out = srv->store.kv[key];
      lk.unlock();
      uint32_t len = static_cast<uint32_t>(out.size());
      if (!write_full(fd, &len, 4)) break;
      if (len && !write_full(fd, out.data(), len)) break;
    } else if (op == 3) {  // ADD
      int64_t delta = 0;
      std::memcpy(&delta, val.data(), std::min(val.size(), sizeof(delta)));
      int64_t now;
      {
        std::lock_guard<std::mutex> g(srv->store.mu);
        now = (srv->store.counters[key] += delta);
        // publish the counter as a normal key too, so GET/wait sees it
        srv->store.kv[key].assign(reinterpret_cast<char*>(&now),
                                  sizeof(now));
      }
      srv->store.cv.notify_all();
      uint32_t len = 8;
      if (!write_full(fd, &len, 4) || !write_full(fd, &now, 8)) break;
    } else {
      break;
    }
  }
  ::close(fd);
}

}  // namespace

extern "C" {

// returns server handle (>0) or -errno; *out_port gets the bound port
void* ts_server_start(int port, int* out_port) {
  auto* srv = new Server();
  srv->listen_fd = ::socket(AF_INET, SOCK_STREAM, 0);
  if (srv->listen_fd < 0) {
    delete srv;
    return nullptr;
  }
  int one = 1;
  ::setsockopt(srv->listen_fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_addr.s_addr = htonl(INADDR_ANY);
  addr.sin_port = htons(static_cast<uint16_t>(port));
  if (::bind(srv->listen_fd, reinterpret_cast<sockaddr*>(&addr),
             sizeof(addr)) != 0 ||
      ::listen(srv->listen_fd, 128) != 0) {
    ::close(srv->listen_fd);
    delete srv;
    return nullptr;
  }
  socklen_t alen = sizeof(addr);
  ::getsockname(srv->listen_fd, reinterpret_cast<sockaddr*>(&addr), &alen);
  srv->port = ntohs(addr.sin_port);
  if (out_port) *out_port = srv->port;
  srv->accept_thread = std::thread([srv] {
    for (;;) {
      int fd = ::accept(srv->listen_fd, nullptr, nullptr);
      if (fd < 0) return;  // listen socket closed -> shut down
      {
        std::lock_guard<std::mutex> g(srv->conn_mu);
        if (srv->stopping) {
          ::close(fd);
          continue;
        }
        srv->conn_fds.push_back(fd);
        ++srv->active_handlers;
      }
      std::thread([srv, fd] {
        serve_conn(srv, fd);
        std::lock_guard<std::mutex> g(srv->conn_mu);
        --srv->active_handlers;
        srv->conn_cv.notify_all();
      }).detach();
    }
  });
  return srv;
}

void ts_server_stop(void* handle) {
  auto* srv = static_cast<Server*>(handle);
  if (!srv) return;
  {
    std::lock_guard<std::mutex> g(srv->conn_mu);
    srv->stopping = true;
    for (int fd : srv->conn_fds) ::shutdown(fd, SHUT_RDWR);
  }
  srv->store.cv.notify_all();  // wake any GET waiters so handlers exit
  ::shutdown(srv->listen_fd, SHUT_RDWR);
  ::close(srv->listen_fd);
  if (srv->accept_thread.joinable()) srv->accept_thread.join();
  {
    // wait for every detached handler to leave srv before freeing it
    std::unique_lock<std::mutex> lk(srv->conn_mu);
    srv->conn_cv.wait_for(lk, std::chrono::seconds(5),
                          [&] { return srv->active_handlers == 0; });
  }
  delete srv;
}

// client: one blocking connection; thread-compatible, not thread-shared
void* ts_client_connect(const char* host, int port, int timeout_ms) {
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_port = htons(static_cast<uint16_t>(port));
  if (::inet_pton(AF_INET, host, &addr.sin_addr) != 1) return nullptr;
  auto deadline = std::chrono::steady_clock::now() +
                  std::chrono::milliseconds(timeout_ms);
  // POSIX leaves a socket in an unspecified state after a failed connect();
  // a fresh fd per attempt is the only portable retry (the retry window
  // exists precisely for workers that start before the master is listening)
  int fd = -1;
  for (;;) {
    fd = ::socket(AF_INET, SOCK_STREAM, 0);
    if (fd < 0) return nullptr;
    if (::connect(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) == 0)
      break;
    ::close(fd);
    fd = -1;
    if (std::chrono::steady_clock::now() > deadline) return nullptr;
    std::this_thread::sleep_for(std::chrono::milliseconds(50));
  }
  int one = 1;
  ::setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
  return reinterpret_cast<void*>(static_cast<intptr_t>(fd + 1));
}

static int fd_of(void* h) {
  return static_cast<int>(reinterpret_cast<intptr_t>(h)) - 1;
}

static bool request(int fd, uint8_t op, const char* key, uint32_t klen,
                    const char* val, uint32_t vlen) {
  return write_full(fd, &op, 1) && write_full(fd, &klen, 4) &&
         (klen == 0 || write_full(fd, key, klen)) &&
         write_full(fd, &vlen, 4) && (vlen == 0 || write_full(fd, val, vlen));
}

int ts_set(void* h, const char* key, int klen, const char* val, int vlen) {
  int fd = fd_of(h);
  if (!request(fd, 1, key, klen, val, vlen)) return -1;
  uint32_t rep;
  return read_full(fd, &rep, 4) ? 0 : -1;
}

// returns value length, -1 on timeout, -2 on transport error; caller buffer
int ts_get(void* h, const char* key, int klen, char* buf, int buflen,
           int timeout_ms) {
  int fd = fd_of(h);
  // belt-and-braces: enforce the timeout client-side too (a dead master
  // never replies; SO_RCVTIMEO turns that into a transport error)
  timeval tv{};
  tv.tv_sec = (timeout_ms + 2000) / 1000;
  tv.tv_usec = ((timeout_ms + 2000) % 1000) * 1000;
  ::setsockopt(fd, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof(tv));
  std::string t = std::to_string(timeout_ms);
  if (!request(fd, 2, key, klen, t.data(), static_cast<uint32_t>(t.size())))
    return -2;
  uint32_t len;
  if (!read_full(fd, &len, 4)) return -2;
  if (len == 0xFFFFFFFFu) return -1;
  if (static_cast<int>(len) > buflen) {
    // drain to keep the connection usable, then report short buffer
    std::vector<char> sink(len);
    read_full(fd, sink.data(), len);
    return -3;
  }
  if (len && !read_full(fd, buf, len)) return -2;
  return static_cast<int>(len);
}

// returns 0 on success with *out = new counter value; -1 on transport error
int ts_add(void* h, const char* key, int klen, long long delta,
           long long* out) {
  int fd = fd_of(h);
  if (!request(fd, 3, key, klen, reinterpret_cast<char*>(&delta), 8))
    return -1;
  uint32_t len;
  int64_t val = 0;
  if (!read_full(fd, &len, 4) || len != 8 || !read_full(fd, &val, 8))
    return -1;
  if (out) *out = val;
  return 0;
}

void ts_client_close(void* h) { ::close(fd_of(h)); }

}  // extern "C"
