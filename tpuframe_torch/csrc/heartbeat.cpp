// Heartbeat: a driver-side monitor and a worker-side beacon, for
// tpuframe_torch.launch.
//
// The port's own copy of the heartbeat half of the JAX package's host
// control plane (tpuframe/_native/controlplane.cpp): the port builds and
// loads this file alone and never the JAX package's library.  The
// collective half (barrier, broadcast, allgather) is not here: the port
// carries its small host values over the torch.distributed process group.
//
// The beacon is a background thread that sends one byte per interval over
// TCP; the monitor records a monotonic last-seen time per rank.  This
// detects worker process death, host death and network partition; it does
// not detect a wedged main thread (the beacon thread keeps ticking), which
// stays the run deadline's job.
//
// Build: g++ -O2 -shared -fPIC -std=c++17 heartbeat.cpp -o libtfhb.so -lpthread

#include <arpa/inet.h>
#include <netdb.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <poll.h>
#include <string.h>
#include <sys/socket.h>
#include <sys/time.h>
#include <time.h>
#include <unistd.h>

#include <atomic>
#include <cerrno>
#include <cstdint>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

bool send_all(int fd, const void* buf, size_t n) {
  const char* p = (const char*)buf;
  while (n) {
    ssize_t r = ::send(fd, p, n, MSG_NOSIGNAL);
    if (r <= 0) return false;
    p += r;
    n -= (size_t)r;
  }
  return true;
}

bool recv_all(int fd, void* buf, size_t n) {
  char* p = (char*)buf;
  while (n) {
    ssize_t r = ::recv(fd, p, n, 0);
    if (r <= 0) return false;
    p += r;
    n -= (size_t)r;
  }
  return true;
}

void set_nodelay(int fd) {
  int one = 1;
  setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
}

// Post-rendezvous receive timeout: a crashed peer makes ops fail instead
// of blocking forever (the pre-fix behavior left spokes hung in recv).
void set_rcvtimeo(int fd, int timeout_ms) {
  if (timeout_ms <= 0) return;
  timeval tv{};
  tv.tv_sec = timeout_ms / 1000;
  tv.tv_usec = (timeout_ms % 1000) * 1000;
  setsockopt(fd, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof(tv));
}

int64_t now_ms() {
  timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return (int64_t)ts.tv_sec * 1000 + ts.tv_nsec / 1000000;
}

// Hostname-or-dotted-quad resolver: inet_addr alone rejects DNS names,
// and launcher host lists are usually names (ssh targets, pod names).
bool resolve_ipv4(const char* host, in_addr* out) {
  in_addr_t a = inet_addr(host);
  if (a != INADDR_NONE) {
    out->s_addr = a;
    return true;
  }
  addrinfo hints{};
  hints.ai_family = AF_INET;
  hints.ai_socktype = SOCK_STREAM;
  addrinfo* res = nullptr;
  if (getaddrinfo(host, nullptr, &hints, &res) != 0 || !res) return false;
  *out = ((sockaddr_in*)res->ai_addr)->sin_addr;
  freeaddrinfo(res);
  return true;
}

struct HbMonitor {
  int world = 0;
  uint64_t token = 0;
  int listen_fd = -1;
  std::unique_ptr<std::atomic<int64_t>[]> last_seen;  // now_ms, or -1 never
  std::atomic<bool> stop{false};
  std::thread acceptor;
  std::mutex mu;  // guards conns/readers
  std::vector<int> conns;  // slot == -1: retired, reusable
  std::vector<std::pair<std::thread, size_t>> readers;  // (thread, conn slot)
};

void hb_reader(HbMonitor* m, int fd, int rank, size_t conn_idx) {
  // 1-second receive slices so stop is honored promptly
  set_rcvtimeo(fd, 1000);
  while (!m->stop.load()) {
    uint8_t byte;
    ssize_t r = ::recv(fd, &byte, 1, 0);
    if (r == 1) {
      m->last_seen[rank].store(now_ms());
    } else if (r == 0) {
      break;  // beacon closed (worker exited or reconnecting)
    } else if (errno != EAGAIN && errno != EWOULDBLOCK && errno != EINTR) {
      break;
    }
  }
  // close under the mutex AND retire the conns slot: reconnecting
  // beacons must not leak one fd per flap, and destroy()'s shutdown
  // pass must never touch a number the process has since reused.
  std::lock_guard<std::mutex> lock(m->mu);
  close(fd);
  m->conns[conn_idx] = -1;
}

void hb_acceptor(HbMonitor* m) {
  while (!m->stop.load()) {
    pollfd pfd{m->listen_fd, POLLIN, 0};
    int pr = poll(&pfd, 1, 200);
    if (pr <= 0) continue;
    int cfd = accept(m->listen_fd, nullptr, nullptr);
    if (cfd < 0) continue;
    set_nodelay(cfd);
    set_rcvtimeo(cfd, 2000);  // short handshake window for strays
    uint32_t rank;
    uint64_t token;
    if (!recv_all(cfd, &rank, 4) || !recv_all(cfd, &token, 8) ||
        token != m->token || (int)rank >= m->world) {
      close(cfd);
      continue;
    }
    m->last_seen[rank].store(now_ms());
    std::lock_guard<std::mutex> lock(m->mu);
    if (m->stop.load()) {  // destroy raced the accept
      close(cfd);
      return;
    }
    // reap finished readers + reuse their retired slot: a flapping
    // beacon reconnecting for days must not grow threads/slots unboundedly
    for (auto it = m->readers.begin(); it != m->readers.end();) {
      if (m->conns[it->second] == -1) {
        if (it->first.joinable()) it->first.join();  // already exited
        it = m->readers.erase(it);
      } else {
        ++it;
      }
    }
    size_t slot = m->conns.size();
    for (size_t i = 0; i < m->conns.size(); ++i)
      if (m->conns[i] == -1) {
        slot = i;
        break;
      }
    if (slot == m->conns.size())
      m->conns.push_back(cfd);
    else
      m->conns[slot] = cfd;
    m->readers.emplace_back(std::thread(hb_reader, m, cfd, (int)rank, slot),
                            slot);
  }
}

struct HbBeacon {
  std::atomic<bool> stop{false};
  std::thread t;
};

void hb_beat(HbBeacon* b, std::string addr, int port, int rank, uint64_t token,
             int interval_ms) {
  auto nap = [&](int ms) {  // sleep in slices so destroy() is prompt
    for (int done = 0; done < ms && !b->stop.load(); done += 50)
      usleep(50 * 1000);
  };
  while (!b->stop.load()) {
    int fd = socket(AF_INET, SOCK_STREAM, 0);
    if (fd < 0) {
      nap(500);
      continue;
    }
    sockaddr_in sa{};
    sa.sin_family = AF_INET;
    sa.sin_port = htons((uint16_t)port);
    if (!resolve_ipv4(addr.c_str(), &sa.sin_addr)) {
      close(fd);
      nap(2000);  // DNS may come up later; keep trying
      continue;
    }
    timeval tv{2, 0};
    setsockopt(fd, SOL_SOCKET, SO_SNDTIMEO, &tv, sizeof(tv));
    if (connect(fd, (sockaddr*)&sa, sizeof(sa)) != 0) {
      close(fd);
      nap(500);  // monitor not up yet / transient: retry forever
      continue;
    }
    set_nodelay(fd);
    uint32_t r = (uint32_t)rank;
    if (!send_all(fd, &r, 4) || !send_all(fd, &token, 8)) {
      close(fd);
      nap(500);
      continue;
    }
    while (!b->stop.load()) {
      uint8_t byte = 1;
      if (!send_all(fd, &byte, 1)) break;  // reconnect path
      nap(interval_ms);
    }
    close(fd);
  }
}

}  // namespace

extern "C" {

// Monitor (driver side): listens for beacon connections, tracks last-seen
// per rank.  Returns handle or nullptr.
void* tfhb_monitor_create(const char* bind_addr, int port, int world,
                          uint64_t token) {
  HbMonitor* m = new HbMonitor;
  m->world = world;
  m->token = token;
  m->last_seen.reset(new std::atomic<int64_t>[world]);
  for (int i = 0; i < world; ++i) m->last_seen[i].store(-1);
  int fd = socket(AF_INET, SOCK_STREAM, 0);
  if (fd < 0) {
    delete m;
    return nullptr;
  }
  int one = 1;
  setsockopt(fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_port = htons((uint16_t)port);
  addr.sin_addr.s_addr =
      bind_addr && *bind_addr ? inet_addr(bind_addr) : INADDR_ANY;
  if (bind(fd, (sockaddr*)&addr, sizeof(addr)) != 0 ||
      listen(fd, world > 0 ? world : 1) != 0) {
    close(fd);
    delete m;
    return nullptr;
  }
  m->listen_fd = fd;
  m->acceptor = std::thread(hb_acceptor, m);
  return m;
}

// Milliseconds since rank's last beacon; -1 if it never connected.
int64_t tfhb_last_seen_ms(void* h, int rank) {
  HbMonitor* m = (HbMonitor*)h;
  if (rank < 0 || rank >= m->world) return -1;
  int64_t t = m->last_seen[rank].load();
  if (t < 0) return -1;
  int64_t d = now_ms() - t;
  return d < 0 ? 0 : d;
}

void tfhb_monitor_destroy(void* h) {
  HbMonitor* m = (HbMonitor*)h;
  if (!m) return;
  m->stop.store(true);
  if (m->acceptor.joinable()) m->acceptor.join();
  {
    std::lock_guard<std::mutex> lock(m->mu);
    for (int fd : m->conns)
      if (fd >= 0) shutdown(fd, SHUT_RDWR);  // -1 = reader already retired it
  }
  for (auto& r : m->readers)
    if (r.first.joinable()) r.first.join();
  // every reader closed+retired its own slot on exit; nothing left to close
  if (m->listen_fd >= 0) close(m->listen_fd);
  delete m;
}

// Beacon (worker side): background thread, connects (retrying forever —
// the monitor may start later or restart) and ticks every interval_ms.
void* tfhb_beacon_create(const char* addr, int port, int rank, uint64_t token,
                         int interval_ms) {
  HbBeacon* b = new HbBeacon;
  b->t = std::thread(hb_beat, b, std::string(addr ? addr : "127.0.0.1"), port,
                     rank, token, interval_ms > 0 ? interval_ms : 1000);
  return b;
}

void tfhb_beacon_destroy(void* h) {
  HbBeacon* b = (HbBeacon*)h;
  if (!b) return;
  b->stop.store(true);
  if (b->t.joinable()) b->t.join();
  delete b;
}

}  // extern "C"
