// Host control plane: a TCP rendezvous, then barrier, broadcast and
// allgather of small host-side byte payloads, for tpuframe_torch.core.native.
//
// The port's own copy of the hub-and-spoke half of the JAX package's host
// control plane (tpuframe/_native/controlplane.cpp); heartbeat.cpp is the
// other half.  The port builds and loads this file alone and never the JAX
// package's library.  The wire format is the JAX package's byte for byte,
// so a port spoke joins a JAX hub and the reverse.
//
// It carries the control values that must flow before or outside the
// process group (the run id, a host's name): torchrun's MASTER_ADDR
// rendezvous and the c10d barrier/broadcast/gather of small values.
//
// Topology: rank 0 is the hub (listens), ranks 1..n-1 connect.  All ops are
// hub-mediated; payloads are length-prefixed (u64 LE).  Every op carries an
// op tag so mismatched call sequences fail loudly instead of deadlocking.
//
// Build: g++ -O2 -shared -fPIC -std=c++17 controlplane.cpp -o libtfcp.so -lpthread

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

#include <cerrno>
#include <cstdint>
#include <cstdlib>
#include <vector>

namespace {

constexpr uint8_t OP_BARRIER = 1;
constexpr uint8_t OP_BROADCAST = 2;
constexpr uint8_t OP_ALLGATHER = 3;

// Hard ceiling on any frame: control payloads are capped at 1 MiB on the
// Python side; the allgather blob concatenates one payload per rank.  An
// attacker-supplied length beyond this is rejected before malloc.
constexpr uint64_t MAX_FRAME = 1ull << 30;

struct Plane {
  int world = 1;
  int rank = 0;
  int listen_fd = -1;
  std::vector<int> peers;  // hub: fd per rank (index 0 unused); spoke: [fd]
};

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

bool send_frame(int fd, uint8_t op, const uint8_t* buf, uint64_t n) {
  if (!send_all(fd, &op, 1)) return false;
  uint64_t len = n;  // LE assumed (x86/arm little-endian)
  if (!send_all(fd, &len, 8)) return false;
  return n == 0 || send_all(fd, buf, n);
}

// Receives into a malloc'd buffer (caller frees); checks the op tag and
// rejects frames beyond MAX_FRAME (no attacker-sized mallocs).
bool recv_frame(int fd, uint8_t expect_op, uint8_t** buf, uint64_t* n) {
  uint8_t op;
  if (!recv_all(fd, &op, 1) || op != expect_op) return false;
  uint64_t len;
  if (!recv_all(fd, &len, 8)) return false;
  if (len > MAX_FRAME) return false;
  uint8_t* p = (uint8_t*)malloc(len ? len : 1);
  if (!p) return false;
  if (len && !recv_all(fd, p, len)) {
    free(p);
    return false;
  }
  *buf = p;
  *n = len;
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

// Collective ops wait much longer than the rendezvous: ranks legitimately
// reach a barrier minutes apart (one rank checkpointing, say) and must not
// be failed by the rendezvous-scale timeout.
constexpr int OP_TIMEOUT_FACTOR = 10;

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

}  // namespace

extern "C" {

// Hub (rank 0): bind, accept world-1 connections.  Each spoke introduces
// itself with (rank u32, token u64); a token mismatch (stray/hostile
// connection) drops that connection and keeps accepting — rendezvous only
// fails when the timeout expires without all genuine spokes arriving.
// Returns handle or nullptr.
void* tfcp_hub_create(const char* bind_addr, int port, int world,
                      int timeout_ms, uint64_t token) {
  Plane* pl = new Plane;
  pl->world = world;
  pl->rank = 0;
  pl->peers.assign(world, -1);
  if (world == 1) return pl;

  int fd = socket(AF_INET, SOCK_STREAM, 0);
  if (fd < 0) goto fail;
  {
    int one = 1;
    setsockopt(fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
    sockaddr_in addr{};
    addr.sin_family = AF_INET;
    addr.sin_port = htons((uint16_t)port);
    addr.sin_addr.s_addr =
        bind_addr && *bind_addr ? inet_addr(bind_addr) : INADDR_ANY;
    if (bind(fd, (sockaddr*)&addr, sizeof(addr)) != 0) goto fail;
    if (listen(fd, world) != 0) goto fail;
    pl->listen_fd = fd;
    int joined = 0;
    // absolute rendezvous deadline: stray connections (port scanners,
    // health checks) must not re-arm the timeout
    const int64_t deadline = now_ms() + timeout_ms;
    while (joined < world - 1) {
      int64_t remaining = deadline - now_ms();
      if (remaining <= 0) goto fail;
      pollfd pfd{fd, POLLIN, 0};
      if (poll(&pfd, 1, (int)remaining) <= 0) goto fail;
      int cfd = accept(fd, nullptr, nullptr);
      if (cfd < 0) goto fail;
      set_nodelay(cfd);
      // short handshake window so a silent stray can't stall acceptance
      int hs = timeout_ms < 5000 ? timeout_ms : 5000;
      set_rcvtimeo(cfd, hs);
      uint32_t peer_rank;
      uint64_t peer_token;
      if (!recv_all(cfd, &peer_rank, 4) || !recv_all(cfd, &peer_token, 8) ||
          peer_token != token || peer_rank == 0 || (int)peer_rank >= world ||
          pl->peers[peer_rank] != -1) {
        close(cfd);  // stray or duplicate: reject, keep listening
        continue;
      }
      set_rcvtimeo(cfd, timeout_ms * OP_TIMEOUT_FACTOR);
      pl->peers[peer_rank] = cfd;
      ++joined;
    }
  }
  return pl;
fail:
  if (fd >= 0) close(fd);
  for (int p : pl->peers)
    if (p >= 0) close(p);
  delete pl;
  return nullptr;
}

// Spoke (rank > 0): connect to the hub, retrying until timeout.
void* tfcp_spoke_create(const char* hub_addr, int port, int rank, int world,
                        int timeout_ms, uint64_t token) {
  Plane* pl = new Plane;
  pl->world = world;
  pl->rank = rank;
  int waited = 0;
  for (;;) {
    int fd = socket(AF_INET, SOCK_STREAM, 0);
    if (fd < 0) break;
    sockaddr_in addr{};
    addr.sin_family = AF_INET;
    addr.sin_port = htons((uint16_t)port);
    if (!resolve_ipv4(hub_addr, &addr.sin_addr)) {
      close(fd);
      break;
    }
    if (connect(fd, (sockaddr*)&addr, sizeof(addr)) == 0) {
      set_nodelay(fd);
      set_rcvtimeo(fd, timeout_ms * OP_TIMEOUT_FACTOR);
      uint32_t r = (uint32_t)rank;
      if (send_all(fd, &r, 4) && send_all(fd, &token, 8)) {
        pl->peers.push_back(fd);
        return pl;
      }
      close(fd);
      break;
    }
    close(fd);
    if (waited >= timeout_ms) break;
    usleep(100 * 1000);  // 100ms between connect retries
    waited += 100;
  }
  delete pl;
  return nullptr;
}

// Barrier: spokes send an empty BARRIER frame; the hub replies once all
// have arrived.  Returns 0 on success.
int tfcp_barrier(void* h) {
  Plane* pl = (Plane*)h;
  if (pl->world == 1) return 0;
  if (pl->rank == 0) {
    for (int i = 1; i < pl->world; ++i) {
      uint8_t* b;
      uint64_t n;
      if (!recv_frame(pl->peers[i], OP_BARRIER, &b, &n)) return -1;
      free(b);
    }
    for (int i = 1; i < pl->world; ++i)
      if (!send_frame(pl->peers[i], OP_BARRIER, nullptr, 0)) return -1;
    return 0;
  }
  if (!send_frame(pl->peers[0], OP_BARRIER, nullptr, 0)) return -1;
  uint8_t* b;
  uint64_t n;
  if (!recv_frame(pl->peers[0], OP_BARRIER, &b, &n)) return -1;
  free(b);
  return 0;
}

// Broadcast from rank 0.  On rank 0, (buf, *size) is the payload; elsewhere
// buf is an output buffer of capacity cap and *size receives the length.
// Returns 0 on success, -2 if the receiver's buffer is too small.
int tfcp_broadcast(void* h, uint8_t* buf, uint64_t* size, uint64_t cap) {
  Plane* pl = (Plane*)h;
  if (pl->world == 1) return 0;
  if (pl->rank == 0) {
    for (int i = 1; i < pl->world; ++i)
      if (!send_frame(pl->peers[i], OP_BROADCAST, buf, *size)) return -1;
    return 0;
  }
  uint8_t* b;
  uint64_t n;
  if (!recv_frame(pl->peers[0], OP_BROADCAST, &b, &n)) return -1;
  if (n > cap) {
    free(b);
    return -2;
  }
  memcpy(buf, b, n);
  *size = n;
  free(b);
  return 0;
}

// Allgather of variable-size payloads.  Everyone sends (in, in_size); the
// hub concatenates in rank order and broadcasts sizes[world] + the blob.
// out must have capacity out_cap; sizes_out must hold world entries.
// Returns 0 on success, -2 if out_cap is too small.
int tfcp_allgather(void* h, const uint8_t* in, uint64_t in_size, uint8_t* out,
                   uint64_t out_cap, uint64_t* sizes_out) {
  Plane* pl = (Plane*)h;
  if (pl->world == 1) {
    if (in_size > out_cap) return -2;
    memcpy(out, in, in_size);
    sizes_out[0] = in_size;
    return 0;
  }
  if (pl->rank == 0) {
    std::vector<uint8_t*> bufs(pl->world, nullptr);
    std::vector<uint64_t> sizes(pl->world, 0);
    bufs[0] = (uint8_t*)in;
    sizes[0] = in_size;
    uint64_t total = in_size;
    for (int i = 1; i < pl->world; ++i) {
      if (!recv_frame(pl->peers[i], OP_ALLGATHER, &bufs[i], &sizes[i])) {
        for (int j = 1; j < i; ++j) free(bufs[j]);
        return -1;
      }
      total += sizes[i];
    }
    int rc = 0;
    if (total > out_cap) rc = -2;
    if (rc == 0) {
      uint64_t off = 0;
      for (int i = 0; i < pl->world; ++i) {
        memcpy(out + off, bufs[i], sizes[i]);
        off += sizes[i];
        sizes_out[i] = sizes[i];
      }
      // header frame: sizes vector; payload frame: concatenated blob
      for (int i = 1; i < pl->world; ++i) {
        if (!send_frame(pl->peers[i], OP_ALLGATHER,
                        (const uint8_t*)sizes_out, 8ull * pl->world) ||
            !send_frame(pl->peers[i], OP_ALLGATHER, out, total)) {
          rc = -1;
          break;
        }
      }
    }
    for (int j = 1; j < pl->world; ++j) free(bufs[j]);
    return rc;
  }
  if (!send_frame(pl->peers[0], OP_ALLGATHER, in, in_size)) return -1;
  uint8_t *sz_buf, *blob;
  uint64_t sz_len, blob_len;
  if (!recv_frame(pl->peers[0], OP_ALLGATHER, &sz_buf, &sz_len)) return -1;
  if (sz_len != 8ull * pl->world) {
    free(sz_buf);
    return -1;
  }
  if (!recv_frame(pl->peers[0], OP_ALLGATHER, &blob, &blob_len)) {
    free(sz_buf);
    return -1;
  }
  int rc = 0;
  if (blob_len > out_cap) {
    rc = -2;
  } else {
    memcpy(out, blob, blob_len);
    memcpy(sizes_out, sz_buf, sz_len);
  }
  free(sz_buf);
  free(blob);
  return rc;
}

void tfcp_destroy(void* h) {
  Plane* pl = (Plane*)h;
  if (!pl) return;
  for (int fd : pl->peers)
    if (fd >= 0) close(fd);
  if (pl->listen_fd >= 0) close(pl->listen_fd);
  delete pl;
}

}  // extern "C"
