// graftrpc reactor: the native dispatch plane for the actor-call hot
// path (SURVEY §2.1 — the reference's equivalent component is the gRPC
// direct-call stack in src/ray/rpc/ + core_worker client pool; here a
// single epoll thread per process moves length-prefixed frames between
// co-located workers over unix sockets).
//
// Division of labor with the Python seam (core/_native/graftrpc.py):
// this file only MOVES frames — accept, reassemble split reads, coalesce
// writes, batch wakeups. It never interprets a frame body beyond the
// length prefix; opcodes and the header layout are defined here solely
// so the wire contract is lint-checkable against the Python constants
// (tools/lint/wire_schema.py, same discipline as the store sidecar).
//
// Wire format (little-endian):
//   frame  : u32 len | header | payload          (len = header + payload)
//   header : u8 op | u8 flags | u16 chan | u64 seq      (kFrameHeaderSize)
// Ops: 1 CALL (task batch)  2 REPLY  3 INTERN (spec template)
//      4 PING               5 GOAWAY
//
// Threading:
//   - one reactor thread owns epoll, all reads, and all epoll_ctl calls;
//   - senders (any thread; in practice the worker's io loop via ctypes,
//     which releases the GIL) append to a per-connection write buffer
//     under its mutex and try ONE immediate nonblocking write when the
//     buffer is empty — the common case completes entirely in the caller
//     thread with zero reactor involvement (write coalescing: whatever
//     queues behind a busy socket is flushed by the reactor in one burst
//     when EPOLLOUT fires);
//   - inbound frames land in a locked inbox; a pipe byte is written only
//     on the empty->nonempty transition (batched wakeups: a burst of
//     frames costs the event loop ONE reader callback, which drains the
//     whole inbox via rpc_core_drain).
//
// Lifetime: connections are closed only by the reactor (or by stop after
// the reactor has joined), always under the connection's write mutex, so
// a concurrent sender can never write into a recycled fd number.
// rpc_core_stop must not race rpc_core_send — the Python seam closes the
// endpoint only after its event loop stops dispatching.

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <memory>
#include <mutex>
#include <string>
#include <unordered_map>
#include <vector>

#include <errno.h>
#include <fcntl.h>
#include <pthread.h>
#include <sys/epoll.h>
#include <sys/socket.h>
#include <sys/un.h>
#include <unistd.h>

#include "prof_core.h"
#include "scope_core.h"

namespace {

#pragma pack(push, 1)
struct FrameHeader {  // 12 bytes on the wire, little-endian
  uint8_t op;
  uint8_t flags;
  uint16_t chan;
  uint64_t seq;
};
#pragma pack(pop)

constexpr int kFrameHeaderSize = 12;
static_assert(sizeof(FrameHeader) == kFrameHeaderSize, "header packing");

// Opcodes are interpreted by the Python seam; defined here so lint can
// cross-check the two tables (wire_schema pass).
[[maybe_unused]] constexpr uint8_t kOpCall = 1, kOpReply = 2, kOpIntern = 3,
                                   kOpPing = 4, kOpGoaway = 5;

constexpr uint32_t kMaxFrame = 64u << 20;  // sanity cap per frame
constexpr uint32_t kClosedLen = 0xFFFFFFFFu;  // drain record: conn closed

struct Conn {
  uint32_t id = 0;
  int fd = -1;                 // -1 once closed (under wmu)
  std::mutex wmu;              // guards fd validity, outbuf, epollout
  std::string outbuf;          // bytes the socket wouldn't take yet
  bool epollout = false;       // EPOLLOUT armed (reactor keeps in sync)
  std::atomic<bool> dead{false};
  // Read side: reactor-thread-only, no lock needed.
  std::string inbuf;
  size_t inoff = 0;
};

struct InRec {
  uint32_t conn;
  uint32_t len;       // kClosedLen => connection closed, no bytes
  std::string data;   // header + payload
};

enum CmdKind { kCmdAdd = 1, kCmdArmWrite = 2, kCmdClose = 3, kCmdStop = 4 };

struct Cmd {
  CmdKind kind;
  uint32_t conn;
};

struct Endpoint {
  int epfd = -1;
  int listen_fd = -1;
  int wake_r = -1, wake_w = -1;      // reactor wakeup (commands pending)
  int notify_r = -1, notify_w = -1;  // inbox nonempty signal to Python
  pthread_t reactor;
  bool reactor_started = false;

  std::mutex mu;  // conns map, inbox, cmds, next_id
  std::unordered_map<uint32_t, std::shared_ptr<Conn>> conns;
  std::deque<InRec> inbox;
  std::vector<Cmd> cmds;
  uint32_t next_id = 2;  // 0 = wake pipe, 1 = listen fd in epoll data
  std::atomic<bool> stopping{false};
};

void Notify(Endpoint* ep, InRec&& rec) {
  bool was_empty;
  {
    std::lock_guard<std::mutex> g(ep->mu);
    was_empty = ep->inbox.empty();
    ep->inbox.push_back(std::move(rec));
  }
  if (was_empty) {
    // graftscope: one wake record per empty->nonempty transition — the
    // recv-side wakeup-batching ratio falls straight out of
    // RpcRecv.calls / RpcWake.calls.
    scope_emit(kScopeRpcWake, 0, 0, 0, 0, 0, 0);
    char b = 1;
    (void)!::write(ep->notify_w, &b, 1);
  }
}

void Wake(Endpoint* ep) {
  char b = 1;
  (void)!::write(ep->wake_w, &b, 1);
}

std::shared_ptr<Conn> FindConn(Endpoint* ep, uint32_t id) {
  std::lock_guard<std::mutex> g(ep->mu);
  auto it = ep->conns.find(id);
  return it == ep->conns.end() ? nullptr : it->second;
}

// Reactor-side close: drop from epoll + map, close the fd under wmu so
// no sender can race the fd into a recycled descriptor, then (unless
// locally initiated) report the loss to Python as a close record.
void CloseConn(Endpoint* ep, const std::shared_ptr<Conn>& c, bool report) {
  {
    std::lock_guard<std::mutex> g(c->wmu);
    if (c->fd < 0) return;  // already closed
    // dead is only ever touched under wmu: relaxed, the mutex orders it.
    c->dead.store(true, std::memory_order_relaxed);
    ::epoll_ctl(ep->epfd, EPOLL_CTL_DEL, c->fd, nullptr);
    ::close(c->fd);
    c->fd = -1;
  }
  {
    std::lock_guard<std::mutex> g(ep->mu);
    ep->conns.erase(c->id);
  }
  if (report) Notify(ep, InRec{c->id, kClosedLen, std::string()});
}

// Flush as much of outbuf as the socket takes; returns false on a fatal
// write error. Caller holds wmu.
bool FlushLocked(Conn* c) {
  while (!c->outbuf.empty()) {
    ssize_t w = ::send(c->fd, c->outbuf.data(), c->outbuf.size(),
                       MSG_NOSIGNAL);
    if (w > 0) {
      c->outbuf.erase(0, (size_t)w);
      continue;
    }
    if (w < 0 && (errno == EAGAIN || errno == EWOULDBLOCK)) return true;
    return false;
  }
  return true;
}

void SetEpollOut(Endpoint* ep, Conn* c, bool on) {  // caller holds wmu
  if (c->epollout == on || c->fd < 0) return;
  epoll_event ev;
  std::memset(&ev, 0, sizeof(ev));
  ev.events = EPOLLIN | (on ? (uint32_t)EPOLLOUT : 0u);
  ev.data.u64 = c->id;
  if (::epoll_ctl(ep->epfd, EPOLL_CTL_MOD, c->fd, &ev) == 0) {
    c->epollout = on;
  }
}

void RegisterConn(Endpoint* ep, const std::shared_ptr<Conn>& c) {
  epoll_event ev;
  std::memset(&ev, 0, sizeof(ev));
  bool failed = false;
  {
    std::lock_guard<std::mutex> g(c->wmu);
    if (c->fd < 0) return;
    bool arm = !c->outbuf.empty();
    c->epollout = arm;
    ev.events = EPOLLIN | (arm ? (uint32_t)EPOLLOUT : 0u);
    ev.data.u64 = c->id;
    if (::epoll_ctl(ep->epfd, EPOLL_CTL_ADD, c->fd, &ev) != 0) {
      c->dead.store(true, std::memory_order_relaxed);  // under wmu
      ::close(c->fd);
      c->fd = -1;
      failed = true;
    }
  }
  if (failed) {
    std::lock_guard<std::mutex> g(ep->mu);
    ep->conns.erase(c->id);
  }
}

// Slice complete frames out of c->inbuf and deliver them to the inbox.
// Returns false if the peer sent a malformed length (connection dropped).
bool ExtractFrames(Endpoint* ep, Conn* c) {
  for (;;) {
    size_t avail = c->inbuf.size() - c->inoff;
    if (avail < 4) break;
    uint32_t len;
    std::memcpy(&len, c->inbuf.data() + c->inoff, 4);
    if (len < (uint32_t)kFrameHeaderSize || len > kMaxFrame) return false;
    if (avail < 4 + (size_t)len) break;
    InRec rec;
    rec.conn = c->id;
    rec.len = len;
    rec.data.assign(c->inbuf.data() + c->inoff + 4, len);
    if (scope_enabled()) {
      // Frame header leads the record data; peek it for the trace tag.
      FrameHeader h;
      std::memcpy(&h, rec.data.data(), sizeof(h));
      scope_emit(kScopeRpcRecv, h.op, h.chan, len, h.seq, 0, 0);
    }
    Notify(ep, std::move(rec));
    c->inoff += 4 + (size_t)len;
  }
  if (c->inoff == c->inbuf.size()) {
    c->inbuf.clear();
    c->inoff = 0;
  } else if (c->inoff > (1u << 20)) {  // keep the partial tail compact
    c->inbuf.erase(0, c->inoff);
    c->inoff = 0;
  }
  return true;
}

void HandleReadable(Endpoint* ep, const std::shared_ptr<Conn>& c) {
  char buf[65536];
  for (;;) {
    ssize_t r = ::read(c->fd, buf, sizeof(buf));
    if (r > 0) {
      c->inbuf.append(buf, (size_t)r);
      if (!ExtractFrames(ep, c.get())) {
        CloseConn(ep, c, /*report=*/true);
        return;
      }
      // Short read: the socket is likely drained; level-triggered epoll
      // re-reports if more arrived meanwhile.
      if ((size_t)r < sizeof(buf)) return;
      continue;
    }
    if (r < 0 && (errno == EAGAIN || errno == EWOULDBLOCK)) return;
    if (r < 0 && errno == EINTR) continue;
    CloseConn(ep, c, /*report=*/true);  // EOF or hard error
    return;
  }
}

void HandleWritable(Endpoint* ep, const std::shared_ptr<Conn>& c) {
  bool fatal = false;
  uint64_t t0 = scope_enabled() ? scope_now_ns() : 0;
  size_t flushed = 0;
  {
    std::lock_guard<std::mutex> g(c->wmu);
    if (c->fd < 0) return;
    size_t before = c->outbuf.size();
    if (!FlushLocked(c.get())) {
      fatal = true;
    } else if (c->outbuf.empty()) {
      SetEpollOut(ep, c.get(), false);
    }
    flushed = before - c->outbuf.size();
  }
  if (t0 != 0 && flushed > 0) {
    // Span-in-one record: seq_or_oid = start_ns, t_ns = end_ns.
    uint64_t t1 = scope_now_ns();
    scope_emit(kScopeRpcFlush, 0, 0, (uint32_t)flushed, t0, t1, t1 - t0);
  }
  if (fatal) CloseConn(ep, c, /*report=*/true);
}

void HandleAccept(Endpoint* ep) {
  for (;;) {
    int fd = ::accept(ep->listen_fd, nullptr, nullptr);
    if (fd < 0) return;
    ::fcntl(fd, F_SETFL, O_NONBLOCK);
    auto c = std::make_shared<Conn>();
    c->fd = fd;
    {
      std::lock_guard<std::mutex> g(ep->mu);
      c->id = ep->next_id++;
      ep->conns[c->id] = c;
    }
    RegisterConn(ep, c);
  }
}

bool HandleCommands(Endpoint* ep) {  // returns false on stop
  char scratch[64];
  while (::read(ep->wake_r, scratch, sizeof(scratch)) > 0) {
  }
  std::vector<Cmd> cmds;
  {
    std::lock_guard<std::mutex> g(ep->mu);
    cmds.swap(ep->cmds);
  }
  for (const Cmd& cmd : cmds) {
    if (cmd.kind == kCmdStop) return false;
    auto c = FindConn(ep, cmd.conn);
    if (c == nullptr) continue;
    if (cmd.kind == kCmdAdd) {
      RegisterConn(ep, c);
    } else if (cmd.kind == kCmdArmWrite) {
      std::lock_guard<std::mutex> g(c->wmu);
      if (c->fd >= 0 && !c->outbuf.empty()) SetEpollOut(ep, c.get(), true);
    } else if (cmd.kind == kCmdClose) {
      CloseConn(ep, c, /*report=*/false);
    }
  }
  return true;
}

void* ReactorLoop(void* argp) {
  auto* ep = static_cast<Endpoint*>(argp);
  prof_register_thread("graftrpc-reactor");
  epoll_event evs[64];
  for (;;) {
    int n = ::epoll_wait(ep->epfd, evs, 64, -1);
    if (n < 0) {
      if (errno == EINTR) continue;
      return nullptr;
    }
    for (int i = 0; i < n; i++) {
      uint64_t tag = evs[i].data.u64;
      if (tag == 0) {
        if (!HandleCommands(ep)) return nullptr;
        continue;
      }
      if (tag == 1) {
        HandleAccept(ep);
        continue;
      }
      auto c = FindConn(ep, (uint32_t)tag);
      if (c == nullptr) continue;
      if (evs[i].events & (EPOLLHUP | EPOLLERR)) {
        // Drain any final bytes first, then report the close.
        HandleReadable(ep, c);
        CloseConn(ep, c, /*report=*/true);
        continue;
      }
      if (evs[i].events & EPOLLOUT) HandleWritable(ep, c);
      if (evs[i].events & EPOLLIN) HandleReadable(ep, c);
    }
  }
}

int MakePipe(int* r, int* w, bool nonblock_read) {
  int fds[2];
  if (::pipe(fds) != 0) return -1;
  if (nonblock_read) ::fcntl(fds[0], F_SETFL, O_NONBLOCK);
  *r = fds[0];
  *w = fds[1];
  return 0;
}

}  // namespace

extern "C" {

// Starts an endpoint: reactor thread + optional listening socket
// (listen_path may be NULL for a connect-only endpoint). Returns the
// endpoint handle or NULL; *notify_fd_out receives the inbox-signal
// pipe's read end (register with the event loop, then rpc_core_drain).
void* rpc_core_start(const char* listen_path, int* notify_fd_out) {
  auto* ep = new Endpoint();
  if (MakePipe(&ep->wake_r, &ep->wake_w, true) != 0) {
    delete ep;
    return nullptr;
  }
  if (MakePipe(&ep->notify_r, &ep->notify_w, true) != 0) {
    ::close(ep->wake_r);
    ::close(ep->wake_w);
    delete ep;
    return nullptr;
  }
  ep->epfd = ::epoll_create1(0);
  if (ep->epfd < 0) {
    ::close(ep->wake_r);
    ::close(ep->wake_w);
    ::close(ep->notify_r);
    ::close(ep->notify_w);
    delete ep;
    return nullptr;
  }
  epoll_event ev;
  std::memset(&ev, 0, sizeof(ev));
  ev.events = EPOLLIN;
  ev.data.u64 = 0;
  ::epoll_ctl(ep->epfd, EPOLL_CTL_ADD, ep->wake_r, &ev);
  if (listen_path != nullptr && listen_path[0] != 0) {
    ep->listen_fd = ::socket(AF_UNIX, SOCK_STREAM, 0);
    sockaddr_un addr;
    std::memset(&addr, 0, sizeof(addr));
    addr.sun_family = AF_UNIX;
    std::snprintf(addr.sun_path, sizeof(addr.sun_path), "%s", listen_path);
    ::unlink(listen_path);
    if (::bind(ep->listen_fd, (sockaddr*)&addr, sizeof(addr)) != 0 ||
        ::listen(ep->listen_fd, 128) != 0) {
      ::close(ep->listen_fd);
      ::close(ep->epfd);
      ::close(ep->wake_r);
      ::close(ep->wake_w);
      ::close(ep->notify_r);
      ::close(ep->notify_w);
      delete ep;
      return nullptr;
    }
    ::fcntl(ep->listen_fd, F_SETFL, O_NONBLOCK);
    std::memset(&ev, 0, sizeof(ev));
    ev.events = EPOLLIN;
    ev.data.u64 = 1;
    ::epoll_ctl(ep->epfd, EPOLL_CTL_ADD, ep->listen_fd, &ev);
  }
  if (pthread_create(&ep->reactor, nullptr, ReactorLoop, ep) != 0) {
    if (ep->listen_fd >= 0) ::close(ep->listen_fd);
    ::close(ep->epfd);
    ::close(ep->wake_r);
    ::close(ep->wake_w);
    ::close(ep->notify_r);
    ::close(ep->notify_w);
    delete ep;
    return nullptr;
  }
  ep->reactor_started = true;
  *notify_fd_out = ep->notify_r;
  return ep;
}

// Connect to a peer endpoint's listening socket. Returns the connection
// id (> 1) or -1. Callable from any thread.
int rpc_core_connect(void* handle, const char* path) {
  auto* ep = static_cast<Endpoint*>(handle);
  int fd = ::socket(AF_UNIX, SOCK_STREAM, 0);
  if (fd < 0) return -1;
  sockaddr_un addr;
  std::memset(&addr, 0, sizeof(addr));
  addr.sun_family = AF_UNIX;
  std::snprintf(addr.sun_path, sizeof(addr.sun_path), "%s", path);
  if (::connect(fd, (sockaddr*)&addr, sizeof(addr)) != 0) {
    ::close(fd);
    return -1;
  }
  ::fcntl(fd, F_SETFL, O_NONBLOCK);
  auto c = std::make_shared<Conn>();
  c->fd = fd;
  uint32_t id;
  {
    std::lock_guard<std::mutex> g(ep->mu);
    id = ep->next_id++;
    c->id = id;
    ep->conns[id] = c;
    ep->cmds.push_back(Cmd{kCmdAdd, id});
  }
  Wake(ep);
  return (int)id;
}

// Send one frame (data = header + payload; the u32 length prefix is
// added here). Appends to the connection's write buffer and attempts an
// immediate nonblocking flush when nothing was queued; bytes the socket
// won't take are flushed by the reactor on EPOLLOUT. Returns 0, or -1
// if the connection is unknown/closed or the write failed fatally.
int rpc_core_send(void* handle, uint32_t conn, const char* data,
                  uint32_t len) {
  auto* ep = static_cast<Endpoint*>(handle);
  if (len < (uint32_t)kFrameHeaderSize || len > kMaxFrame) return -1;
  auto c = FindConn(ep, conn);
  if (c == nullptr) return -1;
  if (scope_enabled()) {
    // Peek the header only — this plane never interprets payloads. The
    // chan field carries the submitter's trace tag (graftscope.py).
    FrameHeader h;
    std::memcpy(&h, data, sizeof(h));
    scope_emit(kScopeRpcSend, h.op, h.chan, len, h.seq, 0, 0);
  }
  bool need_arm = false;
  {
    std::lock_guard<std::mutex> g(c->wmu);
    if (c->fd < 0 || c->dead.load(std::memory_order_relaxed)) return -1;
    bool was_idle = c->outbuf.empty();
    char prefix[4];
    std::memcpy(prefix, &len, 4);
    if (was_idle) {
      // Fast path: write prefix+frame straight from the caller thread.
      iovec iov[2] = {{prefix, 4}, {(void*)data, len}};
      msghdr msg;
      std::memset(&msg, 0, sizeof(msg));
      msg.msg_iov = iov;
      msg.msg_iovlen = 2;
      ssize_t w = ::sendmsg(c->fd, &msg, MSG_NOSIGNAL);
      if (w < 0 && errno != EAGAIN && errno != EWOULDBLOCK) {
        c->dead.store(true, std::memory_order_relaxed);  // under wmu
        return -1;
      }
      size_t wrote = w > 0 ? (size_t)w : 0;
      if (wrote >= 4 + (size_t)len) return 0;  // fully sent, no wakeup
      if (wrote < 4) c->outbuf.append(prefix + wrote, 4 - wrote);
      size_t body_off = wrote > 4 ? wrote - 4 : 0;
      c->outbuf.append(data + body_off, len - body_off);
      need_arm = !c->epollout;
    } else {
      c->outbuf.append(prefix, 4);
      c->outbuf.append(data, len);
      need_arm = !c->epollout;
    }
  }
  if (need_arm) {
    {
      std::lock_guard<std::mutex> g(ep->mu);
      ep->cmds.push_back(Cmd{kCmdArmWrite, conn});
    }
    Wake(ep);
  }
  return 0;
}

// Drain inbox records into buf:
//   u32 conn | u32 len | len bytes (header + payload)
// len == 0xFFFFFFFF marks a closed connection (no bytes follow).
// Returns bytes written; if the FIRST pending record exceeds cap,
// returns -(required capacity) so the caller can grow its buffer.
// Also consumes the notify-pipe signal.
int rpc_core_drain(void* handle, char* buf, int cap) {
  auto* ep = static_cast<Endpoint*>(handle);
  char scratch[64];
  while (::read(ep->notify_r, scratch, sizeof(scratch)) > 0) {
  }
  std::lock_guard<std::mutex> g(ep->mu);
  int n = 0;
  while (!ep->inbox.empty()) {
    InRec& rec = ep->inbox.front();
    int need = 8 + (rec.len == kClosedLen ? 0 : (int)rec.data.size());
    if (n + need > cap) {
      if (n == 0) return -need;
      break;
    }
    std::memcpy(buf + n, &rec.conn, 4);
    std::memcpy(buf + n + 4, &rec.len, 4);
    if (rec.len != kClosedLen) {
      std::memcpy(buf + n + 8, rec.data.data(), rec.data.size());
    }
    n += need;
    ep->inbox.pop_front();
  }
  return n;
}

// Request a local close of a connection (no close record is delivered —
// the caller initiated it).
void rpc_core_close_conn(void* handle, uint32_t conn) {
  auto* ep = static_cast<Endpoint*>(handle);
  {
    std::lock_guard<std::mutex> g(ep->mu);
    ep->cmds.push_back(Cmd{kCmdClose, conn});
  }
  Wake(ep);
}

// Stop the reactor and free everything. Must not race rpc_core_send.
void rpc_core_stop(void* handle) {
  auto* ep = static_cast<Endpoint*>(handle);
  // No reader pairs with this: stop is actually signaled via kCmdStop +
  // pthread_join below. Relaxed keeps the vestigial flag honest.
  ep->stopping.store(true, std::memory_order_relaxed);
  {
    std::lock_guard<std::mutex> g(ep->mu);
    ep->cmds.push_back(Cmd{kCmdStop, 0});
  }
  Wake(ep);
  if (ep->reactor_started) pthread_join(ep->reactor, nullptr);
  std::vector<std::shared_ptr<Conn>> conns;
  {
    std::lock_guard<std::mutex> g(ep->mu);
    for (auto& kv : ep->conns) conns.push_back(kv.second);
    ep->conns.clear();
  }
  for (auto& c : conns) {
    std::lock_guard<std::mutex> g(c->wmu);
    if (c->fd >= 0) {
      ::close(c->fd);
      c->fd = -1;
    }
    c->dead.store(true, std::memory_order_relaxed);  // under wmu
  }
  if (ep->listen_fd >= 0) ::close(ep->listen_fd);
  ::close(ep->epfd);
  ::close(ep->wake_r);
  ::close(ep->wake_w);
  ::close(ep->notify_r);
  ::close(ep->notify_w);
  delete ep;
}

}  // extern "C"
