// Native unit tests for the graftrpc reactor (rpc_core.cc). Same
// no-framework style as object_store_test.cc: plain asserts, built and
// run by `make rpc-test` (and under TSAN/ASAN in CI). Exercises the
// frame plane end to end: round-trips (small and multi-megabyte),
// byte-at-a-time split reads, concurrent bursts from several client
// threads with echo replies, write backpressure through the EPOLLOUT
// path, and peer-crash close records.

#undef NDEBUG
#include <cassert>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <atomic>
#include <string>
#include <thread>
#include <vector>

#include <poll.h>
#include <sys/socket.h>
#include <sys/un.h>
#include <unistd.h>

extern "C" {
void* rpc_core_start(const char* listen_path, int* notify_fd_out);
int rpc_core_connect(void* handle, const char* path);
int rpc_core_send(void* handle, uint32_t conn, const char* data,
                  uint32_t len);
int rpc_core_drain(void* handle, char* buf, int cap);
void rpc_core_close_conn(void* handle, uint32_t conn);
void rpc_core_stop(void* handle);
}

namespace {

constexpr int kHdr = 12;  // u8 op | u8 flags | u16 chan | u64 seq
constexpr uint32_t kClosed = 0xFFFFFFFFu;

std::string Frame(uint8_t op, uint64_t seq, const std::string& payload) {
  std::string f(kHdr, '\0');
  f[0] = (char)op;
  uint16_t chan = 0;
  std::memcpy(&f[2], &chan, 2);
  std::memcpy(&f[4], &seq, 8);
  f += payload;
  return f;
}

struct Rec {
  uint32_t conn;
  uint32_t len;  // kClosed => close record
  std::string data;
};

// Drain every pending record (grows the buffer when a record exceeds it).
void DrainInto(void* ep, std::vector<Rec>* out) {
  static thread_local std::vector<char> buf(1 << 16);
  for (;;) {
    int n = rpc_core_drain(ep, buf.data(), (int)buf.size());
    if (n < 0) {
      buf.resize((size_t)(-n));
      continue;
    }
    int off = 0;
    while (off < n) {
      Rec r;
      std::memcpy(&r.conn, buf.data() + off, 4);
      std::memcpy(&r.len, buf.data() + off + 4, 4);
      off += 8;
      if (r.len != kClosed) {
        r.data.assign(buf.data() + off, r.len);
        off += (int)r.len;
      }
      out->push_back(std::move(r));
    }
    return;
  }
}

// Wait (poll on the notify fd, then drain) until `want` records arrived.
void WaitRecords(void* ep, int notify_fd, size_t want, std::vector<Rec>* out,
                 int timeout_ms = 10000) {
  int waited = 0;
  while (out->size() < want) {
    DrainInto(ep, out);
    if (out->size() >= want) break;
    pollfd p{notify_fd, POLLIN, 0};
    int rc = ::poll(&p, 1, 50);
    if (rc == 0) {
      waited += 50;
      assert(waited < timeout_ms && "timed out waiting for records");
    }
  }
}

// The suites' sockets go under $TMPDIR (else /tmp), and under /tmp when
// $TMPDIR is too long for a unix socket's path.
std::string TmpBase() {
  const char* t = std::getenv("TMPDIR");
  return (t != nullptr && *t != '\0') ? std::string(t) : std::string("/tmp");
}

std::string SockPath(const char* name) {
  std::string leaf = std::string("/raytpu_torch_rpc_test_") + name + "_" +
                     std::to_string(::getpid()) + ".sock";
  std::string path = TmpBase() + leaf;
  return path.size() < 100 ? path : "/tmp" + leaf;
}

void TestRoundTripAndEcho() {
  std::string sock = SockPath("echo");
  int srv_fd = -1, cli_fd = -1;
  void* srv = rpc_core_start(sock.c_str(), &srv_fd);
  assert(srv != nullptr);
  void* cli = rpc_core_start(nullptr, &cli_fd);  // connect-only endpoint
  assert(cli != nullptr);
  int conn = rpc_core_connect(cli, sock.c_str());
  assert(conn > 1);

  std::string f = Frame(1, 7, "ping-payload");
  assert(rpc_core_send(cli, (uint32_t)conn, f.data(), (uint32_t)f.size()) ==
         0);
  std::vector<Rec> got;
  WaitRecords(srv, srv_fd, 1, &got);
  assert(got[0].len == f.size() && got[0].data == f);
  assert(got[0].data[0] == 1);  // op
  uint64_t seq;
  std::memcpy(&seq, got[0].data.data() + 4, 8);
  assert(seq == 7);

  // Echo a reply on the server-side connection id.
  std::string reply = Frame(2, 7, "pong");
  assert(rpc_core_send(srv, got[0].conn, reply.data(),
                       (uint32_t)reply.size()) == 0);
  std::vector<Rec> back;
  WaitRecords(cli, cli_fd, 1, &back);
  assert(back[0].data == reply && back[0].conn == (uint32_t)conn);

  // Undersized (sub-header) and oversized frames are rejected up front.
  assert(rpc_core_send(cli, (uint32_t)conn, f.data(), 4) == -1);
  assert(rpc_core_send(cli, (uint32_t)conn, f.data(), (65u << 20)) == -1);

  rpc_core_stop(cli);
  rpc_core_stop(srv);
  ::unlink(sock.c_str());
  std::printf("  round-trip/echo OK\n");
}

void TestLargeFramesAndBackpressure() {
  // 24 x 1MiB frames back to back: far beyond any socket buffer, so the
  // sender's immediate-write fast path must hand leftovers to the
  // reactor's EPOLLOUT flush, and the receiver must reassemble frames
  // that arrive split across many reads.
  std::string sock = SockPath("large");
  int srv_fd = -1, cli_fd = -1;
  void* srv = rpc_core_start(sock.c_str(), &srv_fd);
  void* cli = rpc_core_start(nullptr, &cli_fd);
  assert(srv && cli);
  int conn = rpc_core_connect(cli, sock.c_str());
  assert(conn > 1);
  const int kFrames = 24;
  for (int i = 0; i < kFrames; i++) {
    std::string payload(1 << 20, (char)('a' + i));
    std::string f = Frame(1, (uint64_t)i, payload);
    assert(rpc_core_send(cli, (uint32_t)conn, f.data(),
                         (uint32_t)f.size()) == 0);
  }
  std::vector<Rec> got;
  WaitRecords(srv, srv_fd, kFrames, &got, 30000);
  assert(got.size() == (size_t)kFrames);
  for (int i = 0; i < kFrames; i++) {  // in order, intact
    uint64_t seq;
    std::memcpy(&seq, got[i].data.data() + 4, 8);
    assert(seq == (uint64_t)i);
    assert(got[i].data.size() == (size_t)kHdr + (1 << 20));
    assert(got[i].data[kHdr] == (char)('a' + i));
    assert(got[i].data.back() == (char)('a' + i));
  }
  rpc_core_stop(cli);
  rpc_core_stop(srv);
  ::unlink(sock.c_str());
  std::printf("  large/backpressure OK\n");
}

void TestSplitReads() {
  // A raw socket dribbling one frame a few bytes at a time: the reactor
  // must buffer partial prefixes/headers/payloads across reads.
  std::string sock = SockPath("split");
  int srv_fd = -1;
  void* srv = rpc_core_start(sock.c_str(), &srv_fd);
  assert(srv != nullptr);
  int fd = ::socket(AF_UNIX, SOCK_STREAM, 0);
  sockaddr_un addr;
  std::memset(&addr, 0, sizeof(addr));
  addr.sun_family = AF_UNIX;
  std::snprintf(addr.sun_path, sizeof(addr.sun_path), "%s", sock.c_str());
  assert(::connect(fd, (sockaddr*)&addr, sizeof(addr)) == 0);

  std::string f = Frame(3, 42, std::string(1000, 'z'));
  uint32_t len = (uint32_t)f.size();
  std::string wire(4, '\0');
  std::memcpy(&wire[0], &len, 4);
  wire += f;
  for (size_t off = 0; off < wire.size(); off += 3) {
    size_t n = std::min<size_t>(3, wire.size() - off);
    assert(::write(fd, wire.data() + off, n) == (ssize_t)n);
    if (off % 300 == 0) ::usleep(1000);
  }
  std::vector<Rec> got;
  WaitRecords(srv, srv_fd, 1, &got);
  assert(got[0].data == f);

  // A malformed length prefix (> 64MiB cap) drops the connection.
  uint32_t evil = 0x7FFFFFFFu;
  assert(::write(fd, &evil, 4) == 4);
  std::vector<Rec> closed;
  WaitRecords(srv, srv_fd, 1, &closed);
  assert(closed[0].len == kClosed && closed[0].conn == got[0].conn);
  ::close(fd);
  rpc_core_stop(srv);
  ::unlink(sock.c_str());
  std::printf("  split-reads OK\n");
}

void TestConcurrentClientsWithEchoes() {
  // 4 client endpoints (one per thread) x 200 frames each, with a server
  // thread echoing every frame back. Verifies per-connection ordering,
  // payload integrity, and that the locked inbox + command queue hold up
  // under concurrency (the TSAN target's main course).
  std::string sock = SockPath("burst");
  int srv_fd = -1;
  void* srv = rpc_core_start(sock.c_str(), &srv_fd);
  assert(srv != nullptr);
  std::atomic<bool> stop_echo{false};
  std::atomic<int> echoed{0};
  const int kThreads = 4, kEach = 200;
  std::thread echo([&] {
    std::vector<Rec> got;
    while (!stop_echo.load()) {
      got.clear();
      DrainInto(srv, &got);
      if (got.empty()) {
        pollfd p{srv_fd, POLLIN, 0};
        ::poll(&p, 1, 20);
        continue;
      }
      for (const Rec& r : got) {
        if (r.len == kClosed) continue;
        assert(rpc_core_send(srv, r.conn, r.data.data(),
                             (uint32_t)r.data.size()) == 0);
        echoed.fetch_add(1);
      }
    }
  });
  auto client = [&](int t) {
    int fd = -1;
    void* cli = rpc_core_start(nullptr, &fd);
    assert(cli != nullptr);
    int conn = rpc_core_connect(cli, sock.c_str());
    assert(conn > 1);
    std::vector<Rec> replies;
    for (int i = 0; i < kEach; i++) {
      std::string payload(64 + (i % 512), (char)('A' + t));
      std::string f = Frame(1, (uint64_t)i, payload);
      assert(rpc_core_send(cli, (uint32_t)conn, f.data(),
                           (uint32_t)f.size()) == 0);
    }
    WaitRecords(cli, fd, kEach, &replies, 30000);
    assert(replies.size() == (size_t)kEach);
    for (int i = 0; i < kEach; i++) {  // echoes return in send order
      uint64_t seq;
      std::memcpy(&seq, replies[i].data.data() + 4, 8);
      assert(seq == (uint64_t)i);
      assert(replies[i].data.size() == (size_t)kHdr + 64 + (i % 512));
      assert(replies[i].data[kHdr] == (char)('A' + t));
    }
    rpc_core_stop(cli);
  };
  std::vector<std::thread> ts;
  for (int t = 0; t < kThreads; t++) ts.emplace_back(client, t);
  for (auto& th : ts) th.join();
  assert(echoed.load() == kThreads * kEach);
  stop_echo.store(true);
  echo.join();
  rpc_core_stop(srv);
  ::unlink(sock.c_str());
  std::printf("  concurrent-bursts OK\n");
}

void TestPeerCrashDeliversClose() {
  std::string sock = SockPath("crash");
  int srv_fd = -1, cli_fd = -1;
  void* srv = rpc_core_start(sock.c_str(), &srv_fd);
  void* cli = rpc_core_start(nullptr, &cli_fd);
  assert(srv && cli);
  int conn = rpc_core_connect(cli, sock.c_str());
  assert(conn > 1);
  std::string f = Frame(1, 1, "about-to-die");
  assert(rpc_core_send(cli, (uint32_t)conn, f.data(), (uint32_t)f.size()) ==
         0);
  std::vector<Rec> got;
  WaitRecords(srv, srv_fd, 1, &got);
  uint32_t srv_conn = got[0].conn;

  // "Crash" the client endpoint: the server must observe a close record
  // for its side of the connection, and replying must start failing.
  rpc_core_stop(cli);
  std::vector<Rec> closed;
  WaitRecords(srv, srv_fd, 1, &closed);
  assert(closed[0].conn == srv_conn && closed[0].len == kClosed);
  int rc = rpc_core_send(srv, srv_conn, f.data(), (uint32_t)f.size());
  assert(rc == -1);  // conn already reaped

  // Local close on the other direction: caller-initiated, no record.
  int conn2_fd = -1;
  void* cli2 = rpc_core_start(nullptr, &conn2_fd);
  int conn2 = rpc_core_connect(cli2, sock.c_str());
  assert(conn2 > 1);
  rpc_core_close_conn(cli2, (uint32_t)conn2);
  for (int i = 0; i < 100; i++) {
    if (rpc_core_send(cli2, (uint32_t)conn2, f.data(),
                      (uint32_t)f.size()) == -1) {
      break;
    }
    ::usleep(1000);
  }
  assert(rpc_core_send(cli2, (uint32_t)conn2, f.data(),
                       (uint32_t)f.size()) == -1);
  rpc_core_stop(cli2);
  rpc_core_stop(srv);
  ::unlink(sock.c_str());
  std::printf("  peer-crash/close OK\n");
}

}  // namespace

int main() {
  TestRoundTripAndEcho();
  TestLargeFramesAndBackpressure();
  TestSplitReads();
  TestConcurrentClientsWithEchoes();
  TestPeerCrashDeliversClose();
  std::printf("rpc_core_test: ALL OK\n");
  return 0;
}
