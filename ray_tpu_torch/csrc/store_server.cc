// Native fast-path server + client for the shared-memory object store.
//
// TPU-native analogue of the reference's plasma store socket protocol
// (reference: src/ray/object_manager/plasma/{store_runner.cc,client.cc} —
// there the store IS a socket server speaking flatbuffers; here the
// Python agent's asyncio RPC remains the control plane while THIS
// sidecar carries the hot object ops). The agent starts one server
// thread inside its process sharing the native Store handle; workers
// connect a blocking unix-socket client and perform put(ingest)/get/
// release/delete/contains with ZERO Python or event-loop work on either
// side — the whole round-trip is two small socket writes between two C
// threads.
//
// The Python agent still owns object lifecycle bookkeeping (primary
// ledger, seal waiters, spill policy). A lock-protected EVENT JOURNAL
// records every ingest/delete the sidecar admits; a pipe byte wakes the
// agent's event loop, which drains the journal via store_server_drain()
// and applies the bookkeeping. Full-store ingests are REFUSED (rc -2):
// the worker falls back to the RPC path whose admission can spill.
//
// Wire format (little-endian, fixed header):
//   request : u8 op | 20B oid | u64 a | u64 b | u16 nlen | name[nlen]
//   response: i32 rc | u64 ds | u64 ms | u16 plen | path[plen]
// Ops: 1 INGEST(a=data_size, b=meta_size, name=ingest file)
//      2 GET (pins; pair with RELEASE)   3 RELEASE
//      4 DELETE                          5 CONTAINS (rc = 0/1/2)
//      6 PUT (a=data_size, b=meta_size, name=put-* staging file): the
//        fused graftcopy put — identical admission to INGEST (account,
//        evict, rename-in, pin, journal as an ingest) but for the
//        O_TMPFILE+linkat pipeline whose staging names derive from the
//        object id ("put-<oid hex>"), so the worker needs no
//        name-collision machinery at all. PUT and CONTAINS replies carry
//        the connection's cumulative DROP counters (seen, erased) in
//        their otherwise-unused ds/ms fields.
//      7 DROP: fire-and-forget DELETE — processed and journaled like op 4
//        but answered with NO reply frame; outcomes are reported via the
//        counters on the next PUT/CONTAINS reply.
//      8 SCOPE: drain this process's graftscope flight-recorder rings
//        into the reply's path field (rc = plen = bytes, a whole number
//        of 24-byte records; ds = records dropped so far, ms = recorder
//        enabled flag). Touches no store state — observability only, so
//        a slow scope reader never couples to the object data plane.
//      9 CREATE (a=data_size, b=meta_size): graftshm — allocate a
//        store-owned slab for the object, admit it STAGED (unsealed,
//        invisible to readers and eviction), and pass the slab's fd to
//        the client via SCM_RIGHTS immediately AFTER the reply frame
//        (only when rc == 0). The reply's path field carries the slab
//        path, ms carries a warm-slab-reuse flag. The client maps the
//        fd and serializes in place — no bulk copy phase exists.
//     10 SEAL: graftshm — publish a CREATEd object (staged -> sealed,
//        pinned as the primary copy), journaled as an ingest so the
//        agent's bookkeeping is op-agnostic. Reply carries the drop
//        counters like PUT. A connection that dies between CREATE and
//        SEAL gets its staged objects reclaimed (deleted + journaled)
//        on disconnect — the slab returns to the arena.

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <string>
#include <unordered_map>
#include <unordered_set>
#include <vector>

#include <fcntl.h>
#include <pthread.h>
#include <sys/socket.h>
#include <sys/un.h>
#include <unistd.h>

#include "prof_core.h"
#include "scope_core.h"
#include "shm_core.h"

extern "C" {
// From object_store.cc (same shared library).
int store_ingest_object(void* handle, const char* id, const char* src_path,
                        uint64_t data_size, uint64_t meta_size, int pinned);
int store_get(void* handle, const char* id, char* out_path, int path_cap,
              uint64_t* data_size, uint64_t* meta_size);
int store_release(void* handle, const char* id);
int store_delete(void* handle, const char* id);
int store_contains(void* handle, const char* id);
int store_adopt_staged(void* handle, const char* id, const char* slab_path,
                       uint64_t data_size, uint64_t meta_size);
int store_seal_pin(void* handle, const char* id, uint64_t* total_out);
void store_set_slab_recycler(void* handle,
                             void (*fn)(void*, const char*, uint64_t),
                             void* ctx);
const char* store_dir_ref(void* handle);
uint64_t store_capacity(void* handle);
}

namespace {

constexpr int kIdSize = 20;
constexpr uint8_t kOpIngest = 1, kOpGet = 2, kOpRelease = 3,
                  kOpDelete = 4, kOpContains = 5, kOpPut = 6,
                  kOpDrop = 7, kOpScope = 8, kOpCreate = 9,
                  kOpSeal = 10;

// First 8 oid bytes as a little-endian u64 — enough entropy to match a
// native record back to the Python-side object id during stitching.
uint64_t Oid64(const char* oid) {
  uint64_t v;
  std::memcpy(&v, oid, 8);
  return v;
}

struct Event {       // journal entry: 30 bytes packed on drain
  uint8_t op;        // kOpIngest | kOpDelete | kOpCreate
  uint8_t origin;    // the wire op that caused it (grafttrail provenance:
                     // distinguishes shm seal / copy put / drop / staged
                     // reclaim behind the folded op)
  char oid[kIdSize];
  uint64_t size;
};

struct Server {
  void* store = nullptr;
  void* arena = nullptr;  // graftshm slab arena (owned; see stop())
  std::string dir;
  int listen_fd = -1;
  int notify_r = -1, notify_w = -1;  // pipe: journal nonempty signal
  pthread_t accept_thread;
  std::mutex mu;
  std::vector<Event> journal;
  std::vector<int> conn_fds;             // live connections (under mu)
  std::atomic<int> active_conns{0};      // ConnLoop threads running
  std::atomic<bool> stopping{false};
};

bool ReadFull(int fd, void* buf, size_t n) {
  char* p = static_cast<char*>(buf);
  while (n > 0) {
    ssize_t r = ::read(fd, p, n);
    if (r <= 0) return false;
    p += r;
    n -= (size_t)r;
  }
  return true;
}

bool WriteFull(int fd, const void* buf, size_t n) {
  const char* p = static_cast<const char*>(buf);
  while (n > 0) {
    ssize_t r = ::write(fd, p, n);
    if (r <= 0) return false;
    p += r;
    n -= (size_t)r;
  }
  return true;
}

void Journal(Server* s, uint8_t op, uint8_t origin, const char* oid,
             uint64_t size) {
  bool was_empty;
  {
    std::lock_guard<std::mutex> g(s->mu);
    was_empty = s->journal.empty();
    Event e;
    e.op = op;
    e.origin = origin;
    std::memcpy(e.oid, oid, kIdSize);
    e.size = size;
    s->journal.push_back(e);
  }
  if (was_empty) {
    char b = 1;
    (void)!::write(s->notify_w, &b, 1);
  }
}

struct ConnArgs {
  Server* server;
  int fd;
};

void* ConnLoop(void* argp) {
  ConnArgs* args = static_cast<ConnArgs*>(argp);
  Server* s = args->server;
  int fd = args->fd;
  delete args;
  prof_register_thread("sidecar-conn");
  {
    std::lock_guard<std::mutex> g(s->mu);
    s->conn_fds.push_back(fd);
  }
  char oid[kIdSize];
  char name[512];
  char path[4096];
  // Per-connection pin ledger: a client that dies between GET and
  // RELEASE must not leak pins (the reference plasma store releases a
  // disconnected client's pins the same way).
  std::unordered_map<std::string, int> pins;
  // Cumulative fire-and-forget delete outcomes (kOpDrop). DROP writes no
  // reply; these counters ride the otherwise-unused ds/ms fields of the
  // next PUT reply so the client can settle its in-flight drop list with
  // zero extra wakeups.
  uint64_t drops_seen = 0, drops_erased = 0;
  // graftshm staged objects this client CREATEd but has not SEALed: if
  // the client dies mid-put, these are reclaimed on disconnect so no
  // slab leaks behind an invisible staged entry.
  std::unordered_set<std::string> staged;
  for (;;) {
    uint8_t op;
    uint64_t a, b;
    uint16_t nlen;
    if (!ReadFull(fd, &op, 1) || !ReadFull(fd, oid, kIdSize) ||
        !ReadFull(fd, &a, 8) || !ReadFull(fd, &b, 8) ||
        !ReadFull(fd, &nlen, 2)) {
      break;
    }
    if (nlen >= sizeof(name)) break;
    if (nlen && !ReadFull(fd, name, nlen)) break;
    name[nlen] = 0;

    // SCOPE requests are not themselves recorded: a drain loop that
    // produced a fresh record per drain would never run dry.
    uint64_t svc_t0 =
        scope_enabled() && op != kOpScope ? scope_now_ns() : 0;
    if (svc_t0 != 0) {
      uint32_t sz = a + b > 0xFFFFFFFFull ? 0xFFFFFFFFu : (uint32_t)(a + b);
      scope_emit(kScopeScBegin, op, 0, sz, Oid64(oid), svc_t0, 0);
    }
    int32_t rc = -1;
    uint64_t ds = 0, ms = 0;
    uint16_t plen = 0;
    int send_fd = -1;  // slab fd to pass after the reply (CREATE only)
    path[0] = 0;
    switch (op) {
      case kOpIngest:
      case kOpPut: {
        // Same validation as the agent RPC: relative staging-file names
        // only — a worker must not rename arbitrary paths in. INGEST
        // takes the legacy per-worker "ingest-" names; PUT takes the
        // oid-derived "put-" names of the graftcopy pipeline.
        const char* prefix = (op == kOpPut) ? "put-" : "ingest-";
        if (std::strncmp(name, prefix, std::strlen(prefix)) != 0 ||
            std::strchr(name, '/') != nullptr) {
          rc = -4;
          break;
        }
        std::string src = s->dir + "/" + name;
        rc = store_ingest_object(s->store, oid, src.c_str(), a, b,
                                 /*pinned=*/1);
        // Journaled as an ingest either way: the agent's bookkeeping
        // (primary ledger, seal waiters) is op-agnostic.
        if (rc == 0) {
          if (svc_t0 != 0) {
            // The staging file just became the store object (rename-in).
            scope_emit(kScopeScRename, op, 0,
                       a + b > 0xFFFFFFFFull ? 0xFFFFFFFFu
                                             : (uint32_t)(a + b),
                       Oid64(oid), 0, 0);
          }
          Journal(s, kOpIngest, op, oid, a + b);
        }
        if (op == kOpPut) {
          ds = drops_seen;
          ms = drops_erased;
        }
        break;
      }
      case kOpDrop:
        // Fire-and-forget delete: same semantics as DELETE but NO reply
        // frame, so a worker's put/drop loop costs one context-switch
        // cycle per iteration instead of two (a replied delete wakes
        // the client mid-pipeline and preempts the sidecar). Outcomes
        // accumulate into the per-connection counters above.
        drops_seen++;
        if (store_delete(s->store, oid) == 0) drops_erased++;
        Journal(s, kOpDelete, kOpDrop, oid, 0);
        if (svc_t0 != 0) {
          uint64_t t1 = scope_now_ns();
          uint64_t d = t1 - svc_t0;
          scope_emit(kScopeScEnd, op,
                     0, d > 0xFFFFFFFFull ? 0xFFFFFFFFu : (uint32_t)d,
                     Oid64(oid), t1, d);
        }
        continue;
      case kOpGet:
        rc = store_get(s->store, oid, path, sizeof(path), &ds, &ms);
        if (rc == 0) {
          plen = (uint16_t)std::strlen(path);
          pins[std::string(oid, kIdSize)]++;
        }
        break;
      case kOpRelease: {
        rc = store_release(s->store, oid);
        auto it = pins.find(std::string(oid, kIdSize));
        if (it != pins.end() && --it->second <= 0) pins.erase(it);
        break;
      }
      case kOpDelete:
        rc = store_delete(s->store, oid);
        staged.erase(std::string(oid, kIdSize));
        // Journal even when the store never had it (-1): the Python
        // agent may hold spill state for the oid that must drop too.
        Journal(s, kOpDelete, kOpDelete, oid, 0);
        break;
      case kOpCreate: {
        // graftshm: slab allocation + staged admission. -2 maps the
        // arena's clean ENOSPC (and the store's full-after-eviction)
        // onto the same code PUT uses, so the client's fallback logic
        // is shared.
        uint64_t total = a + b;
        int reused = 0;
        int sfd = shm_arena_acquire(s->arena, total, path, sizeof(path),
                                    &reused);
        if (sfd < 0) {
          rc = sfd == -2 ? -2 : -3;
          break;
        }
        rc = store_adopt_staged(s->store, oid, path, a, b);
        if (rc != 0) {
          ::close(sfd);
          shm_arena_recycle(s->arena, path, total);
          path[0] = 0;
          break;
        }
        staged.insert(std::string(oid, kIdSize));
        // grafttrail: a staged shm object now exists (unsealed); the
        // agent's ledger bookkeeping stays seal-driven, but the trail
        // wants creation provenance for conservation audits.
        Journal(s, kOpCreate, kOpCreate, oid, total);
        plen = (uint16_t)std::strlen(path);
        ms = (uint64_t)reused;
        send_fd = sfd;
        break;
      }
      case kOpSeal: {
        uint64_t total = 0;
        rc = store_seal_pin(s->store, oid, &total);
        // Journaled as an ingest: the agent's bookkeeping (primary
        // ledger, seal waiters) is op-agnostic, exactly like PUT.
        if (rc == 0) {
          staged.erase(std::string(oid, kIdSize));
          Journal(s, kOpIngest, kOpSeal, oid, total);
        }
        ds = drops_seen;
        ms = drops_erased;
        break;
      }
      case kOpContains:
        rc = store_contains(s->store, oid);
        // CONTAINS replies carry the drop counters too: the put plane
        // confirms staging-inode reuse with a contains round-trip, and
        // that same reply settles its in-flight drops.
        ds = drops_seen;
        ms = drops_erased;
        break;
      case kOpScope: {
        // Drain the recorder into the path field: a whole number of
        // records, bounded by the u16 plen (path cap 4096, NUL spare).
        int m = scope_drain(path, (int)sizeof(path) - 1);
        if (m < 0) m = 0;
        rc = m;
        plen = (uint16_t)m;
        ds = scope_dropped();
        ms = (uint64_t)scope_enabled();
        break;
      }
      default:
        rc = -5;
    }
    if (svc_t0 != 0) {
      // Span-in-one: size carries the service duration (ns, clipped) so
      // stitching needs no Begin/End pairing across thread rings.
      uint64_t t1 = scope_now_ns();
      uint64_t d = t1 - svc_t0;
      scope_emit(kScopeScEnd, op,
                 0, d > 0xFFFFFFFFull ? 0xFFFFFFFFu : (uint32_t)d,
                 Oid64(oid), t1, d);
    }
    if (!WriteFull(fd, &rc, 4) || !WriteFull(fd, &ds, 8) ||
        !WriteFull(fd, &ms, 8) || !WriteFull(fd, &plen, 2) ||
        (plen && !WriteFull(fd, path, plen))) {
      if (send_fd >= 0) ::close(send_fd);
      break;
    }
    if (send_fd >= 0) {
      // The slab fd rides AFTER the reply frame (SCM_RIGHTS needs its
      // own sendmsg; the client does recv-reply then recv-fd, in
      // order, only when rc == 0). The server's copy closes either
      // way — the client holds the only other reference.
      int ok = shm_send_fd(fd, send_fd);
      ::close(send_fd);
      if (ok != 0) break;
    }
  }
  // Reclaim staged graftshm objects this client never sealed: delete
  // returns the slab to the arena, and the journal tells the agent to
  // drop any bookkeeping it may have for the oid.
  for (const auto& key : staged) {
    store_delete(s->store, key.data());
    Journal(s, kOpDelete, kOpCreate, key.data(), 0);
  }
  // Release any pins this client still held (died mid GET..RELEASE).
  for (const auto& kv : pins) {
    for (int i = 0; i < kv.second; i++) {
      store_release(s->store, kv.first.data());
    }
  }
  {
    std::lock_guard<std::mutex> g(s->mu);
    for (size_t i = 0; i < s->conn_fds.size(); i++) {
      if (s->conn_fds[i] == fd) {
        s->conn_fds.erase(s->conn_fds.begin() + i);
        break;
      }
    }
  }
  ::close(fd);
  // acq_rel: the final fetch_sub publishes this thread's last touches
  // of *s to the acquire loads in store_server_stop, which may delete
  // the Server the moment the count hits zero.
  s->active_conns.fetch_sub(1, std::memory_order_acq_rel);
  return nullptr;
}

void* AcceptLoop(void* argp) {
  Server* s = static_cast<Server*>(argp);
  prof_register_thread("sidecar-accept");
  for (;;) {
    int fd = ::accept(s->listen_fd, nullptr, nullptr);
    if (fd < 0) {
      // acquire pairs with stop()'s release store: everything stop()
      // did before raising the flag is visible here.
      if (s->stopping.load(std::memory_order_acquire)) return nullptr;
      continue;
    }
    if (s->stopping.load(std::memory_order_acquire)) {
      ::close(fd);
      return nullptr;
    }
    scope_emit(kScopeScAccept, 0, 0, 0, 0, 0, 0);
    auto* args = new ConnArgs{s, fd};
    s->active_conns.fetch_add(1, std::memory_order_acq_rel);
    pthread_t t;
    if (pthread_create(&t, nullptr, ConnLoop, args) == 0) {
      pthread_detach(t);
    } else {
      s->active_conns.fetch_sub(1, std::memory_order_acq_rel);
      ::close(fd);
      delete args;
    }
  }
}

// Trampoline: the store's EraseObject hands slab-backed paths here
// (under store.mu) and the arena free-lists them under its own mutex.
void ArenaRecycleTramp(void* ctx, const char* path, uint64_t size) {
  shm_arena_recycle(ctx, path, size);
}

}  // namespace

extern "C" {

// Starts the sidecar inside the agent process. Returns the server
// handle (NULL on failure); *notify_fd_out receives the read end of the
// journal-notification pipe (register with the event loop).
void* store_server_start(void* store_handle, const char* sock_path,
                         int* notify_fd_out) {
  auto* s = new Server();
  s->store = store_handle;
  s->dir = store_dir_ref(store_handle);
  // graftshm arena: retain up to a quarter of store capacity in
  // recycled slabs. Warm-slab reuse is the put-bandwidth win; the cap
  // bounds how much tmpfs the free list can hold back from eviction.
  s->arena = shm_arena_create(s->dir.c_str(),
                              store_capacity(store_handle) / 4);
  store_set_slab_recycler(store_handle, ArenaRecycleTramp, s->arena);
  int fds[2];
  if (::pipe(fds) != 0) {
    store_set_slab_recycler(store_handle, nullptr, nullptr);
    shm_arena_destroy(s->arena);
    delete s;
    return nullptr;
  }
  s->notify_r = fds[0];
  s->notify_w = fds[1];
  ::fcntl(s->notify_r, F_SETFL, O_NONBLOCK);
  s->listen_fd = ::socket(AF_UNIX, SOCK_STREAM, 0);
  sockaddr_un addr;
  std::memset(&addr, 0, sizeof(addr));
  addr.sun_family = AF_UNIX;
  std::snprintf(addr.sun_path, sizeof(addr.sun_path), "%s", sock_path);
  ::unlink(sock_path);
  if (::bind(s->listen_fd, (sockaddr*)&addr, sizeof(addr)) != 0 ||
      ::listen(s->listen_fd, 128) != 0) {
    ::close(s->listen_fd);
    ::close(fds[0]);
    ::close(fds[1]);
    store_set_slab_recycler(store_handle, nullptr, nullptr);
    shm_arena_destroy(s->arena);
    delete s;
    return nullptr;
  }
  if (pthread_create(&s->accept_thread, nullptr, AcceptLoop, s) != 0) {
    ::close(s->listen_fd);
    ::close(fds[0]);
    ::close(fds[1]);
    store_set_slab_recycler(store_handle, nullptr, nullptr);
    shm_arena_destroy(s->arena);
    delete s;
    return nullptr;
  }
  *notify_fd_out = s->notify_r;
  return s;
}

// Drain journal events into buf as 30-byte records (u8 op | u8 origin |
// 20B oid | u64 size). Returns bytes written. Also consumes the pipe
// signal.
int store_server_drain(void* handle, char* buf, int cap) {
  auto* s = static_cast<Server*>(handle);
  char scratch[64];
  while (::read(s->notify_r, scratch, sizeof(scratch)) > 0) {
  }  // notify_r is O_NONBLOCK: drains the wake bytes without blocking
  std::lock_guard<std::mutex> g(s->mu);
  int n = 0;
  size_t taken = 0;
  for (const Event& e : s->journal) {
    if (n + 30 > cap) break;
    buf[n] = (char)e.op;
    buf[n + 1] = (char)e.origin;
    std::memcpy(buf + n + 2, e.oid, kIdSize);
    std::memcpy(buf + n + 22, &e.size, 8);
    n += 30;
    taken++;
  }
  s->journal.erase(s->journal.begin(), s->journal.begin() + taken);
  return n;
}

// graftpulse: arena occupancy snapshot — out[0..2] = {free_bytes,
// free_slabs, reuses}. Three arena-mutex reads; called once per pulse
// tick from the node agent.
void store_server_shm_stats(void* handle, uint64_t* out) {
  auto* s = static_cast<Server*>(handle);
  out[0] = shm_arena_free_bytes(s->arena);
  out[1] = shm_arena_free_slabs(s->arena);
  out[2] = shm_arena_reuses(s->arena);
}

void store_server_stop(void* handle) {
  auto* s = static_cast<Server*>(handle);
  s->stopping.store(true, std::memory_order_release);
  ::shutdown(s->listen_fd, SHUT_RDWR);
  ::close(s->listen_fd);
  pthread_join(s->accept_thread, nullptr);
  // Kick every live connection out of its blocking read, then wait for
  // the detached handler threads to finish — freeing the Server while a
  // ConnLoop still references it would be a use-after-free.
  {
    std::lock_guard<std::mutex> g(s->mu);
    for (int fd : s->conn_fds) ::shutdown(fd, SHUT_RDWR);
  }
  // acquire pairs with ConnLoop's final fetch_sub(acq_rel): observing 0
  // means every handler's last touch of *s happened-before the delete.
  for (int spins = 0;
       s->active_conns.load(std::memory_order_acquire) > 0 &&
       spins < 5000;
       spins++) {
    ::usleep(1000);
  }
  ::close(s->notify_r);
  ::close(s->notify_w);
  if (s->active_conns.load(std::memory_order_acquire) == 0) {
    // Unregister before destroying: a store op after stop() must not
    // call into a freed arena. (The store itself outlives the server —
    // the agent destroys it separately.)
    store_set_slab_recycler(s->store, nullptr, nullptr);
    shm_arena_destroy(s->arena);
    delete s;  // else: leak one Server rather than risk a UAF
  }
}

// ---------------------------------------------------------------------
// Blocking client (runs in worker processes; no event loop).
// ---------------------------------------------------------------------

int store_client_connect(const char* sock_path) {
  int fd = ::socket(AF_UNIX, SOCK_STREAM, 0);
  if (fd < 0) return -1;
  sockaddr_un addr;
  std::memset(&addr, 0, sizeof(addr));
  addr.sun_family = AF_UNIX;
  std::snprintf(addr.sun_path, sizeof(addr.sun_path), "%s", sock_path);
  if (::connect(fd, (sockaddr*)&addr, sizeof(addr)) != 0) {
    ::close(fd);
    return -1;
  }
  return fd;
}

// Send half of a request: frames and writes one op without waiting for
// the reply. The server answers every request in order on the same
// connection, so a caller may pipeline — send a fire-and-forget op
// (delete), do useful work, and collect the reply with
// store_client_recv before the next request. 0 ok, -1 IO error (the
// connection is desynced; caller must reconnect).
int store_client_send(int fd, uint8_t op, const char* oid, uint64_t a,
                      uint64_t b, const char* name) {
  uint16_t nlen = name ? (uint16_t)std::strlen(name) : 0;
  char req[1 + kIdSize + 8 + 8 + 2];
  req[0] = (char)op;
  std::memcpy(req + 1, oid, kIdSize);
  std::memcpy(req + 21, &a, 8);
  std::memcpy(req + 29, &b, 8);
  std::memcpy(req + 37, &nlen, 2);
  if (!WriteFull(fd, req, sizeof(req))) return -1;
  if (nlen && !WriteFull(fd, name, nlen)) return -1;
  return 0;
}

// Receive half: blocks for exactly one reply. 0 ok, -1 IO error.
int store_client_recv(int fd, int32_t* rc_out, uint64_t* ds_out,
                      uint64_t* ms_out, char* path_out, int path_cap) {
  int32_t rc;
  uint64_t ds, ms;
  uint16_t plen;
  if (!ReadFull(fd, &rc, 4) || !ReadFull(fd, &ds, 8) ||
      !ReadFull(fd, &ms, 8) || !ReadFull(fd, &plen, 2)) {
    return -1;
  }
  if (plen >= path_cap) return -1;
  if (plen && !ReadFull(fd, path_out, plen)) return -1;
  path_out[plen] = 0;
  *rc_out = rc;
  *ds_out = ds;
  *ms_out = ms;
  return 0;
}

// Returns 0 on transport success (rc/ds/ms/path filled), -1 on IO error
// (caller should reconnect or fall back to the RPC path).
int store_client_request(int fd, uint8_t op, const char* oid, uint64_t a,
                         uint64_t b, const char* name, int32_t* rc_out,
                         uint64_t* ds_out, uint64_t* ms_out,
                         char* path_out, int path_cap) {
  if (store_client_send(fd, op, oid, a, b, name) != 0) return -1;
  return store_client_recv(fd, rc_out, ds_out, ms_out, path_out,
                           path_cap);
}

// graftshm CREATE round-trip: request a staged slab for the object and
// receive its fd. Returns 0 on transport success (*rc_out is the
// server's status; *slab_fd_out is a valid mapped-writable fd iff
// *rc_out == 0), -1 on IO error — including a failed fd-receive, after
// which the connection is desynced and the caller must reconnect.
int store_client_create(int fd, const char* oid, uint64_t data_size,
                        uint64_t meta_size, int32_t* rc_out,
                        uint64_t* reused_out, char* path_out, int path_cap,
                        int* slab_fd_out) {
  *slab_fd_out = -1;
  if (store_client_send(fd, kOpCreate, oid, data_size, meta_size,
                        nullptr) != 0) {
    return -1;
  }
  uint64_t ds = 0, ms = 0;
  if (store_client_recv(fd, rc_out, &ds, &ms, path_out, path_cap) != 0) {
    return -1;
  }
  *reused_out = ms;
  if (*rc_out != 0) return 0;  // no fd follows a non-zero reply
  int sfd = shm_recv_fd(fd);
  if (sfd < 0) return -1;
  *slab_fd_out = sfd;
  return 0;
}

// graftshm SEAL round-trip: publish a CREATEd object. Semantics of the
// return mirror store_client_request; the reply's ds/ms carry the
// connection's cumulative drop counters (like PUT).
int store_client_seal(int fd, const char* oid, int32_t* rc_out,
                      uint64_t* ds_out, uint64_t* ms_out) {
  char path[8];
  return store_client_request(fd, kOpSeal, oid, 0, 0, nullptr, rc_out,
                              ds_out, ms_out, path, sizeof(path));
}

void store_client_close(int fd) { ::close(fd); }

}  // extern "C"
