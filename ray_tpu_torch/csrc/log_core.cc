// graftlog emit path: crash-persistent MAP_SHARED log ring.
//
// Design constraints, in order (inherited from scope_core.cc, with one
// twist — the ring must survive its writer):
//   1. The record must be on the filesystem BEFORE the process can die:
//      the ring is a MAP_SHARED tmpfs file, so every store lands in the
//      page cache immediately; SIGKILL/OOM cannot unwrite it. No
//      fsync — tmpfs pages ARE the storage.
//   2. Losing records under overload is fine; corrupting them is not.
//      One writer per process (threads serialize on a spinlock), head
//      published with a release store, readers lap-check — torn records
//      are discarded by the reader, never surfaced.
//   3. Emitting must never block on I/O, locks held elsewhere, or the
//      reader: an agent tailing the file shares no lock with emit.
//
// No static destructors: globals are PODs/atomics only; the mapping is
// deliberately leaked at exit (the kernel unmaps, the file persists for
// salvage).

#include "log_core.h"

#include <atomic>
#include <cstdio>
#include <cstring>

#include <fcntl.h>
#include <stdlib.h>
#include <strings.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <time.h>
#include <unistd.h>

namespace {

inline void CpuRelax() {
#if defined(__x86_64__) || defined(__i386__)
  __builtin_ia32_pause();
#elif defined(__aarch64__)
  asm volatile("yield" ::: "memory");
#endif
}

struct SpinLock {
  std::atomic_flag f = ATOMIC_FLAG_INIT;
  void lock() {
    while (f.test_and_set(std::memory_order_acquire)) {
      CpuRelax();
    }
  }
  void unlock() { f.clear(std::memory_order_release); }
};
struct SpinGuard {
  SpinLock& l;
  explicit SpinGuard(SpinLock& lk) : l(lk) { l.lock(); }
  ~SpinGuard() { l.unlock(); }
};

uint64_t WallNs() {
  timespec ts;
  clock_gettime(CLOCK_REALTIME, &ts);
  return (uint64_t)ts.tv_sec * 1000000000ull + (uint64_t)ts.tv_nsec;
}

// File header at offset 0 (fixed offsets — the Python decoder reads
// these with struct, not this header definition).
#pragma pack(push, 1)
struct LogRingHeader {
  uint32_t magic;
  uint32_t version;
  uint32_t record_size;
  uint32_t slots;
  uint64_t pid;
  uint64_t head;     // records ever emitted; __atomic release store
  uint64_t dropped;  // emit-side losses, mirrored for salvage
  uint64_t start_ns;
  char pad[kLogHeaderSize - 48];
};
#pragma pack(pop)
static_assert(sizeof(LogRingHeader) == kLogHeaderSize, "header packing");

LogRingHeader* g_hdr = nullptr;  // published under g_emit_lock
char* g_base = nullptr;          // slot area (g_hdr + 1)
SpinLock g_emit_lock;            // serializes same-process emitters
uint64_t g_tail = 0;             // log_drain cursor, under g_drain_lock
SpinLock g_drain_lock;
std::atomic<uint64_t> g_dropped{0};  // emit-before-open + drain laps

std::atomic<int> g_enabled{-1};  // -1 = resolve from env on first use

int ResolveEnabled() {
  const char* v = getenv("RAY_TPU_TORCH_GRAFTLOG");
  int on = 1;
  if (v != nullptr &&
      (strcmp(v, "0") == 0 || strcasecmp(v, "false") == 0 ||
       strcasecmp(v, "off") == 0 || strcasecmp(v, "no") == 0)) {
    on = 0;
  }
  int expected = -1;
  g_enabled.compare_exchange_strong(expected, on,
                                    std::memory_order_relaxed,
                                    std::memory_order_relaxed);
  return g_enabled.load(std::memory_order_relaxed);
}

void CopyPadded(char* dst, int cap, const char* src) {
  size_t n = src != nullptr ? strlen(src) : 0;
  if (n > (size_t)cap) n = (size_t)cap;
  if (n > 0) memcpy(dst, src, n);
  if ((int)n < cap) memset(dst + n, 0, (size_t)(cap - n));
}

}  // namespace

extern "C" {

int log_ring_open(const char* dir, uint64_t pid) {
  if (dir == nullptr) return -1;
  char path[512];
  int k = snprintf(path, sizeof(path), "%s/logring-%llu", dir,
                   (unsigned long long)pid);
  if (k <= 0 || (size_t)k >= sizeof(path)) return -1;
  size_t total =
      (size_t)kLogHeaderSize + (size_t)kLogRingSlots * kLogRecordSize;
  int fd = open(path, O_RDWR | O_CREAT | O_TRUNC, 0644);
  if (fd < 0) return -1;
  if (ftruncate(fd, (off_t)total) != 0) {
    close(fd);
    unlink(path);
    return -1;
  }
  void* map =
      mmap(nullptr, total, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  close(fd);  // the mapping keeps the file's pages reachable
  if (map == MAP_FAILED) {
    unlink(path);
    return -1;
  }
  auto* hdr = (LogRingHeader*)map;
  hdr->magic = (uint32_t)kLogMagic;
  hdr->version = (uint32_t)kLogRingVersion;
  hdr->record_size = (uint32_t)kLogRecordSize;
  hdr->slots = (uint32_t)kLogRingSlots;
  hdr->pid = pid;
  hdr->dropped = 0;
  hdr->start_ns = WallNs();
  __atomic_store_n(&hdr->head, 0, __ATOMIC_RELEASE);
  SpinGuard g(g_emit_lock);
  if (g_hdr != nullptr) {
    // Re-open (tests): drop the old mapping; its file was the caller's
    // to clean up.
    munmap((void*)g_hdr, total);
  }
  g_base = (char*)map + kLogHeaderSize;
  g_hdr = hdr;
  {
    SpinGuard dg(g_drain_lock);
    g_tail = 0;
  }
  return 0;
}

void log_ring_close(void) {
  SpinGuard g(g_emit_lock);
  if (g_hdr == nullptr) return;
  size_t total =
      (size_t)kLogHeaderSize + (size_t)kLogRingSlots * kLogRecordSize;
  munmap((void*)g_hdr, total);
  g_hdr = nullptr;
  g_base = nullptr;
}

uint64_t log_emit(int level, int source, const char* task,
                  const char* actor, const char* msg, int msg_len) {
  if (!log_enabled()) return 0;
  if (msg == nullptr) msg = "";
  if (msg_len < 0) msg_len = (int)strlen(msg);
  SpinGuard g(g_emit_lock);
  if (g_hdr == nullptr) {
    g_dropped.fetch_add(1, std::memory_order_relaxed);
    return 0;
  }
  uint64_t h = __atomic_load_n(&g_hdr->head, __ATOMIC_RELAXED);
  LogWireRec* rec =
      (LogWireRec*)(g_base +
                    (size_t)(h & (kLogRingSlots - 1)) * kLogRecordSize);
  rec->level = (uint8_t)(level < 0 ? 0 : level > 255 ? 255 : level);
  rec->source = (uint8_t)(source & 0xff);
  rec->line_len =
      (uint16_t)(msg_len > 0xffff ? 0xffff : msg_len);
  rec->seq = (uint32_t)(h + 1);
  rec->t_ns = WallNs();
  CopyPadded(rec->task, kLogTaskCap, task);
  CopyPadded(rec->actor, kLogActorCap, actor);
  int n = msg_len > kLogMsgCap ? kLogMsgCap : msg_len;
  if (n > 0) memcpy(rec->msg, msg, (size_t)n);
  if (n < kLogMsgCap) memset(rec->msg + n, 0, (size_t)(kLogMsgCap - n));
  // Publish: the record bytes land before the head moves, so a reader
  // that observes head >= h+1 sees a whole record (or lap-checks it
  // away). MAP_SHARED means these stores are already durable against
  // SIGKILL — the page cache outlives the process.
  __atomic_store_n(&g_hdr->head, h + 1, __ATOMIC_RELEASE);
  g_hdr->dropped = g_dropped.load(std::memory_order_relaxed);
  return h + 1;
}

uint64_t log_emit_batch(int level, int source, const char* task,
                        const char* actor, const char* lines, int len) {
  if (!log_enabled()) return 0;
  if (lines == nullptr || len <= 0) return 0;
  SpinGuard g(g_emit_lock);
  if (g_hdr == nullptr) {
    // Count the would-be records so the loss is visible.
    uint64_t n = 1;
    for (int i = 0; i < len; i++) n += lines[i] == '\n';
    g_dropped.fetch_add(n, std::memory_order_relaxed);
    return 0;
  }
  uint64_t t_ns = WallNs();
  char task_pad[kLogTaskCap], actor_pad[kLogActorCap];
  CopyPadded(task_pad, kLogTaskCap, task);
  CopyPadded(actor_pad, kLogActorCap, actor);
  uint8_t lvl = (uint8_t)(level < 0 ? 0 : level > 255 ? 255 : level);
  uint64_t h = __atomic_load_n(&g_hdr->head, __ATOMIC_RELAXED);
  const char* p = lines;
  const char* end = lines + len;
  while (p < end) {
    const char* nl = (const char*)memchr(p, '\n', (size_t)(end - p));
    int mlen = (int)((nl != nullptr ? nl : end) - p);
    if (mlen > 0) {
      LogWireRec* rec =
          (LogWireRec*)(g_base +
                        (size_t)(h & (kLogRingSlots - 1)) *
                            kLogRecordSize);
      rec->level = lvl;
      rec->source = (uint8_t)(source & 0xff);
      rec->line_len = (uint16_t)(mlen > 0xffff ? 0xffff : mlen);
      rec->seq = (uint32_t)(h + 1);
      rec->t_ns = t_ns;
      memcpy(rec->task, task_pad, kLogTaskCap);
      memcpy(rec->actor, actor_pad, kLogActorCap);
      int n = mlen > kLogMsgCap ? kLogMsgCap : mlen;
      memcpy(rec->msg, p, (size_t)n);
      if (n < kLogMsgCap)
        memset(rec->msg + n, 0, (size_t)(kLogMsgCap - n));
      h++;
    }
    p = nl != nullptr ? nl + 1 : end;
  }
  uint64_t h0 = __atomic_load_n(&g_hdr->head, __ATOMIC_RELAXED);
  if (h == h0) return 0;  // batch was all empty lines
  // One publish for the whole batch: every record's bytes land before
  // the head moves, so a reader that observes the new head sees whole
  // records — same discipline as the single-record emit.
  __atomic_store_n(&g_hdr->head, h, __ATOMIC_RELEASE);
  g_hdr->dropped = g_dropped.load(std::memory_order_relaxed);
  return h;
}

int log_enabled(void) {
  int e = g_enabled.load(std::memory_order_relaxed);
  return e < 0 ? ResolveEnabled() : e;
}

void log_set_enabled(int on) {
  g_enabled.store(on ? 1 : 0, std::memory_order_relaxed);
}

int log_drain(char* buf, int cap) {
  SpinGuard dg(g_drain_lock);
  if (g_hdr == nullptr) return 0;
  int n = 0;
  uint64_t head = __atomic_load_n(&g_hdr->head, __ATOMIC_ACQUIRE);
  uint64_t t = g_tail;
  if (head - t >= kLogRingSlots) {
    uint64_t safe = head - kLogRingSlots + 1;
    g_dropped.fetch_add(safe - t, std::memory_order_relaxed);
    t = safe;
  }
  while (t < head) {
    if (n + kLogRecordSize > cap) break;
    memcpy(buf + n,
           g_base + (size_t)(t & (kLogRingSlots - 1)) * kLogRecordSize,
           kLogRecordSize);
    // Lap check: if the writer reached t + slots while we copied, the
    // slot may hold a half-written newer record — discard and skip to
    // the new safe window.
    uint64_t h2 = __atomic_load_n(&g_hdr->head, __ATOMIC_ACQUIRE);
    if (h2 - t >= kLogRingSlots) {
      uint64_t safe = h2 - kLogRingSlots + 1;
      g_dropped.fetch_add(safe - t, std::memory_order_relaxed);
      t = safe;
      head = h2;
      continue;
    }
    n += kLogRecordSize;
    t++;
  }
  g_tail = t;
  return n;
}

uint64_t log_emitted(void) {
  SpinGuard g(g_emit_lock);
  if (g_hdr == nullptr) return 0;
  return __atomic_load_n(&g_hdr->head, __ATOMIC_ACQUIRE);
}

uint64_t log_dropped(void) {
  return g_dropped.load(std::memory_order_relaxed);
}

}  // extern "C"
