// graftscope recorder: per-thread lock-free ring buffers + cumulative
// per-kind counters for the native planes (SURVEY §5 — the reference
// splits the same way: a lock-cheap C++ stats layer in src/ray/stats/
// feeding a per-node exporter; here the rings feed the node agent's
// metrics tick and the stitched timeline).
//
// Design constraints, in order:
//   1. The write path must cost nanoseconds and never block — it sits
//      inside rpc_core_send (20k calls/s) and the sidecar service loop.
//      Each thread owns one ring (single writer); a record is three
//      relaxed u64 stores plus one release store of the head. No CAS,
//      no lock, no allocation.
//   2. Losing records under overload is fine; corrupting them is not.
//      The drainer detects writer lap-over by re-reading the head after
//      copying a record and discards anything the writer may have been
//      overwriting (counted in scope_dropped()).
//   3. Draining is cold (metrics tick, tests, OP_SCOPE) — it takes a
//      mutex against other drainers, never against writers.
//
// Ring slots are leased per thread and recycled on thread exit via a
// thread_local destructor, so long-lived processes with churning
// sidecar connection threads don't exhaust the table.

#include "scope_core.h"

#include <atomic>
#include <cstring>
#include <ctime>

#include <stdlib.h>
#include <strings.h>

namespace {

constexpr int kRingSlots = 64;       // max concurrently recording threads
constexpr uint64_t kRingCap = 2048;  // records per ring (power of two)

// One record = 3 words: w0 packs kind|op|chan|size, w1 = seq_or_oid,
// w2 = t_ns. Stored as atomics so a concurrent drainer reading a slot
// mid-overwrite is a benign (detected) race, not UB — the lap check
// below discards the torn copy.
struct ScopeRing {
  std::atomic<uint64_t> head{0};  // next absolute record index
  uint64_t tail = 0;              // drainer cursor (under g_drain_mu)
  std::atomic<uint64_t> w[kRingCap * 3];
};

// All recorder globals are PODs or atomics with trivial destructors:
// detached sidecar threads may run their thread_local SlotLease
// destructor after main() returns, so nothing here may be torn down by
// a static destructor (a std::vector free list here is a TSAN-visible
// shutdown race). Cold-path mutual exclusion uses atomic_flag
// spinlocks for the same reason.
// Hint the core that we are spinning: keeps an SMT sibling (often the
// flag holder) from being starved and cuts the spin's power draw.
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

ScopeRing g_rings[kRingSlots];
std::atomic<int> g_high_water{0};  // slots ever handed out
SpinLock g_slot_lock;              // slot lease/recycle (thread birth/death)
int g_free_slots[kRingSlots];      // stack of recycled slots
int g_free_count = 0;              // both under g_slot_lock
SpinLock g_drain_lock;             // serializes drainers
std::atomic<uint64_t> g_dropped{0};
std::atomic<uint64_t> g_counters[kScopeKindCount][3];  // calls, bytes, ns
std::atomic<uint64_t> g_hist[kScopeKindCount][kScopeHistBuckets];

// Log2 bucket of a duration: 0 for anything under 2^(shift+1) ns, then
// one bucket per doubling, clamped into the last bucket. Branch-free
// except the two clamps; one clz on the hot path.
inline int HistBucket(uint64_t dur_ns) {
  uint64_t v = dur_ns >> kScopeHistShift;
  if (v < 2) return 0;
  int b = 63 - __builtin_clzll(v);
  return b < kScopeHistBuckets ? b : kScopeHistBuckets - 1;
}

std::atomic<int> g_enabled{-1};  // -1 = resolve from env on first use

int ResolveEnabled() {
  const char* v = getenv("RAY_TPU_TORCH_GRAFTSCOPE");
  int on = 1;
  if (v != nullptr &&
      (strcmp(v, "0") == 0 || strcasecmp(v, "false") == 0 ||
       strcasecmp(v, "off") == 0 || strcasecmp(v, "no") == 0)) {
    on = 0;
  }
  // Pure flag, no payload to publish: relaxed on both outcomes.
  int expected = -1;
  g_enabled.compare_exchange_strong(expected, on,
                                    std::memory_order_relaxed,
                                    std::memory_order_relaxed);
  return g_enabled.load(std::memory_order_relaxed);
}

// Recycle the slot when the thread exits so its ring (and any undrained
// records in it) can serve the next thread.
struct SlotLease {
  int slot = -1;
  ~SlotLease() {
    if (slot >= 0) {
      SpinGuard g(g_slot_lock);
      g_free_slots[g_free_count++] = slot;
    }
  }
};
thread_local SlotLease t_lease;

ScopeRing* CurRing() {
  if (t_lease.slot >= 0) return &g_rings[t_lease.slot];
  SpinGuard g(g_slot_lock);
  int s;
  if (g_free_count > 0) {
    s = g_free_slots[--g_free_count];
  } else {
    s = g_high_water.load(std::memory_order_relaxed);
    if (s >= kRingSlots) return nullptr;  // exhausted: counters only
    g_high_water.store(s + 1, std::memory_order_release);
  }
  t_lease.slot = s;
  return &g_rings[s];
}

}  // namespace

extern "C" {

int scope_enabled(void) {
  int e = g_enabled.load(std::memory_order_relaxed);
  return e < 0 ? ResolveEnabled() : e;
}

void scope_set_enabled(int on) {
  g_enabled.store(on ? 1 : 0, std::memory_order_relaxed);
}

uint64_t scope_now_ns(void) {
  timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return (uint64_t)ts.tv_sec * 1000000000ull + (uint64_t)ts.tv_nsec;
}

void scope_emit(uint8_t kind, uint8_t op, uint16_t chan, uint32_t size,
                uint64_t seq_or_oid, uint64_t t_ns, uint64_t dur_ns) {
  if (!scope_enabled()) return;
  if (kind >= kScopeKindCount) return;
  g_counters[kind][0].fetch_add(1, std::memory_order_relaxed);
  g_counters[kind][1].fetch_add(size, std::memory_order_relaxed);
  if (dur_ns) {
    g_counters[kind][2].fetch_add(dur_ns, std::memory_order_relaxed);
    g_hist[kind][HistBucket(dur_ns)].fetch_add(1,
                                               std::memory_order_relaxed);
  }
  ScopeRing* r = CurRing();
  if (r == nullptr) {
    g_dropped.fetch_add(1, std::memory_order_relaxed);
    return;
  }
  if (t_ns == 0) t_ns = scope_now_ns();
  uint64_t w0 = (uint64_t)kind | ((uint64_t)op << 8) |
                ((uint64_t)chan << 16) | ((uint64_t)size << 32);
  uint64_t h = r->head.load(std::memory_order_relaxed);
  size_t i = (size_t)(h & (kRingCap - 1)) * 3;
  r->w[i].store(w0, std::memory_order_relaxed);
  r->w[i + 1].store(seq_or_oid, std::memory_order_relaxed);
  r->w[i + 2].store(t_ns, std::memory_order_relaxed);
  r->head.store(h + 1, std::memory_order_release);
}

int scope_drain(char* buf, int cap) {
  SpinGuard dg(g_drain_lock);
  int n = 0;
  int slots = g_high_water.load(std::memory_order_acquire);
  for (int s = 0; s < slots; s++) {
    ScopeRing* r = &g_rings[s];
    uint64_t head = r->head.load(std::memory_order_acquire);
    uint64_t t = r->tail;
    // Only records in (head - cap, head) are guaranteed un-overwritten;
    // the writer may be mid-store into slot (head - cap) right now.
    if (head - t >= kRingCap) {
      uint64_t safe = head - kRingCap + 1;
      g_dropped.fetch_add(safe - t, std::memory_order_relaxed);
      t = safe;
    }
    while (t < head) {
      if (n + kScopeRecordSize > cap) break;
      size_t i = (size_t)(t & (kRingCap - 1)) * 3;
      uint64_t w0 = r->w[i].load(std::memory_order_relaxed);
      uint64_t w1 = r->w[i + 1].load(std::memory_order_relaxed);
      uint64_t w2 = r->w[i + 2].load(std::memory_order_relaxed);
      // Lap check: if the writer reached t + cap while we copied, the
      // slot may hold a half-written newer record — discard and skip to
      // the new safe window.
      uint64_t h2 = r->head.load(std::memory_order_acquire);
      if (h2 - t >= kRingCap) {
        uint64_t safe = h2 - kRingCap + 1;
        g_dropped.fetch_add(safe - t, std::memory_order_relaxed);
        t = safe;
        head = h2;
        continue;
      }
      ScopeWireRec rec;
      rec.kind = (uint8_t)(w0 & 0xff);
      rec.op = (uint8_t)((w0 >> 8) & 0xff);
      rec.chan = (uint16_t)((w0 >> 16) & 0xffff);
      rec.size = (uint32_t)(w0 >> 32);
      rec.seq_or_oid = w1;
      rec.t_ns = w2;
      std::memcpy(buf + n, &rec, kScopeRecordSize);
      n += kScopeRecordSize;
      t++;
    }
    r->tail = t;
    if (n + kScopeRecordSize > cap) break;
  }
  return n;
}

int scope_counters(uint64_t* out, int max_kinds) {
  int k = max_kinds < kScopeKindCount ? max_kinds : kScopeKindCount;
  for (int i = 0; i < k; i++) {
    out[i * 3 + 0] = g_counters[i][0].load(std::memory_order_relaxed);
    out[i * 3 + 1] = g_counters[i][1].load(std::memory_order_relaxed);
    out[i * 3 + 2] = g_counters[i][2].load(std::memory_order_relaxed);
  }
  return k;
}

int scope_histograms(uint64_t* out, int max_kinds) {
  int k = max_kinds < kScopeKindCount ? max_kinds : kScopeKindCount;
  for (int i = 0; i < k; i++) {
    for (int b = 0; b < kScopeHistBuckets; b++) {
      out[i * kScopeHistBuckets + b] =
          g_hist[i][b].load(std::memory_order_relaxed);
    }
  }
  return k;
}

uint64_t scope_dropped(void) {
  return g_dropped.load(std::memory_order_relaxed);
}

}  // extern "C"
